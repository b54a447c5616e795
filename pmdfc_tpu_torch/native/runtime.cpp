// pmdfc_tpu_torch native runtime: request coalescing engine (a copy of the
// JAX package's `native/runtime.cpp`; only this header differs).
//
// Native component parity with the reference server's data-plane machinery:
// - lock-free bounded MPMC queues (capability of server/circular_queue.cpp's
//   FAA+CAS Valois queue, implemented as Vyukov sequence-stamped rings —
//   cache-friendlier and ABA-free without cmpxchg16b);
// - request batching with adaptive timeout flush (the coalescer role of
//   server/rdma_svr.cpp's per-queue poller threads + BATCH_SIZE fused verbs,
//   rdma_svr.h:16-19 — device batches are three orders deeper);
// - a page staging arena addressed by page index (the registered-MR staging
//   regions of rdma_svr.cpp:873-886, minus the NIC);
// - per-request completion slots the submitting thread spins/yields on (the
//   client's CQ spin-poll, client/rdpma.c:395-435, turned inward).
//
// The Python/PyTorch driver (`runtime/server.py`) is the "device side": it
// pops coalesced batches, runs them through the KV on the GPU, and
// completes the requests. C ABI only — consumed via ctypes.
//
// Build: `ops/_build.build_host("runtime")` (g++ with the flags below) ->
// build/pmdfc_tpu_torch/libpmdfc_runtime.so

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <thread>

namespace {

using u32 = uint32_t;
using u64 = uint64_t;

struct alignas(8) Req {
  u32 op;        // 0=put 1=get 2=del
  u32 khi, klo;
  u32 page_off;  // arena page index (put: source; get: destination)
  u64 req_id;
};

// Vyukov bounded MPMC queue.
class Mpmc {
 public:
  void init(u32 cap) {  // cap must be a power of two
    cap_ = cap;
    mask_ = cap - 1;
    cells_ = static_cast<Cell*>(std::calloc(cap, sizeof(Cell)));
    for (u32 i = 0; i < cap; ++i)
      cells_[i].seq.store(i, std::memory_order_relaxed);
    head_.store(0, std::memory_order_relaxed);
    tail_.store(0, std::memory_order_relaxed);
  }
  void destroy() { std::free(cells_); }

  bool push(const Req& r) {
    u64 pos = tail_.load(std::memory_order_relaxed);
    for (;;) {
      Cell& c = cells_[pos & mask_];
      u64 seq = c.seq.load(std::memory_order_acquire);
      intptr_t dif = (intptr_t)seq - (intptr_t)pos;
      if (dif == 0) {
        if (tail_.compare_exchange_weak(pos, pos + 1,
                                        std::memory_order_relaxed))
          {
            c.req = r;
            c.seq.store(pos + 1, std::memory_order_release);
            return true;
          }
      } else if (dif < 0) {
        return false;  // full
      } else {
        pos = tail_.load(std::memory_order_relaxed);
      }
    }
  }

  bool pop(Req* out) {
    u64 pos = head_.load(std::memory_order_relaxed);
    for (;;) {
      Cell& c = cells_[pos & mask_];
      u64 seq = c.seq.load(std::memory_order_acquire);
      intptr_t dif = (intptr_t)seq - (intptr_t)(pos + 1);
      if (dif == 0) {
        if (head_.compare_exchange_weak(pos, pos + 1,
                                        std::memory_order_relaxed))
          {
            *out = c.req;
            c.seq.store(pos + cap_, std::memory_order_release);
            return true;
          }
      } else if (dif < 0) {
        return false;  // empty
      } else {
        pos = head_.load(std::memory_order_relaxed);
      }
    }
  }

 private:
  struct Cell {
    std::atomic<u64> seq;
    Req req;
  };
  alignas(64) std::atomic<u64> head_{0};
  alignas(64) std::atomic<u64> tail_{0};
  Cell* cells_ = nullptr;
  u32 cap_ = 0, mask_ = 0;
};

// Completion table: req_id-tagged slots; waiters spin then yield.
struct CompSlot {
  std::atomic<u64> req_id{0};   // id whose completion is stored (0 = none)
  std::atomic<int32_t> status{0};
};

struct Engine {
  u32 nq = 0;
  u32 batch = 0;
  u32 timeout_us = 0;
  u32 arena_pages = 0;
  u32 page_bytes = 0;
  Mpmc* queues = nullptr;
  uint8_t* arena = nullptr;   // caller-owned (numpy) — never freed here
  bool owns_arena = false;    // legacy path: allocated by pm_create
  CompSlot* comp = nullptr;
  u64 comp_mask = 0;
  std::atomic<u64> next_id{1};
  std::atomic<u64> submitted{0}, completed{0}, batches{0}, flushes{0};
  u32 rr = 0;  // round-robin cursor (driver thread only)
  // Lifecycle guard: pm_destroy must never free queues/slots under a live
  // call. Every API entry increments `inflight` and bails if `closing`;
  // destroy flips `closing` then drains `inflight` before freeing. The
  // failure-drill tier tears servers down UNDER client load on purpose —
  // without this, a freed-queue write from a racing submit corrupts the
  // process heap and detonates arbitrarily later (observed as segfaults
  // inside XLA long after the engine died).
  std::atomic<u32> inflight{0};
  std::atomic<bool> closing{false};
};

struct Gate {
  Engine* e;
  bool ok;
  explicit Gate(Engine* eng) : e(eng) {
    e->inflight.fetch_add(1, std::memory_order_acq_rel);
    ok = !e->closing.load(std::memory_order_acquire);
  }
  ~Gate() { e->inflight.fetch_sub(1, std::memory_order_release); }
};

inline u64 now_us() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

}  // namespace

extern "C" {

Engine* pm_create2(u32 nq, u32 qcap, u32 batch, u32 timeout_us,
                   u32 arena_pages, u32 page_bytes, u64 comp_slots);

Engine* pm_create(u32 nq, u32 qcap, u32 batch, u32 timeout_us,
                  u32 arena_pages, u32 page_bytes) {
  return pm_create2(nq, qcap, batch, timeout_us, arena_pages, page_bytes, 0);
}

// comp_slots: completion-table capacity (rounded up to a power of two;
// 0 = legacy sizing). The table is addressed by req_id & mask, so two LIVE
// ids comp_cap apart collide — and "live" spans from id allocation (at
// submit) until the WAITER READS the slot, not until the driver completes
// it. Deep pipelined clients (T threads x V-key verbs x D inflight) keep
// T*V*D ids allocated-but-unread; the legacy qcap/batch-derived bound does
// not see that term, and an overwritten unread slot wedges its waiter
// forever (found by the round-4 deep-client sweep: 8x32768x8 = 2M live ids
// vs a 1M-slot table -> "completed 0/32768 before timeout"). Callers with
// pipelined clients must pass comp_slots >= total outstanding ids.
Engine* pm_create2(u32 nq, u32 qcap, u32 batch, u32 timeout_us,
                   u32 arena_pages, u32 page_bytes, u64 comp_slots) {
  auto* e = new (std::nothrow) Engine();
  if (!e) return nullptr;
  e->nq = nq;
  e->batch = batch;
  e->timeout_us = timeout_us;
  e->arena_pages = arena_pages;
  e->page_bytes = page_bytes;
  e->queues = new Mpmc[nq];
  for (u32 i = 0; i < nq; ++i) e->queues[i].init(qcap);
  // arena is adopted from the caller via pm_set_arena (numpy-owned memory,
  // refcounted by the views that touch it); nothing to allocate here
  e->arena = nullptr;
  e->owns_arena = false;
  // Legacy floor = queued (qcap*nq) + popped-but-uncompleted (≤ batch) with
  // 2x headroom — sufficient only for synchronous (inflight≤1) clients.
  u64 want = (u64)(qcap * nq + batch) * 2;
  if (comp_slots > want) want = comp_slots;
  u64 comp_cap = 1;
  while (comp_cap < want) comp_cap <<= 1;
  e->comp = new (std::nothrow) CompSlot[comp_cap];
  if (!e->comp) { delete[] e->queues; delete e; return nullptr; }
  e->comp_mask = (u64)comp_cap - 1;
  return e;
}

// Stop sign WITHOUT freeing: makes every native spin loop (submit retry,
// waits, pop) bail promptly so the host-side call drain can finish. Call
// this, drain host-side callers, THEN pm_destroy — the Gate inside each
// API is defense-in-depth, not the primary lifetime mechanism (a caller
// could otherwise enter between destroy's drain and its frees).
void pm_close(Engine* e) {
  e->closing.store(true, std::memory_order_release);
}

// EMBEDDER CONTRACT: pm_destroy is only safe once the embedder has
// quiesced its own callers — call pm_close, wait until no thread of yours
// can still be about to enter a pm_* function with this handle, THEN
// pm_destroy. The Gate/inflight drain below is defense-in-depth, not the
// primary lifetime mechanism: a caller that read the handle before
// `closing` was set can still enter between the drain hitting zero and the
// frees (check-then-free). The Python binding enforces this with its own
// host-side call gate (engine.py close()); a non-Python embedder must
// provide the equivalent.
void pm_destroy(Engine* e) {
  // Quiesce: no new calls get past their Gate once `closing` is set; wait
  // for the ones already inside (their loops all poll `closing` and exit
  // promptly) before freeing anything.
  e->closing.store(true, std::memory_order_release);
  while (e->inflight.load(std::memory_order_acquire) != 0)
    std::this_thread::yield();
  for (u32 i = 0; i < e->nq; ++i) e->queues[i].destroy();
  delete[] e->queues;
  delete[] e->comp;
  if (e->owns_arena) std::free(e->arena);
  delete e;
}

// Adopt a caller-owned arena buffer (numpy-allocated): teardown then never
// frees page memory under an in-flight client view — the buffer's lifetime
// is refcounted by the views that touch it.
void pm_set_arena(Engine* e, uint8_t* buf) {
  if (e->owns_arena) std::free(e->arena);
  e->arena = buf;
  e->owns_arena = false;
}

uint8_t* pm_arena(Engine* e) { return e->arena; }

// Client side: enqueue one request; returns req_id, or 0 if the queue stayed
// full for timeout_us (driver gone/stalled — backpressure must not become a
// hang; the reference client's send-queue block relies on the NIC always
// draining, which an in-process driver cannot promise).
u64 pm_submit(Engine* e, u32 q, u32 op, u32 khi, u32 klo, u32 page_off,
              u32 timeout_us) {
  Gate g(e);
  if (!g.ok) return 0;
  u64 id = e->next_id.fetch_add(1, std::memory_order_relaxed);
  Req r{op, khi, klo, page_off, id};
  Mpmc& queue = e->queues[q % e->nq];
  if (!queue.push(r)) {
    u64 deadline = now_us() + timeout_us;
    for (;;) {
      std::this_thread::yield();
      if (e->closing.load(std::memory_order_acquire)) return 0;
      if (queue.push(r)) break;
      if (now_us() >= deadline) return 0;
    }
  }
  e->submitted.fetch_add(1, std::memory_order_relaxed);
  return id;
}

// Driver side: coalesce up to `max` requests across all queues; returns
// early count on timeout with whatever accumulated (adaptive flush).
u32 pm_pop_batch(Engine* e, Req* out, u32 max, u32 timeout_us) {
  Gate g(e);
  if (!g.ok) return 0;
  u32 n = 0;
  u64 deadline = now_us() + timeout_us;
  // Settle cutoff: once a partial batch has seen NO new arrivals for a
  // fraction of the flush budget, every client is almost certainly blocked
  // waiting on THIS batch — dwelling out the rest of the deadline would
  // serialize the convoy (clients wait on driver, driver waits on deadline).
  u32 settle = timeout_us / 8;
  if (settle > 500) settle = 500;
  if (settle < 50) settle = 50;
  u64 empty_since = 0;
  u32 idle_spins = 0;
  while (n < max) {
    bool got = false;
    for (u32 i = 0; i < e->nq && n < max; ++i) {
      if (e->queues[(e->rr + i) % e->nq].pop(&out[n])) {
        ++n;
        got = true;
      }
    }
    e->rr = (e->rr + 1) % e->nq;
    if (got) {
      empty_since = 0;
      // the deadline binds even while requests keep arriving: the FIRST
      // request of the batch must not wait for the cap to fill under a
      // sustained stream. Exception: a non-blocking pop (timeout 0) means
      // "drain what is queued right now" — it is bounded by an empty
      // sweep below, not by the (already-passed) deadline, so the
      // pipelined driver still empties the backlog in one call.
      if (timeout_us > 0 && now_us() >= deadline) {
        if (n < max) e->flushes.fetch_add(1, std::memory_order_relaxed);
        break;
      }
    } else {
      u64 t = now_us();
      if (empty_since == 0) empty_since = t;
      // settle cutoff: a partial batch that has seen no arrivals for a
      // fraction of the budget flushes early — every client is almost
      // certainly blocked on THIS batch (convoy), dwelling is pure loss
      if (t >= deadline || (n > 0 && t - empty_since >= settle)) {
        if (n > 0 && n < max)
          e->flushes.fetch_add(1, std::memory_order_relaxed);
        break;
      }
      if (++idle_spins > 64) {
        std::this_thread::yield();
        idle_spins = 0;
      }
      if (e->closing.load(std::memory_order_acquire)) break;
    }
  }
  if (n) e->batches.fetch_add(1, std::memory_order_relaxed);
  return n;
}

// Driver side: publish completions (status >= 0 ok / hit, < 0 miss or error).
void pm_complete(Engine* e, const u64* req_ids, const int32_t* status,
                 u32 n) {
  Gate g(e);
  if (!g.ok) return;
  for (u32 i = 0; i < n; ++i) {
    CompSlot& s = e->comp[req_ids[i] & e->comp_mask];
    s.status.store(status[i], std::memory_order_relaxed);
    s.req_id.store(req_ids[i], std::memory_order_release);
  }
  e->completed.fetch_add(n, std::memory_order_relaxed);
}

// Client side: enqueue a whole batch under ONE call (the reference ships 4
// pages per verb, client/rdpma.c:307-320; a ctypes call per page would be
// the Python-tax equivalent of one verb per page). Request ids are allocated
// contiguously: returns the count submitted (requests [*base_id, *base_id+
// count) are live). count < n means the queue stayed full past timeout_us
// for the tail — the unsubmitted ids are dead and never complete.
u32 pm_submit_batch(Engine* e, u32 q, u32 op, const u32* khi, const u32* klo,
                    const u32* page_off, u32 n, u32 timeout_us,
                    u64* base_id) {
  Gate g(e);
  if (!g.ok) { *base_id = 0; return 0; }
  u64 base = e->next_id.fetch_add(n, std::memory_order_relaxed);
  *base_id = base;
  Mpmc& queue = e->queues[q % e->nq];
  u64 deadline = 0;  // lazily armed on first full queue
  u32 i = 0;
  while (i < n) {
    Req r{op, khi[i], klo[i], page_off ? page_off[i] : 0, base + i};
    if (queue.push(r)) {
      ++i;
      continue;
    }
    if (deadline == 0) deadline = now_us() + timeout_us;
    std::this_thread::yield();
    if (e->closing.load(std::memory_order_acquire)) break;
    if (now_us() >= deadline) break;
  }
  if (i < n) {
    // Partial submit: try to hand back the unused ids so burned ids cannot
    // erode the comp-table spacing invariant (two live ids must never be
    // comp_cap apart). The CAS only succeeds if no one allocated since;
    // a failed CAS leaves a rare bounded gap, covered by comp_cap's 2x
    // headroom.
    u64 expect = base + n;
    e->next_id.compare_exchange_strong(expect, base + i,
                                       std::memory_order_relaxed);
  }
  e->submitted.fetch_add(i, std::memory_order_relaxed);
  return i;
}

// Client side: wait for n contiguous-id completions, filling status[n].
// Returns the number completed before timeout (n on success); slots not
// completed in time hold INT32_MIN.
u32 pm_wait_many(Engine* e, u64 base_id, u32 n, int32_t* status,
                 u32 timeout_us) {
  Gate g(e);
  if (!g.ok) { for (u32 i = 0; i < n; ++i) status[i] = INT32_MIN; return 0; }
  u64 deadline = now_us() + timeout_us;
  u32 done = 0;
  u32 spins = 0;
  for (u32 i = 0; i < n; ++i) status[i] = INT32_MIN;
  // Scan round-robin so one slow request does not starve observation of the
  // rest (completions land in driver order, not submit order).
  bool progress = true;
  while (done < n) {
    progress = false;
    for (u32 i = 0; i < n; ++i) {
      if (status[i] != INT32_MIN) continue;
      CompSlot& s = e->comp[(base_id + i) & e->comp_mask];
      if (s.req_id.load(std::memory_order_acquire) == base_id + i) {
        status[i] = s.status.load(std::memory_order_relaxed);
        ++done;
        progress = true;
      }
    }
    if (done == n) break;
    if (now_us() >= deadline) break;
    if (e->closing.load(std::memory_order_acquire)) break;
    if (!progress && ++spins > 64) {
      std::this_thread::yield();
      spins = 0;
    }
  }
  return done;
}

// Client side: wait for a request's completion. Returns status, or
// INT32_MIN on timeout.
int32_t pm_wait(Engine* e, u64 req_id, u32 timeout_us) {
  Gate g(e);
  if (!g.ok) return INT32_MIN;
  CompSlot& s = e->comp[req_id & e->comp_mask];
  u64 deadline = now_us() + timeout_us;
  u32 spins = 0;
  for (;;) {
    if (s.req_id.load(std::memory_order_acquire) == req_id)
      return s.status.load(std::memory_order_relaxed);
    if (now_us() >= deadline) return INT32_MIN;
    if (e->closing.load(std::memory_order_acquire)) return INT32_MIN;
    if (++spins > 256) {
      std::this_thread::yield();
      spins = 0;
    }
  }
}

void pm_stats(Engine* e, u64* out4) {
  Gate g(e);
  if (!g.ok) { out4[0] = out4[1] = out4[2] = out4[3] = 0; return; }
  out4[0] = e->submitted.load(std::memory_order_relaxed);
  out4[1] = e->completed.load(std::memory_order_relaxed);
  out4[2] = e->batches.load(std::memory_order_relaxed);
  out4[3] = e->flushes.load(std::memory_order_relaxed);
}

}  // extern "C"
