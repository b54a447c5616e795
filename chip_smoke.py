#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`pmdfc_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each reported on its own line; any failure exits nonzero:

1. env     — the card (nvidia-smi name and power limit), torch, CUDA, nvcc.
2. build   — compiles every kernel of the paths from `pmdfc_tpu_torch/ops/csrc`
             (one source, `fused_get.cu`, holding all four fused-GET variants)
             with nvcc, and beside it the coalescing engine
             (`pmdfc_tpu_torch/native/runtime.cpp`) with g++.
3. kernel  — each kernel against its plain PyTorch version, bit for bit
             (tolerance 0: all integer arithmetic), on small states at w in
             {16, 2^10, 2^14}, over batches that hold every miss cause (real
             extent covers for EXT, corrupted pages for DIGEST; tiered: a
             NOPAGE entry and a cleared live bit for PARKED, entries left
             stale by a forced shrink, a grow and fresh puts for STALE):
             linear and cceh with S=16 and S=32, and cceh on an extendible
             (LSB directory) state through the wrapper with msb=False, each
             over the flat pool and then over a tiered pool whose 1/16 hot
             tier went through promotions, demotions and ghost readmits.
4. main    — four main paths through the `KV` host class on the default
             device at the serving size, 2^21 slots and 4 KiB pages, the
             evicted-key sketch, one path at a time:
             - linear·flat: 65,536 clusters of 32, a 2^24-bit counting
               bloom, an 8 GiB pool;
             - cceh·flat: the JAX defaults (1024-slot segments, 32-slot
               probe windows, split headroom 1, 64 splits per round) at
               capacity 2^20, so 1024 segments growing to 2048 (Gmax 11,
               an 8 KiB directory, a 32 MiB table), the default bloom;
             - linear·tiered and cceh·tiered: the same indexes over the
               tiered pool with `TierConfig()`'s defaults, 262,144 hot +
               2,097,152 cold rows = 9 GiB; cceh·tiered with the admission
               gate (`AdmitConfig()`), linear·tiered without.
             Fill 75% of the slots in 2^16-key inserts (CCEH: splits up to
             the headroom, then in-window evictions; on the flat path, a
             third of the way in, one replicated directory entry is
             damaged, the keys behind it stop hitting, and `recovery()`
             repairs it); serve mixed 2^14-key GET and get_compact batches
             (present, never-inserted, capacity-evicted, padding; tiered: a
             quarter from a fixed hot set of 2^12 present keys, which
             promote and are then served byte-exact from hot rows); delete;
             serve again with deleted keys mixed in. Every hit must return
             the exact page inserted (pages are a function of key and word
             index, made on the device), every present key must hit, every
             miss is zeroed, `misses == Σ miss_*`, and the path's kernel
             must have launched. cceh·flat then inserts a few hundred
             extents (bases and values around 2^31 and 2^32) and checks
             `get_extent`'s addresses, a page GET of a cover (a cold miss
             through EXT), a page put over a cover (converted), and
             `find_anyway` on 16 keys. The tiered paths update hot-resident
             keys in place, delete hot-resident keys (`hot_occupied` drops
             by as many), shrink the balloon by its free rows plus 2 x 1024
             (every key whose row it evicted misses as `miss_stale`), grow
             it back and insert fresh keys into the evicted rows (the old
             keys still miss, the new ones hit byte-exact). Then phase 3's
             comparison on each full-size state.
5. times   — per path: CUDA-event device times per 2^14-key batch of the
             kernel and of its plain version (queued behind a busy stream,
             so the host's launch time is not counted; the host-driven loop
             is reported beside), rotated over 8 distinct batches whose pages
             (about 8 x 42 MB) far exceed the 50 MB L2, with one batch
             repeated as the warm time beside it; the kernel's bound (the
             bytes these batches must move over 3.35 TB/s); whole-path GET
             (tiered: with its `tier.on_get` epilogue) and insert rates and
             a torch.profiler breakdown of `KV.get`.
6. families — the six index families that take the composed GET (cuckoo,
             cuckoo-probing, level, path, static, HotRing), one at a time,
             each through `KV` at linear·flat's serving configuration with
             only the kind changed but the requested capacity cut to 2^20
             for the time limit (the 2^24-bit bloom, 4 KiB pages, the
             sketch); the pool follows each family's slot count (level
             3 x 2^19 slots = 6 GiB). Fill 75% of the slots; serve mixed
             get and get_compact batches (present, never-inserted,
             evicted or dropped, padding) and, after a delete, with the
             deleted keys mixed in: every key an insert reported placed
             and no later insert reported evicted hits byte-exact, every
             miss is zeroed, `misses == Σ miss_*`, static never evicts,
             and a `scan()` of the table holds exactly the present keys.
             HotRing serves 2^20 GET keys, a quarter from a 2^12-key hot
             set, so the default decay fires through `KV`; then every hot
             key resolves from the mirror, and hot keys updated in place
             serve their new bytes from the table. No family launches the
             fused GET. Times per family: fill pages/s, `KV.get` wall per
             2^14 keys (CUDA events), and torch.profiler's device ops,
             device busy and device-to-host copies per insert and get
             (its profiled inserts of fresh keys take the table to about
             87% full, and their results are held to the same checks).
             Then the standalone policy cache (`ops/policy_cache.py`):
             LRU, LFU and FIFO on the card, each call held equal to the
             same call on the CPU (gets, evictions, table, metric, tick).
7. serve   — the serving path, after the families: linear·flat's configuration
             (8 GiB) in a `KVServer` behind the native engine (32 queues,
             2^14-request flushes, a 256 MiB arena), driven by 4 clients x 8
             threads of `CleanCacheClient` over `EngineBackend`, each with
             its own queue and a 2^11-page arena slice, the server pushing
             its bloom filter every 0.05 s. `warmup()` first, on the main
             thread (a kernel that fails to build or launch raises there,
             not as -2 statuses inside the driver). Fill 75% of the slots:
             5/8 through `KV.insert` in 2^16-page batches, then 1/8
             through the engine in 2^11-page put_pages verbs; push; every
             acknowledged key a mirror denies must miss at the server;
             invalidate; then 8 get_pages verbs per thread (5/8 present,
             1/8 never inserted, 1/8 invalidated, 1/16 oldest, 1/16
             padding): hits byte-exact, misses zeroed with their arena
             slots untouched by the server, never-inserted and
             invalidated keys miss, misses of acknowledged keys <=
             evictions + drops, >= 90% of never-inserted GETs
             short-circuited by the mirrors, no -2 status, no serve error,
             submitted == completed, one fused-GET launch per GET flush;
             then 256 extents through OP_INS_EXT, read back through
             OP_GET_EXT. Reports fill and GET rates, verb latency, flush
             widths, the driver's phase times and the push counters. With
             the driver stopped: quiet PUT flushes (2^14 and 11,826 pages)
             that must serve their pages back and a quiet GET flush that
             must agree with `KV.get`, timed, and a profile of the GET
             flush; then phase 3's comparison and phase 5's times on the
             server's full-size state.

8. wire   — the wire path, last: linear·flat's configuration (8 GiB) behind
             the port's `NetServer(NetConfig())` on loopback TCP, driven by
             4 clients x 8 connections, each a pipelined `TcpBackend`
             (window 32, keepalives on) built by a `ReconnectingClient`
             under a `CleanCacheClient` whose mirror the server's bloom
             pushes (every 0.05 s) feed. Pre-fill 1,310,720 pages straight
             through `KV.insert`, then 262,144 pages over the wire in
             2^11-page put_pages verbs (75% of the slots in all); a scan
             names the pre-fill keys the fills evicted; every acknowledged
             key a mirror denies must miss; invalidate; a GET storm of
             2^19 keys (5/8 present, 1/8 never inserted, 1/8 invalidated,
             1/8 evicted); 128 extents over the wire. The fast lane: 4
             connections opened with `directory=True` pull the directory
             and read 2^16 pre-fill keys each by MSG_FASTREAD; another
             connection rewrites 2^12 of them and the second pass must
             serve the new pages (their lanes stale, answered by the verb
             path); it invalidates 2^12 more and the third pass must miss
             them. A recovering window (`begin_recovering`, one GET verb of
             never-inserted keys past the mirror, MSG_RECOVERY's
             `mark_recovered`): its cold misses count as miss_recovering.
             Checks: hits byte-exact, misses zeroed, misses of acknowledged
             keys <= evictions + drops, `misses == Σ miss_*`,
             fastpath_hits + fastpath_stale == the fast lanes read, no
             serve error, no disconnect, no bloom false negative, >= 90%
             of never-inserted GETs short-circuited, one fused-GET launch
             per GET phase. Reports rates, verb latency, flush widths, the
             fast passes, `directory_snapshot` and `fast_view` costs; the
             kernel against plain at the smallest and largest GET-phase
             widths and its times at the largest. Then, with the KV freed,
             the one-sided sub-phase: a `PassivePool` of 2^21 rows (8 GiB)
             on the card behind `PoolServer`, 4 `OneSidedBackend`s over
             `RemotePool`s, each writing 2^16 pages and reading them back
             byte-exact; rows/s both ways.
9. fleet  — durability and the replicated fleet, after the wire: three
             nodes, each a `pmdfc_tpu_torch.tools.crashbox` child process
             (spawn) on the card serving linear·flat's configuration cut
             to 2^19 slots (a 2 GiB pool) from a `KV` with its own
             write-ahead `Journal` (`JournalConfig()`) behind
             `NetServer(NetConfig())` on loopback: three 2 GiB pools on
             the one H100, the one phase where pools share the card,
             because a fleet needs them to.
             Snapshots and journals go to `build/fleet` (git-ignored; its
             filesystem and free bytes are printed, tmpfs or less than
             4 GiB free fails), removed at the end. One `ReplicaGroup`
             (rf 2, hedge 50 ms, the ring; repair by manual ticks) over a
             `ReconnectingClient(TcpBackend)` per node, whose factory
             follows the node's port, shared by 8 client threads with
             2^11-key verbs; keys (0xC0000000, i). Put 2^16 keys; node 2
             cuts a full snapshot; put 2^13; node 2 cuts a delta; put 2^12
             and invalidate 2^10 earlier keys (node 2's journal tail); a
             GET storm of 2^15 keys. With the traffic paused, SIGKILL node
             2; while it is down put 2^11, invalidate 2^9 and storm 2^15:
             every acknowledged, non-invalidated key hits byte-exact by
             failover, every invalidated key misses, node 2's breaker
             opens. Warm restart node 2 from [full, delta] and its journal
             (time from spawn to serving, with the child's split: chain
             read and verify, fold, to the device, `recovery()`, replay);
             over its own `TcpBackend`: every key the ring gives it that
             was acknowledged before the kill hits byte-exact (losses
             within `(rpo_ops + 1) x 2^11`, 0 expected), keys invalidated
             before the kill miss, it is `recovering` and the misses of
             the outage's keys count as `miss_recovering` with `misses ==
             Σ miss_*`. Rejoin: the breaker closes, repair ticks drain
             the backlog (pages/s), the drain's `mark_recovered` makes
             `recoveries_completed` 1 and node 2 leaves `recovering`;
             then node 2 serves every key it owns byte-exact, those put
             while it was down included (a bloom false positive of the
             repair scan is the one legal miss, counted), and no
             invalidated key is served by it or by the group (its client
             replays the invalidations it journaled). Node 2 cuts one
             more delta; the nodes stop; this process restores the
             three-member chain with `checkpoint.load_chain(...,
             device="cuda")` into a `KV`, where every such key hits
             byte-exact, and phase 3's comparison runs on that 2 GiB
             state. Throughout: one fused-GET launch per GET phase on
             every node (read over each child's control pipe), no serve
             error, no contained phase failure, no corrupt page, no wrong
             byte, no shed put. Reports snapshot seconds and GB/s, dirty
             rows, journal appends, syncs and fsync lag per node, put and
             GET rates and verb p50/p99 before and during the outage,
             time to recover and its split, repair pages/s, the
             in-process restore's seconds and peak RSS.
10. plane — the sharded plane, last: `ShardedKV` over a grid that names the
             card four times (`make_mesh(["cuda"] * 4)`), each shard
             linear·flat at 2^17 slots, `BloomConfig(num_bits=1 << 20)`
             (8 bits per slot, as linear·flat) and 4 KiB pages: four
             512 MiB pools, 2 GiB in all — the reference server's 10 GB
             buffer split over four shards as `NuMA_KV` splits one server
             over its NUMA nodes, cut to a quarter for the time limit;
             four shards on one card stand in for four devices (no width
             is cut). Fill 327,680 pages through
             `ShardedKV.insert` (a2a, 2^16-key batches; the a2a pair
             overflow is counted, 0 expected); put `PlaneBackend(skv)`
             behind `NetServer(NetConfig())` with the wire phase's 4 x 8
             pipelined connections: 65,536 pages over the wire (75% of the
             slots), the mirror check and invalidates, a GET storm of 2^18
             keys (present, never inserted, invalidated, evicted), 64
             extents, and the fast lane's three passes over 2^14 pre-fill
             keys per directory connection (per-(shard, row) validated
             reads around rewrites and invalidates). Checks: the
             wire phase's (hits byte-exact, misses zeroed, acknowledged
             misses <= evictions + drops, no serve error, NACK or
             disconnect; the mirrors, the OR of the per-shard filters,
             short-circuit what their bit density allows),
             `misses == Σ miss_*` on `stats()` and on every
             shard's row of `shard_report()`, the `shard{i}_ops` counters
             sum to the routed ops, every GET key routed is counted once,
             and one fused-GET launch per shard per GET phase; then the
             kernel against plain on shard 0's full state at w = 8 (the
             router's pad floor) and at the widest per-shard width served,
             timed at both. Snapshots to `build/plane` (git-ignored, on the
             checkout's disk): a full, 2^14 puts and 2^12 deletes, a delta;
             `restore_chain` onto a fresh 4-shard plane, where every key the
             delta held hits byte-exact and the deleted ones miss; the
             engine pass on that plane (`KVServer(kv=skv)`, 8 clean-cache
             threads putting and getting 2^16 pages through the engine:
             every hit byte-exact, no -2, no serve error, one launch per
             shard per GET flush); then, with both planes freed, the full
             reshard-restored onto 8 shards (4 GiB): no live page lost,
             invalidated keys stay missing, the replay drops nothing,
             counters carried. Last the 2 x 2 plane (`make_mesh2d(2, 2,
             ["cuda"] * 4)`, 2^18 slots per lane: 1 GiB pools, 4 GiB on
             the card, 2 GiB of distinct pages) behind `NetServer`: every
             connection negotiates `replica_lanes == 2`; 327,680 pages
             through `plane_insert` (one call writes both lanes) and 65,536
             over the wire; lane 1 corrupted: a storm serves every hit
             byte-exact from lane 0 and lane 1's `digest_refused` counts
             exactly lane 0's serves; `TcpBackend.replica_repair()`
             (`MSG_RREPAIR`) repairs at least every live row; lane 0
             corrupted: lane 1 serves, with the same checks, one launch per
             shard per lane per GET phase. Reports rates, verb p50/p99,
             snapshot and restore seconds, GB/s and peak RSS, the kernel at
             w = 8 and at the widest width.
11. control — the device-time profiler, the row-rebuild insert and the
             closed-loop controller, after the plane, its KV freed first.
             The row insert: two linear indexes of 2^21 slots (32 MiB
             each) filled to 75% in 2^16-key batches of fresh keys,
             updates, in-batch duplicates and padding (same-cluster
             collisions come with the fill), one through
             `insert_batch_element` and one through `insert_batch_row`:
             tables, heads and every InsertResult equal after every batch,
             every insert timed with CUDA events. Then a child process of
             this script (`--row-kv`) started with PMDFC_INSERT_PATH=row:
             linear·flat at 8 GiB filled to 75% through `KV.insert` on the
             row path, GET storms through the fused kernel (every hit
             byte-exact, every present key hits, `misses == Σ miss_*`),
             kernel against plain on that state, and its times. Then
             linear·tiered at 9 GiB (`TierConfig()`) pre-filled through
             `KV.insert`, behind `NetServer(NetConfig())` with PMDFC_PROF
             on, telemetry dumping under `build/control` (git-ignored,
             removed at the end), a series collector every 0.25 s and
             `autotune.attach(server=..., client=...)` with the KV's
             balloon bound: 32 pipelined `TcpBackend` connections, a light
             phase (one connection, 64-key verbs, 4 s) then a fan-in phase
             (all 32, 2^11-key verbs) during which a monitor connection
             sends MSG_PROFILE. Checks: every hit byte-exact, never-inserted
             keys miss, present keys miss only by a legal cause, `misses ==
             Σ miss_*`, no serve error or failed phase, no reconnect, one
             fused-GET launch per GET phase, the profiler's `kv.get`
             launches equal to the GET phases, each `kv.get` `device_us`
             (its CUDA event window) at least 0.9x the kernel alone at that
             width and at most the phase's wall, the capture's `trace.json`
             holding `fused_get_kernel` kernel events, a second capture
             inside the cooldown refused, the controller having consumed
             series windows with every knob inside its `AutotuneConfig`
             envelope, and the port's `proftool` breaking down the pulled
             MSG_STATS snapshot. Prints the knob moves (their direction
             depends on the host's timing and is not checked). Last, the
             harnesses `bench/insert_rowscatter.py` and
             `bench/telemetry_overhead.py --smoke` on the card, each its
             own process (the ON/OFF ratio is reported, not gated).
12. scale — the multi-process plane on torch.distributed and the
             reference's workload harnesses, after control. (a) Two
             processes from the `spawn` context join over gloo on
             loopback (`connect_multihost`, two shards each on the card,
             the exchange staged through pinned host buffers), each shard
             linear·flat at 2^18 slots, 8 bloom bits per slot, 4 KiB
             pages (4 GiB in all, cut from 8 GiB for the time limit).
             Every process passes
             the same full batches: 75% of the slots in 2^14-key a2a
             inserts (the pair overflow counted), 2^12 deletes, 6 a2a
             GETs of 2^14 keys (5/8 present, 1/8 deleted, 1/8 never
             inserted, 1/8 any) and one broadcast GET of 2^12 on the same
             plane. Checks in every process: every present key hits, every
             hit byte-exact, every deleted or never-inserted key misses,
             every miss zeroed, `misses == Σ miss_*` on `stats()` and on
             every shard's row of `shard_report()`, one fused-GET launch
             per shard per GET phase; the processes' results are
             identical; the kernel against plain on each process's first
             full shard at w = 8 and at the widest per-shard width (rank
             0 times it). Reports fill and GET rates and the exchange's
             bytes and seconds per batch. (b) One process in an NCCL
             group of world size 1, four 2^16-slot shards on the card
             (the exchange's collectives run on the card): the same
             checks. Then two NCCL ranks naming the one card must both
             be refused (`SharedDeviceError`) before any collective. (c)
             The harnesses of `pmdfc_tpu_torch/bench/`, each its own
             process with `--device cuda`, five side by side in lanes
             from the phase's start, beside (a) and (b); phase 13's
             harnesses are queued behind them in the same lanes:
             `multihost_bench --procs 2 --backend gloo` (hits == n),
             `test_kv` over the reference baseline's 10M uniform keys at
             2^25 slots, linear then cceh (`failedSearch` 0), the six
             `paging_sim` jobs, `swap_sim`, filebench's fileserver and
             webserver (8 GiB pools; `verify_failures` 0), `replay` of
             the bundled trace and of 10^6 synthetic events (no wrong
             value), `multinode` with 3 clients (no wrong page).
13. tail   — the bench tail of `pmdfc_tpu_torch/bench/`, after scale.
             In this process, launches counted: `fused_get` for
             linear·flat and cceh·flat at phase 4's configurations (8 GiB
             pools filled to 75% of the slots), one family at a time, its
             kernel side (`KV.get_async`) against the composed chain
             (`kv._get_core` on a second KV) on zipf 0 and 0.99 streams
             of 2^18 keys in batches of 2^11, 2^14 and 2^16: pages, found
             and every stats lane equal on every batch, every hit the
             key's page, every miss zeroed, one launch per kernel-side GET
             and none on the composed side, both timed by CUDA events;
             then `tier_sweep`, linear at 2^20 slots tiered against flat
             (4 GiB each), batches of 2^14, zipf 0, 0.6, 0.99 and 1.2,
             2^16 GETs a skew: every hit byte-exact, every miss zeroed,
             `misses == Σ miss_*`. Each harness's last state is held
             kernel against plain and timed (w = 2^11, 2^14, 2^16).
             Beside them, in the lanes phase 12 started, each its own
             process with `--device cuda`: `mesh_sweep` (1, 2, 4 and 8
             shards over a 4 GiB total, the one card named per shard, and
             the PMDFC_MESH=off row, behind `NetServer`; every verb
             verified, one launch per shard per GET phase), `soak`
             (linear·flat at 4 GiB through the engine for 30 s; no wrong
             page, no stale serve, no serve error), `fill_sweep` (its
             families and fills at 2^20 slots, inserts of 2^16),
             `insert_profile`,
             `train_pressure` (4 KiB pages, 100 steps), and
             `fastpath_sweep`, `replica_soak` and `elastic_sweep` (120
             storm steps), `recovery_soak` (160 steps),
             `containment_soak`, `qos_soak --backend direct` (4 KiB
             pages, 2^18 slots a node), each held to its
             gates (no wrong byte, no serve error, and its own: the RPO
             bound and `miss_recovering`, the isolation and re-admission,
             the shed attribution, a falling loss). Reports every row
             beside the card's name and power limit, and its wall time.
14. chaos  — the failure ladder through `ChaosProxy`, in a child
             process (`--chaos`) queued first in phase 12's lanes, so its
             wall hides beside phases 12 and 13; its lines are echoed and
             its kernel entries added after phase 13. (a) A linear·flat
             `KV` of 2^18 slots (1 GiB of 4 KiB pages) filled to 75%
             through `KV.insert`, behind `NetServer`, a `ChaosProxy` at
             `tests/test_chaos.py`'s rates and `IntegrityBackend` over
             `ReconnectingClient` over `TcpBackend`: 120 steps
             unpipelined and 120 pipelined (window 8) of puts, GETs and
             invalidates of up to 2^11 pages, after a warm GET on a
             chaos-free connection. A quarter in, 2^10 probe keys are put
             directly and every pool byte is XORed in place under the
             KV's lock and device: the probe GET launches the kernel,
             misses every probe key and counts them as corrupt. Midway, a
             durable snapshot and a newer one torn at 70%, the server
             killed: the torn file is refused, the KV restored from the
             durable one serves exactly the hit set (and bytes) the
             killed one served. Gates: zero wrong bytes, the torn file
             refused, the hit sets equal, `corrupt_detected > 0`, no
             NACK and no serve error (the wire's -2). (b) The xray
             acceptance soak: a 4-shard plane naming the card four times,
             2^16 slots a shard, linear over `TierConfig` (balloon step
             1/8, ghost rows 1/16), behind the coalescing `NetServer` and
             a `ChaosProxy` (flip 1%, duplicate 0.5%): a zipf 0.99 stream
             of 2^11-key verbs, puts every third step, the balloon shrunk
             by a shard's whole cold pool midway; every hit byte-exact,
             `misses == Σ miss_*` on `stats()`, every `shard_report()`
             row, `KVServer.health` and the wire document (which passes
             the port's `check_teledump`); one collector window later the
             port's `teletop --once --json` against this server and a
             2-shard one reports rates and per-shard rows. (c) The wire
             drills, 2^11-page verbs, the card's counterparts of the JAX
             suites' `slow` drills: poison bisection with 4
             connections fused into one GET flush (only the culprit
             NACKed within ceil(log2 4) failures, no connection dropped,
             the resubmit refused, the fingerprint seeded with the verb,
             the NACKed ops' spans closed failed; the kernel launches of
             the bisection counted), NACK negotiation and its kill
             switches and an unnegotiated peer's dropped connection, the
             deadline shed (`miss_deadline`, no launch; a zero deadline
             never sheds), plane shard quarantine and half-open
             re-admission (`miss_quarantined`, the shard's rows
             reconciled) and the plane with containment off, the QoS
             edge shed (`miss_shed`, the tenant lanes) and `PMDFC_QOS=off`,
             and the reconnect storm's bounded backoff. Each GET path's
             kernel is held against its plain version at 2^11 and timed
             (`chaos`: linear·flat, `xray-plane`: linear·tiered).
15. trace  — causal tracing across processes and the SLO watchdog, last.
             (a) This process holds a 4-shard linear·flat plane naming the
             card four times, 2^17 slots of 4 KiB pages a shard (2 GiB),
             filled to 75% through `ShardedKV.insert`, behind
             `NetServer(NetConfig())`, its flight ring fresh and the
             profiler installed. A client child of this script
             (`--trace-client`, queued in phase 12's lanes, waiting for the
             server's address) drives 8 connections, each `ReplicaGroup(rf
             1) -> ReconnectingClient -> pipelined TcpBackend`, 4 PUT and
             16 GET verbs of 2^11 keys each (pre-filled, its own and
             never-inserted keys): every hit byte-exact, every miss zeroed,
             no never-inserted key served, acknowledged misses <=
             evictions + drops, no disconnect. Each process writes its
             flight dump (`dump_now`); the port's `tracetool` joins every
             traced GET across the two dumps at depth >= 6 with the chain
             get -> attempt -> client get -> server get -> phase ->
             flush:get -> shard_program, `clock_offsets` finds every
             connection with |offset| under its round trip, `chrome_trace`
             gives >= 6 events per GET trace, the breakdown holds
             flush:get, shard:get and server:queue_wait (p50/p95 per stage
             printed), and the port's `check_teledump`'s `check_flight` is
             clean on both dumps. (b) The shard_program spans' ops per
             shard equal `mesh.shard{i}_ops`; one launch per shard per GET
             phase. (c) Every flush:get span lasts at least the CUDA-event
             window of the plane launch it holds (the handle's event pair);
             the device share of flush:get and of each shard_program span
             is printed, not gated. (d) The SLO watchdog: JAX's
             injected-latency drill (20 ms lag on a `KV` on the card behind
             `NetServer`, a 2 ms p99 GET target, 2 burn windows) must
             breach and dump `flight_slo_breach_*` naming flush:get,
             `check_flight` clean; on the healthy plane of (a), a target of
             10x the warm-up window's p99 must see no breach over 3
             windows. (e) In the lanes, `bench/net_sweep.py --smoke` (4 KiB
             pages, 2^17 slots) and `bench/autotune_sweep.py --smoke
             --backend direct` (4 KiB pages), each held to its own gate
             (exit 0, `smoke OK`), rows echoed. (f) The kernel against
             plain on shard 0's state at the widest per-shard GET width (a)
             launched, timed (`trace-plane`).
16. ops    — the operator pull where JAX is absent, and the fast lane's
             structural drills under serving traffic, last. A linear·tiered
             `KV` of 2^18 slots of 4 KiB pages (`TierConfig()`; cut from
             2^21), 75% full through `KV.insert`, behind `NetServer(
             NetConfig())`, read by directory connections (`TcpBackend(
             directory=True)`) in 2^11-key verbs, each GET checked lane by
             lane: (b) a delete's epoch bump (every lane of the next fast
             read stale, the verb path answers, a refresh re-arms), a tier
             promotion then a re-put (the vacated and re-digested rows'
             lanes stale, the verb path serves the new bytes), a balloon
             shrink by the free rows plus 2 x 1024 while a second directory
             connection serves; (a) then, against the quiet server, in
             child interpreters where importing jax or pmdfc_tpu raises:
             `python -m pmdfc_tpu_torch.tools.teledump HOST PORT --out`
             and `--format prom`, `python -m pmdfc_tpu_torch.tools.
             check_teledump --live HOST PORT` and on the pulled file, each
             exit 0, the document passing `check` and `check_fastpath` with
             the server's fast-lane counters. Then a 4-shard linear·flat
             plane of 2^16 slots a shard (cut from 2^17), 30% full, behind
             `NetServer` through `DirectBackend`: saved, restored onto 2
             shards and swapped in while a directory connection serves, a
             read pass (every fast lane stale, the verb path serves every
             key the replay kept), a refresh (owners on the 2 shards).
             Throughout: every fast hit and every hit the key's current
             page, every stale lane re-asked through the verb path and
             answered as a plain connection answers it, no deleted key
             served, `fastpath_hits + fastpath_stale` on the server equal
             to the fast lanes the connections read and to their
             directories' counters, no serve error, no NACK; one fused-GET
             launch per fallback GET phase (per shard on the plane). The
             kernel against plain on the widest batch each part served,
             timed (`ops-tiered`: linear·tiered, `ops-plane`: shard 0 of
             the 2-shard plane).
17. failure — the failure ladder on the engine-backed server, in a child
             process (`--failure`) queued last in phase 12's lanes; its
             lines are echoed and its kernel entry added after phase 16.
             A linear·flat `KVServer` on the card behind the engine, 2^18
             slots of 4 KiB pages (1 GiB; phase 14's cut), filled to 75%
             by eight `ReconnectingClient`s over `EngineBackend` slices of
             2^11 pages, one engine queue each. (a) The eight clients
             stream puts and GETs of 2^11 pages while a durable
             `KVServer.checkpoint` is cut (the index scanned under the same
             lock: the durable set), 2^11 of its keys are invalidated
             through a control client, 2^11 more are put, a newest
             checkpoint is torn to half and the server killed; downtime
             GETs miss zeroed, downtime puts count dropped, the torn file
             is refused (`CheckpointCorruptError`) and the durable one
             restored on the card; the control client's journal replays
             its invalidations, and every key ever put is read back: found
             exactly when the durable cut held it and it was not
             invalidated, every hit byte-exact. (b) `drop_next(3)`: the
             put verb times out within 5 s, every request of a dropped
             batch is counted lost and no dropped put lands; one kernel
             launch per GET flush not dropped. (d) A `NetServer` of
             `EngineBackend`s over the same server takes garbage, a
             truncated header, an oversized payload, an unknown verb, a
             CRC-flipped put and a handshake of the wrong page words
             (refused): `bad_frames` counts them, `serve_errors` 0, a
             2^11-key GET through the wire byte-exact. (c) A server over
             the same KV with queues of 64, `stall_next(6, 0.25)` under
             six 2^11-page put verbs: the loss bounded and counted, then
             full service byte-exact. Gates: no wrong byte, every miss
             zeroed, `misses == Σ miss_*`, no serve error, no -2 status,
             launches == the GET flushes not dropped. The kernel against
             plain at w = 2^11 on the restored KV, timed (`failure`).
18. store  — the store's own suites' card-only drills, in a child process
             (`--store`) queued in phase 12's lanes after phase 17's: (a)
             `KV` edges on linear·flat, (b) a tiered snapshot restored, (c)
             a 2 x 2 plane's lane corrupted mid-soak, (d) breaker-driven
             auto-replacement, (e) `tests/test_admit.py`'s scan-flood drill
             on (b)'s depth, gated (its fast-aging `AdmitConfig`) and
             without a gate: a zipf set of half the hot rows promoted
             (through the live threshold knob: at 2^11-key GETs the gate
             ages inside every GET and denies every zipf promotion, in
             JAX as in the port), then a scan of four times the hot rows
             read twice; the gate denies it and the zipf set keeps 3/4 of
             its hot rows, without it the set keeps fewer and the KV
             demotes more (`store`, `store-tiered`, `store-2x2`,
             `store-admit`).
19. sanitize — the serving path under the runtime lock sanitizer, in a
             child process (`--sanitize`) whose environment has
             `PMDFC_SAN=on` (and JAX's 200 ms hold limit) before any import,
             so every lock the port builds is instrumented, the module-level
             `engine._lib_lock` among them; queued last in phase 12's lanes,
             its lines echoed after phase 18. (a) JAX's acceptance soak on
             the card: a linear·tiered `KV` of 2^18 slots of 4 KiB pages,
             75% full through `KV.insert`, behind a coalescing
             `NetServer(NetConfig(flush_ops=64, flush_timeout_us=500,
             settle_us=100))` and a `ChaosProxy` (flip 0.01, duplicate 0.005,
             delay 0.01 at 2 ms); four `ReconnectingClient` workers put and
             GET verbs of 1..2^11 pages for 15 s, an `AutotuneController`
             attached and bound to the KV's balloon (`hysteresis_windows=1`,
             `balloon_every=1`, `balloon_max_extents=3`), a fifth
             `TcpBackend` setting its window live 32 -> 4 -> 64. (c) Then
             `tests/test_telemetry.py`'s traced chaos soak against the same
             server: one pipelined `ReconnectingClient` (window 8) through a
             `ChaosProxy` at seed 17 (flip 0.01, truncate 0.005, duplicate
             0.01), 300 verbs of 1..2^11 keys over a 2^14-key set. (b) The
             engine-backed `KVServer` on linear·flat 2^18 slots, eight
             `ReconnectingClient`s over `EngineBackend` slices of 2^11
             pages for 10 s with the bloom push on (`KVServer._bf_push_lock`,
             `KV._lock` and `engine._lib_lock` at runtime). Gates:
             `sanitizer.violations() == []` (a long hold that JAX's twin
             shows JAX makes too is printed, `SAN_SHARED_HOLDS`), no wrong
             byte, every miss zeroed, `check_autotune` over the server's
             `MSG_STATS` document `[]` and the port's `check_teledump`
             passing it, each balloon move one `balloon_step` extent inside
             the envelope, every completed traced verb's trace joined to a
             server span and every failed span closed with its error,
             `misses == Σ miss_*`, no serve error, no -2 status, one launch
             per GET phase (per flush in (b)). The kernel against plain at
             (a)'s widest GET phase (`sanitize-tiered`) and (b)'s widest
             flush (`sanitize`), timed.

    python3 chip_smoke.py --sanitize   # phase 19 alone

Each KV is freed before the next path's fill, so no two pools share the
card but the fleet's and the plane's own shards, and, in phases 12 to
18, the harness processes' and the children of phases 14, 17, 18 and
19. The next-to-last line is one JSON object naming each kernel with its
path, launches, error and times; the last is `{"ok": true, "device": ...}`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
PAGE_HI = 0x80000001  # hi word of page keys (>= 2^31: unsigned order matters)
EXT_HI = 0x80000002   # hi word of extent keys
INS_B, GET_B = 1 << 16, 1 << 14
HOT_SET = 1 << 12      # tiered paths: a quarter of each GET comes from it
EXTENTS = 300          # the CCEH path's extents (two cross 2^31 and 2^32)
BALLOON_EVICT = 2 * 1024  # tiered paths: live rows a forced shrink evicts
# the serving size: 2^21 slots for each family (CCEH's capacity is its
# initial segments' slots; one split of each gives the 2^21)
DEVICE = "cuda"
LINEAR_INDEX = dict(capacity=1 << 21)
CCEH_INDEX = dict(capacity=1 << 20)
CAUSE_NAMES = "(hit,pad,cold,evicted,ext,parked,stale,digest)"
# the families phase: linear·flat's serving configuration with only the
# index kind changed, for each family that takes the composed GET
FAMILY_INDEX = dict(capacity=1 << 20)
FAMILIES = ("cuckoo", "ccp", "level", "path", "static", "hotring")
# hotring: GET keys served before the mirror drill, and the decay period
# (`IndexConfig`'s default, so the decay fires once through `KV`)
HOT_GETS = 1 << 20
# the policy cache's check: its capacity and the keys per call
POLICY_CAPACITY, POLICY_B = 1 << 16, 1 << 12
# the serving path: linear·flat's configuration behind the engine and the
# KVServer driver; 4 clients x 8 threads (the reference's 4 clients x 8
# QPs), each thread with its own engine queue and a VERB-page arena slice
SERVE_INDEX = dict(capacity=1 << 21)
SERVE_BLOOM_BITS = 1 << 24
SERVE_ENGINE = dict(num_queues=32, queue_cap=1 << 14, batch=1 << 14,
                    arena_pages=1 << 16, page_bytes=4096)
CLIENT_GROUPS, GROUP_THREADS = 4, 8
VERB = 1 << 11         # pages per client verb
GET_VERBS = 8          # get_pages verbs per thread in the storm
SERVE_EXTENTS = 256    # extents one thread registers through the engine
PUT_ODD = 11_826       # a quiet PUT flush off the ladder: the mean width of
                       # the fill's PUT flushes on an H100
MISS_FILL = 0xA5A5A5A5  # a GET verb's arena slots hold this until served
BF_PUSH_S = 0.05       # the server's bloom push period
SERVE_HI = 0x90000000  # thread t's page keys are (SERVE_HI + t, i)
SERVE_DIRECT_HI = 0x9F000000  # the pre-fill's keys are (SERVE_DIRECT_HI, i)
NEVER_LO = 1 << 24     # lo words at or above this were never inserted
CLIENT_TIMEOUT_US = 120_000_000
# one deadline for all the client threads of a serving phase (the fill
# through the engine took 93-176 s on the H100)
PHASE_TIMEOUT_S = 600.0
# the wire: linear·flat's configuration behind the port's NetServer on
# loopback TCP, 4 clients x 8 connections (the reference's 4 clients x 8
# QPs), each a pipelined TcpBackend in a ReconnectingClient under a
# CleanCacheClient fed by the server's bloom pushes
WIRE_INDEX = dict(capacity=1 << 21)
WIRE_BLOOM_BITS = 1 << 24
WIRE_CLIENTS, WIRE_CONNS = 4, 8
WIRE_WINDOW = 32
WIRE_DIRECT = 1_310_720  # pages the pre-fill puts straight through KV.insert
WIRE_FILL = 1 << 18      # pages the connections then put over the wire
WIRE_GETS = 1 << 19      # keys of the GET storm
WIRE_EXTENTS = 128
WIRE_FAST_CONNS = 4      # connections that open with a directory
WIRE_FAST_KEYS = 1 << 16  # present keys each of them reads on the fast lane
WIRE_REWRITE = 1 << 12   # of those, keys rewritten, and keys invalidated
WIRE_HI = 0xA0000000     # connection c's wire keys are (WIRE_HI + c, i)
DIRECT_HI = 0xB0000000   # the pre-fill's keys are (DIRECT_HI, i)
# the one-sided sub-phase: a PassivePool of POOL_ROWS rows (8 GiB) behind
# PoolServer, POOL_CLIENTS OneSidedBackends each writing POOL_PAGES pages
POOL_ROWS = 1 << 21
POOL_CLIENTS = 4
POOL_PAGES = 1 << 16
# the fleet: three crashbox nodes at linear·flat's configuration cut to
# 2^19 slots (2 GiB pools; the keys cut by the same quarter, for the time
# limit) behind a ReplicaGroup (rf 2); node FLEET_CRASH is snapshotted,
# killed, warm restarted and rejoined. Keys are (FLEET_HI, i).
FLEET_INDEX = dict(capacity=1 << 19)
FLEET_BLOOM_BITS = 1 << 22
FLEET_NODES = 3
FLEET_CRASH = 2
FLEET_THREADS = 8         # client threads sharing the group
FLEET_FILL = 1 << 16      # keys put before the full snapshot
FLEET_DELTA = 1 << 13     # keys put before the delta
FLEET_TAIL = 1 << 12      # keys put after the delta (the journal tail)
FLEET_INVAL = 1 << 10     # earlier keys invalidated in the tail
FLEET_STORM = 1 << 15     # GET keys of each storm
FLEET_DOWN_PUT = 1 << 11  # keys put while the node is down
FLEET_DOWN_INVAL = 1 << 9  # keys invalidated while it is down
FLEET_HI = 0xC0000000
FLEET_JOURNAL: dict = {}  # JournalConfig's defaults (rpo_ops 256, 50 ms)
FLEET_DISK_BYTES = 4 << 30   # a full, deltas and the journals
FLEET_START_S = 300.0     # a node's start timeout (spawn to serving)
FLEET_REPAIR_S = 600.0    # the repair drain's deadline

# the sharded plane (phase 10): per shard linear·flat at 2^17 slots and 8
# bloom bits per slot (a 512 MiB pool); four shards on the one card hold
# 2 GiB, the reference's 10 GB buffer split as NuMA_KV splits one server,
# cut to a quarter (slots, fills and storms) for the time limit
PLANE_SHARDS = 4
PLANE_INDEX = dict(capacity=1 << 17)
PLANE_BLOOM_BITS = 1 << 20
PLANE_DIRECT = 327_680    # pages through ShardedKV.insert (a2a)
PLANE_INS_B = 1 << 16     # keys per a2a fill batch
PLANE_FILL = 1 << 16      # pages then put over the wire (75% of the slots)
PLANE_GETS = 1 << 18      # keys of the GET storm
PLANE_EXTENTS = 64
PLANE_FAST_KEYS = 1 << 14  # pre-fill keys each fast connection reads
PLANE_MUTATE = 1 << 14    # keys put between the full and the delta
PLANE_MUT_HI = 0xD0000000
PLANE_RESHARD = 8         # shards the full is reshard-restored onto (4 GiB)
PLANE_ENGINE_THREADS = 8
PLANE_ENGINE_PAGES = 1 << 16
PLANE_DISK_BYTES = 3 << 30   # the full and the delta
# the 2 x 2 replica plane: 2^18 slots per lane (a 1 GiB pool), 4 GiB on
# the card, 2 GiB of distinct pages
PLANE2D = (2, 2)
PLANE2D_INDEX = dict(capacity=1 << 18)
PLANE2D_BLOOM_BITS = 1 << 21

# phase 11, control: the row insert, the profiler and the controller
ROW_INDEX = dict(capacity=1 << 21)  # each of the two A/B indexes (32 MiB)
ROW_KV_TIMEOUT_S = 600.0  # the row-path KV's child process
CONTROL_INDEX = dict(capacity=1 << 21)
CONTROL_BLOOM_BITS = 1 << 24
CONTROL_CONNS = 32        # pipelined TcpBackend connections
CONTROL_LIGHT_S = 4.0     # the light phase: one connection, small verbs
CONTROL_LIGHT_VERB = 64
CONTROL_FANIN_VERBS = 8   # GET verbs of VERB keys per connection, fan-in
# the MSG_PROFILE capture sent mid-storm: the profiler's longest window,
# since a recorded session slows each tiered GET to a good part of a
# second (300 ms windows caught 0-1 of the fan-in's GET kernels)
CONTROL_CAPTURE_MS = 2000
CONTROL_HI = 0xE0000000   # the control path's pre-fill keys
# what a capture's trace must hold: a CUDA kernel event of the fused GET
TRACE_CAT, TRACE_NAME = "kernel", "fused_get_kernel"
# the harnesses run on the card, each as its own process
HARNESSES = (("insert_rowscatter", ()),
             ("telemetry_overhead", ("--smoke", "--gate", "1e9")))

# phase 12, scale: the multi-process plane on torch.distributed and the
# reference's workload harnesses. Part (a): 2 spawned processes joined
# over gloo, 2 shards each on the one card, each shard linear·flat at
# 2^18 slots (8 bits of bloom per slot, 4 KiB pages: 1 GiB pools, 4 GiB
# in all, cut from 8 GiB for the time limit); part (b): one process in an
# NCCL group of world size 1, 4 shards of 2^16 slots
SCALE_PROCS = 2
SCALE_PER_PROC = 2
SCALE_INDEX = dict(capacity=1 << 18)
SCALE_BLOOM_BITS = 1 << 21
SCALE_SOLO_BACKEND = "nccl"
SCALE_SOLO_SHARDS = 4
SCALE_SOLO_INDEX = dict(capacity=1 << 16)
SCALE_SOLO_BLOOM_BITS = 1 << 19
SCALE_INS_B = 1 << 14     # keys per a2a insert
SCALE_GET_B = 1 << 14     # keys per a2a GET
SCALE_GETS = 6            # a2a GET batches
SCALE_BCAST_B = 1 << 12   # the broadcast GET batch
SCALE_DELETE = 1 << 12    # present keys deleted before the GETs
SCALE_HI = 0xF0000000     # the plane's keys are (SCALE_HI, i)
SCALE_JOIN_S = 120.0      # connect_multihost's timeout
SCALE_TIMEOUT_S = 600.0   # a part's workers, spawn to exit
SCALE_TIMED = True        # rank 0 times the kernel (not in the rehearsal)
# part (a) then drives the plane verbs in both processes: through
# PlaneBackend, 2^14-key plane puts (rewrites of present keys), deletes,
# extents and GET phases (5/8 present, 1/8 deleted, 1/8 never inserted,
# 1/8 any); the fast lane over a sample of the directory (a host mirror
# of every pool in each process); restore_chain and a reshard restore of
# a one-process plane's snapshots; a tiered plane with the gate (its GETs
# on both cadences); and a 2 x 2 grid with a corrupted lane. Part (b)
# runs the plane verbs once over its four shards.
SCALE_PLANE_PUTS = 2       # 2^14-key plane puts
SCALE_PLANE_GETS = 2       # 2^14-key plane GET phases
SCALE_PLANE_EXTENTS = 16
SCALE_FAST_KEYS = 1 << 14  # directory entries read on the fast lane
SCALE_FAST_REWRITE = 1 << 10  # of those, keys rewritten before the mirror
# the one-process plane whose full and delta snapshots the grid restores:
# 2 shards of 2^17 slots (1 GiB), half filled; restore_chain onto a
# 2-shard grid (one shard a process), the reshard onto the 4-shard grid
SCALE_RESTORE_INDEX = dict(capacity=1 << 17)
SCALE_RESTORE_BLOOM_BITS = 1 << 20
# the tiered plane (TierConfig() with AdmitConfig(), every second GET
# batch counting) and the 2 x 2 grid: 2 GiB each
SCALE_TIER_INDEX = dict(capacity=1 << 17, touch_sample_every=2)
SCALE_2D_INDEX = dict(capacity=1 << 17)
SCALE_SIDE_BLOOM_BITS = 1 << 20
# the paging jobs over an 8 GiB pool (2^21 slots, 4 KiB pages): the read
# jobs batch 16 faults a window over a 4096-page file through a
# 1024-page RAM cache (8 passes of it); the write jobs go op by op (each
# write invalidates its page on the card), over a 1024-page file through
# a 256-page cache (4 passes); swap_sim 2^11 ops, filebench 4 loops over
# 32 files and multinode 1500 ops (halved for the time limit)
_POOL = ("--capacity", str(1 << 21))
_READS = (*_POOL, "--file-pages", "4096", "--ram-pages", "1024", "--ops",
          "8192", "--iodepth", "16")
_WRITES = (*_POOL, "--file-pages", "1024", "--ram-pages", "256", "--ops",
           "1024")
SCALE_HARNESSES = (
    ("multihost_bench", ("--procs", "2", "--backend", "gloo")),
    ("test_kv", ("--n", "10000000", "--batch", "1000000", "--capacity",
                 str(1 << 25), "--index", "linear", "--no-engine")),
    ("test_kv", ("--n", "10000000", "--batch", "1000000", "--capacity",
                 str(1 << 25), "--index", "cceh", "--no-engine")),
    ("paging_sim", ("--job", "seq_read", *_READS)),
    ("paging_sim", ("--job", "rand_read", *_READS)),
    *(("paging_sim", ("--job", job, *_WRITES)) for job in
      ("rand_rw", "seq_rw", "seq_write")),
    ("paging_sim", ("--job", "scan_mix", *_POOL, "--ops", "4096",
                    "--iodepth", "16", "--repeats", "1")),
    ("swap_sim", (*_POOL, "--working-pages", "4096", "--ram-pages", "1024",
                  "--ops", "2048", "--iodepth", "16")),
    ("filebench", ("--personality", "fileserver", *_POOL, "--loops", "4",
                   "--nfiles", "32")),
    ("filebench", ("--personality", "webserver", *_POOL, "--loops", "4",
                   "--nfiles", "32")),
    ("replay", ("--trace", "tests/data/fileserver.trace")),
    ("replay", ("--synthetic", "1000000")),
    ("multinode", ("--clients", "3", *_POOL, "--ops", "1500")),
)


# ---------------------------------------------------------------------------
# phase 13, tail: the bench tail's harnesses
# ---------------------------------------------------------------------------

# fused_get, one family at a time at phase 4's configurations (4 KiB
# pages, 8 GiB pools, 75% of the slots filled), two KVs each
TAIL_FUSED = (("linear", LINEAR_INDEX["capacity"]),
              ("cceh", CCEH_INDEX["capacity"]))
TAIL_FUSED_ARGS = dict(page_words=1024, fill=0.75,
                       batches=[1 << 11, 1 << 14, 1 << 16], gets=1 << 18,
                       zipfs=[0.0, 0.99])
# tier_sweep: linear at 2^20 slots, tiered vs flat (4 GiB each); 2^16
# GETs a skew (cut from 2^21 slots and 2^19 GETs for the time limit)
TAIL_TIER_ARGS = dict(capacity=1 << 20, page_words=1024, batch=1 << 14,
                      gets=1 << 16, zipfs=[0.0, 0.6, 0.99, 1.2],
                      hot_fraction=16)
TAIL_WIDTHS = (1 << 11, 1 << 14, 1 << 16)  # kernel against plain, timed
TAIL_TIMED_W = 1 << 14                    # the kernels line's width
# in the harness lanes, the longest first: mesh_sweep over a 4 GiB total
# (1, 2, 4, 8 shards and PMDFC_MESH=off), the soak (4 GiB, 30 s), and the
# host-bound harnesses at their JAX defaults but 4 KiB pages and 2^18
# slots per node, cut for the time limit: the elastic storm to 84 steps
# and the replica storm to 90 (from 600; 120 until phase 19's child joined
# the lanes: every membership change and two kill cycles still land), the
# recovery soak to 100 (from 400; 160 before), train_pressure to 100
# (from 200), fill_sweep to 2^20 slots
_TAIL_POOL = ("--capacity", str(1 << 20), "--page-words", "1024")
_TAIL_NODE = ("--page-words", "1024", "--capacity", str(1 << 18))
TAIL_LANE_RUNS = (
    ("elastic_sweep", (*_TAIL_NODE, "--steps", "84", "--settle-steps",
                       "12")),
    ("recovery_soak", (*_TAIL_NODE, "--steps", "100")),
    ("replica_soak", (*_TAIL_NODE, "--steps", "90", "--kill-every", "30",
                      "--down-steps", "15")),
    ("mesh_sweep", ("--shards", "1,2,4,8", *_TAIL_POOL, "--rounds", "1")),
    ("train_pressure", ("--page-words", "1024", "--steps", "100")),
    ("fastpath_sweep", _TAIL_NODE),
    ("fill_sweep", ("--capacity", str(1 << 20), "--batch", str(1 << 16))),
    ("soak", ("--minutes", "0.5", *_TAIL_POOL)),
    ("containment_soak", _TAIL_NODE),
    ("qos_soak", ("--backend", "direct", *_TAIL_NODE)),
    ("insert_profile", ()),
)
# harness processes side by side (phases 12 and 13 share the lanes)
HARNESS_LANES = 5
TAIL_ROWS = ("mesh_sweep", "fastpath_sweep", "qos_soak")  # rows in --out


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def variant_of(state) -> str:
    family = "cceh" if hasattr(state.index, "dirr") else "linear"
    pool = "tiered" if hasattr(state.pool, "cgen") else "flat"
    return f"fused_get_{family}_{pool}"


class Smoke:
    def __init__(self, seed: int):
        import numpy as np
        import torch

        from pmdfc_tpu_torch import kv as kv_mod
        from pmdfc_tpu_torch.ops import fused
        from pmdfc_tpu_torch.utils import u32
        from pmdfc_tpu_torch.utils.keys import is_invalid

        self.np, self.torch, self.kv_mod, self.fused, self.u32 = (
            np, torch, kv_mod, fused, u32)
        self.is_invalid = is_invalid
        self.dev = torch.device(DEVICE)
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(seed)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.max_err: dict[str, int] = {}

    # -- data made on the device --------------------------------------------
    def keys_of(self, hi: int, lo):
        """[n, 2] int32 keys (u32 bits) from a hi word and int64 lo words."""
        torch, u32 = self.torch, self.u32
        hiw = torch.full_like(lo, hi)
        return torch.stack([u32.narrow(hiw), u32.narrow(lo)], dim=-1)

    def pages_of(self, keys, pw: int):
        """Page contents as a function of key and word index."""
        torch, u32 = self.torch, self.u32
        hi, lo = u32.widen(keys[:, 0]), u32.widen(keys[:, 1])
        j = torch.arange(pw, device=keys.device)
        base = u32.mul(lo, 0x9E3779B1) ^ u32.mul(hi, 0x85EBCA77)
        return u32.narrow(base[:, None] + u32.mul(j, 0x01000193)[None, :]
                          + 0x165667B1)

    def pick(self, idx, n: int):
        """n rows of idx drawn uniformly (with replacement)."""
        r = self.torch.randint(0, idx.shape[0], (n,), device=self.dev,
                               generator=self.gen)
        return idx[r]

    # -- kernel against plain -----------------------------------------------
    @staticmethod
    def kernel_args(state):
        """fused_get's tensors and keywords for a state (with its directory
        and `msb` flag for CCEH and extendible hashing, and the cold rows'
        sidecars for a tiered pool)."""
        ix, pool = state.index, state.pool
        kw = dict(dirr=ix.dirr, msb=ix.msb) if hasattr(ix, "dirr") else {}
        if hasattr(pool, "cgen"):
            kw.update(cgen=pool.cgen, live=pool.live,
                      hot_rows=pool.hfree.shape[0])
        return (ix.table, pool.pages, pool.sums, state.evicted_filter), kw

    def compare(self, keys, state, label: str):
        """Kernel and plain version on the same inputs, bit for bit;
        -> (the batch's cause counts, keys whose page entry sits on a cold
        row past the generation gate: they read its generation and live
        byte; 0 over the flat pool)."""
        torch, fused = self.torch, self.fused
        args, kw = self.kernel_args(state)
        got = fused.fused_get(keys, *args, **kw)
        want = fused.get_core_reference(keys, *args, **kw)
        torch.cuda.synchronize()
        err = max(int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
                  if g.numel() else 0 for g, r in zip(got, want))
        v = variant_of(state)
        self.max_err[v] = max(self.max_err.get(v, 0), err)
        if err:
            raise AssertionError(f"{label}: kernel differs from plain "
                                 f"version (max abs err {err})")
        cause, rows = want[1], want[2]
        cold = int((rows >= kw["hot_rows"]).sum()) if "hot_rows" in kw else 0
        return torch.bincount(cause, minlength=8).tolist(), cold

    def add_extents(self, kv, n: int):
        """n extents of a few pages under EXT_HI -> their base keys."""
        bases = [1000 * (j + 1) for j in range(n)]
        for j, base in enumerate(bases):
            kv.insert_extent(self.np.array([EXT_HI, base], self.np.uint32),
                             self.np.array([j, 4096 * j], self.np.uint32),
                             1 + 7 * j)
        return self.keys_of(EXT_HI, self.torch.tensor(bases, device=self.dev))

    def small_state(self, kind: str, s: int, tiered: bool = False):
        """A small KV on the card with evictions (CCEH: and splits),
        deletes, real extent covers and a sketch; tiered: a 1/16 hot tier
        through promotions, demotions and ghost readmits, then a forced
        shrink, a grow and fresh puts into the evicted rows (stale
        entries)."""
        torch, kv_mod = self.torch, self.kv_mod
        from pmdfc_tpu_torch.config import (IndexConfig, IndexKind, KVConfig,
                                            TierConfig)

        if kind == "linear":
            ix, n = IndexConfig(capacity=2048, cluster_slots=s), 3072
        else:  # 4 segments of 512 slots growing to 8, then evictions
            ix = IndexConfig(kind=IndexKind(kind), capacity=2048,
                             segment_slots=512, probe_window=s)
            n = 6144
        tier = TierConfig(hot_fraction=16, ghost_rows=64, balloon_step=64) \
            if tiered else None
        kv = kv_mod.KV(KVConfig(index=ix, page_words=64, tier=tier,
                                evicted_sketch_bits=1 << 14), device=self.dev)
        lo = torch.randint(0, 1 << 32, (n,), device=self.dev,
                           generator=self.gen)
        keys = self.keys_of(0x80000003, lo)
        for i in range(0, n, 1024):
            kv.insert(keys[i:i + 1024], self.pages_of(keys[i:i + 1024], 64))
        covers = self.add_extents(kv, 4)
        kv.delete(keys[n - 1024:n - 872])
        if tiered:
            for r in range(12):  # rotate over 3 windows of present keys
                kv.get(keys[(r % 3) * 400:(r % 3) * 400 + 600])
            kv.balloon_shrink(kv.balloon_state()["free"] + 256)
            kv.balloon_grow(256)
            fresh = self.keys_of(0x80000004, torch.arange(256, device=self.dev))
            kv.insert(fresh, self.pages_of(fresh, 64))
            t = kv.tier_stats()
            log("kernel", f"small {kind} S={s} tiered: promotions "
                f"{t['promotions']}, demotions {t['demotions']}, ghost "
                f"readmits {t['ghost_readmits']}, shrink evictions "
                f"{t['shrink_evictions']}")
            if not (t["demotions"] and t["ghost_readmits"]
                    and t["shrink_evictions"]):
                raise AssertionError("the small tiered state lacks a tier event")
        absent = self.keys_of(7, torch.randint(0, 1 << 32, (512,),
                                               device=self.dev,
                                               generator=self.gen))
        pool = torch.cat([keys, absent,
                          torch.full((64, 2), -1, dtype=torch.int32,
                                     device=self.dev)])
        return kv, pool, keys[:2048], covers

    def poke(self, kv, keys, covers):
        """Corrupt one present key's page word (tiered: one on a hot row
        and one on a cold row, then poke one entry to NOPAGE and clear one
        current cold row's live bit, and take up to 8 stale keys); keep up
        to 4 of the cover keys that are live extent entries. -> (probe
        head: those keys and covers, undo)."""
        from pmdfc_tpu_torch import tier
        from pmdfc_tpu_torch.models.base import get_index_ops

        torch, u32 = self.torch, self.u32
        ops = get_index_ops(kv.config.index.kind)
        st = kv.state
        pool = st.pool
        res = ops.get_batch(st.index, keys)
        cres = ops.get_batch(st.index, covers)
        live = cres.found & (cres.values[:, 0] == self.fused.EXTENT_TAG_I32)
        if not bool(live.any()):
            raise AssertionError("no live extent cover to probe")
        rows = res.values[:, 1]
        if not hasattr(pool, "cgen"):
            picks = [int(res.found.nonzero().flatten()[0])]
            corrupt, extra = picks, []
        else:
            h = pool.hfree.shape[0]
            entry = res.found & ((u32.widen(res.values[:, 0]) >> 30) == 0)
            cur = tier.entry_current(pool, res.values)
            page = entry & cur & tier.row_live(pool, rows)
            hot = (page & (rows < h)).nonzero().flatten().tolist()
            cold = (page & (rows >= h)).nonzero().flatten().tolist()
            if not hot or len(cold) < 3:
                raise AssertionError("no hot or too few cold keys to poke")
            picks = [hot[0], cold[0], cold[1], cold[2]]
            corrupt = picks[:2]
            extra = (entry & ~cur).nonzero().flatten()[:8].tolist()
        saved = [(int(rows[k]), st.pool.pages[int(rows[k]), 0].clone())
                 for k in corrupt]
        for r, _ in saved:
            st.pool.pages[r, 0] ^= 1 << 7
        if hasattr(pool, "cgen"):
            knp, kd = picks[2], picks[3]
            slot = res.slots[knp:knp + 1]
            ops.set_values(st.index, slot, u32.narrow(torch.tensor(
                [[0xC0000000, 0]], device=keys.device)))
            drow = int(rows[kd]) - pool.hfree.shape[0]
            pool.live[drow] = False

        def undo():
            for r, word in saved:
                st.pool.pages[r, 0] = word
            if hasattr(pool, "cgen"):
                ops.set_values(st.index, slot, res.values[knp:knp + 1])
                pool.live[drow] = True

        return torch.cat([keys[picks + extra], covers[live][:4]]), undo

    def kernel_phase(self, kv, pool, present, covers, label: str,
                     extra=None, need=None):
        """Kernel against plain at w in {16, 2^10, 2^14}: each batch holds
        the poked keys (and `extra` keys) ahead of keys drawn from `pool`;
        at w >= 2^10 every cause in `need` must occur (by default every
        cause of the pool: the tiered pool's PARKED and STALE too)."""
        torch = self.torch
        head, undo = self.poke(kv, present, covers)
        if extra is not None:
            head = torch.cat([head, extra])
        tiered = hasattr(kv.state.pool, "cgen")
        if need is None:
            need = range(8) if tiered else (0, 1, 2, 3, 4, 7)
        for w in (16, 1 << 10, 1 << 14):
            npad = w // 64  # padding rides every batch but the smallest
            keys = torch.cat([head, self.pick(pool, max(
                w - head.shape[0] - npad, 0)),
                              torch.full((npad, 2), -1, dtype=torch.int32,
                                         device=self.dev)])[:w]
            causes, _ = self.compare(keys, kv.state, f"{label} w={w}")
            log("kernel", f"{label} w={w}: kernel == plain, causes "
                f"{CAUSE_NAMES}={causes}")
            if w >= 1 << 10 and not all(causes[c] for c in need):
                raise AssertionError(f"{label} w={w}: a cause is missing")
        undo()


def time_ms(torch, fns, iters: int, warmup: int = 3,
            device_only: bool = False) -> float:
    """Mean ms per call over `iters` calls taken round-robin from `fns`.
    With `device_only`, the stream is first held busy (about 50 ms) so the
    host queues every call before the first runs: the events then see the
    device's time alone, not the host's time to launch."""
    for i in range(warmup):
        fns[i % len(fns)]()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if device_only:
        torch.cuda._sleep(100_000_000)  # cycles
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_breakdown(torch, fn, iters: int) -> str:
    """Device-side breakdown of `fn` from torch.profiler: device ops per
    call, device busy time per call, and the ops taking the most of it.
    `fn` runs 1 + `iters` times whatever the profiler does, and an
    exception from `fn` propagates: only the profiler's own failure is
    caught, and then the line says "not measured"."""
    fn()
    torch.cuda.synchronize()
    prof = failed = None
    try:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:  # the profiler's own failure: report, go on
        prof, failed = None, e
    try:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    finally:
        if prof is not None:
            try:
                prof.stop()
                events = prof.key_averages()
            except Exception as e:  # the profiler's own failure
                failed = e
    if failed is not None:
        return f"not measured: {failed!r}"
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return "not measured: the profiler saw no device activity"
    busy = sum(e.self_device_time_total for e in dev) / iters / 1e3
    ops = sum(e.count for e in dev) / iters
    d2h = sum(e.count for e in dev if "DtoH" in e.key) / iters
    syncs = sum(e.count for e in events
                if e.key in ("cudaStreamSynchronize",
                             "cudaDeviceSynchronize")) / iters
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    parts = "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / iters / 1e3:.4f} ms "
        f"x{e.count // iters}" for e in top)
    return (f"{ops:.0f} device ops, device busy {busy:.4f} ms per call, "
            f"{d2h:.1f} device-to-host copies and {syncs:.1f} stream "
            f"synchronizes per call; top: {parts}")


class MainPath:
    """One index family's serving path through `KV` at the serving size.

    Key index i <-> key (PAGE_HI, i); `status[i]`: 0 never inserted,
    1 present, 2 capacity-evicted, 3 deleted, 4 dropped, 5 its row evicted
    by a forced balloon shrink (tiered: the entry is stale). With a `hot`
    set of key indices, a quarter of every mixed batch is drawn from it."""

    def __init__(self, sm: Smoke, cfg, label: str):
        torch = sm.torch
        self.sm, self.label = sm, label
        self.kv = sm.kv_mod.KV(cfg, device=sm.dev)
        self.pw = cfg.page_words
        self.n_slots = self.kv.capacity()
        self.n_fill = (3 * self.n_slots // 4) // INS_B * INS_B
        self.n_keys = self.n_fill + self.n_slots
        self.status = torch.zeros(self.n_keys, dtype=torch.int8,
                                  device=sm.dev)
        self.evicted_covers: set[int] = set()  # lo words of EXT_HI keys
        self.evictions = self.drops = 0
        self.hot = None
        st = self.kv.state
        log("main", f"{label}: KV on {self.kv.device}: {self.n_slots} slots, "
            f"table {tuple(st.index.table.shape)}, pool "
            f"{tuple(st.pool.pages.shape)} = "
            f"{st.pool.pages.numel() * 4 / 2**30:.2f} GiB, bloom "
            f"{cfg.bloom.num_bits} counters, sketch "
            f"{cfg.evicted_sketch_bits} bits")

    def track(self, res) -> None:
        """Mark what an insert evicted: page keys turn status 2, extent
        covers join `evicted_covers`."""
        sm, u32 = self.sm, self.sm.u32
        ev = res.evicted
        if not isinstance(ev, sm.torch.Tensor):  # uint32 from a host call
            ev = u32.from_numpy(ev, sm.dev)
        ev = ev[~sm.is_invalid(ev)]
        hi = u32.widen(ev[:, 0])
        self.status[u32.widen(ev[hi == PAGE_HI, 1])] = 2
        self.evicted_covers |= set(u32.widen(ev[hi == EXT_HI, 1]).tolist())
        self.evictions += ev.shape[0]

    def fill(self, start: int, stop: int) -> float:
        """Insert key indices [start, stop) in INS_B batches -> seconds."""
        sm, torch = self.sm, self.sm.torch
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for i in range(start, stop, INS_B):
            lo = torch.arange(i, i + INS_B, device=sm.dev)
            keys = sm.keys_of(PAGE_HI, lo)
            res = self.kv.insert(keys, sm.pages_of(keys, self.pw))
            self.status[lo] = torch.where(res.dropped, 4, 1).to(torch.int8)
            self.drops += int(res.dropped.sum())
            self.track(res)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    def counts(self):
        return self.sm.torch.bincount(self.status.long(),
                                      minlength=6).tolist()

    def mixed(self, n: int, deleted: bool):
        sm, torch, status = self.sm, self.sm.torch, self.status
        present = (status == 1).nonzero().flatten()
        evicted = (status == 2).nonzero().flatten()
        never = (status == 0).nonzero().flatten()
        if self.hot is None:
            parts = [sm.pick(present, n * 5 // 8)]
        else:
            parts = [sm.pick(self.hot, n // 4),
                     sm.pick(present, n * 5 // 8 - n // 4)]
        parts.append(sm.pick(never, n // 8))
        if evicted.numel():
            parts.append(sm.pick(evicted, n // 8))
        if deleted:
            parts.append(sm.pick((status == 3).nonzero().flatten(), n // 16))
        idx = torch.cat(parts)
        keys = torch.cat([sm.keys_of(PAGE_HI, idx),
                          torch.full((n - idx.numel(), 2), -1,
                                     dtype=torch.int32, device=sm.dev)])
        return keys[torch.randperm(n, device=sm.dev, generator=sm.gen)]

    def check_get(self, keys, out, found, stats_before, label):
        sm, kv = self.sm, self.kv
        valid = ~sm.is_invalid(keys)
        st = self.status[sm.u32.widen(keys[:, 1]).clamp(max=self.n_keys - 1)]
        want = valid & (st == 1)
        if not sm.torch.equal(found, want):
            raise AssertionError(f"{label}: found mask != present keys "
                                 f"({int((found != want).sum())} differ)")
        if not sm.torch.equal(out[found], sm.pages_of(keys[found], self.pw)):
            raise AssertionError(f"{label}: a hit returned wrong bytes")
        if out[~found].any():
            raise AssertionError(f"{label}: a miss returned nonzero bytes")
        d = (kv.state.stats.long() - stats_before).tolist()
        s = dict(zip(sm.kv_mod.STAT_NAMES, d))
        causes = sum(s[c] for c in sm.kv_mod.MISS_CAUSE_NAMES)
        counts = [int((valid & (st == k)).sum()) for k in range(6)]
        if s["misses"] != causes:
            raise AssertionError(f"{label}: misses {s['misses']} != "
                                 f"sum of causes {causes}")
        if s["misses"] > sum(counts) - counts[1]:
            raise AssertionError(f"{label}: more misses than lost keys")
        if s["miss_evicted"] < counts[2]:
            raise AssertionError(f"{label}: evicted keys not attributed")
        return s, counts

    def serve(self, rounds: int, deleted: bool, label: str):
        sm, torch, kv = self.sm, self.sm.torch, self.kv
        for _ in range(rounds):
            keys = self.mixed(GET_B, deleted)
            before = kv.state.stats.long()
            out, found = kv.get(keys)
            s, counts = self.check_get(keys, out, found, before,
                                       f"{label} get")
            before = kv.state.stats.long()
            o2, order, f2, nfound, b = kv.get_compact_async(keys)
            nf = int(nfound)
            hits = found.nonzero().flatten()
            if not (torch.equal(f2[:b], found) and nf == hits.numel()
                    and torch.equal(order[:nf].long(), hits)
                    and torch.equal(o2[:nf], out[hits])):
                raise AssertionError(f"{label}: get_compact disagrees with get")
            self.check_get(keys, out, found, before, f"{label} get_compact")
        log("main", f"{self.label} {label}: {rounds} x (get + get_compact) of "
            f"{GET_B} keys ok; last batch (never,present,evicted,deleted,"
            f"dropped,stale)={counts}, hits={s['hits']}, misses="
            f"{s['misses']} (cold={s['miss_cold']}, evicted="
            f"{s['miss_evicted']}, stale={s['miss_stale']}, digest="
            f"{s['miss_digest']})")

    def delete(self):
        sm = self.sm
        gone = sm.pick((self.status == 1).nonzero().flatten(), GET_B).unique()
        hit = self.kv.delete(sm.keys_of(PAGE_HI, gone))
        if not bool(hit.all()):
            raise AssertionError("delete missed present keys")
        self.status[gone] = 3
        log("main", f"{self.label} delete: {gone.numel()} keys, all hit")

    def run_fill(self, on_fill_step=None):
        """Fill 75% of the slots -> seconds. `on_fill_step(i)` runs after
        the fill batch that ends at key index i."""
        t = 0.0
        for i in range(0, self.n_fill, INS_B):
            t += self.fill(i, i + INS_B)
            if on_fill_step is not None:
                on_fill_step(i + INS_B)
        self.t_fill = t
        log("main", f"{self.label} fill: {self.n_fill} pages in {t:.3f} s = "
            f"{self.n_fill / t:.0f} pages/s; evictions {self.evictions}, "
            f"drops {self.drops}; status counts (never,present,evicted,"
            f"deleted,dropped,stale)={self.counts()}")

    def run(self, on_fill_step=None):
        """Fill, serve, delete, serve."""
        self.run_fill(on_fill_step)
        self.serve(4, False, "serve")
        self.delete()
        self.serve(4, True, "serve after delete")


def measure(sm: Smoke, path: MainPath, launches: int, dir_bytes: int = 0):
    """Phase 5 for one path -> its kernel's `kernels` entry."""
    torch, fused, kv = sm.torch, sm.fused, path.kv
    st = kv.state
    name = variant_of(st)
    smi = nvidia_smi()
    s = st.index.table.shape[1] // 4
    args, kw = sm.kernel_args(st)
    # 8 distinct batches: their pages (about 8 x 42 MB) far exceed the
    # 50 MB L2, so launches rotated over them read from memory, as a
    # stream of fresh requests does; one batch repeated is the warm time.
    batches = [path.mixed(GET_B, True) for _ in range(8)]
    nbytes = []
    for i, k in enumerate(batches):
        causes, cold = sm.compare(k, st, f"timed batch {i}")
        nbytes.append(fused.fused_get_bytes(causes, GET_B, s, path.pw,
                                            st.evicted_filter.numel(),
                                            dir_bytes, cold))
    kern = [lambda k=k: fused.fused_get(k, *args, **kw) for k in batches]
    plain = [lambda k=k: fused.get_core_reference(k, *args, **kw)
             for k in batches]
    ms = time_ms(torch, kern, 48, device_only=True)
    warm_ms = time_ms(torch, kern[:1], 48, device_only=True)
    host_ms = time_ms(torch, kern, 48)
    plain_ms = time_ms(torch, plain, 8, device_only=True)
    mean_bytes = sum(nbytes) / len(nbytes)
    bound_ms = mean_bytes / HBM_BYTES_PER_S * 1e3
    warm_bound_ms = nbytes[0] / HBM_BYTES_PER_S * 1e3
    log("times", f"{name} w={GET_B}, rotated over {len(batches)} "
        f"batches: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({mean_bytes:.0f} bytes per batch, "
        f"{min(nbytes)}..{max(nbytes)}) = {bound_ms / ms:.1%} of the memory "
        f"rate; no single PyTorch call computes this function, so there is "
        f"no library time ({smi})")
    log("times", f"{name} w={GET_B}, one batch repeated (warm L2): "
        f"kernel {warm_ms:.4f} ms, bound {warm_bound_ms:.4f} ms "
        f"({nbytes[0]} bytes) = {warm_bound_ms / warm_ms:.1%} ({smi})")
    log("times", f"{name} w={GET_B}, rotated, launched back to back "
        f"from the host with no queue ahead: {host_ms:.4f} ms per call "
        f"(wrapper and launch on the host included) ({smi})")
    kv_get = [lambda k=k: kv.get(k) for k in batches]
    get_ms = time_ms(torch, kv_get, 24)
    log("times", f"{path.label} whole-path KV.get, rotated: {get_ms:.3f} ms "
        f"per {GET_B} keys = {GET_B / get_ms * 1e3:.0f} keys/s (a tiered "
        f"KV.get includes its tier.on_get epilogue); fill "
        f"{path.n_fill / path.t_fill:.0f} pages/s ({smi})")
    log("times", f"{path.label} torch.profiler, KV.get of 2^14 keys: "
        + profile_breakdown(torch, kv_get[0], 5))
    return {
        "name": name,
        "route": "cuda",
        "source": "pmdfc_tpu_torch/ops/csrc/fused_get.cu",
        "replaces": "pmdfc_tpu/ops/fused.py:414",
        "launches": launches,
        "max_abs_err": sm.max_err[name],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "path": path.label,
    }


def all_keys(sm: Smoke, path: MainPath):
    """Every page key of the path plus padding: the full-size probe pool."""
    torch = sm.torch
    return torch.cat([sm.keys_of(PAGE_HI, torch.arange(path.n_keys,
                                                        device=sm.dev)),
                      torch.full((64, 2), -1, dtype=torch.int32,
                                 device=sm.dev)])


def run_linear(sm: Smoke):
    from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, KVConfig

    cfg = KVConfig(index=IndexConfig(**LINEAR_INDEX),
                   bloom=BloomConfig(num_bits=1 << 24, num_hashes=4))
    path = MainPath(sm, cfg, "linear")
    sm.fused.launches.clear()
    sm.torch.cuda.synchronize()
    path.run()
    sm.torch.cuda.synchronize()
    launches = sm.fused.launches["fused_get_linear_flat"]
    if launches <= 0:
        raise AssertionError("the linear main path never launched its kernel")
    check_stats(sm, path)

    # 3, continued: kernel against plain on the full-size state, with
    # real extent covers for EXT
    present = (path.status == 1).nonzero().flatten()[:4096]
    covers = sm.add_extents(path.kv, 4)
    sm.kernel_phase(path.kv, all_keys(sm, path),
                    sm.keys_of(PAGE_HI, present), covers, "linear full")
    return measure(sm, path, launches)


def check_stats(sm: Smoke, path: MainPath) -> None:
    stats = path.kv.stats()
    if stats["misses"] != sum(stats[c] for c in sm.kv_mod.MISS_CAUSE_NAMES):
        raise AssertionError("misses != sum of miss causes")
    log("main", f"{path.label}: {dict(sm.fused.launches)} launches on the "
        f"main path; utilization {path.kv.utilization():.4f}; stats "
        f"{json.dumps(stats)}")


def recovery_drill(sm: Smoke, path: MainPath) -> None:
    """Damage one replicated directory entry: the present keys behind it
    stop hitting; `recovery()` restores the directory and they hit
    byte-exact again."""
    torch, u32, kv = sm.torch, sm.u32, path.kv
    from pmdfc_tpu_torch.utils.hashing import hash_u64

    ix = kv.state.index
    saved = ix.dirr.clone()
    dirr, ld = saved.tolist(), ix.ld.tolist()
    gmax = len(dirr).bit_length() - 1
    i = next((i for i in range(len(dirr))
              if i & ((1 << (gmax - ld[dirr[i]])) - 1)), None)
    if i is None:
        raise AssertionError("no replicated directory entry to damage")
    present = (path.status == 1).nonzero().flatten()
    keys = sm.keys_of(PAGE_HI, present)
    bucket = hash_u64(keys[:, 0], keys[:, 1]) >> (32 - gmax)
    behind = keys[bucket == i]
    ix.dirr[i] = (dirr[i] + 1) % len(dirr)
    _, found = kv.get(behind)
    hidden = int((~found).sum())
    if hidden != behind.shape[0] or hidden == 0:
        raise AssertionError(f"damaged entry {i} hid {hidden} of "
                             f"{behind.shape[0]} keys")
    kv.recovery()
    if not torch.equal(ix.dirr, saved):
        raise AssertionError("recovery() did not restore the directory")
    before = kv.state.stats.long()
    out, found = kv.get(behind)
    path.check_get(behind, out, found, before, "after recovery")
    log("main", f"{path.label} recovery: directory entry {i} of "
        f"{len(dirr)} damaged, {hidden} present keys behind it missed; "
        f"recovery() restored the directory, all {hidden} hit byte-exact "
        f"(nseg {int(ix.nseg)}, gdepth {u32.widen(ix.gdepth).item()})")


def extent_phase(sm: Smoke, path: MainPath):
    """A few hundred extents on the CCEH path -> live cover base keys."""
    np, torch, kv, kv_mod = sm.np, sm.torch, path.kv, sm.kv_mod
    cfg = kv.config
    lengths = [1, 2, 3, 7, 64, 100, 255, 1000, 4096, 3000, 33, 517]
    vlos = [0x7FFFF000, 0xFFFFF000, 0x7FF00000, 0xFFF80000, 0, 0x12345000]
    exts = []  # (base, length, value words)
    for j in range(EXTENTS - 2):
        base = (j + 1) * (1 << 22) + int(sm.rng.integers(0, 4096))
        vlo = (vlos[j % len(vlos)] - 4096 * (j % 5)) % (1 << 32)
        exts.append((base, lengths[j % len(lengths)], (j, vlo)))
    exts += [((1 << 31) - 1500, 3000, (7, 0x7FFFF800)),   # base across 2^31
             ((1 << 32) - 5000, 4096, (8, 0xFFFFE000))]   # base near 2^32
    covers, uncovered = [], 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for base, n, val in exts:
        res, unc = kv.insert_extent(np.array([EXT_HI, base], np.uint32),
                                    np.array(val, np.uint32), n)
        path.track(res)
        bases, _ = kv_mod._covers(base, n, cfg.extent_max_covers,
                                  cfg.extent_max_height)
        covers.append([b for b in bases if b != 0xFFFFFFFF])
        uncovered += unc
    torch.cuda.synchronize()
    t_ext = time.monotonic() - t0

    # probe: offsets inside each run and just past it. A key is found
    # through any live cover of its own extent that one of GetExtent's
    # height-masked probes names (extents are disjoint, so no other
    # record spans it), and its address is value + 4096 * offset.
    probe, expect = [], []
    heights = range(cfg.extent_max_height)
    for (base, n, val), cb in zip(exts, covers):
        live = set(cb) - path.evicted_covers
        for o in (0, n - 1, n // 2, int(sm.rng.integers(0, n)), n + 3):
            lo = base + o
            hit = o < n and any((lo >> h) << h in live for h in heights)
            probe.append([EXT_HI, lo])
            expect.append((hit, (((val[0] << 32) | val[1]) + 4096 * o)
                           % (1 << 64)))
    keys = sm.u32.from_numpy(np.array(probe, np.uint32), sm.dev)
    before = kv.state.stats.long()
    out, found = kv.get_extent(keys)
    got = sm.u32.to_numpy(out).astype(np.uint64)
    addr = (got[:, 0] << np.uint64(32)) | got[:, 1]
    found = found.cpu().numpy()
    want_found = np.array([e[0] for e in expect])
    if not np.array_equal(found, want_found):
        raise AssertionError(f"get_extent: found mask differs at "
                             f"{int((found != want_found).sum())} keys")
    want = np.array([e[1] for e in expect], np.uint64)
    if not np.array_equal(addr[found], want[found]) or addr[~found].any():
        raise AssertionError("get_extent: wrong address")
    d = dict(zip(kv_mod.STAT_NAMES,
                 (kv.state.stats.long() - before).tolist()))
    if d["misses"] != sum(d[c] for c in kv_mod.MISS_CAUSE_NAMES):
        raise AssertionError("get_extent: misses != sum of causes")

    # a page GET of a live cover is a cold miss (cause EXT); a page put
    # over a cover converts it into a page entry
    live = [b for cb in covers for b in cb if b not in path.evicted_covers]
    ck = sm.keys_of(EXT_HI, torch.tensor(live[:256], device=sm.dev))
    before = kv.state.stats.long()
    out, found = kv.get(ck)
    d = dict(zip(kv_mod.STAT_NAMES,
                 (kv.state.stats.long() - before).tolist()))
    if found.any() or out.any() or d["miss_cold"] != ck.shape[0] \
            or d["misses"] != ck.shape[0]:
        raise AssertionError(f"page GET of covers: {d}")
    conv = ck[:8]
    res = kv.insert(conv, sm.pages_of(conv, path.pw))
    path.track(res)
    out, found = kv.get(conv)
    if not (found.all() and torch.equal(out, sm.pages_of(conv, path.pw))):
        raise AssertionError("a page put over a cover did not convert it")
    log("main", f"{path.label} extents: {len(exts)} inserted in "
        f"{t_ext:.3f} s ({sum(map(len, covers))} covers, {uncovered} pages "
        f"uncovered, {len(path.evicted_covers)} covers evicted); get_extent "
        f"of {len(probe)} keys: {int(want_found.sum())} addresses exact, the "
        f"rest missed as expected; page GET of "
        f"{ck.shape[0]} covers: all cold misses; 8 page puts over covers "
        f"converted them")
    return sm.keys_of(EXT_HI, torch.tensor(live[8:264], device=sm.dev))


def find_anyway_check(sm: Smoke, path: MainPath) -> None:
    torch, kv, status = sm.torch, path.kv, path.status
    idx = torch.cat([sm.pick((status == 1).nonzero().flatten(), 8),
                     sm.pick((status >= 2).nonzero().flatten(), 4),
                     torch.arange(path.n_fill, path.n_fill + 4,
                                  device=sm.dev)])
    keys = sm.keys_of(PAGE_HI, idx)
    vals, found, slot = kv.find_anyway(keys)
    res = kv._ops.get_batch(kv.state.index, keys)
    if not (torch.equal(found, status[idx] == 1)
            and torch.equal(found, res.found)
            and torch.equal(slot, res.slots)
            and torch.equal(vals[found], res.values[found])):
        raise AssertionError("find_anyway disagrees with the hashed probe")
    log("main", f"{path.label} find_anyway: 16 keys scanned over "
        f"{path.n_slots} slots, {int(found.sum())} found, slots and values "
        f"equal to the hashed probe's")


def run_cceh(sm: Smoke):
    from pmdfc_tpu_torch.config import IndexConfig, IndexKind, KVConfig

    cfg = KVConfig(index=IndexConfig(kind=IndexKind.CCEH, **CCEH_INDEX))
    path = MainPath(sm, cfg, "cceh")
    ix = path.kv.state.index
    log("main", f"cceh: {int(ix.nseg)} segments of "
        f"{cfg.index.segment_slots} slots, directory {ix.dirr.numel()} "
        f"entries ({ix.dirr.numel() * 4} bytes), up to {ix.ld.numel()} "
        f"segments, {ix.rounds} insert rounds, {ix.k_splits} splits a round")
    third = path.n_fill // 3 // INS_B * INS_B

    def step(i):
        if i == third:
            log("main", f"cceh after {i} pages: nseg {int(ix.nseg)}, gdepth "
                f"{sm.u32.widen(ix.gdepth).item()}, evictions "
                f"{path.evictions}")
            recovery_drill(sm, path)

    sm.fused.launches.clear()
    sm.torch.cuda.synchronize()
    path.run(step)
    log("main", f"cceh after the fill: nseg {int(ix.nseg)}, gdepth "
        f"{sm.u32.widen(ix.gdepth).item()}, evictions {path.evictions}, "
        f"drops {path.drops}")
    covers = extent_phase(sm, path)
    find_anyway_check(sm, path)
    sm.torch.cuda.synchronize()
    launches = sm.fused.launches["fused_get_cceh_flat"]
    if launches <= 0:
        raise AssertionError("the CCEH main path never launched its kernel")
    check_stats(sm, path)

    # 3, continued: kernel against plain on the full-size state
    present = (path.status == 1).nonzero().flatten()[:4096]
    sm.kernel_phase(path.kv, all_keys(sm, path),
                    sm.keys_of(PAGE_HI, present), covers, "cceh full")
    return measure(sm, path, launches, dir_bytes=ix.dirr.numel() * 4)


def hot_resident(sm: Smoke, kv, idx):
    """Of key indices `idx` (present keys), those whose entry points at a
    hot row."""
    res = kv._ops.get_batch(kv.state.index, sm.keys_of(PAGE_HI, idx))
    return idx[res.found & (res.values[:, 1] < kv.state.pool.hfree.shape[0])]


def tier_line(kv) -> str:
    t = kv.tier_stats()
    return ", ".join(f"{k} {t[k]}" for k in (
        "promotions", "demotions", "hot_hits", "cold_hits", "hot_occupied",
        "migrated_bytes", "balloon_grows", "balloon_shrinks",
        "shrink_evictions", "cold_free"))


def run_tiered(sm: Smoke, kind: str):
    """One family's 9 GiB tiered path: fill, serve with a hot set (its keys
    promote and then hit byte-exact from hot rows), update hot-resident
    keys in place, delete (hot-resident keys among them), a forced balloon
    shrink whose evicted keys all miss as stale, a grow and fresh puts
    into the evicted rows (the old keys still miss, the new hit), then
    kernel against plain on the full-size state."""
    torch, u32, kv_mod = sm.torch, sm.u32, sm.kv_mod
    from pmdfc_tpu_torch.config import (AdmitConfig, BloomConfig, IndexConfig,
                                        IndexKind, KVConfig, TierConfig)

    if kind == "linear":
        cfg = KVConfig(index=IndexConfig(**LINEAR_INDEX),
                       bloom=BloomConfig(num_bits=1 << 24), tier=TierConfig())
    else:
        cfg = KVConfig(index=IndexConfig(kind=IndexKind.CCEH, **CCEH_INDEX),
                       tier=TierConfig(admit=AdmitConfig()))
    path = MainPath(sm, cfg, f"{kind}·tiered")
    kv = path.kv
    pool = kv.state.pool
    h = pool.hfree.shape[0]
    log("main", f"{path.label}: {h} hot + {pool.live.numel()} cold rows, "
        f"{cfg.tier}")
    variant = variant_of(kv.state)
    sm.fused.launches.clear()
    torch.cuda.synchronize()
    path.run_fill()

    # serve with a hot set: its keys reach 2 touches and promote
    present = (path.status == 1).nonzero().flatten()
    path.hot = present[torch.randperm(present.numel(), device=sm.dev,
                                      generator=sm.gen)[:HOT_SET]]
    path.serve(4, False, "serve")
    res_hot = hot_resident(sm, kv, path.hot)
    if res_hot.numel() == 0 or kv.tier_stats()["promotions"] <= 0:
        raise AssertionError(f"{path.label}: nothing promoted")
    before = kv.state.stats.long()
    hits0 = kv.tier_stats()["hot_hits"]
    keys = sm.keys_of(PAGE_HI, res_hot)
    out, found = kv.get(keys)
    path.check_get(keys, out, found, before, "hot-resident get")
    if kv.tier_stats()["hot_hits"] - hits0 != res_hot.numel():
        raise AssertionError(f"{path.label}: hot-resident keys not served "
                             "from hot rows")
    log("main", f"{path.label} hot set: {res_hot.numel()} of {HOT_SET} keys "
        f"on rows < {h}, all hit byte-exact from hot rows; {tier_line(kv)}")
    if kind != "linear":
        log("main", f"{path.label} admit_state {json.dumps(kv.admit_state())}")

    # update in place: new bytes on hot rows, read back, then restored
    upd = sm.keys_of(PAGE_HI, res_hot[:64])
    new_pages = sm.pages_of(upd, path.pw) ^ 0x5A5A5A5A
    kv.insert(upd, new_pages)
    out, found = kv.get(upd)
    if not (found.all() and torch.equal(out, new_pages)):
        raise AssertionError(f"{path.label}: in-place update not served")
    if hot_resident(sm, kv, res_hot[:64]).numel() != 64:
        raise AssertionError(f"{path.label}: an update moved a hot key")
    kv.insert(upd, sm.pages_of(upd, path.pw))
    log("main", f"{path.label} update: 64 hot-resident keys rewritten in "
        f"place and read back byte-exact, then restored")

    # delete, hot-resident keys among them: their hot rows free
    occ0 = kv.tier_stats()["hot_occupied"]
    gone_hot = res_hot[64:320]
    hit = kv.delete(sm.keys_of(PAGE_HI, gone_hot))
    if not bool(hit.all()):
        raise AssertionError("delete missed hot-resident keys")
    path.status[gone_hot] = 3
    occ1 = kv.tier_stats()["hot_occupied"]
    if occ1 != occ0 - gone_hot.numel():
        raise AssertionError(f"hot_occupied {occ0} -> {occ1} after deleting "
                             f"{gone_hot.numel()} hot-resident keys")
    path.delete()
    path.serve(2, True, "serve after delete")
    log("main", f"{path.label} delete: hot_occupied {occ0} -> {occ1} for "
        f"{gone_hot.numel()} hot-resident keys deleted")

    # forced balloon shrink: free rows park, then the coldest live rows
    # are evicted; every key on an evicted row misses as stale
    live0 = pool.live.clone()
    free = kv.balloon_state()["free"]
    kv.balloon_shrink(free + BALLOON_EVICT)
    evicted_rows = live0 & ~pool.live
    present = (path.status == 1).nonzero().flatten()
    res = kv._ops.get_batch(kv.state.index, sm.keys_of(PAGE_HI, present))
    crow = (res.values[:, 1].long() - h).clamp(min=0)
    on_evicted = (res.values[:, 1] >= h) & evicted_rows[crow]
    stale_idx = present[on_evicted]
    if stale_idx.numel() != int(evicted_rows.sum()) or not stale_idx.numel():
        raise AssertionError(f"{path.label}: {stale_idx.numel()} keys on "
                             f"{int(evicted_rows.sum())} evicted rows")
    path.status[stale_idx] = 5
    before = kv.state.stats.long()
    for i in range(0, stale_idx.numel(), GET_B):
        k = sm.keys_of(PAGE_HI, stale_idx[i:i + GET_B])
        out, found = kv.get(k)
        if found.any() or out.any():
            raise AssertionError("a key on an evicted row was served")
    d = dict(zip(kv_mod.STAT_NAMES, (kv.state.stats.long() - before).tolist()))
    if d["miss_stale"] != stale_idx.numel() or d["misses"] != d["miss_stale"]:
        raise AssertionError(f"{path.label}: evicted keys missed as {d}")
    log("main", f"{path.label} balloon shrink by {free} free + "
        f"{BALLOON_EVICT}: {stale_idx.numel()} live rows evicted, every key "
        f"on them missed as miss_stale; {kv.balloon_state()}")

    # grow, then fresh keys reuse the evicted rows: old keys still miss,
    # the new keys hit byte-exact
    kv.balloon_grow(stale_idx.numel())
    nfree = kv.balloon_state()["free"]
    new_idx = (path.status == 0).nonzero().flatten()[:nfree]
    new_keys = sm.keys_of(PAGE_HI, new_idx)
    res = kv.insert(new_keys, sm.pages_of(new_keys, path.pw))
    path.status[new_idx] = torch.where(res.dropped, 4, 1).to(torch.int8)
    path.track(res)
    rows = kv._ops.get_batch(kv.state.index, new_keys).values[:, 1].long()
    reused = int(evicted_rows[(rows - h).clamp(min=0)].sum())
    if reused == 0:
        raise AssertionError("no fresh key landed on an evicted row")
    for label, idx in (("stale keys", stale_idx), ("fresh keys", new_idx)):
        for i in range(0, idx.numel(), GET_B):
            k = sm.keys_of(PAGE_HI, idx[i:i + GET_B])
            before = kv.state.stats.long()
            out, found = kv.get(k)
            path.check_get(k, out, found, before, f"{label} after regrow")
    log("main", f"{path.label} balloon grow: {nfree} rows back, {new_idx.numel()}"
        f" fresh keys inserted, {reused} on rows the shrink evicted; the "
        f"{stale_idx.numel()} stale keys still miss, the fresh keys hit "
        f"byte-exact; {tier_line(kv)}")
    torch.cuda.synchronize()
    launches = sm.fused.launches[variant]
    if launches <= 0:
        raise AssertionError(f"the {path.label} main path never launched "
                             "its kernel")
    check_stats(sm, path)

    # 3, continued: kernel against plain on the full-size state, with
    # real extent covers, stale keys and capacity-evicted keys in the head
    covers = sm.add_extents(kv, 4)
    cand = torch.cat([path.hot, (path.status == 1).nonzero().flatten()[:4096],
                      stale_idx[:64]])
    evicted = (path.status == 2).nonzero().flatten()[:4]
    sm.kernel_phase(kv, all_keys(sm, path), sm.keys_of(PAGE_HI, cand), covers,
                    f"{path.label} full", extra=sm.keys_of(PAGE_HI, evicted))
    dir_bytes = kv.state.index.dirr.numel() * 4 if kind != "linear" else 0
    return measure(sm, path, launches, dir_bytes=dir_bytes)


def scan_agrees(sm: Smoke, path: MainPath) -> int:
    """The page keys a scan of the whole table finds are exactly the
    present ones (every reported drop, eviction and delete gone, every
    placement there) -> the count of occupied slots."""
    torch, u32 = sm.torch, sm.u32
    flat_keys, _ = path.kv._ops.scan(path.kv.state.index)
    occ = flat_keys[~sm.is_invalid(flat_keys)]
    if not bool((u32.widen(occ[:, 0]) == PAGE_HI).all()):
        raise AssertionError(f"{path.label}: a foreign key in the table")
    held = u32.widen(occ[:, 1]).sort().values
    present = (path.status == 1).nonzero().flatten()
    if not torch.equal(held, present):
        raise AssertionError(
            f"{path.label}: the table holds {held.numel()} page keys, the "
            f"inserts reported {present.numel()} present")
    return occ.shape[0]


def hot_mirror_drill(sm: Smoke, path: MainPath, decays: int,
                     gets: int) -> None:
    """HotRing after at least 2^20 GET keys: the default decay fired through
    `KV`, and its shift put every hot key in its bucket's mirror (a hot
    key is touched about 64 times; the shift caps its heat key at
    0xFFFFFFFE, so a count of 1 after the halving would tie an untouched
    occupant). Then 64 hot keys are updated in place: their mirror rows
    are invalidated, and GETs serve the new bytes from the table; the old
    pages go back."""
    torch, kv = sm.torch, path.kv
    from pmdfc_tpu_torch.models import hotring

    if not decays:
        raise AssertionError(f"{path.label}: the decay never fired")
    hot = sm.keys_of(PAGE_HI, path.hot.unique())
    in_mirror = hotring.probe_hot(kv.state.index, hot)
    if not bool(in_mirror.all()):
        raise AssertionError(f"hotring: {int((~in_mirror).sum())} of "
                             f"{hot.shape[0]} hot keys not in the mirror")
    upd = hot[:64]
    new_pages = sm.pages_of(upd, path.pw) ^ 0x5A5A5A5A
    kv.insert(upd, new_pages)
    if bool(hotring.probe_hot(kv.state.index, upd).any()):
        raise AssertionError("hotring: an update left its mirror row")
    out, found = kv.get(upd)
    if not (bool(found.all()) and torch.equal(out, new_pages)):
        raise AssertionError("hotring: an updated hot key served stale bytes")
    kv.insert(upd, sm.pages_of(upd, path.pw))
    log("families", f"hotring mirror: {decays} decay(s) through KV "
        f"after {gets} GET keys; all {hot.shape[0]} hot keys resolve "
        f"from the mirror; 64 hot keys updated in place served their new "
        f"bytes from the table (mirror rows invalidated), then restored")


def run_family(sm: Smoke, kind: str) -> None:
    """One index family through `KV` at linear·flat's serving configuration
    with only `kind` changed: fill 75% of its slots, serve mixed GETs and
    get_compact (HotRing: a quarter from a hot set, at least 2^20 GET keys,
    then the mirror drill), delete, serve again; the table's scan must
    hold exactly the present keys. Times: fill, `KV.get` wall (CUDA
    events) and device busy, device ops and copies per insert and get."""
    torch = sm.torch
    from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, IndexKind, \
        KVConfig

    smi = nvidia_smi()
    cfg = KVConfig(index=IndexConfig(kind=IndexKind(kind),
                                     decay_every_gets=HOT_GETS,
                                     **FAMILY_INDEX),
                   bloom=BloomConfig(num_bits=1 << 24))
    path = MainPath(sm, cfg, kind)
    kv = path.kv
    decays = [0]
    if kv._ops.decay is not None:
        real_decay = kv._ops.decay

        def decay(index):
            decays[0] += 1
            return real_decay(index)
        kv._ops = dataclasses.replace(kv._ops, decay=decay)
    log("families", f"{kind}: num_slots {path.n_slots}, pool "
        f"{kv.state.pool.pages.numel() * 4 / 2**30:.2f} GiB")
    sm.fused.launches.clear()
    torch.cuda.synchronize()
    path.run_fill()
    if kind == "hotring":
        present = (path.status == 1).nonzero().flatten()
        path.hot = present[torch.randperm(present.numel(), device=sm.dev,
                                          generator=sm.gen)[:HOT_SET]]
        rounds = -(-HOT_GETS // (2 * GET_B))
    else:
        rounds = 4
    path.serve(rounds, False, "serve")
    if kind == "hotring":
        hot_mirror_drill(sm, path, decays[0], rounds * 2 * GET_B)
    path.delete()
    path.serve(2, True, "serve after delete")
    scan_agrees(sm, path)
    check_stats(sm, path)

    # times: KV.get over 8 mixed batches, and inserts of fresh keys (they
    # take the table from 75% to about 87% of its slots); the profiled
    # calls are real verbs whose results the checks below hold
    batches = [path.mixed(GET_B, True) for _ in range(8)]
    get_ms = time_ms(torch, [lambda k=k: kv.get(k) for k in batches], 24)
    starts = iter(range(path.n_fill, path.n_keys - INS_B, INS_B))

    def insert_fresh():
        i = next(starts)
        lo = torch.arange(i, i + INS_B, device=sm.dev)
        keys = sm.keys_of(PAGE_HI, lo)
        res = kv.insert(keys, sm.pages_of(keys, path.pw))
        path.status[lo] = torch.where(res.dropped, 4, 1).to(torch.int8)
        path.drops += int(res.dropped.sum())
        path.track(res)

    ins_prof = profile_breakdown(torch, insert_fresh, 3)
    get_prof = profile_breakdown(torch, lambda: kv.get(batches[0]), 5)
    path.serve(2, True, "serve after the timed inserts")
    if kind == "static" and path.evictions:
        raise AssertionError("static evicted")
    occupied = scan_agrees(sm, path)
    check_stats(sm, path)
    torch.cuda.synchronize()
    if sum(sm.fused.launches.values()):
        raise AssertionError(f"{kind} took the fused GET: "
                             f"{dict(sm.fused.launches)}")
    log("families", f"{kind}: fill {path.n_fill / path.t_fill:.0f} pages/s "
        f"({path.n_fill} pages in {path.t_fill:.3f} s); KV.get "
        f"{get_ms:.3f} ms per {GET_B} keys (CUDA events, rotated over 8 "
        f"batches); evictions {path.evictions}, drops {path.drops} (fill "
        f"and timed inserts); occupied {occupied} of {path.n_slots} slots "
        f"({smi})")
    log("families", f"{kind} torch.profiler, KV.insert of {INS_B} fresh "
        f"pages: {ins_prof} ({smi})")
    log("families", f"{kind} torch.profiler, KV.get of {GET_B} keys: "
        f"{get_prof} ({smi})")


def policy_cache_check(sm: Smoke) -> None:
    """The standalone policy cache on `sm.dev` against the same calls on
    the CPU, for LRU, LFU and FIFO: fill 3/4 of POLICY_CAPACITY, get live
    keys with repeats (LRU ticks, LFU counts) beside never-inserted and
    padding keys, put a batch of new keys past capacity with duplicates
    and padding (evictions over tied metrics), update live keys, get
    again. Every get, every eviction and the table, metric and tick after
    each call must be identical."""
    torch, u32 = sm.torch, sm.u32
    from pmdfc_tpu_torch.ops import policy_cache as pc

    cap, b = POLICY_CAPACITY, POLICY_B
    gen = torch.Generator().manual_seed(11)

    def rand(n):
        return torch.randint(0, 1 << 31, (n, 2), dtype=torch.int32,
                             generator=gen)

    for policy in ("lru", "lfu", "fifo"):
        card = pc.init(cap, policy, device=sm.dev)
        host = pc.init(cap, policy, device="cpu")
        live, evictions = rand(0), 0

        def same(label, *pairs):
            for x, y in pairs:
                if not torch.equal(x.cpu(), y):
                    raise AssertionError(f"policy cache {policy} {label}: "
                                         "card != CPU")
            for f in ("table", "metric", "tick"):
                if not torch.equal(getattr(card, f).cpu(),
                                   getattr(host, f)):
                    raise AssertionError(f"policy cache {policy} {label}: "
                                         f"{f} differs, card != CPU")

        def put(keys, label):
            nonlocal evictions
            vals = rand(keys.shape[0])
            _, ek, ev = pc.put_batch(card, keys.to(sm.dev), vals.to(sm.dev))
            _, hk, hv = pc.put_batch(host, keys, vals)
            same(label, (ek, hk), (ev, hv))
            evictions += int((~sm.is_invalid(hk)).sum())

        def get(keys, label):
            _, cv, cf = pc.get_batch(card, keys.to(sm.dev))
            _, hv, hf = pc.get_batch(host, keys)
            same(label, (cv, hv), (cf, hf))
            return hf

        for _ in range(3 * cap // 4 // b):
            keys = rand(b)
            put(keys, "fill")
            live = torch.cat([live, keys])
        pad = torch.full((16, 2), -1, dtype=torch.int32)
        for _ in range(3):
            hot = live[torch.randint(0, live.shape[0], (b // 2,),
                                     generator=gen)]
            get(torch.cat([hot, hot[:b // 4], rand(b // 4 - 16), pad]),
                "get with repeats")
        new = rand(2 * b)
        put(torch.cat([new, new[:b // 8], pad]), "put past capacity")
        put(live[:b], "update")
        found = get(torch.cat([live[:b], new[:b]]), "get after evictions")
        if not evictions:
            raise AssertionError(f"policy cache {policy}: nothing evicted")
        log("families", f"policy cache {policy} on {sm.dev}: every get, "
            f"eviction and state leaf == the CPU's over capacity {cap} in "
            f"{b}-key calls; {evictions} evictions, {int(found.sum())} of "
            f"{2 * b} keys found after them")


def run_families(sm: Smoke) -> None:
    """The families phase: each of FAMILIES in turn, each KV freed before
    the next family's fill; then the policy cache's check."""
    for kind in FAMILIES:
        run_family(sm, kind)
        sm.torch.cuda.empty_cache()
    policy_cache_check(sm)


def pages_np(hi, lo, pw: int):
    """`Smoke.pages_of` on the host: the pages of keys (hi, lo), uint32
    (hi a word or one per key)."""
    import numpy as np

    with np.errstate(over="ignore"):
        base = (np.asarray(lo, np.uint32) * np.uint32(0x9E3779B1)) \
            ^ (np.asarray(hi, np.uint32) * np.uint32(0x85EBCA77))
        cols = np.arange(pw, dtype=np.uint32) * np.uint32(0x01000193)
        return base[:, None] + cols[None, :] + np.uint32(0x165667B1)


def percentiles_ms(xs) -> str:
    import numpy as np

    p50, p99 = np.percentile(np.asarray(xs) * 1e3, [50, 99])
    return f"p50 {p50:.3f} ms, p99 {p99:.3f} ms over {len(xs)} verbs"


def run_threads(targets, label: str) -> float:
    """Run one thread per callable, join them all by one deadline,
    PHASE_TIMEOUT_S after the start -> wall seconds; a thread still running
    at the deadline or any thread's exception fails the phase."""
    import threading

    errors: list[BaseException] = []

    def wrap(fn):
        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(e)
        return run

    threads = [threading.Thread(target=wrap(fn), name=f"client-{i}")
               for i, fn in enumerate(targets)]
    t0 = time.monotonic()
    for th in threads:
        th.start()
    deadline = t0 + PHASE_TIMEOUT_S
    for th in threads:
        th.join(timeout=max(0.0, deadline - time.monotonic()))
    wall = time.monotonic() - t0
    if any(th.is_alive() for th in threads):
        raise AssertionError(f"{label}: a client thread did not finish "
                             f"within {PHASE_TIMEOUT_S} s")
    if errors:
        raise AssertionError(f"{label}: {len(errors)} client thread(s) "
                             f"failed; first: {errors[0]!r}") from errors[0]
    return wall


class ServeClient:
    """One client thread of the serving path: its own engine queue, a
    `VERB`-page arena slice (`EngineBackend`) and a `CleanCacheClient`
    registered for bloom pushes. Its page keys are (SERVE_HI + tid, i)."""

    def __init__(self, srv, tid: int, n_fill: int, seed: int):
        import numpy as np

        from pmdfc_tpu_torch.client import CleanCacheClient, EngineBackend

        self.np, self.tid, self.n_fill = np, tid, n_fill
        self.hi = SERVE_HI + tid
        self.pw = srv.config.page_words
        self.rng = np.random.default_rng([seed, tid])
        self.be = EngineBackend(srv, queue=tid, slice_pages=VERB,
                                timeout_us=CLIENT_TIMEOUT_US)
        self.never_asked = 0  # never-inserted keys that reached the server
        real_get = self.be.get

        def get(keys):
            """Counts never-inserted keys asked; checks that the server
            wrote nothing into a miss's arena slot (one verb: len(keys)
            <= VERB, the slice)."""
            self.never_asked += int(((keys[:, 0] == self.hi)
                                     & (keys[:, 1] >= NEVER_LO)).sum())
            slots = self.be.engine.arena[self.be.arena_lo:][:len(keys)]
            slots[:] = MISS_FILL
            out, found = real_get(keys)
            if (slots[~found] != MISS_FILL).any():
                raise AssertionError(f"client {tid}: the server wrote into "
                                     "a miss's arena slot")
            return out, found

        self.be.get = get
        self.cc = CleanCacheClient(self.be)
        srv.register_bf_client(self.cc)
        self.put_lat: list[float] = []
        self.get_lat: list[float] = []
        self.inval = np.zeros(0, np.uint32)
        self.acked_misses = self.negatives = self.never = 0

    def oids(self, n: int):
        return self.np.full(n, self.hi, self.np.uint32)

    def fill(self) -> None:
        """put_pages of [0, n_fill) in VERB-page verbs."""
        np = self.np
        for v in range(self.n_fill // VERB):
            lo = np.arange(v * VERB, (v + 1) * VERB, dtype=np.uint32)
            pages = pages_np(self.hi, lo, self.pw)
            t0 = time.perf_counter()
            self.cc.put_pages(self.oids(VERB), lo, pages)
            self.put_lat.append(time.perf_counter() - t0)

    def check_mirror(self) -> None:
        """After a push: every acknowledged key the mirror denies must be
        one the server lost. Asked without the mirror, each must miss."""
        from pmdfc_tpu_torch.utils.hashing_np import query_packed_np

        np = self.np
        acked = np.arange(self.n_fill, dtype=np.uint32)
        keys = np.stack([self.oids(self.n_fill), acked], -1)
        neg = keys[~query_packed_np(self.cc._bloom, keys, self.cc.num_hashes)]
        for i in range(0, len(neg), VERB):
            _, found = self.be.get(neg[i:i + VERB])
            if found.any():
                raise AssertionError(f"client {self.tid}: a key its mirror "
                                     "denies still hits (false negative)")
        self.negatives = len(neg)

    def prepare(self) -> None:
        """The mirror check, then invalidate 1/8 of the GET volume through
        the engine."""
        np = self.np
        self.check_mirror()
        n_inv = GET_VERBS * VERB // 8
        perm = self.rng.permutation(self.n_fill).astype(np.uint32)
        self.inval = np.sort(perm[:n_inv])
        self.cc.invalidate_pages(self.oids(n_inv), self.inval)
        self.present = perm[n_inv:]

    def storm(self) -> None:
        """GET_VERBS get_pages verbs: 5/8 present, 1/8 never inserted, 1/8
        invalidated, 1/16 from the first fill verb (the likeliest evicted),
        1/16 padding. Checks every verb: hits byte-exact, misses zeroed
        (their arena slots untouched by the server: `get` above),
        never-inserted, invalidated and padding keys miss."""
        np = self.np
        present = self.present
        oldest = np.setdiff1d(np.arange(VERB, dtype=np.uint32), self.inval)
        k8, k16 = VERB // 8, VERB // 16
        for _ in range(GET_VERBS):
            kinds = [(present, VERB - 2 * k8 - 2 * k16, 0),
                     (None, k8, 1), (self.inval, k8, 2), (oldest, k16, 3)]
            his, los, tags = [], [], []
            for pool, n, tag in kinds:
                if pool is None:
                    lo = self.rng.integers(NEVER_LO, 1 << 32, n,
                                           dtype=np.uint64).astype(np.uint32)
                else:
                    lo = pool[self.rng.integers(0, len(pool), n)]
                his.append(self.oids(n))
                los.append(lo)
                tags.append(np.full(n, tag, np.int8))
            his.append(np.full(k16, 0xFFFFFFFF, np.uint32))  # padding
            los.append(np.full(k16, 0xFFFFFFFF, np.uint32))
            tags.append(np.full(k16, 4, np.int8))
            order = self.rng.permutation(VERB)
            hi, lo, tag = (np.concatenate(x)[order] for x in (his, los, tags))
            t0 = time.perf_counter()
            out, found = self.cc.get_pages(hi, lo)
            self.get_lat.append(time.perf_counter() - t0)
            if found[(tag == 1) | (tag == 2) | (tag == 4)].any():
                raise AssertionError(f"client {self.tid}: a never-inserted, "
                                     "invalidated or padding key hit")
            if not np.array_equal(out[found],
                                  pages_np(self.hi, lo[found], self.pw)):
                raise AssertionError(f"client {self.tid}: a hit returned "
                                     "wrong bytes")
            if out[~found].any():
                raise AssertionError(f"client {self.tid}: a miss returned "
                                     "nonzero bytes")
            self.acked_misses += int((~found & ((tag == 0) | (tag == 3))).sum())
            self.never += k8

    def extents(self, n: int, stats) -> tuple[int, int]:
        """n extents through OP_INS_EXT, read back through OP_GET_EXT
        (`extent_roundtrip`)."""
        return extent_roundtrip(self.be, n, stats)


def extent_roundtrip(be, n: int, stats) -> tuple[int, int]:
    """n extents registered through a client backend, read back in
    VERB-key verbs: every address found is value + 4096 * (key -
    base), keys past a run's end miss, and in-run keys missed are at
    most the evictions the phase made. -> (in-run probes found, of)."""
    import numpy as np

    ev0 = stats()["evictions"]
    exts = []
    for j in range(n):
        base, length = (j + 1) * 4096, 1 + (7 * j) % 61
        value = (j, (0xFFFF0000 - 4096 * 64 * j) % (1 << 32))
        unc = be.insert_extent(np.array([EXT_HI, base], np.uint32),
                               np.array(value, np.uint32), length)
        if unc:
            raise AssertionError(f"extent {j}: {unc} pages uncovered")
        exts.append((base, length, value))
    probe, want, inrun = [], [], []
    for base, length, (vhi, vlo) in exts:
        for o in (0, length - 1, length // 2, length):
            probe.append([EXT_HI, base + o])
            want.append((((vhi << 32) | vlo) + 4096 * o) % (1 << 64))
            inrun.append(o < length)
    probe, want, inrun = (np.array(probe, np.uint32),
                          np.array(want, np.uint64), np.array(inrun))
    vals, found = np.zeros((0, 2), np.uint32), np.zeros(0, bool)
    for i in range(0, len(probe), VERB):
        v, f = be.get_extent(probe[i:i + VERB])
        vals, found = np.concatenate([vals, v]), np.concatenate([found, f])
    addr = (vals[:, 0].astype(np.uint64) << np.uint64(32)) | vals[:, 1]
    if found[~inrun].any():
        raise AssertionError("get_extent found a key past a run's end")
    if not np.array_equal(addr[found], want[found]) or addr[~found].any():
        raise AssertionError("get_extent returned a wrong address")
    lost = int((inrun & ~found).sum())
    if lost > stats()["evictions"] - ev0:
        raise AssertionError(f"get_extent lost {lost} in-run keys beyond "
                             "the phase's evictions")
    return int(found.sum()), int(inrun.sum())


class ServePath:
    """The serving path's key sets on the device for phase 5 (`measure`):
    status[tid, i] of key (SERVE_HI + tid, i): 1 present, 3 invalidated."""

    def __init__(self, sm: Smoke, kv, clients, t_fill: float):
        torch = sm.torch
        self.sm, self.kv, self.label = sm, kv, "serving"
        self.pw = kv.config.page_words
        n = clients[0].n_fill
        self.n_fill, self.t_fill = n * len(clients), t_fill
        status = torch.ones((len(clients), n), dtype=torch.int8,
                            device=sm.dev)
        for c in clients:
            status[c.tid, torch.from_numpy(c.inval.astype("int64")).to(
                sm.dev)] = 3
        self.status = status

    def keys(self, want: int):
        """Keys of status `want` as [n, 2] int32 on the device."""
        sm = self.sm
        tid, lo = (self.status == want).nonzero(as_tuple=True)
        return sm.torch.stack([sm.u32.narrow(tid + SERVE_HI),
                               sm.u32.narrow(lo)], dim=-1)

    def mixed(self, n: int, deleted: bool = True):
        """5/8 present, 1/8 never inserted, 1/16 invalidated, padding."""
        sm, torch = self.sm, self.sm.torch
        never = torch.stack([
            sm.u32.narrow(torch.randint(0, self.status.shape[0], (n // 8,),
                                        device=sm.dev, generator=sm.gen)
                          + SERVE_HI),
            sm.u32.narrow(torch.randint(NEVER_LO, 1 << 32, (n // 8,),
                                        device=sm.dev, generator=sm.gen))],
            dim=-1)
        parts = [sm.pick(self.keys(1), n * 5 // 8), never]
        if deleted:
            parts.append(sm.pick(self.keys(3), n // 16))
        keys = torch.cat(parts)
        keys = torch.cat([keys, torch.full((n - keys.shape[0], 2), -1,
                                           dtype=torch.int32, device=sm.dev)])
        return keys[torch.randperm(n, device=sm.dev, generator=sm.gen)]


def quiet_flushes(sm: Smoke, srv, path: ServePath) -> None:
    """With the driver stopped and no client running, through a probe
    engine that shares the server's KV: `serve_batch` of a PUT flush of
    present keys re-put with their own pages, at GET_B and at PUT_ODD
    pages (a width the pad ladder rounds up), and of one GET flush of GET_B
    mixed keys. Checks (they raise): every re-put page is served back, and
    the GET flush's statuses agree with `KV.get`. Measured: each flush's
    host-clock time (mean of 3); a PUT_ODD flush's padding step both ways
    (padded on the host with GET_B rows across, or `KV._padded`: PUT_ODD
    rows across, padded on the device); torch.profiler over the GET flush
    (device ops, device busy time, host syncs)."""
    np, torch, smi = sm.np, sm.torch, nvidia_smi()
    from pmdfc_tpu_torch.runtime import OP_GET, OP_PUT, Engine, KVServer

    eng = Engine(num_queues=1, queue_cap=GET_B, batch=GET_B,
                 arena_pages=GET_B, page_bytes=path.pw * 4)
    probe = KVServer(srv.config, engine=eng, kv=srv.kv)

    def flush(op, keys):
        n = len(keys)
        base = eng.submit_batch(0, op, keys, np.arange(n, dtype=np.uint32))
        reqs = eng.pop_batch(n, timeout_us=0)
        if len(reqs) != n:
            raise AssertionError(f"probe flush popped {len(reqs)} of {n}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            probe.serve_batch(reqs)
        torch.cuda.synchronize()
        return reqs, eng.wait_many(base, n), (
            time.perf_counter() - t0) / 3 * 1e3

    try:
        put_ms = {}
        for n in (GET_B, PUT_ODD):
            keys = sm.u32.to_numpy(sm.pick(path.keys(1), n))
            pages = pages_np(keys[:, 0], keys[:, 1], path.pw)
            eng.arena[:n] = pages
            _, st, put_ms[n] = flush(OP_PUT, keys)
            out, found = srv.kv.get(keys)
            if (st != 0).any() or not (found.all()
                                       and np.array_equal(out, pages)):
                raise AssertionError(f"a re-put flush of {n} pages did not "
                                     "serve its pages")
        rows = eng.arena[np.arange(PUT_ODD)]  # the flush's gather
        w = sm.kv_mod._pad_pow2(PUT_ODD)

        def host_pad():
            h = np.zeros((w, rows.shape[1]), np.int32)
            h[:PUT_ODD] = rows.view(np.int32)
            return torch.from_numpy(h).to(srv.kv.device)

        host_ms = time_ms(torch, [host_pad], 5, warmup=1)
        dev_ms = time_ms(torch, [lambda: srv.kv._padded(rows, w, 0)], 5,
                         warmup=1)
        keys = sm.u32.to_numpy(path.mixed(GET_B))
        reqs, st, get_ms = flush(OP_GET, keys)
        _, found = srv.kv.get(keys)
        if not np.array_equal(st == 0, found):
            raise AssertionError("a served GET flush disagrees with KV.get")
        log("serve", f"quiet flushes (driver stopped, no client running), "
            f"serve_batch, host clock, mean of 3: PUT flush of {GET_B} pages "
            f"{put_ms[GET_B]:.3f} ms, of {PUT_ODD} pages (padded to {w}) "
            f"{put_ms[PUT_ODD]:.3f} ms, GET flush of {GET_B} keys "
            f"{get_ms:.3f} ms; the {PUT_ODD}-page flush's padding, mean of "
            f"5: padded on the host, {w} rows across {host_ms:.3f} ms; "
            f"KV._padded, {PUT_ODD} rows across and padded on the device "
            f"{dev_ms:.3f} ms ({smi})")
        prof = profile_breakdown(torch, lambda: probe.serve_batch(reqs), 5)
        log("serve", f"torch.profiler of the quiet GET flush: {prof} ({smi})")
    finally:
        eng.close()


def run_serving(sm: Smoke):
    """The serving path: linear·flat at the serving size behind the native
    engine and the `KVServer` driver, CLIENT_GROUPS x GROUP_THREADS clean-
    cache client threads (one engine queue each), a bloom push every
    BF_PUSH_S. Fill 75% of the slots (5/8 through KV.insert, then an
    eighth through the engine), push, then the GET
    storm and the extent verbs; then kernel against plain on the server's
    full-size state and phase 5's times."""
    np, torch, fused = sm.np, sm.torch, sm.fused
    from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, KVConfig
    from pmdfc_tpu_torch.runtime import Engine, KVServer

    smi = nvidia_smi()
    cfg = KVConfig(index=IndexConfig(**SERVE_INDEX),
                   bloom=BloomConfig(num_bits=SERVE_BLOOM_BITS))
    srv = KVServer(cfg, engine=Engine(**SERVE_ENGINE), device=DEVICE,
                   bf_push_s=BF_PUSH_S)
    kv, eng = srv.kv, srv.engine
    minus_two: list[int] = []
    real_wait = eng.wait_many

    def wait_many(base, n, timeout_us=10_000_000):
        st = real_wait(base, n, timeout_us=timeout_us)
        if (st == -2).any():
            minus_two.append(int((st == -2).sum()))
        return st

    eng.wait_many = wait_many  # every client verb's statuses pass here
    nthreads = CLIENT_GROUPS * GROUP_THREADS
    unit = nthreads * VERB
    # 75% of the slots, 5/8 straight through KV.insert, then an eighth
    # through the engine: the fill through the engine runs at 8,000-10,000
    # pages/s, and the whole 75% through it took 156 s
    n_fill = (kv.capacity() // 8) // unit * unit
    n_direct = (3 * kv.capacity() // 4 - n_fill) // INS_B * INS_B
    st = kv.state
    log("serve", f"KVServer on {kv.device}: {kv.capacity()} slots, table "
        f"{tuple(st.index.table.shape)}, pool {tuple(st.pool.pages.shape)} = "
        f"{st.pool.pages.numel() * 4 / 2**30:.2f} GiB, bloom "
        f"{cfg.bloom.num_bits} counters; engine {SERVE_ENGINE} (arena "
        f"{eng.arena.nbytes / 2**20:.0f} MiB); {CLIENT_GROUPS} clients x "
        f"{GROUP_THREADS} threads, {VERB}-page verbs, bloom push every "
        f"{BF_PUSH_S} s")
    t0 = time.monotonic()
    n_warm = srv.warmup()  # on this thread: a kernel failure raises here
    torch.cuda.synchronize()
    log("serve", f"warmup: {n_warm} (kind, width) ops in "
        f"{time.monotonic() - t0:.3f} s, pad floor {srv.pad_floor}")
    # the pre-fill straight through KV.insert; the clients' fill then
    # evicts the oldest entries of full clusters, the pre-fill's
    t0 = time.monotonic()
    for i in range(0, n_direct, INS_B):
        keys = sm.keys_of(SERVE_DIRECT_HI,
                          torch.arange(i, i + INS_B, device=sm.dev))
        kv.insert(keys, sm.pages_of(keys, cfg.page_words))
    torch.cuda.synchronize()
    log("serve", f"pre-fill: {n_direct} pages through KV.insert in "
        f"{INS_B}-page batches in {time.monotonic() - t0:.3f} s")

    fused.launches.clear()
    torch.cuda.synchronize()
    srv.start()
    clients: list[ServeClient] = []
    try:
        clients = [ServeClient(srv, t, n_fill // nthreads, sm.seed)
                   for t in range(nthreads)]
        t_fill = run_threads([c.fill for c in clients], "fill")
        e_fill = eng.stats()
        fill_phases = srv.timers.report()
        fill_totals = srv.timers.totals_s()
        push = srv.push_bloom_now()
        run_threads([c.prepare for c in clients], "mirror check, invalidate")
        e_prep = eng.stats()
        srv.timers.reset()
        t_storm = run_threads([c.storm for c in clients], "storm")
        e_storm = eng.stats()
        storm_phases = srv.timers.report()
        storm_totals = srv.timers.totals_s()
        n_found, n_inrun = clients[0].extents(SERVE_EXTENTS, kv.stats)
        torch.cuda.synchronize()
        launches = fused.launches["fused_get_linear_flat"]
        health = srv.health()
    finally:
        srv.stop()
        for c in clients:
            c.cc.close()
            c.be.close()

    s, e = health["kv"], health["engine"]
    get_flushes = health["op_batches"].get("get", 0)
    n_gets = nthreads * GET_VERBS * VERB
    acked_misses = sum(c.acked_misses for c in clients)
    negatives = sum(c.negatives for c in clients)
    never = sum(c.never for c in clients)
    asked = sum(c.never_asked for c in clients)
    short = 1 - asked / never
    lost = s["evictions"] + s["drops"]
    checks = [
        (health["serve_errors"] == 0, f"serve_errors {health['serve_errors']}"),
        (not minus_two, f"{sum(minus_two)} requests completed with -2"),
        (e["submitted"] == e["completed"], f"engine {e}"),
        (s["misses"] == sum(s[c] for c in sm.kv_mod.MISS_CAUSE_NAMES),
         "misses != sum of miss causes"),
        (acked_misses <= lost, f"{acked_misses} acknowledged keys missed, "
         f"more than evictions + drops {lost}"),
        (negatives <= lost, f"{negatives} mirror negatives among "
         f"acknowledged keys, more than evictions + drops {lost}"),
        (short >= 0.9, f"only {short:.1%} of never-inserted GETs were "
         "short-circuited by the mirror"),
        (get_flushes > 0 and launches >= get_flushes,
         f"{launches} fused-GET launches for {get_flushes} GET flushes"),
        (push["clients"] == nthreads, f"push reached {push}"),
    ]
    for ok, msg in checks:
        if not ok:
            raise AssertionError(f"serving: {msg}")

    def widths(a, b=None):
        d = {k: a[k] - (b[k] if b else 0) for k in a}
        return (f"{d['batches']} batches ({d['flushes']} flushed partial), "
                f"mean width {d['submitted'] / max(d['batches'], 1):.1f}")

    put_lat = [x for c in clients for x in c.put_lat]
    get_lat = [x for c in clients for x in c.get_lat]
    log("serve", f"fill: {n_fill} pages through the engine by {nthreads} "
        f"threads in {t_fill:.3f} s = {n_fill / t_fill:.0f} pages/s; "
        f"put_pages verb of {VERB} pages: {percentiles_ms(put_lat)}; engine "
        f"{widths(e_fill)} ({smi})")
    log("serve", f"fill driver phases: {fill_phases}; totals {fill_totals} "
        f"of a {t_fill:.3f} s wall ({smi})")
    log("serve", f"storm: {n_gets} GET keys in {t_storm:.3f} s = "
        f"{n_gets / t_storm:.0f} keys/s; get_pages verb of {VERB} keys: "
        f"{percentiles_ms(get_lat)}; engine {widths(e_storm, e_prep)} ({smi})")
    log("serve", f"storm driver phases: {storm_phases}; totals "
        f"{storm_totals} of a {t_storm:.3f} s wall ({smi})")
    log("serve", f"bloom push: {srv.bf_push_stats}; after the fill push: "
        f"{negatives} mirror negatives among {n_fill} acknowledged keys, "
        f"each a server miss; never-inserted GETs short-circuited "
        f"{never - asked} of {never} = {short:.2%} ({smi})")
    log("serve", f"checks passed: {acked_misses} acknowledged keys missed "
        f"<= evictions {s['evictions']} + drops {s['drops']}; hits "
        f"{s['hits']}, misses {s['misses']} (cold {s['miss_cold']}, "
        f"evicted {s['miss_evicted']}); serve_errors 0, no -2 status, "
        f"submitted == completed == {e['submitted']}; extents: "
        f"{SERVE_EXTENTS} through OP_INS_EXT, {n_found} of {n_inrun} in-run "
        f"probes found through OP_GET_EXT, every address exact")
    log("serve", f"fused_get_linear_flat launches {launches} for {get_flushes} "
        f"GET flushes (op batches {health['op_batches']}) ({smi})")

    path = ServePath(sm, kv, clients, t_fill)
    quiet_flushes(sm, srv, path)

    # 3, continued: kernel against plain on the server's full-size state
    present = path.keys(1)[:4096]
    pool = torch.cat([path.keys(1), path.keys(3), path.mixed(1 << 16)])
    covers = sm.keys_of(EXT_HI, torch.tensor(
        [(j + 1) * 4096 for j in range(SERVE_EXTENTS)], device=sm.dev))
    # the capacity evictions fell on the pre-fill's oldest keys: a few of
    # its first batch that miss now ride every batch (the EVICTED cause)
    first = sm.keys_of(SERVE_DIRECT_HI, torch.arange(INS_B, device=sm.dev))
    _, found = kv.get(first)
    sm.kernel_phase(kv, pool, present, covers, "serving full",
                    extra=first[~found][:4])
    return measure(sm, path, launches)


class WireClient:
    """One connection of the wire phase: a pipelined `TcpBackend` (window
    WIRE_WINDOW; `directory=True` for the fast-lane connections) built by
    a `ReconnectingClient`, under a `CleanCacheClient` that the TcpBackend
    feeds with the server's bloom pushes. Its wire keys are (WIRE_HI +
    cid, i); `storm` draws evicted keys from the pre-fill's."""

    def __init__(self, port: int, cid: int, n_fill: int, pw: int,
                 seed: int, directory: bool = False):
        import threading

        import numpy as np

        from pmdfc_tpu_torch.client import CleanCacheClient
        from pmdfc_tpu_torch.runtime.failure import ReconnectingClient
        from pmdfc_tpu_torch.runtime.net import TcpBackend

        self.np, self.cid, self.n_fill, self.pw = np, cid, n_fill, pw
        self.hi = WIRE_HI + cid
        self.rng = np.random.default_rng([seed, 1000 + cid])
        self.tcp: list = []  # every TcpBackend the factory made
        # the push channel's sink: the CleanCacheClient below, which pulls
        # the filter (and so connects) inside its own constructor; a push
        # that arrives first waits for it
        self._cc_ready = threading.Event()

        def factory():
            # keepalives (the default period) hold a connection that
            # sits out a pass past the server's idle timeout
            be = TcpBackend("127.0.0.1", port, page_words=pw,
                            bloom_sink=self,
                            client_id=(0xC11E << 32) | cid,
                            window=WIRE_WINDOW, op_timeout_s=120.0,
                            directory=directory,
                            dir_max_entries=4 * WIRE_INDEX["capacity"])
            self.tcp.append(be)
            return be

        self.rc = ReconnectingClient(factory, page_words=pw)
        self.never_asked = 0
        real_get = self.rc.get

        def get(keys):
            self.never_asked += int(((keys[:, 0] == self.hi)
                                     & (keys[:, 1] >= NEVER_LO)).sum())
            return real_get(keys)

        self.rc.get = get
        self.cc = CleanCacheClient(self.rc)
        self._cc_ready.set()
        self.put_lat: list[float] = []
        self.get_lat: list[float] = []
        self.inval = np.zeros(0, np.uint32)
        self.acked_misses = self.negatives = self.never = 0

    @property
    def be(self):
        """The live TcpBackend."""
        return self.tcp[-1]

    def receive_bloom_full(self, *args, **kw):
        self._cc_ready.wait(60)
        self.cc.receive_bloom_full(*args, **kw)

    def receive_bloom_blocks(self, *args, **kw):
        self._cc_ready.wait(60)
        self.cc.receive_bloom_blocks(*args, **kw)

    def oids(self, n: int, hi: int | None = None):
        return self.np.full(n, self.hi if hi is None else hi, self.np.uint32)

    def fill(self) -> None:
        """put_pages of [0, n_fill) in VERB-page verbs."""
        np = self.np
        for v in range(self.n_fill // VERB):
            lo = np.arange(v * VERB, (v + 1) * VERB, dtype=np.uint32)
            t0 = time.perf_counter()
            self.cc.put_pages(self.oids(VERB), lo,
                              pages_np(self.hi, lo, self.pw))
            self.put_lat.append(time.perf_counter() - t0)

    def check_mirror(self) -> None:
        """Every acknowledged key the pushed mirror denies must miss at the
        server (asked without the mirror)."""
        from pmdfc_tpu_torch.utils.hashing_np import query_packed_np

        np = self.np
        keys = np.stack([self.oids(self.n_fill),
                         np.arange(self.n_fill, dtype=np.uint32)], -1)
        neg = keys[~query_packed_np(self.cc._bloom, keys, self.cc.num_hashes)]
        for i in range(0, len(neg), VERB):
            if self.rc.get(neg[i:i + VERB])[1].any():
                raise AssertionError(f"connection {self.cid}: a key its "
                                     "mirror denies still hits")
        self.negatives = len(neg)

    def prepare(self, n_inv: int) -> None:
        """The mirror check, then invalidate n_inv of the connection's
        keys over the wire."""
        np = self.np
        self.check_mirror()
        perm = self.rng.permutation(self.n_fill).astype(np.uint32)
        self.inval = np.sort(perm[:n_inv])
        self.cc.invalidate_pages(self.oids(n_inv), self.inval)
        self.present = perm[n_inv:]

    def storm(self, verbs: int, evicted) -> None:
        """`verbs` get_pages verbs: 5/8 present, 1/8 never inserted, 1/8
        invalidated, 1/8 evicted (pre-fill keys the index evicted; never
        inserted ones if it evicted none). Hits
        byte-exact, misses zeroed, never-inserted, invalidated and evicted
        keys miss."""
        np = self.np
        k8 = VERB // 8
        for _ in range(verbs):
            his, los, tags = [], [], []
            for pool, n, tag, hi in (
                    (self.present, VERB - 3 * k8, 0, self.hi),
                    (None, k8, 1, self.hi), (self.inval, k8, 2, self.hi),
                    (evicted if len(evicted) else None, k8, 3, DIRECT_HI)):
                if pool is None:
                    lo = self.rng.integers(NEVER_LO, 1 << 32, n,
                                           dtype=np.uint64).astype(np.uint32)
                else:
                    lo = pool[self.rng.integers(0, len(pool), n)]
                his.append(self.oids(n, hi))
                los.append(lo)
                tags.append(np.full(n, tag, np.int8))
            order = self.rng.permutation(VERB)
            hi, lo, tag = (np.concatenate(x)[order] for x in (his, los, tags))
            t0 = time.perf_counter()
            out, found = self.cc.get_pages(hi, lo)
            self.get_lat.append(time.perf_counter() - t0)
            if found[tag != 0].any():
                raise AssertionError(f"connection {self.cid}: a never-"
                                     "inserted, invalidated or evicted key "
                                     "hit")
            if not np.array_equal(out[found], pages_np(hi[found], lo[found],
                                                       self.pw)):
                raise AssertionError(f"connection {self.cid}: a hit "
                                     "returned wrong bytes")
            if out[~found].any():
                raise AssertionError(f"connection {self.cid}: a miss "
                                     "returned nonzero bytes")
            self.acked_misses += int((~found & (tag == 0)).sum())
            self.never += k8

    def close(self) -> None:
        self.cc.close()
        self.rc.close()


def fast_pass(clients, sets, want: dict, label: str):
    """Each fast connection reads its key set (pre-fill keys) through
    get_pages in VERB-key verbs, in parallel: every hit must equal
    `want[lo]`, the page the key holds now (never an older one); keys in
    `want["gone"]` must miss. -> (wall s, keys, hits, fast lanes asked,
    acknowledged keys missed)."""
    import numpy as np

    res = [None] * len(clients)
    lanes0 = [c.be.directory.counters["fastpath_gets"] for c in clients]

    def run(i):
        c, los = clients[i], sets[i]
        hits = missed = 0
        for j in range(0, len(los), VERB):
            lo = los[j:j + VERB]
            hi = np.full(len(lo), DIRECT_HI, np.uint32)
            out, found = c.cc.get_pages(hi, lo)
            gone = np.isin(lo, want["gone"])
            if found[gone].any():
                raise AssertionError(f"{label}: an invalidated key hit")
            exp = pages_np(hi, lo, c.pw)
            rw = np.isin(lo, want["rewritten"])
            exp[rw] ^= np.uint32(want["xor"])
            bad = found & (out != exp).any(axis=1)
            if bad.any():
                old = pages_np(hi, lo, c.pw)
                raise AssertionError(
                    f"{label}: {int(bad.sum())} hits returned bytes other "
                    f"than the key's current page ({int((bad & rw).sum())} "
                    f"of them rewritten keys, "
                    f"{int((bad & (out == old).all(axis=1)).sum())} equal "
                    f"to the key's first page); client {c.rc.stats()}")
            if out[~found].any():
                raise AssertionError(f"{label}: a miss returned nonzero "
                                     "bytes")
            hits += int(found.sum())
            missed += int((~found & ~gone).sum())
        res[i] = (hits, missed)

    wall = run_threads([lambda i=i: run(i) for i in range(len(clients))],
                       label)
    lanes = sum(c.be.directory.counters["fastpath_gets"] - l0
                for c, l0 in zip(clients, lanes0))
    return (wall, sum(len(x) for x in sets), sum(r[0] for r in res), lanes,
            sum(r[1] for r in res))


def run_wire(sm: Smoke):
    """The wire path (phase 8): linear·flat's configuration behind the
    port's `NetServer` on loopback TCP, WIRE_CLIENTS x WIRE_CONNS
    connections, then the one-sided sub-phase. -> the wire path's kernel
    entry."""
    np, torch, fused = sm.np, sm.torch, sm.fused
    from pmdfc_tpu_torch.client import DirectBackend
    from pmdfc_tpu_torch.config import (BloomConfig, IndexConfig, KVConfig,
                                        NetConfig)
    from pmdfc_tpu_torch.runtime.net import NetServer

    smi = nvidia_smi()
    cfg = KVConfig(index=IndexConfig(**WIRE_INDEX),
                   bloom=BloomConfig(num_bits=WIRE_BLOOM_BITS))
    kv = sm.kv_mod.KV(cfg, device=DEVICE)
    pw = cfg.page_words
    nconn = WIRE_CLIENTS * WIRE_CONNS
    st = kv.state
    log("wire", f"KV on {kv.device}: {kv.capacity()} slots, pool "
        f"{tuple(st.pool.pages.shape)} = {st.pool.pages.numel() * 4 / 2**30:.2f}"
        f" GiB, bloom {cfg.bloom.num_bits} counters; NetServer(NetConfig()) "
        f"on 127.0.0.1, {WIRE_CLIENTS} clients x {WIRE_CONNS} connections, "
        f"window {WIRE_WINDOW}, {VERB}-page verbs, bloom push every "
        f"{BF_PUSH_S} s")

    # pre-fill straight through KV.insert
    t0 = time.monotonic()
    for i in range(0, WIRE_DIRECT, INS_B):
        lo = torch.arange(i, min(i + INS_B, WIRE_DIRECT), device=sm.dev)
        keys = sm.keys_of(DIRECT_HI, lo)
        kv.insert(keys, sm.pages_of(keys, pw))
    torch.cuda.synchronize()
    t_direct = time.monotonic() - t0
    log("wire", f"pre-fill: {WIRE_DIRECT} pages through KV.insert in "
        f"{INS_B}-page batches in {t_direct:.3f} s = "
        f"{WIRE_DIRECT / t_direct:.0f} pages/s")

    shared = DirectBackend(kv)
    phases: list[int] = []  # the padded width of every GET phase served
    real_get = shared.get

    def get(keys):
        phases.append(len(keys))
        return real_get(keys)

    shared.get = get
    srv = NetServer(lambda: shared, net=NetConfig(), bf_push_s=BF_PUSH_S)
    srv.start()
    clients: list[WireClient] = []
    fused.launches.clear()
    torch.cuda.synchronize()
    try:
        clients = [WireClient(srv.port, c, WIRE_FILL // nconn, pw, sm.seed,
                              directory=c < WIRE_FAST_CONNS)
                   for c in range(nconn)]
        t_fill = run_threads([c.fill for c in clients], "wire fill")
        s_fill = dict(srv.stats)
        # which pre-fill keys the table still holds (a scan on the card):
        # the rest were evicted by the fills
        with kv._lock:
            flat, _ = kv._ops.scan(kv.state.index)
            held = flat[flat[:, 0] == sm.u32.narrow(torch.tensor(DIRECT_HI))]
            direct_present = np.sort(sm.u32.to_numpy(held[:, 1]))
        evicted = np.setdiff1d(np.arange(WIRE_DIRECT, dtype=np.uint32),
                               direct_present)
        log("wire", f"after the fills: {len(direct_present)} pre-fill keys "
            f"held, {len(evicted)} evicted")
        # every mirror must have taken a push (the push channel works);
        # between pushes each client's put overlay keeps it free of false
        # negatives
        srv.push_bloom_now()
        deadline = time.monotonic() + 60
        while any(c.cc.counters["bf_pushes"] < 1 or c.cc._bloom is None
                  for c in clients):
            if time.monotonic() > deadline:
                raise AssertionError("wire: a client never received the "
                                     "bloom push")
            time.sleep(0.01)
        verbs = max(1, WIRE_GETS // (nconn * VERB))
        run_threads([lambda c=c: c.prepare(verbs * VERB // 8)
                     for c in clients], "wire mirror check, invalidate")
        s0 = dict(srv.stats)
        t_storm = run_threads([lambda c=c: c.storm(verbs, evicted)
                               for c in clients], "wire storm")
        s_storm = dict(srv.stats)
        n_found, n_inrun = extent_roundtrip(clients[-1].rc, WIRE_EXTENTS,
                                            kv.stats)

        # the fast lane: the directory connections pull the directory and
        # read pre-fill keys; the driver rewrites and invalidates some of
        # them over the wire between passes
        fast = clients[:WIRE_FAST_CONNS]
        t0 = time.monotonic()
        if not all(c.rc.dir_refresh() for c in fast):
            raise AssertionError("wire: a directory pull failed")
        t_pull = time.monotonic() - t0
        n_dir = len(fast[0].be.directory)
        perm = np.random.default_rng(sm.seed).permutation(direct_present)
        k = min(WIRE_FAST_KEYS, len(perm) // WIRE_FAST_CONNS)
        sets = [np.sort(perm[i * k:(i + 1) * k])
                for i in range(WIRE_FAST_CONNS)]
        want = {"gone": np.zeros(0, np.uint32),
                "rewritten": np.zeros(0, np.uint32), "xor": 0x5A5A5A5A}
        fp0 = (int(srv.stats["fastpath_hits"]), int(srv.stats["fastpath_stale"]))
        p1 = fast_pass(fast, sets, want, "fast read 1")
        r = WIRE_REWRITE // WIRE_FAST_CONNS
        rw = np.sort(np.concatenate([x[:r] for x in sets]))
        gone = np.sort(np.concatenate([x[r:2 * r] for x in sets]))
        driver = clients[WIRE_FAST_CONNS]
        for j in range(0, len(rw), VERB):
            lo = rw[j:j + VERB]
            hi = np.full(len(lo), DIRECT_HI, np.uint32)
            driver.cc.put_pages(hi, lo, pages_np(hi, lo, pw)
                                ^ np.uint32(want["xor"]))
        # a put the ReconnectingClient dropped is legal, but then the
        # rewrite did not happen and the passes below test nothing
        rs = driver.rc.stats()
        if rs["dropped_puts"] or rs["disconnects"]:
            raise AssertionError(f"wire: the driver's rewrites were not all "
                                 f"applied: {rs}")
        want["rewritten"] = rw
        p2 = fast_pass(fast, sets, want, "fast read 2 (after rewrites)")
        driver.cc.invalidate_pages(np.full(len(gone), DIRECT_HI, np.uint32),
                                   gone)
        want["gone"] = gone
        p3 = fast_pass(fast, sets, want, "fast read 3 (after invalidates)")
        fp = (int(srv.stats["fastpath_hits"]) - fp0[0],
              int(srv.stats["fastpath_stale"]) - fp0[1])

        # a recovering window: one storm batch of never-inserted keys asked
        # past the mirror; its cold misses count as miss_recovering
        s_rec0 = kv.stats()
        kv.begin_recovering()
        lo = np.random.default_rng(sm.seed).integers(
            NEVER_LO, 1 << 32, VERB, dtype=np.uint64).astype(np.uint32)
        rec_found = driver.be.get(np.stack([driver.oids(VERB), lo], -1))[1]
        info = driver.be.recovery_info()
        was = driver.be.mark_recovered()
        s_rec1 = kv.stats()
        torch.cuda.synchronize()
        launches = fused.launches["fused_get_linear_flat"]
        n_phases = len(phases)
        health = dict(srv.stats)
        disconnects = sum(c.rc.stats()["disconnects"] for c in clients)
    finally:
        srv.stop()
        for c in clients:
            c.close()

    s = kv.stats()
    d_rec = {c: s_rec1[c] - s_rec0[c] for c in sm.kv_mod.MISS_CAUSE_NAMES}
    never = sum(c.never for c in clients)
    asked = sum(c.never_asked for c in clients)
    short = 1 - asked / never
    lost = s["evictions"] + s["drops"]
    acked = (sum(c.acked_misses for c in clients) + p1[4] + p2[4] + p3[4])
    negatives = sum(c.negatives for c in clients)
    lanes = p1[3] + p2[3] + p3[3]
    checks = [
        (int(health["serve_errors"]) == 0,
         f"serve_errors {health['serve_errors']}"),
        # a failing phase is bisected and its ops answered MSG_NACK (a
        # legal miss): none may have happened
        (all(int(health[k]) == 0 for k in ("nacks_sent", "bisect_failures",
                                           "poison_ops", "deadline_shed")),
         "a phase failed: " + str({k: health[k] for k in (
             "nacks_sent", "bisect_failures", "poison_ops",
             "deadline_shed")})),
        (disconnects == 0, f"{disconnects} client disconnects"),
        (s["misses"] == sum(s[c] for c in sm.kv_mod.MISS_CAUSE_NAMES),
         "misses != sum of miss causes"),
        (acked <= lost, f"{acked} acknowledged keys missed, more than "
         f"evictions + drops {lost}"),
        (negatives <= lost, f"{negatives} mirror negatives among "
         f"acknowledged keys, more than evictions + drops {lost}"),
        (short >= 0.9, f"only {short:.1%} of never-inserted GETs were "
         "short-circuited by the mirrors"),
        (fp[0] + fp[1] == lanes, f"fastpath_hits {fp[0]} + fastpath_stale "
         f"{fp[1]} != {lanes} fast lanes read"),
        (p1[2] > 0 and p2[3] > 0, "the fast lane served nothing"),
        (info.get("recovering") is True and was,
         f"recovering window not seen over the wire ({info}, {was})"),
        # a never-inserted key the evicted-key sketch flags is
        # miss_evicted; every other one would be miss_cold
        (not rec_found.any() and d_rec["miss_cold"] == 0
         and d_rec["miss_recovering"] > 0
         and d_rec["miss_recovering"] + d_rec["miss_evicted"] == VERB,
         f"recovering batch: causes {d_rec}"),
        (n_phases > 0 and launches == n_phases,
         f"{launches} fused-GET launches for {n_phases} GET phases"),
    ]
    for ok, msg in checks:
        if not ok:
            raise AssertionError(f"wire: {msg}")

    def flushes(a, b):
        f = int(b["flushes"]) - int(a["flushes"])
        ops = int(b["coalesced_ops"]) - int(a["coalesced_ops"])
        return f"{f} flushes, mean {ops / max(f, 1):.1f} verbs per flush"

    put_lat = [x for c in clients for x in c.put_lat]
    get_lat = [x for c in clients for x in c.get_lat]
    n_gets = nconn * verbs * VERB
    log("wire", f"fill: {WIRE_FILL} pages over the wire by {nconn} "
        f"connections in {t_fill:.3f} s = {WIRE_FILL / t_fill:.0f} pages/s; "
        f"put_pages verb of {VERB} pages: {percentiles_ms(put_lat)}; "
        f"{flushes({'flushes': 0, 'coalesced_ops': 0}, s_fill)} ({smi})")
    log("wire", f"storm: {n_gets} GET keys in {t_storm:.3f} s = "
        f"{n_gets / t_storm:.0f} keys/s; get_pages verb of {VERB} keys: "
        f"{percentiles_ms(get_lat)}; {flushes(s0, s_storm)} ({smi})")
    log("wire", f"GET phases {n_phases}, padded widths "
        f"{min(phases)}..{max(phases)}, mean {sum(phases) / n_phases:.0f}; "
        f"fused_get_linear_flat launches {launches} ({smi})")
    log("wire", f"fast lane: directory pull by {WIRE_FAST_CONNS} "
        f"connections in {t_pull:.3f} s ({n_dir} entries each); read 1: "
        f"{p1[1]} keys in {p1[0]:.3f} s = {p1[1] / p1[0]:.0f} keys/s, "
        f"{p1[2]} hits; read 2 after {len(rw)} rewrites: {p2[1] / p2[0]:.0f}"
        f" keys/s; read 3 after {len(gone)} invalidates: "
        f"{p3[1] / p3[0]:.0f} keys/s; server fastpath_hits {fp[0]}, "
        f"fastpath_stale {fp[1]} of {lanes} fast lanes ({smi})")
    log("wire", f"checks passed: {acked} acknowledged keys missed <= "
        f"evictions {s['evictions']} + drops {s['drops']}; hits {s['hits']},"
        f" misses {s['misses']} == sum of causes; {negatives} mirror "
        f"negatives; never-inserted GETs short-circuited {never - asked} of "
        f"{never} = {short:.2%}; no serve error, NACK or disconnect; "
        f"recovering batch of {VERB}: {d_rec['miss_recovering']} "
        f"miss_recovering, "
        f"{d_rec['miss_evicted']} miss_evicted (sketch), 0 miss_cold; "
        f"extents: {WIRE_EXTENTS} over the wire, {n_found} of {n_inrun} "
        f"in-run probes found, every address exact; fast reads served no "
        f"old byte")

    # directory and fast-view costs at the phase's end state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = kv.directory_snapshot(max_entries=4 * WIRE_INDEX["capacity"])
    t_snap = (time.perf_counter() - t0) * 1e3
    kv.bump_dir_epoch()
    t0 = time.perf_counter()
    fv = kv.fast_view()
    t_fv = (time.perf_counter() - t0) * 1e3
    m = min(VERB, len(snap["rows"]))
    t0 = time.perf_counter()
    ok, hit, _ = fv.read(fv.epoch, snap["shards"][:m], snap["rows"][:m],
                         snap["digs"][:m])
    t_read = (time.perf_counter() - t0) * 1e3
    from pmdfc_tpu_torch.ops.pagepool import page_digest_np

    if not ok.all() or not np.array_equal(page_digest_np(hit),
                                          snap["digs"][:m]):
        raise AssertionError("wire: FastView.read of a fresh directory "
                             "refused a lane or served other bytes")
    log("wire", f"directory_snapshot: {len(snap['keys'])} entries in "
        f"{t_snap:.3f} ms; fast_view() after a mutation {t_fv:.4f} ms; "
        f"FastView.read of {m} lanes {t_read:.3f} ms ({smi})")

    # kernel against plain at the smallest and largest widths the phase
    # launched, and the kernel's times at the largest
    present = torch.from_numpy(direct_present.astype(np.int64)).to(sm.dev)

    def batch(w):
        n_never = w // 8
        keys = torch.cat([
            sm.keys_of(DIRECT_HI, sm.pick(present, w - 2 * n_never)),
            sm.keys_of(DIRECT_HI, torch.randint(
                NEVER_LO, 1 << 32, (n_never,), device=sm.dev,
                generator=sm.gen)),
            sm.keys_of(DIRECT_HI, torch.from_numpy(evicted[:n_never].astype(
                np.int64)).to(sm.dev)) if len(evicted) >= n_never else
            torch.full((n_never, 2), -1, dtype=torch.int32, device=sm.dev)])
        return keys[torch.randperm(w, device=sm.dev, generator=sm.gen)]

    wmax = max(phases)
    for w in sorted({min(phases), wmax}):
        causes, _ = sm.compare(batch(w), kv.state, f"wire w={w}")
        log("kernel", f"wire full w={w}: kernel == plain, causes "
            f"{CAUSE_NAMES}={causes}")
    args, kw = sm.kernel_args(kv.state)
    batches = [batch(wmax) for _ in range(4)]
    s_ = kv.state.index.table.shape[1] // 4
    nbytes = [fused.fused_get_bytes(
        sm.compare(k, kv.state, "wire timed")[0], wmax, s_, pw,
        kv.state.evicted_filter.numel()) for k in batches]
    ms = time_ms(torch, [lambda k=k: fused.fused_get(k, *args, **kw)
                         for k in batches], 24, device_only=True)
    plain_ms = time_ms(torch, [lambda k=k: fused.get_core_reference(
        k, *args, **kw) for k in batches], 4, device_only=True)
    bound_ms = sum(nbytes) / len(nbytes) / HBM_BYTES_PER_S * 1e3
    log("times", f"fused_get_linear_flat w={wmax} (the wire's widest GET "
        f"phase), rotated over {len(batches)} batches: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms = "
        f"{bound_ms / ms:.1%} of the memory rate ({smi})")
    entry = {
        "name": "fused_get_linear_flat",
        "route": "cuda",
        "source": "pmdfc_tpu_torch/ops/csrc/fused_get.cu",
        "replaces": "pmdfc_tpu/ops/fused.py:414",
        "launches": launches,
        "max_abs_err": sm.max_err["fused_get_linear_flat"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "path": "wire",
    }
    del kv, shared, srv, st, snap, fv
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    run_onesided(sm)
    return entry


def run_onesided(sm: Smoke) -> None:
    """The one-sided sub-phase: a PassivePool of POOL_ROWS rows on the card
    behind `PoolServer`; POOL_CLIENTS `OneSidedBackend`s, each over its own
    `RemotePool` and grant, write POOL_PAGES pages in VERB-page verbs in
    parallel and read them back byte-exact."""
    np, torch = sm.np, sm.torch
    from pmdfc_tpu_torch.onesided import OneSidedBackend, PassivePool
    from pmdfc_tpu_torch.runtime.net import PoolServer, RemotePool

    smi = nvidia_smi()
    pool = PassivePool(num_rows=POOL_ROWS, device=DEVICE)
    pw = pool.page_words
    log("onesided", f"PassivePool on {pool.device}: {POOL_ROWS} rows = "
        f"{POOL_ROWS * pw * 4 / 2**30:.2f} GiB behind PoolServer; "
        f"{POOL_CLIENTS} OneSidedBackends over RemotePool, {POOL_PAGES} "
        f"pages each in {VERB}-page verbs")
    with PoolServer(pool).start() as srv:
        remotes = [RemotePool("127.0.0.1", srv.port, page_words=pw,
                              keepalive_s=None, op_timeout_s=120.0)
                   for _ in range(POOL_CLIENTS)]
        bes = [OneSidedBackend(r, grant=r.grant(POOL_PAGES))
               for r in remotes]
        keys = [np.stack([np.full(POOL_PAGES, i, np.uint32),
                          np.arange(POOL_PAGES, dtype=np.uint32)], -1)
                for i in range(POOL_CLIENTS)]

        def write(i):
            for j in range(0, POOL_PAGES, VERB):
                k = keys[i][j:j + VERB]
                bes[i].put(k, pages_np(k[:, 0], k[:, 1], pw))

        def read(i):
            for j in range(0, POOL_PAGES, VERB):
                k = keys[i][j:j + VERB]
                out, found = bes[i].get(k)
                if not found.all() or not np.array_equal(
                        out, pages_np(k[:, 0], k[:, 1], pw)):
                    raise AssertionError(f"one-sided client {i}: a row read "
                                         "back wrong bytes")

        n = POOL_CLIENTS * POOL_PAGES
        t_w = run_threads([lambda i=i: write(i)
                           for i in range(POOL_CLIENTS)], "one-sided write")
        t_r = run_threads([lambda i=i: read(i)
                           for i in range(POOL_CLIENTS)], "one-sided read")
        for r in remotes:
            r.close()
        ps = pool.stats()
    if ps["writes"] != n or ps["reads"] != n:
        raise AssertionError(f"one-sided: pool counted {ps}")
    log("onesided", f"write {n} rows in {t_w:.3f} s = {n / t_w:.0f} rows/s; "
        f"read back byte-exact in {t_r:.3f} s = {n / t_r:.0f} rows/s; pool "
        f"{ps} ({smi})")
    del pool
    torch.cuda.empty_cache()


def fleet_dir():
    """Where the fleet's snapshots and journals go: `build/fleet` under the
    checkout (git-ignored, on the checkout's disk)."""
    from pathlib import Path

    return Path(__file__).resolve().parent / "build" / "fleet"


def disk_of(path) -> tuple[str, int]:
    """(filesystem type, free bytes) of the mount holding `path`."""
    import os

    path = os.path.realpath(path)
    fs, best = "unknown", ""
    with open("/proc/mounts") as f:
        for line in f:
            _, mnt, kind = line.split()[:3]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) > len(best):
                fs, best = kind, mnt
    st = os.statvfs(path)
    return fs, st.f_bavail * st.f_frsize


class RssPeak:
    """Peak resident set of this process while the block runs, sampled
    every 5 ms from /proc/self/statm (`ru_maxrss` is the whole life's)."""

    def __enter__(self):
        import os
        import threading

        self._page = os.sysconf("SC_PAGE_SIZE")
        self.peak = self._rss()
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._run, daemon=True)
        self._th.start()
        return self

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _run(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._th.join()
        self.peak = max(self.peak, self._rss())


class Fleet:
    """The fleet phase's cluster: FLEET_NODES crashbox children, each a
    journal-attached `KV` behind `NetServer(NetConfig())` on loopback, and
    one `ReplicaGroup` over a `ReconnectingClient(TcpBackend)` per node
    whose factory follows the node's current port.

    Key index i is the key (FLEET_HI, i); `status[i]`: 0 never put, 1
    acknowledged, 2 invalidated; `stage[i]`: which put stage wrote it (1
    fill, 2 before the delta, 3 the journal tail, 4 while the node was
    down)."""

    def __init__(self, sm: Smoke, cfg, root):
        from pmdfc_tpu_torch.config import JournalConfig
        from pmdfc_tpu_torch.models.base import get_index_ops

        np = sm.np
        self.sm, self.np, self.cfg, self.root = sm, np, cfg, root
        self.pw = cfg.page_words
        self.n_slots = get_index_ops(cfg.index.kind).num_slots(cfg.index)
        self.jcfg = JournalConfig(**FLEET_JOURNAL)
        self.n_keys = (FLEET_FILL + FLEET_DELTA + FLEET_TAIL
                       + FLEET_DOWN_PUT)
        self.status = np.zeros(self.n_keys, np.int8)
        self.stage = np.zeros(self.n_keys, np.int8)
        self.next_key = 0
        self.rng = np.random.default_rng([sm.seed, 9])
        self.boxes: list = [None] * FLEET_NODES
        self.ports = [0] * FLEET_NODES
        self.hello: list = [None] * FLEET_NODES
        self.past: list = [[] for _ in range(FLEET_NODES)]  # dead nodes'
        self.group = None
        self.eps: list = []
        self.lat: dict[str, list[float]] = {}

    # -- nodes --------------------------------------------------------------
    def wal(self, i: int) -> str:
        return str(self.root / f"wal{i}")

    def start_node(self, i: int, chain=()) -> float:
        """Spawn node i (a warm restart from `chain` if given) -> seconds
        from spawn to serving."""
        from pmdfc_tpu_torch.tools.crashbox import Crashbox

        box = Crashbox(self.cfg, self.wal(i), self.jcfg, chain_paths=chain,
                       start_timeout_s=FLEET_START_S, device=DEVICE)
        t0 = time.monotonic()
        self.hello[i] = box.start()
        dt = time.monotonic() - t0
        if not self.hello[i]["device"].startswith(DEVICE):
            raise AssertionError(f"fleet: node {i} serves on "
                                 f"{self.hello[i]['device']}, not {DEVICE}")
        self.boxes[i], self.ports[i] = box, box.port
        return dt

    def start(self) -> float:
        """All nodes in parallel, then the group -> seconds."""
        from pmdfc_tpu_torch.client.replica import ReplicaGroup
        from pmdfc_tpu_torch.config import ReplicaConfig
        from pmdfc_tpu_torch.runtime.failure import ReconnectingClient
        from pmdfc_tpu_torch.runtime.net import TcpBackend

        t = run_threads([lambda i=i: self.start_node(i)
                         for i in range(FLEET_NODES)], "fleet start")

        def factory(i):
            # keepalives (the default period) hold a connection idle
            # through a snapshot past the server's idle timeout
            return lambda: TcpBackend("127.0.0.1", self.ports[i],
                                      page_words=self.pw, op_timeout_s=120.0)

        self.eps = [ReconnectingClient(factory(i), page_words=self.pw,
                                       seed=self.sm.seed * 31 + i)
                    for i in range(FLEET_NODES)]
        # connect each endpoint before the threads share it: a client
        # still connecting drops the ops that arrive meanwhile (legal, but
        # then a put reaches fewer replicas than the group counted)
        for i, ep in enumerate(self.eps):
            ep.recovery_info()
            if not ep.connected:
                raise AssertionError(f"fleet: node {i} refused the client")
        self.group = ReplicaGroup(
            self.eps, page_words=self.pw,
            cfg=ReplicaConfig(n_replicas=FLEET_NODES, repair_interval_s=0),
            seed=self.sm.seed)
        return t

    def close(self) -> None:
        if self.group is not None:
            self.group.close()
        for box in self.boxes:
            if box is not None and box.alive():
                box.kill()

    # -- keys ---------------------------------------------------------------
    def keys(self, idx):
        np = self.np
        idx = np.asarray(idx, np.uint32)
        return np.stack([np.full(len(idx), FLEET_HI, np.uint32), idx], -1)

    def pages(self, idx):
        return pages_np(FLEET_HI, idx, self.pw)

    def owned(self, i: int):
        """Bool mask over every key index: the ring gives it to node i."""
        own = self.group.ring.owners_np(
            self.keys(self.np.arange(self.n_keys)), self.group.cfg.rf)
        return (own == i).any(axis=1)

    # -- traffic through the group -------------------------------------------
    def _verbs(self, idx):
        return [idx[j:j + VERB] for j in range(0, len(idx), VERB)]

    def put(self, n: int, stage: int, label: str) -> float:
        """Put the next n keys in VERB-key verbs over FLEET_THREADS threads
        -> wall seconds."""
        np = self.np
        idx = np.arange(self.next_key, self.next_key + n, dtype=np.uint32)
        self.next_key += n
        verbs = self._verbs(idx)
        lat = self.lat.setdefault(label, [])

        def worker(t):
            for v in verbs[t::FLEET_THREADS]:
                t0 = time.perf_counter()
                self.group.put(self.keys(v), self.pages(v))
                lat.append(time.perf_counter() - t0)

        wall = run_threads([lambda t=t: worker(t)
                            for t in range(min(FLEET_THREADS, len(verbs)))],
                           f"fleet {label}")
        self.status[idx] = 1
        self.stage[idx] = stage
        return wall

    def no_drops(self, nodes, label: str) -> None:
        """No client of a live node dropped a put or an invalidate."""
        for i in nodes:
            st = self.eps[i].stats()
            if st["dropped_puts"] or st.get("failed_invalidates", 0):
                raise AssertionError(
                    f"fleet {label}: node {i}'s client dropped "
                    f"{st['dropped_puts']} puts, "
                    f"{st.get('failed_invalidates', 0)} invalidates")

    def invalidate(self, n: int, among) -> "object":
        """Invalidate n acknowledged keys drawn from the index mask `among`
        -> their indices."""
        np = self.np
        pool = np.flatnonzero(among & (self.status == 1))
        idx = np.sort(self.rng.choice(pool, n, replace=False)).astype(
            np.uint32)
        for v in self._verbs(idx):
            self.group.invalidate(self.keys(v))
        self.status[idx] = 2
        return idx

    def storm(self, n: int, label: str) -> float:
        """n GET keys through the group over FLEET_THREADS threads, each
        VERB-key verb 3/4 acknowledged, 1/8 invalidated and 1/8 never-put
        keys: every acknowledged key hits byte-exact (failover serves a
        dead node's share), every other key misses with a zeroed page.
        -> wall seconds."""
        np = self.np
        present = np.flatnonzero(self.status == 1)
        gone = np.flatnonzero(self.status == 2)
        k8 = VERB // 8
        verbs = []
        for _ in range(max(1, n // VERB)):
            lo = np.concatenate([
                self.rng.choice(present, VERB - 2 * k8),
                self.rng.choice(gone, k8),
                self.rng.integers(NEVER_LO, 1 << 32, k8,
                                  dtype=np.uint64)]).astype(np.uint32)
            verbs.append(self.rng.permutation(lo))
        lat = self.lat.setdefault(label, [])
        bad: list[str] = []

        def worker(t):
            for lo in verbs[t::FLEET_THREADS]:
                t0 = time.perf_counter()
                out, found = self.group.get(self.keys(lo))
                lat.append(time.perf_counter() - t0)
                want = np.zeros(len(lo), bool)
                inside = lo < self.n_keys
                want[inside] = self.status[lo[inside]] == 1
                if not np.array_equal(found, want):
                    bad.append(f"{int((found & ~want).sum())} keys hit that "
                               f"must miss, {int((want & ~found).sum())} "
                               "acknowledged keys missed: "
                               + self.explain(lo[found != want]))
                elif not np.array_equal(out[found], self.pages(lo[found])):
                    bad.append("a hit returned wrong bytes")
                elif out[~found].any():
                    bad.append("a miss returned nonzero bytes")

        wall = run_threads([lambda t=t: worker(t)
                            for t in range(min(FLEET_THREADS, len(verbs)))],
                           f"fleet {label}")
        if bad:
            raise AssertionError(f"fleet {label}: {bad[0]}")
        return wall

    def explain(self, idx) -> str:
        """Where up to 4 keys live: their status, stage and owners, and
        which live owner holds them."""
        idx = idx[:4]
        own = self.group.ring.owners_np(self.keys(idx), self.group.cfg.rf)
        held = {i: self.node_get(i, idx)[1] for i in range(FLEET_NODES)
                if self.boxes[i] is not None and self.boxes[i].alive()}
        return "; ".join(
            f"key {k}: status {self.status[k]}, stage {self.stage[k]}, "
            f"owners {own[j].tolist()}, held by "
            f"{[i for i, f in held.items() if f[j]]}"
            for j, k in enumerate(idx.tolist()))

    # -- one node, directly ---------------------------------------------------
    def node_get(self, i: int, idx):
        """GET key indices from node i over its own TcpBackend -> (pages,
        found); every hit byte-exact."""
        from pmdfc_tpu_torch.runtime.net import TcpBackend

        np = self.np
        out = np.zeros((len(idx), self.pw), np.uint32)
        found = np.zeros(len(idx), bool)
        with TcpBackend("127.0.0.1", self.ports[i], page_words=self.pw,
                        op_timeout_s=120.0) as be:
            for j in range(0, len(idx), VERB):
                o, f = be.get(self.keys(idx[j:j + VERB]))
                out[j:j + VERB], found[j:j + VERB] = o, f
        if not np.array_equal(out[found], self.pages(idx[found])):
            raise AssertionError(f"fleet: node {i} served wrong bytes")
        return out, found

    def serving(self, i: int) -> dict:
        """Node i's serving counters; holds its checks: no serve error, no
        contained phase failure, one fused-GET launch per GET phase (the
        plain version runs on the CPU: none there)."""
        sv = self.boxes[i].serving()
        srv = sv["server"]
        if int(srv["serve_errors"]):
            raise AssertionError(f"fleet: node {i} serve_errors "
                                 f"{srv['serve_errors']}")
        contained = {k: srv[k] for k in ("nacks_sent", "bisect_failures",
                                         "poison_ops", "deadline_shed")}
        if any(int(v) for v in contained.values()):
            raise AssertionError(f"fleet: node {i}: a phase failed: "
                                 f"{contained}")
        launches = int(sv["launches"].get("fused_get_linear_flat", 0))
        want = len(sv["get_phases"]) if DEVICE != "cpu" else 0
        if launches != want or not sv["get_phases"]:
            raise AssertionError(
                f"fleet: node {i}: {launches} fused-GET launches for "
                f"{len(sv['get_phases'])} GET phases")
        return sv


def fleet_check_restart(fleet: Fleet, i: int, killed_stage: int,
                        gone_before) -> tuple[int, int]:
    """Node i right after its warm restart, before the group reaches it:
    every key the ring gives it that was acknowledged before the kill and
    not invalidated hits byte-exact, losses within the journal's RPO bound
    (`(rpo_ops + 1) x VERB`); keys invalidated before the kill miss; it is
    `recovering` and the misses of keys put while it was down count as
    `miss_recovering`, with `misses == Σ miss_*`. -> (lost, asked)."""
    np, sm = fleet.np, fleet.sm
    own = fleet.owned(i)
    before = np.flatnonzero(own & (fleet.status == 1)
                            & (fleet.stage <= killed_stage)
                            & (fleet.stage > 0))
    _, found = fleet.node_get(i, before)
    lost = int((~found).sum())
    bound = (fleet.jcfg.rpo_ops + 1) * VERB
    if lost > bound:
        raise AssertionError(f"fleet: node {i} lost {lost} acknowledged keys "
                             f"in the crash, more than the RPO bound {bound}")
    inv = gone_before[own[gone_before]]
    if fleet.node_get(i, inv)[1].any():
        raise AssertionError(f"fleet: node {i} serves a key invalidated "
                             "before the kill")
    info = fleet.boxes[i].recovery_info()
    if info.get("recovering") is not True:
        raise AssertionError(f"fleet: node {i} is not recovering: {info}")
    down = np.flatnonzero(own & (fleet.stage == killed_stage + 1))
    s0 = fleet.boxes[i].stats()
    got = fleet.node_get(i, down)[1]
    s1 = fleet.boxes[i].stats()
    d = {k: s1[k] - s0[k] for k in sm.kv_mod.STAT_NAMES}
    if got.any() or d["miss_recovering"] != len(down) or d["miss_cold"]:
        raise AssertionError(f"fleet: node {i}: keys put while it was down: "
                             f"{int(got.sum())} hit, causes {d}")
    if s1["misses"] != sum(s1[c] for c in sm.kv_mod.MISS_CAUSE_NAMES):
        raise AssertionError(f"fleet: node {i}: misses != sum of causes")
    return lost, len(before)


def fleet_check_rejoined(fleet: Fleet, i: int, gone, fp_keys) -> int:
    """Node i after the rejoin: every key the ring gives it, acknowledged
    and not invalidated, hits byte-exact (those put while it was down
    came by repair; a key its bloom claimed falsely, `fp_keys`, is the
    one legal miss), and no invalidated key is served by it or by the
    group. -> keys checked."""
    np = fleet.np
    own = fleet.owned(i)
    live = np.flatnonzero(own & (fleet.status == 1))
    _, found = fleet.node_get(i, live)
    missed = live[~found]
    if len(np.setdiff1d(missed, fp_keys)):
        raise AssertionError(
            f"fleet: node {i} misses {len(missed)} acknowledged keys after "
            f"the rejoin ({len(np.setdiff1d(missed, fp_keys))} not bloom "
            "false positives)")
    if fleet.node_get(i, gone[own[gone]])[1].any():
        raise AssertionError(f"fleet: node {i} served an invalidated key "
                             "after the rejoin")
    for v in fleet._verbs(gone):
        if fleet.group.get(fleet.keys(v))[1].any():
            raise AssertionError("fleet: the group served an invalidated "
                                 "key after the rejoin")
    return len(live)


def run_fleet(sm: Smoke):
    """The fleet phase (9): three crashbox nodes at linear·flat's serving
    configuration (2 GiB pools, all three on the one card) behind a
    `ReplicaGroup`; node FLEET_CRASH is snapshotted (a full, a delta),
    killed with SIGKILL, warm restarted from its chain and journal, and
    rejoined; its final chain is restored in this process. -> the fleet's
    kernel entry."""
    import shutil

    from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, KVConfig

    cfg = KVConfig(index=IndexConfig(**FLEET_INDEX),
                   bloom=BloomConfig(num_bits=FLEET_BLOOM_BITS))
    root = fleet_dir()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    fs, free = disk_of(root)
    log("env", f"fleet directory {root}: filesystem {fs}, {free} bytes free")
    if fs == "tmpfs" or free < FLEET_DISK_BYTES:
        raise AssertionError(f"fleet: {root} is {fs} with {free} bytes free; "
                             f"the phase needs a disk with {FLEET_DISK_BYTES}")
    try:
        return fleet_run(sm, cfg, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def fleet_run(sm: Smoke, cfg, root):
    """`run_fleet`'s steps, in the fleet directory `root`."""
    import os
    import resource

    np, torch, fused = sm.np, sm.torch, sm.fused
    from pmdfc_tpu_torch import checkpoint
    from pmdfc_tpu_torch.utils.hashing_np import query_packed_np

    smi = nvidia_smi()
    c = FLEET_CRASH
    fleet = Fleet(sm, cfg, root)
    full, d1, d2 = (str(root / f) for f in ("full.npz", "d1.npz", "d2.npz"))
    try:
        t_start = fleet.start()
        g = fleet.group
        log("fleet", f"{FLEET_NODES} nodes on {DEVICE} started in "
            f"{t_start:.3f} s: each KV(IndexConfig(**{FLEET_INDEX}), "
            f"BloomConfig(num_bits={FLEET_BLOOM_BITS})), a pool of "
            f"{fleet.n_slots} pages = {fleet.n_slots * fleet.pw * 4 / 2**30:.2f}"
            f" GiB, {fleet.jcfg}, NetServer(NetConfig()); ReplicaGroup "
            f"rf {g.cfg.rf}, hedge_ms {g.cfg.hedge_ms}, ring on, repair by "
            f"manual ticks; {FLEET_THREADS} client threads, {VERB}-key verbs")

        # 3. fill and chain
        t = fleet.put(FLEET_FILL, 1, "fill")
        log("fleet", f"fill: {FLEET_FILL} keys through the group in {t:.3f} s"
            f" = {FLEET_FILL / t:.0f} keys/s ({g.cfg.rf * FLEET_FILL / t:.0f} "
            f"pages/s written); put verb {percentiles_ms(fleet.lat['fill'])}"
            f" ({smi})")
        snaps = {}
        for name, path, delta, n, stage in (("full", full, False, FLEET_DELTA,
                                             2),
                                            ("delta", d1, True, FLEET_TAIL, 3)):
            r = fleet.boxes[c].snapshot(path, delta=delta)
            if r["kind"] != name:
                raise AssertionError(f"fleet: the {name} snapshot came out "
                                     f"a {r['kind']}")
            size = os.path.getsize(path)
            snaps[name] = r
            log("fleet", f"node {c} {name} snapshot: {size} bytes in "
                f"{r['seconds']:.3f} s = {size / r['seconds'] / 1e9:.3f} GB/s"
                f", dirty rows {r['dirty_rows']} of {r['total_rows']}, seq "
                f"{r['seq']}; the child's peak RSS {r['peak_rss_bytes']} "
                f"bytes ({smi})")
            t = fleet.put(n, stage, f"put {name}")
        gone_before = fleet.invalidate(FLEET_INVAL,
                                       fleet.stage == 1)
        t = fleet.storm(FLEET_STORM, "storm")
        log("fleet", f"after {FLEET_DELTA} + {FLEET_TAIL} more puts and "
            f"{FLEET_INVAL} invalidates: storm of {FLEET_STORM} GET keys in "
            f"{t:.3f} s = {FLEET_STORM / t:.0f} keys/s; get verb "
            f"{percentiles_ms(fleet.lat['storm'])}; every hit byte-exact "
            f"({smi})")

        # 4. crash, with traffic paused between acknowledged verbs
        sv = [fleet.serving(i) for i in range(FLEET_NODES)]
        fleet.no_drops(range(FLEET_NODES), "before the kill")
        time.sleep(max(0.2, 2 * fleet.jcfg.rpo_ms / 1e3))
        fleet.past[c].append(sv[c])
        fleet.boxes[c].kill()
        if fleet.boxes[c].alive():
            raise AssertionError(f"fleet: node {c} survived SIGKILL")
        t = fleet.put(FLEET_DOWN_PUT, 4, "put down")
        gone_during = fleet.invalidate(FLEET_DOWN_INVAL, fleet.stage <= 3)
        t_storm = fleet.storm(FLEET_STORM, "storm down")
        fleet.no_drops([i for i in range(FLEET_NODES) if i != c],
                       "while a node is down")
        # open, or half-open once its cooldown has run out (reading
        # `state` moves it there): never closed while the node is down
        br = g.breakers[c]
        if br.stats["opens"] < 1 or br.state == "closed":
            raise AssertionError(f"fleet: node {c}'s breaker never opened "
                                 f"while it was down ({br.state}, "
                                 f"{dict(br.stats)})")
        log("fleet", f"node {c} killed (SIGKILL); while down: "
            f"{FLEET_DOWN_PUT} puts in {t:.3f} s = {FLEET_DOWN_PUT / t:.0f} "
            f"keys/s, put verb {percentiles_ms(fleet.lat['put down'])}; "
            f"{FLEET_DOWN_INVAL} invalidates; storm of {FLEET_STORM} keys in "
            f"{t_storm:.3f} s = {FLEET_STORM / t_storm:.0f} keys/s, get verb "
            f"{percentiles_ms(fleet.lat['storm down'])}; every acknowledged "
            f"key served byte-exact by failover; breaker {c} opened "
            f"({dict(br.stats)}) ({smi})")

        # 5. warm restart
        t_rec = fleet.start_node(c, chain=[full, d1])
        h = fleet.hello[c]
        rep = h["replay"]
        tm = rep["timings_s"]
        lost, asked = fleet_check_restart(fleet, c, 3, gone_before)
        log("fleet", f"node {c} warm restart: spawn to serving {t_rec:.3f} s;"
            f" in the child {h['restore_s']:.3f} s = chain read and verify "
            f"{tm['read']:.3f} + fold {tm['fold']:.3f} + to the device "
            f"{tm['to_device']:.3f} + recovery() {tm['recovery']:.3f} + "
            f"replay {tm['replay']:.3f} s (+ KV and journal set-up); replay: "
            f"{rep['records']} records, {rep['puts']} puts, {rep['deletes']} "
            f"deletes, {rep['pages']} pages, {rep['truncated_bytes']} bytes "
            f"truncated; peak RSS {h['peak_rss_bytes']} bytes; {lost} of "
            f"{asked} acknowledged keys it owns lost; recovering, cold "
            f"misses counted as miss_recovering ({smi})")

        # 6. rejoin: the breaker closes, repair drains, mark_recovered
        probe = fleet.keys(np.flatnonzero(fleet.status == 1)[:VERB])
        deadline = time.monotonic() + 120.0
        while g.breakers[c].state != "closed":
            if time.monotonic() > deadline:
                raise AssertionError(f"fleet: node {c}'s breaker never "
                                     "closed after the restart")
            g.get(probe)
            time.sleep(0.05)
        bloom = fleet.eps[c].packed_bloom()
        down = np.flatnonzero(fleet.owned(c) & (fleet.stage == 4)
                              & (fleet.status == 1))
        fp = down[query_packed_np(bloom, fleet.keys(down),
                                  cfg.bloom.num_hashes)]
        p0, t0 = g.counters["repair_pages"], time.monotonic()
        while True:
            g.repair_tick()
            if not g._repair_pending:
                break
            if time.monotonic() - t0 > FLEET_REPAIR_S:
                raise AssertionError("fleet: the repair backlog never "
                                     "drained")
        t_rep = time.monotonic() - t0
        repaired = g.counters["repair_pages"] - p0
        info = fleet.boxes[c].recovery_info()
        if g.counters["recoveries_completed"] != 1 or info["recovering"]:
            raise AssertionError(
                f"fleet: recoveries_completed "
                f"{g.counters['recoveries_completed']}, node {c} {info}")
        gone = np.concatenate([gone_before, gone_during])
        n_live = fleet_check_rejoined(fleet, c, gone, fp)
        log("fleet", f"rejoin: breaker closed; repair drained {repaired} "
            f"pages in {t_rep:.3f} s = {repaired / max(t_rep, 1e-9):.0f} "
            f"pages/s ({g.counters['repair_rounds']} rounds); "
            f"recoveries_completed 1, node {c} left recovering; it serves "
            f"all {n_live} acknowledged keys it owns byte-exact ({len(fp)} "
            f"bloom false positives among the keys put while it was down) "
            f"and none of the {len(gone)} invalidated ({smi})")

        # 7. one more delta, stop, restore the chain in this process
        r = fleet.boxes[c].snapshot(d2, delta=True)
        if r["kind"] != "delta" or r["seq"] != 2:
            raise AssertionError(f"fleet: the last delta is {r}")
        sv = [fleet.serving(i) for i in range(FLEET_NODES)]
        grp = dict(g.counters)
        for k in ("corrupt_pages", "load_shed_puts", "load_shed_gets",
                  "miss_digest"):
            if grp[k]:
                raise AssertionError(f"fleet: group {k} {grp[k]}")
        for i in range(FLEET_NODES):
            for when, x in [("before the kill", p) for p in fleet.past[i]] \
                    + [("", sv[i])]:
                j = x["journal"]
                log("fleet", f"node {i}{' ' + when if when else ''}: journal "
                    f"appends {j['appends']}, syncs {j['syncs']}, "
                    f"fsync_lag_ms {j['fsync_lag_ms']:.3f}, rotations "
                    f"{j['rotations']}; GET phases {len(x['get_phases'])}, "
                    f"fused launches "
                    f"{x['launches'].get('fused_get_linear_flat', 0)}; peak "
                    f"RSS {x['peak_rss_bytes']} bytes ({smi})")
        launches = sum(int(x["launches"].get("fused_get_linear_flat", 0))
                       for x in sv + fleet.past[c])
        log("fleet", f"group counters {json.dumps(grp)}")
        for box in fleet.boxes:
            box.stop()
    finally:
        fleet.close()

    with RssPeak() as rss:
        t0 = time.monotonic()
        state = checkpoint.load_chain([full, d1, d2], cfg, device=DEVICE)
        torch.cuda.synchronize()
        t_load = time.monotonic() - t0
    kv = sm.kv_mod.KV(cfg, state=state, device=DEVICE)
    own = fleet.owned(c)
    live = np.flatnonzero(own & (fleet.status == 1))
    gone_own = np.flatnonzero(own & (fleet.status == 2))
    for idx, hit in ((live, True), (gone_own, False)):
        for j in range(0, len(idx), GET_B):
            keys = sm.u32.from_numpy(fleet.keys(idx[j:j + GET_B]), sm.dev)
            out, found = kv.get(keys)
            if hit:
                ok = found | torch.from_numpy(np.isin(
                    idx[j:j + GET_B], fp)).to(sm.dev)
                if not bool(ok.all()) or not torch.equal(
                        out[found], sm.pages_of(keys[found], fleet.pw)):
                    raise AssertionError("fleet: the restored chain lost or "
                                         "changed a page")
            elif bool(found.any()):
                raise AssertionError("fleet: the restored chain serves an "
                                     "invalidated key")
    log("fleet", f"in-process restore of node {c}'s chain (full + 2 deltas) "
        f"onto {kv.device}: {t_load:.3f} s, peak RSS of this process during "
        f"it {rss.peak} bytes (lifetime peak "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}); all "
        f"{len(live)} acknowledged keys it owns hit byte-exact, its "
        f"{len(gone_own)} invalidated keys miss ({smi})")

    # kernel against plain on the restored 2 GiB state, and its times
    present = sm.u32.from_numpy(fleet.keys(live[:4096]), sm.dev)
    never = sm.keys_of(FLEET_HI, torch.randint(
        NEVER_LO, 1 << 32, (1024,), device=sm.dev, generator=sm.gen))
    pool = torch.cat([sm.u32.from_numpy(fleet.keys(live), sm.dev), never,
                      torch.full((64, 2), -1, dtype=torch.int32,
                                 device=sm.dev)])
    covers = sm.add_extents(kv, 4)
    # no key was ever evicted in the fleet: every other cause occurs
    sm.kernel_phase(kv, pool, present, covers, "fleet restored",
                    need=(0, 1, 2, 4, 7))
    st = kv.state
    args, kw = sm.kernel_args(st)
    batches = [sm.pick(pool, GET_B) for _ in range(8)]
    s_ = st.index.table.shape[1] // 4
    nbytes = [fused.fused_get_bytes(sm.compare(k, st, "fleet timed")[0],
                                    GET_B, s_, fleet.pw,
                                    st.evicted_filter.numel())
              for k in batches]
    ms = time_ms(torch, [lambda k=k: fused.fused_get(k, *args, **kw)
                         for k in batches], 48, device_only=True)
    plain_ms = time_ms(torch, [lambda k=k: fused.get_core_reference(
        k, *args, **kw) for k in batches], 8, device_only=True)
    bound_ms = sum(nbytes) / len(nbytes) / HBM_BYTES_PER_S * 1e3
    log("times", f"fused_get_linear_flat w={GET_B} on the restored fleet "
        f"node, rotated over {len(batches)} batches: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms = "
        f"{bound_ms / ms:.1%} of the memory rate ({smi})")
    return {
        "name": "fused_get_linear_flat",
        "route": "cuda",
        "source": "pmdfc_tpu_torch/ops/csrc/fused_get.cu",
        "replaces": "pmdfc_tpu/ops/fused.py:414",
        "launches": launches,
        "max_abs_err": sm.max_err["fused_get_linear_flat"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "path": "fleet",
    }


def plane_dir():
    """Where the plane's snapshots go: `build/plane` under the checkout
    (git-ignored, on the checkout's disk)."""
    from pathlib import Path

    return Path(__file__).resolve().parent / "build" / "plane"


class PlaneCounts:
    """What a `ShardedKV`'s plane verbs were asked in a window: routed ops
    (extent phases count one per shard, as the plane's `shard{i}_ops`
    counters do), GET phases with keys, their keys, and the widest
    per-shard width a GET phase ran. Wraps the instance's verbs."""

    def __init__(self, skv):
        import numpy as np

        self.ops = self.get_phases = self.get_keys = self.wl_max = 0
        n = skv.n_shards
        for name in ("plane_insert", "plane_get", "plane_delete",
                     "plane_get_extent", "insert_extent"):
            real = getattr(skv, name)

            def wrapped(*args, _real=real, _name=name):
                out = _real(*args)
                if _name == "insert_extent" or out.counts is None:
                    self.ops += n
                    if _name == "plane_get_extent":
                        # a GetExtent counts its keys as GETs (shard 0)
                        self.get_keys += out.b
                else:
                    c = np.asarray(out.counts)
                    self.ops += int(c.sum())
                    if _name == "plane_get" and out.b:
                        self.get_phases += 1
                        self.get_keys += out.b
                        self.wl_max = max(self.wl_max,
                                          skv._router.width(int(c.max())))
                return out

            setattr(skv, name, wrapped)


def shard_ops(be) -> int:
    return sum(int(c.value) for c in be._c_shard)


def plane_fill(skv, n: int, hi: int, plane: bool):
    """Pages (hi, i < n) put in PLANE_INS_B-key batches through
    `ShardedKV.insert` (a2a) or `plane_insert`. -> (seconds, drops reported
    by the inserts, rows past an a2a pair's capacity)."""
    import numpy as np

    from pmdfc_tpu_torch.parallel.partitioning import shard_of_np
    from pmdfc_tpu_torch.parallel.shard import pair_capacity

    pw = skv.config.page_words
    drops = overflow = 0
    t0 = time.monotonic()
    for i in range(0, n, PLANE_INS_B):
        lo = np.arange(i, min(i + PLANE_INS_B, n), dtype=np.uint32)
        his = np.full(len(lo), hi, np.uint32)
        keys = np.stack([his, lo], -1)
        if plane:
            res = skv.plane_insert(keys, pages_np(his, lo, pw)).fetch()
        else:
            res = skv.insert(keys, pages_np(his, lo, pw))
            # the rows no a2a bucket could take: each source's count per
            # destination past the pair capacity
            w = 16
            while w < len(lo):
                w <<= 1
            w += -w % skv.n_shards
            bl = w // skv.n_shards
            c = pair_capacity(bl, skv.n_shards)
            own = shard_of_np(keys, skv.n_shards)
            for s in range(skv.n_shards):
                per = np.bincount(own[s * bl:(s + 1) * bl],
                                  minlength=skv.n_shards)
                overflow += int(np.maximum(per - c, 0).sum())
        drops += int(np.asarray(res.dropped).sum())
    skv._sync()
    return time.monotonic() - t0, drops, overflow


def plane_held(skv, hi: int):
    """Sorted lo words of the keys (hi, .) every shard's index holds now
    (lane 0; a scan on each shard's device)."""
    import numpy as np

    from pmdfc_tpu_torch.models.base import get_index_ops
    from pmdfc_tpu_torch.utils import u32

    ops = get_index_ops(skv.config.index.kind)
    out = []
    with skv._lock:
        for st in skv.states:
            flat, _ = ops.scan(st.index)
            hit = flat[:, 0] == int(np.uint32(hi).view(np.int32))
            out.append(u32.to_numpy(flat[hit][:, 1]))
    return np.sort(np.concatenate(out))


def plane_checks(sm, skv, be, srv, clients, counts, launches_per_phase,
                 shard_ops0, stats0, label):
    """The plane's serving checks over one window, as the wire phase's:
    no serve error, no contained phase failure, no disconnect, `misses ==
    Σ miss_*` on stats() and on every shard's row of shard_report(), the
    shard{i}_ops counters sum to the routed ops, every GET key routed was
    counted once (a read-only GET's stats land once), and one fused-GET
    launch per shard (per lane) per GET phase."""
    fused = sm.fused
    health = dict(srv.stats)
    s = skv.stats()
    rep = skv.shard_report()["stats"]
    causes = sm.kv_mod.MISS_CAUSE_NAMES
    launches = fused.launches["fused_get_linear_flat"]
    disconnects = sum(c.rc.stats()["disconnects"] for c in clients)
    checks = [
        (int(health["serve_errors"]) == 0,
         f"serve_errors {health['serve_errors']}"),
        (all(int(health[k]) == 0 for k in ("nacks_sent", "bisect_failures",
                                           "poison_ops", "deadline_shed")),
         "a phase failed: " + str({k: health[k] for k in (
             "nacks_sent", "bisect_failures", "poison_ops",
             "deadline_shed")})),
        (disconnects == 0, f"{disconnects} client disconnects"),
        (s["misses"] == sum(s[c] for c in causes),
         "misses != sum of miss causes"),
        (all(rep["misses"][i] == sum(rep[c][i] for c in causes)
             for i in range(skv.n_shards)),
         "a shard's misses != the sum of its miss causes"),
        (shard_ops(be) - shard_ops0 == counts.ops,
         f"shard ops {shard_ops(be) - shard_ops0} != {counts.ops} routed"),
        (s["gets"] - stats0["gets"] == counts.get_keys,
         f"{s['gets'] - stats0['gets']} GETs counted for {counts.get_keys} "
         "GET keys routed"),
        (counts.get_phases > 0
         and launches == launches_per_phase * counts.get_phases,
         f"{launches} fused-GET launches for {counts.get_phases} GET phases "
         f"x {launches_per_phase}"),
    ]
    for ok, msg in checks:
        if not ok:
            raise AssertionError(f"{label}: {msg}")
    return launches


def plane_kernel(sm, state, present, pw: int, widths, label: str, smi,
                 hi: int = DIRECT_HI, timed: bool = True, batch=None):
    """Kernel against plain on one full state at each width (its keys (hi,
    present) and never-inserted ones, or the batches `batch(w)` draws),
    and with `timed` the kernel's times at each -> {w: (ms, plain_ms,
    bound_ms)}."""
    np, torch, fused = sm.np, sm.torch, sm.fused
    name = variant_of(state)
    if batch is None:
        present = torch.from_numpy(present.astype(np.int64)).to(sm.dev)

        def batch(w):
            n_never = max(1, w // 8)
            keys = torch.cat([
                sm.keys_of(hi, sm.pick(present, w - n_never)),
                sm.keys_of(hi, torch.randint(
                    NEVER_LO, 1 << 32, (n_never,), device=sm.dev,
                    generator=sm.gen))])
            return keys[torch.randperm(w, device=sm.dev, generator=sm.gen)]

    args, kw = sm.kernel_args(state)
    s_ = state.index.table.shape[1] // 4
    # a CCEH key reads its directory word first; a tiered key past the
    # generation gate its cold row's generation and live byte
    dirr = getattr(state.index, "dirr", None)
    dir_bytes = 0 if dirr is None else 4 * dirr.numel()
    out = {}
    for w in widths:
        causes, _ = sm.compare(batch(w), state, f"{label} w={w}")
        log("kernel", f"{label} full w={w}: kernel == plain, "
            f"causes {CAUSE_NAMES}={causes}")
        if not timed:
            continue
        batches = [batch(w) for _ in range(8)]
        nbytes = [fused.fused_get_bytes(
            *cmp[:1], w, s_, pw, state.evicted_filter.numel(), dir_bytes,
            cmp[1]) for cmp in (sm.compare(k, state, f"{label} timed")
                                for k in batches)]
        ms = time_ms(torch, [lambda k=k: fused.fused_get(k, *args, **kw)
                             for k in batches], 48, device_only=True)
        plain_ms = time_ms(torch, [lambda k=k: fused.get_core_reference(
            k, *args, **kw) for k in batches], 8, device_only=True)
        bound_ms = sum(nbytes) / len(nbytes) / HBM_BYTES_PER_S * 1e3
        log("times", f"{name} w={w} on {label}, "
            f"rotated over {len(batches)} batches: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms = "
            f"{bound_ms / ms:.1%} of the memory rate ({smi})")
        out[w] = (ms, plain_ms, bound_ms)
    return out


def plane_entry(sm, path: str, launches: int, t,
                name: str = "fused_get_linear_flat") -> dict:
    ms, plain_ms, bound_ms = t
    return {
        "name": name,
        "route": "cuda",
        "source": "pmdfc_tpu_torch/ops/csrc/fused_get.cu",
        "replaces": "pmdfc_tpu/ops/fused.py:414",
        "launches": launches,
        "max_abs_err": sm.max_err[name],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "path": path,
    }


def free_card(torch) -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_plane(sm: Smoke):
    """The sharded plane (phase 10): a 4-shard 2 GiB plane behind
    `NetServer`, its snapshots, chain restore and reshard restore, the
    engine pass, and the 2 x 2 replica plane. -> the plane's kernel
    entries (1-D and 2-D)."""
    import shutil

    root = plane_dir()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    fs, free = disk_of(root)
    log("env", f"plane directory {root}: filesystem {fs}, {free} bytes free")
    if fs == "tmpfs" or free < PLANE_DISK_BYTES:
        raise AssertionError(f"plane: {root} is {fs} with {free} bytes free; "
                             f"the phase needs a disk with {PLANE_DISK_BYTES}")
    try:
        entry, snap = plane_1d(sm, root)
        free_card(sm.torch)
        plane_restore(sm, snap)
        free_card(sm.torch)
        return [entry, plane_2d(sm)]
    finally:
        shutil.rmtree(root, ignore_errors=True)


def plane_1d(sm: Smoke, root):
    """The 1-D plane: a2a fill, the wire, the storm, extents, the fast
    lane, kernel against plain; then its full and delta snapshots.
    -> (the kernel entry, what the restores check)."""
    import os

    np, torch, fused = sm.np, sm.torch, sm.fused
    from pmdfc_tpu_torch.config import (BloomConfig, IndexConfig, KVConfig,
                                        NetConfig)
    from pmdfc_tpu_torch.parallel.plane import PlaneBackend
    from pmdfc_tpu_torch.parallel.shard import ShardedKV, make_mesh
    from pmdfc_tpu_torch.runtime.net import NetServer

    smi = nvidia_smi()
    cfg = KVConfig(index=IndexConfig(**PLANE_INDEX),
                   bloom=BloomConfig(num_bits=PLANE_BLOOM_BITS))
    pw = cfg.page_words
    n = PLANE_SHARDS
    skv = ShardedKV(cfg, mesh=make_mesh([DEVICE] * n))
    nconn = WIRE_CLIENTS * WIRE_CONNS
    pool_b = sum(st.pool.pages.numel() * 4 for st in skv.states)
    log("plane", f"ShardedKV over {n} shards on {skv.mesh}: "
        f"{skv.capacity()} slots, pools {pool_b / 2**30:.2f} GiB, bloom "
        f"{PLANE_BLOOM_BITS} counters per shard; NetServer(NetConfig()) on "
        f"127.0.0.1, {WIRE_CLIENTS} clients x {WIRE_CONNS} connections")

    t_fill, drops, overflow = plane_fill(skv, PLANE_DIRECT, DIRECT_HI,
                                         plane=False)
    log("plane", f"fill: {PLANE_DIRECT} pages through ShardedKV.insert "
        f"(a2a, {PLANE_INS_B}-key batches) in {t_fill:.3f} s = "
        f"{PLANE_DIRECT / t_fill:.0f} pages/s; a2a pair overflow "
        f"{overflow} rows, drops reported {drops} ({smi})")

    be = PlaneBackend(skv)
    counts = PlaneCounts(skv)
    srv = NetServer(lambda: be, net=NetConfig(), bf_push_s=BF_PUSH_S)
    srv.start()
    clients: list[WireClient] = []
    fused.launches.clear()
    ops0, stats0 = shard_ops(be), skv.stats()
    try:
        clients = [WireClient(srv.port, c, PLANE_FILL // nconn, pw, sm.seed,
                              directory=c < WIRE_FAST_CONNS)
                   for c in range(nconn)]
        t_wfill = run_threads([c.fill for c in clients], "plane fill")
        direct_present = plane_held(skv, DIRECT_HI)
        evicted = np.setdiff1d(np.arange(PLANE_DIRECT, dtype=np.uint32),
                               direct_present)
        log("plane", f"after the fills: {len(direct_present)} pre-fill keys "
            f"held, {len(evicted)} evicted")
        srv.push_bloom_now()
        deadline = time.monotonic() + 60
        while any(c.cc.counters["bf_pushes"] < 1 or c.cc._bloom is None
                  for c in clients):
            if time.monotonic() > deadline:
                raise AssertionError("plane: a client never received the "
                                     "bloom push")
            time.sleep(0.01)
        verbs = max(1, PLANE_GETS // (nconn * VERB))
        run_threads([lambda c=c: c.prepare(verbs * VERB // 8)
                     for c in clients], "plane mirror check, invalidate")
        t_storm = run_threads([lambda c=c: c.storm(verbs, evicted)
                               for c in clients], "plane storm")
        n_found, n_inrun = extent_roundtrip(clients[-1].rc, PLANE_EXTENTS,
                                            skv.stats)
        # the fast lane: per-(shard, row) validated reads of the directory
        fast = clients[:WIRE_FAST_CONNS]
        t0 = time.monotonic()
        if not all(c.rc.dir_refresh() for c in fast):
            raise AssertionError("plane: a directory pull failed")
        t_pull = time.monotonic() - t0
        perm = np.random.default_rng(sm.seed).permutation(direct_present)
        k = min(PLANE_FAST_KEYS, len(perm) // WIRE_FAST_CONNS)
        sets = [np.sort(perm[i * k:(i + 1) * k])
                for i in range(WIRE_FAST_CONNS)]
        want = {"gone": np.zeros(0, np.uint32),
                "rewritten": np.zeros(0, np.uint32), "xor": 0x5A5A5A5A}
        fp0 = (int(srv.stats["fastpath_hits"]),
               int(srv.stats["fastpath_stale"]))
        p1 = fast_pass(fast, sets, want, "plane fast read 1")
        r = WIRE_REWRITE // WIRE_FAST_CONNS
        rw = np.sort(np.concatenate([x[:r] for x in sets]))
        gone = np.sort(np.concatenate([x[r:2 * r] for x in sets]))
        driver = clients[WIRE_FAST_CONNS]
        for j in range(0, len(rw), VERB):
            lo = rw[j:j + VERB]
            hi = np.full(len(lo), DIRECT_HI, np.uint32)
            driver.cc.put_pages(hi, lo, pages_np(hi, lo, pw)
                                ^ np.uint32(want["xor"]))
        rs = driver.rc.stats()
        if rs["dropped_puts"] or rs["disconnects"]:
            raise AssertionError(f"plane: the driver's rewrites were not all "
                                 f"applied: {rs}")
        want["rewritten"] = rw
        p2 = fast_pass(fast, sets, want, "plane fast read 2 (rewrites)")
        driver.cc.invalidate_pages(np.full(len(gone), DIRECT_HI, np.uint32),
                                   gone)
        want["gone"] = gone
        p3 = fast_pass(fast, sets, want, "plane fast read 3 (invalidates)")
        fp = (int(srv.stats["fastpath_hits"]) - fp0[0],
              int(srv.stats["fastpath_stale"]) - fp0[1])
        torch.cuda.synchronize()
        launches = plane_checks(sm, skv, be, srv, clients, counts, n, ops0,
                                stats0, "plane")
        widths = sorted({8, counts.wl_max})
    finally:
        srv.stop()
        for c in clients:
            c.close()

    s = skv.stats()
    never = sum(c.never for c in clients)
    asked = sum(c.never_asked for c in clients)
    short = 1 - asked / never
    mirror = clients[0].cc._bloom
    density = float(np.unpackbits(mirror.view(np.uint8)).mean())
    expect_short = 1 - density ** clients[0].cc.num_hashes
    lost = s["evictions"] + s["drops"]
    acked = sum(c.acked_misses for c in clients) + p1[4] + p2[4] + p3[4]
    negatives = sum(c.negatives for c in clients)
    lanes = p1[3] + p2[3] + p3[3]
    for ok, msg in [
            (acked <= lost, f"{acked} acknowledged keys missed, more than "
             f"evictions + drops {lost}"),
            (negatives <= lost, f"{negatives} mirror negatives among "
             f"acknowledged keys, more than evictions + drops {lost}"),
            # the mirror is the OR of the per-shard filters (PLANE_SHARDS
            # x the keys in one shard's bits): it short-circuits what its
            # bit density lets it, 1 - density^k of never-inserted keys
            (short >= expect_short - 0.05, f"only {short:.1%} of never-"
             f"inserted GETs were short-circuited by the mirrors, "
             f"{expect_short:.1%} expected from their density"),
            (fp[0] + fp[1] == lanes, f"fastpath_hits {fp[0]} + "
             f"fastpath_stale {fp[1]} != {lanes} fast lanes read"),
            (p1[2] > 0 and p2[3] > 0, "the fast lane served nothing")]:
        if not ok:
            raise AssertionError(f"plane: {msg}")
    put_lat = [x for c in clients for x in c.put_lat]
    get_lat = [x for c in clients for x in c.get_lat]
    n_gets = nconn * verbs * VERB
    log("plane", f"fill: {PLANE_FILL} pages over the wire by {nconn} "
        f"connections in {t_wfill:.3f} s = {PLANE_FILL / t_wfill:.0f} "
        f"pages/s; put_pages verb of {VERB} pages: {percentiles_ms(put_lat)}"
        f" ({smi})")
    log("plane", f"storm: {n_gets} GET keys in {t_storm:.3f} s = "
        f"{n_gets / t_storm:.0f} keys/s; get_pages verb of {VERB} keys: "
        f"{percentiles_ms(get_lat)} ({smi})")
    log("plane", f"GET phases {counts.get_phases} ({counts.get_keys} keys), "
        f"widest per-shard width {counts.wl_max}; fused_get_linear_flat "
        f"launches {launches} = {n} per phase; shard ops "
        f"{skv.shard_report()['stats']['gets']} GETs per shard ({smi})")
    log("plane", f"fast lane: directory pull by {WIRE_FAST_CONNS} "
        f"connections in {t_pull:.3f} s; read 1: {p1[1]} keys in "
        f"{p1[0]:.3f} s = {p1[1] / p1[0]:.0f} keys/s; read 2 after "
        f"{len(rw)} rewrites: {p2[1] / p2[0]:.0f} keys/s; read 3 after "
        f"{len(gone)} invalidates: {p3[1] / p3[0]:.0f} keys/s; "
        f"fastpath_hits {fp[0]}, fastpath_stale {fp[1]} ({smi})")
    log("plane", f"checks passed: {acked} acknowledged keys missed <= "
        f"evictions {s['evictions']} + drops {s['drops']}; hits {s['hits']},"
        f" misses {s['misses']} == sum of causes on stats() and every "
        f"shard; routed ops == shard{{i}}_ops; GETs counted once; mirrors "
        f"short-circuited {short:.2%} (bit density {density:.3f}: "
        f"{expect_short:.2%} expected); extents {n_found} of {n_inrun} "
        f"in-run probes found, every address exact; no serve error, NACK "
        f"or disconnect")
    kt = plane_kernel(sm, skv.states[0], direct_present[
        skv.node_of(np.stack([np.full(len(direct_present), DIRECT_HI,
                                      np.uint32), direct_present], -1)) == 0],
        pw, widths, "plane shard 0", smi)

    # snapshots: a full, then PLANE_MUTATE puts and invalidates, a delta
    deleted = np.concatenate(
        [np.stack([c.oids(len(c.inval)), c.inval], -1) for c in clients]
        + [np.stack([np.full(len(gone), DIRECT_HI, np.uint32), gone], -1)])
    d_full = skv.directory_snapshot(max_entries=1 << 30)
    s_full = skv.stats()
    full, delta = str(root / "full.npz"), str(root / "delta.npz")
    with RssPeak() as rss:
        t0 = time.monotonic()
        rep_f = skv.save(full)
        t_full = time.monotonic() - t0
    size_f = os.path.getsize(full)
    log("plane", f"full snapshot: {size_f} bytes in {t_full:.3f} s = "
        f"{size_f / t_full / 1e9:.3f} GB/s, peak RSS {rss.peak} bytes "
        f"({rep_f['kind']}, {rep_f['total_rows']} rows)")
    lo = np.arange(PLANE_MUTATE, dtype=np.uint32)
    his = np.full(PLANE_MUTATE, PLANE_MUT_HI, np.uint32)
    skv.plane_insert(np.stack([his, lo], -1), pages_np(his, lo, pw)).fetch()
    drop = d_full["keys"][np.random.default_rng(sm.seed).choice(
        len(d_full["keys"]), PLANE_MUTATE // 4, replace=False)]
    skv.plane_delete(drop).fetch()
    with RssPeak() as rss_d:
        t0 = time.monotonic()
        rep_d = skv.save(delta, delta=True)
        t_delta = time.monotonic() - t0
    if rep_d["kind"] != "delta":
        raise AssertionError(f"plane: the second snapshot is a {rep_d}")
    d_delta = skv.directory_snapshot(max_entries=1 << 30)
    size_d = os.path.getsize(delta)
    log("plane", f"delta snapshot: {rep_d['dirty_rows']} dirty rows, "
        f"{size_d} bytes in {t_delta:.3f} s = "
        f"{size_d / t_delta / 1e9:.3f} GB/s, peak RSS {rss_d.peak} bytes")
    snap = {"cfg": cfg, "full": full, "delta": delta, "d_full": d_full,
            "d_delta": d_delta, "deleted": deleted, "s_full": s_full,
            "rewritten": rw, "dropped": drop, "size_full": size_f}
    entry = plane_entry(sm, "plane", launches, kt[counts.wl_max])
    log("plane", f"kernel at w=8 per shard: {kt[8][0]:.4f} ms, bound "
        f"{kt[8][2]:.4f} ms ({smi})")
    del skv, be, srv, clients
    return entry, snap


def plane_expect(snap, keys):
    """The page each key should hold: its own page, XOR-ed where the fast
    lane's driver rewrote it."""
    import numpy as np

    pages = pages_np(keys[:, 0], keys[:, 1], snap["cfg"].page_words)
    rw = (keys[:, 0] == DIRECT_HI) & np.isin(keys[:, 1], snap["rewritten"])
    pages[rw] ^= np.uint32(0x5A5A5A5A)
    return pages


def plane_serves(skv, snap, keys, label: str) -> None:
    """Every key hits byte-exact (in 2^16-key plane GETs)."""
    import numpy as np

    for i in range(0, len(keys), 1 << 16):
        k = keys[i:i + (1 << 16)]
        g = skv.plane_get(k).fetch()
        if not g.found.all():
            raise AssertionError(f"{label}: {int((~g.found).sum())} of "
                                 f"{len(k)} live keys missed")
        if not np.array_equal(g.dense(), plane_expect(snap, k)):
            raise AssertionError(f"{label}: a page came back changed")


def plane_restore(sm: Smoke, snap) -> None:
    """The chain restore onto a fresh 4-shard plane (every key the delta
    held hits byte-exact), the engine pass on it, then the reshard restore
    of the full onto PLANE_RESHARD shards (no live page lost, deleted keys
    stay deleted, the replay drops nothing)."""
    import os

    np, torch, fused = sm.np, sm.torch, sm.fused
    from pmdfc_tpu_torch.parallel.shard import ShardedKV, make_mesh
    from pmdfc_tpu_torch.runtime import Engine, KVServer

    smi = nvidia_smi()
    cfg = snap["cfg"]
    skv = ShardedKV(cfg, mesh=make_mesh([DEVICE] * PLANE_SHARDS))
    size = snap["size_full"] + os.path.getsize(snap["delta"])
    with RssPeak() as rss:
        t0 = time.monotonic()
        skv.restore_chain([snap["full"], snap["delta"]])
        skv._sync()
        t_chain = time.monotonic() - t0
    plane_serves(skv, snap, snap["d_delta"]["keys"], "chain restore")
    gone = skv.plane_get(snap["dropped"]).fetch()
    if gone.found.any():
        raise AssertionError("chain restore: a key the delta dropped hit")
    log("plane", f"restore_chain([full, delta]) onto {PLANE_SHARDS} shards: "
        f"{size} bytes in {t_chain:.3f} s = {size / t_chain / 1e9:.3f} GB/s,"
        f" peak RSS {rss.peak} bytes; all {len(snap['d_delta']['keys'])} "
        f"live keys hit byte-exact ({smi})")

    # the engine pass: KVServer(kv=the restored plane), clean-cache
    # threads through the native engine
    srv = KVServer(cfg, engine=Engine(**SERVE_ENGINE), kv=skv)
    eng = srv.engine
    minus_two: list[int] = []
    real_wait = eng.wait_many

    def wait_many(base, nw, timeout_us=10_000_000):
        st = real_wait(base, nw, timeout_us=timeout_us)
        if (st == -2).any():
            minus_two.append(int((st == -2).sum()))
        return st

    eng.wait_many = wait_many
    srv.warmup()
    fused.launches.clear()
    s0 = skv.stats()
    srv.start()
    try:
        per = PLANE_ENGINE_PAGES // PLANE_ENGINE_THREADS
        clients = [ServeClient(srv, t, per, sm.seed)
                   for t in range(PLANE_ENGINE_THREADS)]
        t_fill = run_threads([c.fill for c in clients], "plane engine fill")
        srv.push_bloom_now()
        run_threads([c.prepare for c in clients], "plane engine prepare")
        t_get = run_threads([c.storm for c in clients], "plane engine gets")
    finally:
        srv.stop()
    s1 = skv.stats()
    launches = fused.launches["fused_get_linear_flat"]
    lost = (s1["evictions"] - s0["evictions"]) + (s1["drops"] - s0["drops"])
    acked = sum(c.acked_misses for c in clients)
    for ok, msg in [
            (not minus_two, f"{sum(minus_two)} requests failed with -2"),
            (srv.errors == 0, f"{srv.errors} serve errors"),
            (acked <= lost, f"{acked} acknowledged pages missed, more than "
             f"the pass's evictions + drops {lost}"),
            (srv.op_batches["get"] > 0
             and launches == PLANE_SHARDS * srv.op_batches["get"],
             f"{launches} launches for {srv.op_batches['get']} GET flushes"),
            (s1["misses"] == sum(s1[c] for c in sm.kv_mod.MISS_CAUSE_NAMES),
             "misses != sum of miss causes")]:
        if not ok:
            raise AssertionError(f"plane engine pass: {msg}")
    n_get = PLANE_ENGINE_THREADS * GET_VERBS * VERB
    log("plane", f"engine pass: KVServer(kv=ShardedKV) with "
        f"{PLANE_ENGINE_THREADS} clean-cache threads: {PLANE_ENGINE_PAGES} "
        f"pages put in {t_fill:.3f} s = {PLANE_ENGINE_PAGES / t_fill:.0f} "
        f"pages/s, {n_get} GET keys in {t_get:.3f} s = {n_get / t_get:.0f} "
        f"keys/s; every hit byte-exact, no -2, {srv.op_batches['get']} GET "
        f"flushes = {launches} launches / {PLANE_SHARDS} ({smi})")
    del srv, skv, clients
    free_card(torch)

    # reshard the full onto PLANE_RESHARD shards
    skv = ShardedKV(cfg, mesh=make_mesh([DEVICE] * PLANE_RESHARD))
    with RssPeak() as rss:
        t0 = time.monotonic()
        skv.restore(snap["full"])
        skv._sync()
        t_rs = time.monotonic() - t0
    s = skv.stats()
    plane_serves(skv, snap, snap["d_full"]["keys"], "reshard restore")
    dele = snap["deleted"]
    for i in range(0, len(dele), 1 << 16):
        if skv.plane_get(dele[i:i + (1 << 16)]).fetch().found.any():
            raise AssertionError("reshard restore: a deleted key hit")
    if s["drops"] != snap["s_full"]["drops"]:
        raise AssertionError(f"reshard restore: the replay dropped "
                             f"{s['drops'] - snap['s_full']['drops']} pages")
    for k in ("puts", "deletes", "extent_puts"):
        if s[k] != snap["s_full"][k]:
            raise AssertionError(f"reshard restore: {k} {s[k]} != "
                                 f"{snap['s_full'][k]}")
    log("plane", f"reshard restore of the full onto {PLANE_RESHARD} shards "
        f"({skv.capacity()} slots): {snap['size_full']} bytes in "
        f"{t_rs:.3f} s = {snap['size_full'] / t_rs / 1e9:.3f} GB/s, "
        f"{len(snap['d_full']['keys'])} live pages replayed "
        f"= {len(snap['d_full']['keys']) / t_rs:.0f} pages/s, peak RSS "
        f"{rss.peak} bytes; none lost, {len(dele)} deleted keys miss, the "
        f"replay dropped 0 ({smi})")
    del skv


def plane_2d(sm: Smoke) -> dict:
    """The 2 x 2 replica plane behind NetServer: the replica capability,
    the fill, a corrupted lane routed around, MSG_RREPAIR, the other lane
    corrupted. -> its kernel entry."""
    np, torch, fused = sm.np, sm.torch, sm.fused
    from pmdfc_tpu_torch.config import (BloomConfig, IndexConfig, KVConfig,
                                        NetConfig)
    from pmdfc_tpu_torch.parallel.plane import PlaneBackend
    from pmdfc_tpu_torch.parallel.shard import ShardedKV, make_mesh2d
    from pmdfc_tpu_torch.runtime.net import NetServer

    smi = nvidia_smi()
    ns, nr = PLANE2D
    cfg = KVConfig(index=IndexConfig(**PLANE2D_INDEX),
                   bloom=BloomConfig(num_bits=PLANE2D_BLOOM_BITS))
    pw = cfg.page_words
    skv = ShardedKV(cfg, mesh=make_mesh2d(ns, nr, [DEVICE] * (ns * nr)))
    nconn = WIRE_CLIENTS * WIRE_CONNS
    pool_b = sum(st.pool.pages.numel() * 4 for row in skv._st for st in row)
    log("plane2d", f"ShardedKV over {ns} shards x {nr} replica lanes on "
        f"{skv.mesh}: {skv.capacity()} distinct slots, pools "
        f"{pool_b / 2**30:.2f} GiB on the card")
    t_fill, drops, _ = plane_fill(skv, PLANE_DIRECT, DIRECT_HI, plane=True)
    log("plane2d", f"fill: {PLANE_DIRECT} pages through plane_insert (every "
        f"lane in one call) in {t_fill:.3f} s = {PLANE_DIRECT / t_fill:.0f} "
        f"pages/s, drops {drops} ({smi})")
    be = PlaneBackend(skv)
    counts = PlaneCounts(skv)
    srv = NetServer(lambda: be, net=NetConfig(), bf_push_s=BF_PUSH_S)
    srv.start()
    clients: list[WireClient] = []
    fused.launches.clear()
    ops0, stats0 = shard_ops(be), skv.stats()
    try:
        clients = [WireClient(srv.port, c, PLANE_FILL // nconn, pw, sm.seed)
                   for c in range(nconn)]
        lanes = {c.be.replica_lanes for c in clients}
        if lanes != {nr}:
            raise AssertionError(f"plane2d: connections negotiated replica "
                                 f"lanes {lanes}, not {nr}")
        t_wfill = run_threads([c.fill for c in clients], "plane2d fill")
        direct_present = plane_held(skv, DIRECT_HI)
        evicted = np.setdiff1d(np.arange(PLANE_DIRECT, dtype=np.uint32),
                               direct_present)
        srv.push_bloom_now()
        deadline = time.monotonic() + 60
        while any(c.cc.counters["bf_pushes"] < 1 or c.cc._bloom is None
                  for c in clients):
            if time.monotonic() > deadline:
                raise AssertionError("plane2d: a client never received the "
                                     "bloom push")
            time.sleep(0.01)
        verbs = max(1, PLANE_GETS // (2 * nconn * VERB))
        run_threads([lambda c=c: c.prepare(2 * verbs * VERB // 8)
                     for c in clients], "plane2d mirror check, invalidate")

        def storm(label):
            r0 = skv.replica_report()
            t = run_threads([lambda c=c: c.storm(verbs, evicted)
                             for c in clients], label)
            r1 = skv.replica_report()
            return t, {k: [b - a for a, b in zip(r0[k], r1[k])]
                       for k in ("served", "digest_refused", "repaired")}

        skv.corrupt_replica_lane(1)
        t_s1, d1 = storm("plane2d storm, lane 1 corrupt")
        if not (d1["served"][0] > 0 and d1["served"][1] == 0
                and d1["digest_refused"][1] == d1["served"][0]
                and d1["digest_refused"][0] == 0):
            raise AssertionError(f"plane2d: lane 1 corrupt: {d1}")
        live = int(sum(skv.shard_report()["occupancy"]))
        t0 = time.monotonic()
        repaired = clients[0].be.replica_repair()
        t_rep = time.monotonic() - t0
        if repaired < live:
            raise AssertionError(f"plane2d: MSG_RREPAIR repaired {repaired} "
                                 f"rows, fewer than the {live} live pages")
        skv.corrupt_replica_lane(0)
        t_s2, d2 = storm("plane2d storm, lane 0 corrupt")
        if not (d2["served"][1] > 0 and d2["served"][0] == 0
                and d2["digest_refused"][0] == d2["served"][1]
                and d2["digest_refused"][1] == 0):
            raise AssertionError(f"plane2d: lane 0 corrupt: {d2}")
        torch.cuda.synchronize()
        launches = plane_checks(sm, skv, be, srv, clients, counts, ns * nr, ops0,
                                stats0, "plane2d")
        widths = sorted({8, counts.wl_max})
    finally:
        srv.stop()
        for c in clients:
            c.close()
    s = skv.stats()
    lost = s["evictions"] + s["drops"]
    acked = sum(c.acked_misses for c in clients)
    if acked > lost:
        raise AssertionError(f"plane2d: {acked} acknowledged keys missed, "
                             f"more than evictions + drops {lost}")
    put_lat = [x for c in clients for x in c.put_lat]
    get_lat = [x for c in clients for x in c.get_lat]
    n_gets = nconn * verbs * VERB
    log("plane2d", f"fill: {PLANE_FILL} pages over the wire in "
        f"{t_wfill:.3f} s = {PLANE_FILL / t_wfill:.0f} pages/s; put_pages "
        f"verb: {percentiles_ms(put_lat)} ({smi})")
    log("plane2d", f"storms of {n_gets} GET keys: lane 1 corrupt "
        f"{n_gets / t_s1:.0f} keys/s (lane 0 served {d1['served'][0]}, lane "
        f"1 refused {d1['digest_refused'][1]}); lane 0 corrupt "
        f"{n_gets / t_s2:.0f} keys/s (lane 1 served {d2['served'][1]}, lane "
        f"0 refused {d2['digest_refused'][0]}); get_pages verb: "
        f"{percentiles_ms(get_lat)} ({smi})")
    log("plane2d", f"MSG_RREPAIR: {repaired} rows repaired (>= {live} live "
        f"pages) in {t_rep:.3f} s; GET phases {counts.get_phases}, widest "
        f"per-shard width {counts.wl_max}, fused_get_linear_flat launches "
        f"{launches} = {ns * nr} per phase; checks passed: no wrong byte, "
        f"{acked} acknowledged keys missed <= {lost}, misses == sum of "
        f"causes on stats() and every shard ({smi})")
    own0 = skv.node_of(np.stack([np.full(len(direct_present), DIRECT_HI,
                                         np.uint32), direct_present], -1)) == 0
    skv.replica_repair()
    kt = plane_kernel(sm, skv.states[0], direct_present[own0], pw, widths,
                      "plane2d shard 0", smi)
    del skv, be, srv, clients
    return plane_entry(sm, "plane2d", launches, kt[8])


def control_dir():
    """Where phase 11 writes its telemetry dumps and captures (git-ignored,
    on the checkout's disk); removed at the end of the phase."""
    from pathlib import Path

    return Path(__file__).resolve().parent / "build" / "control"


def run_row_kv(sm: Smoke):
    """The whole KV on the row-rebuild insert (the child process, started
    with PMDFC_INSERT_PATH=row): linear·flat at 8 GiB filled to 75%
    through `KV.insert`, GET storms through the fused kernel with every
    hit byte-exact and `misses == Σ miss_*`, the kernel against its plain
    version on the full state, and its times. -> its `kernels` entry."""
    from pmdfc_tpu_torch.config import (BloomConfig, IndexConfig, IndexKind,
                                        KVConfig)
    from pmdfc_tpu_torch.models import linear
    from pmdfc_tpu_torch.models.base import get_index_ops

    if get_index_ops(IndexKind.LINEAR).insert_batch \
            is not linear.insert_batch_row:
        raise AssertionError("row-kv: PMDFC_INSERT_PATH=row did not select "
                             "the row-rebuild insert")
    cfg = KVConfig(index=IndexConfig(**LINEAR_INDEX),
                   bloom=BloomConfig(num_bits=1 << 24, num_hashes=4))
    # this process starts cold: one untimed insert and get of the fill's
    # batch width on a small KV first, so the timed fill does not pay the
    # caching allocator's first allocations (the element path's fill in
    # phase 4 runs after phase 3 has warmed them)
    warm = sm.kv_mod.KV(dataclasses.replace(
        cfg, index=IndexConfig(capacity=INS_B * 2)), device=sm.dev)
    keys = sm.keys_of(PAGE_HI, sm.torch.arange(INS_B, device=sm.dev))
    warm.insert(keys, sm.pages_of(keys, cfg.page_words))
    warm.get(keys[:GET_B])
    del warm, keys
    path = MainPath(sm, cfg, "linear·row")
    sm.fused.launches.clear()
    sm.torch.cuda.synchronize()
    path.run()
    sm.torch.cuda.synchronize()
    launches = sm.fused.launches["fused_get_linear_flat"]
    if launches <= 0:
        raise AssertionError("row-kv: the fused GET never launched")
    check_stats(sm, path)
    present = (path.status == 1).nonzero().flatten()[:4096]
    covers = sm.add_extents(path.kv, 4)
    sm.kernel_phase(path.kv, all_keys(sm, path),
                    sm.keys_of(PAGE_HI, present), covers, "linear·row full")
    entry = measure(sm, path, launches)
    entry["fill_pages_per_s"] = path.n_fill / path.t_fill
    return entry


def row_kv_subprocess(sm: Smoke) -> dict:
    """`run_row_kv` in a child process of this script with
    PMDFC_INSERT_PATH=row (the switch is read at import); its log lines
    are echoed, its entry read from its `ROWKV` line. A child that fails
    fails the phase."""
    import os

    env = dict(os.environ, PMDFC_INSERT_PATH="row")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--row-kv", "--seed",
         str(sm.seed)], env=env, capture_output=True, text=True,
        timeout=ROW_KV_TIMEOUT_S)
    entry = None
    for line in proc.stdout.splitlines():
        if line.startswith("ROWKV "):
            entry = json.loads(line[len("ROWKV "):])
        else:
            print(line, flush=True)
    if proc.returncode != 0 or entry is None:
        raise AssertionError(f"row-kv child exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    return entry


def run_harness(name: str, args) -> dict:
    """One harness of `pmdfc_tpu_torch/bench` as its own process on
    DEVICE -> its last JSON line. A nonzero exit fails the phase."""
    proc = subprocess.run(
        [sys.executable, "-m", f"pmdfc_tpu_torch.bench.{name}", "--device",
         DEVICE, *args], capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"harness {name} exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    return json.loads(lines[-1])


def trace_kernels(path) -> int:
    """Events of the fused GET kernel (`TRACE_CAT`, `TRACE_NAME`) in the
    capture's `trace.json`."""
    import os

    with open(os.path.join(path, "trace.json")) as f:
        doc = json.load(f)
    return sum(1 for e in doc.get("traceEvents", [])
               if e.get("cat") == TRACE_CAT
               and TRACE_NAME in str(e.get("name", "")))


def knob_envelope(cfg) -> dict:
    """Each controller knob's [lo, hi] from its `AutotuneConfig`."""
    m = cfg.balloon_max_extents
    return {"dwell_us": (cfg.dwell_us_lo, cfg.dwell_us_hi),
            "settle_us": (cfg.settle_us_lo, cfg.settle_us_hi),
            "window": (cfg.window_lo, cfg.window_hi),
            "hedge_ms": (cfg.hedge_ms_lo, cfg.hedge_ms_hi),
            "migrate_pps": (cfg.migrate_pps_lo, cfg.migrate_pps_hi),
            "balloon_x": (-m, m),
            "admit_thresh": (cfg.admit_lo, cfg.admit_hi)}


class ControlConn:
    """One pipelined `TcpBackend` of the control path: GET verbs over the
    pre-fill keys (7/8 present, 1/8 never inserted); every hit must be the
    key's page, every never-inserted key must miss."""

    def __init__(self, port: int, cid: int, pw: int, present, seed: int):
        import numpy as np

        from pmdfc_tpu_torch.runtime.net import TcpBackend

        self.np, self.pw, self.present = np, pw, present
        self.rng = np.random.default_rng([seed, 2000 + cid])
        self.be = TcpBackend("127.0.0.1", port, page_words=pw,
                             window=WIRE_WINDOW, op_timeout_s=120.0)
        self.present_misses = self.keys = 0

    def gets(self, n: int, verb: int, until=None) -> None:
        """`n` GET verbs of `verb` keys, and more until the event `until`
        (when given) is set."""
        np = self.np
        i = 0
        while i < n or (until is not None and not until.is_set()):
            i += 1
            n_never = max(1, verb // 8)
            lo = np.concatenate([
                self.rng.choice(self.present, verb - n_never),
                self.rng.integers(NEVER_LO, 1 << 32, n_never,
                                  dtype=np.uint64).astype(np.uint32)])
            keys = np.stack([np.full(verb, CONTROL_HI, np.uint32), lo], -1)
            out, found = self.be.get(keys)
            found = np.asarray(found, bool)
            if found[verb - n_never:].any():
                raise AssertionError("control: a never-inserted key hit")
            if not np.array_equal(np.asarray(out, np.uint32)[found],
                                  pages_np(CONTROL_HI, lo[found], self.pw)):
                raise AssertionError("control: a hit returned wrong bytes")
            if np.asarray(out)[~found].any():
                raise AssertionError("control: a miss returned nonzero bytes")
            self.present_misses += int((~found[:verb - n_never]).sum())
            self.keys += verb

    def close(self) -> None:
        self.be.close()


def control_row_ab(sm: Smoke) -> None:
    """The index alone: two linear indexes of 2^21 slots filled to 75% in
    INS_B-key batches, one through each insert path, equal bit for bit
    after every batch, every insert timed."""
    from pmdfc_tpu_torch.bench import insert_rowscatter

    smi = nvidia_smi()
    r = insert_rowscatter.ab_fill(ROW_INDEX["capacity"], INS_B, 0.75, DEVICE,
                                  sm.seed)
    speedup = r["element_ms_per_batch"] / r["row_ms_per_batch"]
    log("control", f"row vs element, the index alone: {r['batches']} "
        f"batches of {r['batch']} keys (3/4 fresh, 1/8 updates, 1/16 "
        f"in-batch duplicates, 1/16 padding) into two linear indexes of "
        f"{r['slots']} slots, {r['occupied']} occupied at the end; "
        f"{r['collided']} same-cluster collisions, {r['updates']} updates, "
        f"{r['evicted']} evictions, {r['dropped']} drops; tables, heads and "
        f"every InsertResult equal after every batch; element "
        f"{r['element_ms_per_batch']:.4f} ms, row "
        f"{r['row_ms_per_batch']:.4f} ms per {r['batch']}-key insert "
        f"(CUDA events): row speedup {speedup:.3f}x ({smi})")


def run_control(sm: Smoke):
    """Phase 11: the row insert at full width (the index alone, then the
    whole KV on the row path in a child process), the profiler and the
    controller behind the wire on linear·tiered, and the harnesses.
    -> the phase's kernel entries."""
    import os
    import shutil
    import threading

    np, torch, fused = sm.np, sm.torch, sm.fused
    from pmdfc_tpu_torch.client import DirectBackend
    from pmdfc_tpu_torch.config import (AutotuneConfig, BloomConfig,
                                        IndexConfig, KVConfig, NetConfig,
                                        ProfilerConfig, TelemetryConfig,
                                        TierConfig)
    from pmdfc_tpu_torch.runtime import autotune
    from pmdfc_tpu_torch.runtime import profiler as prof_mod
    from pmdfc_tpu_torch.runtime import telemetry as tele
    from pmdfc_tpu_torch.runtime import timeseries
    from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend

    t_phase = time.monotonic()
    control_row_ab(sm)
    row_entry = row_kv_subprocess(sm)
    log("control", f"row path, whole KV: linear·flat filled at "
        f"{row_entry['fill_pages_per_s']:.0f} pages/s through KV.insert on "
        f"the row-rebuild insert; GETs byte-exact; fused_get_linear_flat "
        f"{row_entry['launches']} launches, kernel == plain ({nvidia_smi()})")
    row_entry.pop("fill_pages_per_s")
    row_entry["path"] = "row-path"

    smi = nvidia_smi()
    root = control_dir()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    env0 = os.environ.get("PMDFC_PROF")
    os.environ["PMDFC_PROF"] = "on"
    reg = tele.configure(TelemetryConfig(dump_dir=str(root / "tele")))
    collector = None
    try:
        prof = prof_mod.install(ProfilerConfig(trace_min_interval_s=60.0))
        collector = timeseries.ensure_collector(interval_s=0.25)
        cfg = KVConfig(index=IndexConfig(**CONTROL_INDEX),
                       bloom=BloomConfig(num_bits=CONTROL_BLOOM_BITS),
                       tier=TierConfig())
        kv = sm.kv_mod.KV(cfg, device=DEVICE)
        pw = cfg.page_words
        n_fill = 3 * kv.capacity() // 4 // INS_B * INS_B
        t0 = time.monotonic()
        for i in range(0, n_fill, INS_B):
            lo = torch.arange(i, i + INS_B, device=sm.dev)
            keys = sm.keys_of(CONTROL_HI, lo)
            kv.insert(keys, sm.pages_of(keys, pw))
        torch.cuda.synchronize()
        t_fill = time.monotonic() - t0
        with kv._lock:
            flat, _ = kv._ops.scan(kv.state.index)
            held = flat[flat[:, 0] == sm.u32.narrow(torch.tensor(CONTROL_HI))]
            present = np.sort(sm.u32.to_numpy(held[:, 1]))
        log("control", f"linear·tiered {kv.state.pool.pages.numel() * 4 / 2**30:.2f}"
            f" GiB ({cfg.tier}) pre-filled with {n_fill} pages through "
            f"KV.insert in {t_fill:.3f} s = {n_fill / t_fill:.0f} pages/s; "
            f"{len(present)} held; NetServer(NetConfig()), PMDFC_PROF=on, "
            f"a series collector every 0.25 s, the controller attached")

        shared = DirectBackend(kv)
        # (padded width, wall us, [kv.get device_us], end on the host clock)
        phases: list = []
        dev_us: list = []
        real_note = prof.note_launch

        def note(program, phase, device_us, *a, **kw):
            if program == "kv.get":
                dev_us.append(device_us)
            return real_note(program, phase, device_us, *a, **kw)

        prof.note_launch = note
        real_get = shared.get

        def get(keys):
            n0 = len(dev_us)
            t0 = time.perf_counter()
            out = real_get(keys)
            phases.append((len(keys), (time.perf_counter() - t0) * 1e6,
                           dev_us[n0:], time.monotonic()))
            return out

        shared.get = get
        srv = NetServer(lambda: shared, net=NetConfig()).start()
        conns: list[ControlConn] = []
        mon = ctl = None
        try:
            conns = [ControlConn(srv.port, c, pw, present, sm.seed)
                     for c in range(CONTROL_CONNS)]
            mon = TcpBackend("127.0.0.1", srv.port, page_words=pw,
                             op_timeout_s=120.0)
            if not (mon.prof and all(c.be.prof for c in conns)):
                raise AssertionError("control: MSG_PROFILE not negotiated")
            ctl = autotune.attach(server=srv, client=conns[0].be,
                                  cfg=AutotuneConfig(interval_s=0.1),
                                  start=True)
            ctl.bind_balloon(kv)
            knobs0 = ctl.knob_values()
            s0 = kv.stats()
            fused.launches.clear()
            get0 = reg.snapshot()["histograms"].get(
                "prof.kv.get.device_us", {}).get("count", 0)
            del phases[:]
            # the light phase: one connection, small verbs, until the
            # deadline
            t_light = time.monotonic()
            while time.monotonic() - t_light < CONTROL_LIGHT_S:
                conns[0].gets(1, CONTROL_LIGHT_VERB)
            knobs_light = ctl.knob_values()
            n_light = len(phases)
            # the fan-in phase, a capture sent mid-storm: every connection
            # serves on until the capture's window has passed
            cap: dict = {}
            done = threading.Event()

            def capture():
                try:
                    time.sleep(0.2)
                    cap["res"] = mon.server_profile(CONTROL_CAPTURE_MS)
                    cap["t"] = time.monotonic()
                    time.sleep(CONTROL_CAPTURE_MS / 1e3)
                finally:
                    done.set()

            th = threading.Thread(target=capture, name="capture")
            th.start()
            t_fan = run_threads([lambda c=c: c.gets(CONTROL_FANIN_VERBS, VERB,
                                                    done)
                                 for c in conns], "control fan-in")
            th.join()
            res = cap.get("res")
            if not res or not res.get("path"):
                raise AssertionError(f"control: the capture was refused "
                                     f"({res})")
            deadline = time.monotonic() + 120
            trace = os.path.join(res["path"], "trace.json")
            while not os.path.exists(trace):
                if time.monotonic() > deadline:
                    raise AssertionError("control: the capture wrote no "
                                         "trace.json")
                time.sleep(0.05)
            t_trace = time.monotonic() - cap["t"]
            second = mon.server_profile(CONTROL_CAPTURE_MS)
            torch.cuda.synchronize()
            launches = fused.launches["fused_get_linear_tiered"]
            snap = reg.snapshot()
            get1 = snap["histograms"]["prof.kv.get.device_us"]["count"]
            health = dict(srv.stats)
            stats_doc = mon.server_stats()
            ctl.stop()
            knobs = ctl.knob_values()
            live = {"dwell_us": srv.flush_knobs()[0],
                    "settle_us": srv.flush_knobs()[1],
                    "window": float(conns[0].be.window)}
            cstats = dict(ctl.stats)
            moves = [r for r in tele.get().ring_tail()
                     if r.get("kind") == "ctl"]
        finally:
            if ctl is not None:
                ctl.stop()
            srv.stop()
            for c in conns:
                c.close()
            if mon is not None:
                mon.close()
            prof.note_launch = real_note
        s1 = kv.stats()
        n_kernel = trace_kernels(res["path"])
        d = {k: s1[k] - s0[k] for k in ("gets", "hits", "misses",
                                        *sm.kv_mod.MISS_CAUSE_NAMES)}
        present_misses = sum(c.present_misses for c in conns)
        n_phases = len(phases)
        widths = sorted({ph[0] for ph in phases})
        t_cap = cap["t"] + res["duration_ms"] / 1e3
        in_capture = sum(1 for ph in phases if cap["t"] <= ph[3] <= t_cap)

        # the kernel alone at each width the phases ran, on this state
        def batch(w):
            idx = torch.from_numpy(present.astype(np.int64)).to(sm.dev)
            n_never = max(1, w // 8)
            keys = torch.cat([
                sm.keys_of(CONTROL_HI, sm.pick(idx, w - n_never)),
                sm.keys_of(CONTROL_HI, torch.randint(
                    NEVER_LO, 1 << 32, (n_never,), device=sm.dev,
                    generator=sm.gen))])
            return keys[torch.randperm(w, device=sm.dev, generator=sm.gen)]

        args, kw = sm.kernel_args(kv.state)
        kern_ms = {}
        for w in widths:
            bs = [batch(w) for _ in range(8)]
            sm.compare(bs[0], kv.state, f"control w={w}")
            kern_ms[w] = time_ms(torch, [lambda k=k: fused.fused_get(
                k, *args, **kw) for k in bs], 24, device_only=True)
        # on the CPU `device_us` is the fetch's host time, which does not
        # hold the plain version's run: the lower bound is the card's
        under = [ph[:3] for ph in phases
                 if len(ph[2]) == 1 and DEVICE != "cpu"
                 and ph[2][0] < 0.9 * kern_ms[ph[0]] * 1e3]
        over = [ph[:3] for ph in phases
                if len(ph[2]) == 1 and ph[2][0] > ph[1]]
        env = knob_envelope(ctl.cfg)
        outside = {k: v for k, v in {**knobs, **live}.items()
                   if not env[k][0] <= v <= env[k][1]}
        checks = [
            (int(health["serve_errors"]) == 0,
             f"serve_errors {health['serve_errors']}"),
            (all(int(health[k]) == 0 for k in (
                "nacks_sent", "bisect_failures", "poison_ops",
                "deadline_shed")), "a phase failed"),
            # a TcpBackend never reconnects (a dropped connection raises
            # in its verb): the connections the server saw are ours alone
            (int(health["connects"]) == CONTROL_CONNS + 1,
             f"{health['connects']} connections for {CONTROL_CONNS + 1}"),
            (n_phases > 0 and launches == n_phases,
             f"{launches} fused-GET launches for {n_phases} GET phases"),
            (get1 - get0 == n_phases
             and all(len(ph[2]) == 1 for ph in phases),
             f"the profiler noted {get1 - get0} kv.get launches for "
             f"{n_phases} GET phases"),
            (not under, f"kv.get device_us under 0.9x the kernel alone: "
             f"{under[:3]}"),
            (not over, f"kv.get device_us over its phase's wall: "
             f"{over[:3]}"),
            (n_kernel > 0, f"the capture's trace holds no {TRACE_NAME} "
             f"kernel event"),
            (second is None, f"a second capture inside the cooldown was "
             f"not refused ({second})"),
            (cstats.get("windows_seen", 0) > 0,
             "the controller consumed no series window"),
            (not outside, f"knobs outside their envelope: {outside}"),
            (d["misses"] == sum(d[c] for c in sm.kv_mod.MISS_CAUSE_NAMES),
             f"misses != sum of miss causes ({d})"),
            (d["miss_digest"] == 0, "a digest miss"),
            (present_misses <= d["miss_evicted"] + d["miss_stale"]
             + d["miss_parked"], f"{present_misses} present keys missed, "
             f"more than their legal causes ({d})"),
        ]
        for ok, msg in checks:
            if not ok:
                raise AssertionError(f"control: {msg}")

        # the port's proftool over the pulled MSG_STATS snapshot
        from pmdfc_tpu_torch.tools import proftool

        stats_path = root / "stats.json"
        stats_path.write_text(json.dumps(stats_doc))
        table = proftool.breakdown(proftool._merge(
            proftool.load_docs([str(stats_path)])))
        progs = {r["program"] for r in table["rows"]}
        if "kv.get" not in progs or not table["launches"]:
            raise AssertionError(f"control: proftool saw {progs}")

        n_keys = sum(c.keys for c in conns)
        dus = [ph[2][0] for ph in phases]
        walls = [ph[1] for ph in phases]
        by_w = {}
        for ph in phases:
            by_w.setdefault(ph[0], []).append(ph[2][0])
        log("control", f"light phase: {n_light} GET phases in "
            f"{CONTROL_LIGHT_S} s; fan-in: {CONTROL_CONNS} connections x "
            f">= {CONTROL_FANIN_VERBS} verbs of {VERB} keys in {t_fan:.3f} s; "
            f"{n_keys} keys in all, every hit byte-exact, {present_misses} "
            f"present keys missed (legal), serve_errors 0 ({smi})")
        log("control", f"GET phases {n_phases}, widths {widths}; "
            f"fused_get_linear_tiered launches {launches}; profiler kv.get "
            f"launches {get1 - get0}; kv.get device_us (CUDA events on a "
            f"card) per width: " + "; ".join(
                f"w={w}: median {np.median(v):.1f} us (kernel alone "
                f"{kern_ms[w] * 1e3:.1f} us)" for w, v in sorted(by_w.items()))
            + f"; device_us / phase wall median "
            f"{np.median(np.asarray(dus) / np.asarray(walls)):.3f} ({smi})")
        log("control", f"MSG_PROFILE capture mid-storm: {res['path']} "
            f"({res['duration_ms']} ms), trace.json written "
            f"{t_trace:.2f} s after the reply, {n_kernel} {TRACE_NAME} "
            f"kernel events for {in_capture} GET phases that ended inside "
            f"the window; a second request inside the cooldown refused")
        log("control", f"controller: {cstats.get('ticks', 0)} ticks, "
            f"{cstats.get('windows_seen', 0)} series windows, "
            f"{cstats.get('decisions', 0)} decisions, "
            f"{cstats.get('reverts', 0)} reverts; knobs at start {knobs0}, "
            f"after the light phase {knobs_light}, at the end {knobs}; "
            f"every knob inside its envelope; series windows collected "
            f"{len(collector.ring)}")
        for r in moves:
            log("control", f"knob move: {r['knob']} {r['from']} -> "
                f"{r['to']} ({r['why']})")
        log("control", "proftool over the MSG_STATS snapshot:\n"
            + proftool.render_report(table))

        # the kernel's entry at the widest width, on this state
        wmax = widths[-1]
        bs = [batch(wmax) for _ in range(8)]
        s_ = kv.state.index.table.shape[1] // 4
        nbytes = []
        for k in bs:
            causes, cold = sm.compare(k, kv.state, "control timed")
            nbytes.append(fused.fused_get_bytes(
                causes, wmax, s_, pw, kv.state.evicted_filter.numel(),
                cold_rows=cold))
        plain_ms = time_ms(torch, [lambda k=k: fused.get_core_reference(
            k, *args, **kw) for k in bs], 8, device_only=True)
        bound_ms = sum(nbytes) / len(nbytes) / HBM_BYTES_PER_S * 1e3
        log("times", f"fused_get_linear_tiered w={wmax} on the control "
            f"state, rotated over 8 batches: kernel {kern_ms[wmax]:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms = "
            f"{bound_ms / kern_ms[wmax]:.1%} of the memory rate ({smi})")
        control_entry = {
            "name": "fused_get_linear_tiered",
            "route": "cuda",
            "source": "pmdfc_tpu_torch/ops/csrc/fused_get.cu",
            "replaces": "pmdfc_tpu/ops/fused.py:414",
            "launches": launches,
            "max_abs_err": sm.max_err["fused_get_linear_tiered"],
            "ms": kern_ms[wmax],
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes",
            "library_ms": None,
            "path": "control",
        }
        del kv, shared, conns
    finally:
        if env0 is None:
            os.environ.pop("PMDFC_PROF", None)
        else:
            os.environ["PMDFC_PROF"] = env0
        if collector is not None:
            collector.stop()
        tele.configure()
        shutil.rmtree(root, ignore_errors=True)
    free_card(torch)

    # the harnesses on the card
    for name, args in HARNESSES:
        out = run_harness(name, args)
        log("control", f"harness {name}: " + json.dumps(
            {k: v for k, v in out.items() if not isinstance(v, (list, dict))})
            + f" ({nvidia_smi()})")
    log("control", f"phase 11 took {time.monotonic() - t_phase:.1f} s")
    return [row_entry, control_entry]


# ---------------------------------------------------------------------------
# phase 12, scale: the multi-process plane and the workload harnesses
# ---------------------------------------------------------------------------

def scale_params(label: str) -> dict:
    """What the children of one part of phase 12 run, from the module's
    constants (the children import this module afresh, so they are
    passed, not read there)."""
    solo = label == "nccl"
    return {"label": label, "device": DEVICE, "seed": 0,
            "world": 1 if solo else SCALE_PROCS,
            "per_proc": SCALE_SOLO_SHARDS if solo else SCALE_PER_PROC,
            "backend": SCALE_SOLO_BACKEND if solo else "gloo",
            "index": SCALE_SOLO_INDEX if solo else SCALE_INDEX,
            "bloom_bits": SCALE_SOLO_BLOOM_BITS if solo else SCALE_BLOOM_BITS,
            "ins_b": SCALE_INS_B, "get_b": SCALE_GET_B, "gets": SCALE_GETS,
            "bcast_b": SCALE_BCAST_B, "delete": SCALE_DELETE,
            "hi": SCALE_HI, "join_s": SCALE_JOIN_S, "timed": SCALE_TIMED,
            "plane_puts": SCALE_PLANE_PUTS, "plane_gets": SCALE_PLANE_GETS,
            "extents": SCALE_PLANE_EXTENTS, "more": not solo,
            "fast_keys": SCALE_FAST_KEYS, "fast_rewrite": SCALE_FAST_REWRITE,
            "restore_index": SCALE_RESTORE_INDEX,
            "restore_bloom_bits": SCALE_RESTORE_BLOOM_BITS,
            "tier_index": SCALE_TIER_INDEX, "index_2d": SCALE_2D_INDEX,
            "side_bloom_bits": SCALE_SIDE_BLOOM_BITS,
            "dir": str(scale_dir())}


def scale_child(rank: int, port: int, p: dict, q) -> None:
    """One process of a multi-process plane (spawned): its results, or the
    traceback of what failed, go to the parent through `q`."""
    try:
        q.put((rank, "ok", scale_drive(rank, port, p)))
    except BaseException:
        import traceback

        q.put((rank, "error", traceback.format_exc()))
        raise


def scale_drive(rank: int, port: int, p: dict) -> dict:
    global DEVICE
    DEVICE = p["device"]
    import torch

    from pmdfc_tpu_torch.ops import _build, fused
    from pmdfc_tpu_torch.parallel import shard as shard_mod

    if torch.device(DEVICE).type == "cuda":
        _build.load("fused_get")
    else:
        # the CPU rehearsal: on CPU tensors the wrapper runs the plain
        # version and counts nothing, so count its calls here; and there
        # is no stream to wait for
        torch.cuda.synchronize = lambda *a: None
        plain = fused.fused_get

        def counted(keys, *a, **kw):
            pool = "tiered" if kw.get("cgen") is not None else "flat"
            fused.launches[f"fused_get_linear_{pool}"] += 1
            return plain(keys, *a, **kw)

        fused.fused_get = counted
    ndev = shard_mod.connect_multihost(
        f"localhost:{port}", p["world"], rank, timeout_s=p["join_s"],
        backend=p["backend"], devices=[DEVICE] * p["per_proc"])
    try:
        return scale_plane(rank, ndev, p)
    finally:
        shard_mod.shutdown_multihost()


def scale_plane(rank: int, ndev: int, p: dict) -> dict:
    """Fill, delete, a2a GETs, a broadcast GET, the stats rows and the
    kernel against plain, in one process of the group; every check
    raises. -> the numbers the parent reports and compares."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, KVConfig
    from pmdfc_tpu_torch.models.base import get_index_ops
    from pmdfc_tpu_torch.ops import fused
    from pmdfc_tpu_torch.parallel.partitioning import shard_of_np
    from pmdfc_tpu_torch.parallel.shard import (
        ShardedKV, make_mesh, pair_capacity)
    from pmdfc_tpu_torch.utils import u32

    sm = Smoke(p["seed"] + rank)
    label, hi = f"{p['label']} rank {rank}", p["hi"]
    cfg = KVConfig(index=IndexConfig(**p["index"]),
                   bloom=BloomConfig(num_bits=p["bloom_bits"]))
    pw = cfg.page_words
    skv = ShardedKV(cfg, mesh=make_mesh(), dispatch="a2a")
    n = skv.n_shards
    if ndev != n or n != p["world"] * p["per_proc"]:
        raise AssertionError(f"{label}: {ndev} devices, {n} shards")
    n_fill = 3 * skv.capacity() // 4
    ver = np.full(n_fill, -1, np.int8)
    rng = np.random.default_rng(p["seed"])  # the same batches everywhere
    digests = []
    ck = ScaleCheck(label, hi, pw, ver, digests)

    def xch():
        r = skv.exchange_report()
        return np.array([r["calls"], r["bytes"], r["seconds"]])

    # the fill: a2a inserts; drops, evictions and the pair overflow
    ins_b = p["ins_b"]
    drops = overflow = 0
    x0, t0 = xch(), time.monotonic()
    for i in range(0, n_fill, ins_b):
        lo = np.arange(i, min(i + ins_b, n_fill), dtype=np.uint32)
        keys = ck.keys(lo)
        res = skv.insert(keys, pages_np(hi, lo, pw))
        drops += int(res.dropped.sum())
        ver[lo[~np.asarray(res.dropped)]] = 0
        ev = np.asarray(res.evicted)
        ev = ev[ev[:, 0] == np.uint32(hi), 1]
        ver[ev[ev < n_fill]] = -1
        w = 16
        while w < len(lo):
            w <<= 1
        w += -w % n
        bl, own = w // n, shard_of_np(keys, n)
        c = pair_capacity(bl, n)
        for s in range(n):
            per = np.bincount(own[s * bl:(s + 1) * bl], minlength=n)
            overflow += int(np.maximum(per - c, 0).sum())
    t_fill = time.monotonic() - t0
    x_fill = xch() - x0
    n_ins = -(-n_fill // ins_b)

    # deletes, then the GETs: present, deleted, never inserted, any
    gone = rng.choice(np.flatnonzero(ver >= 0), p["delete"], replace=False)
    hit = skv.delete(ck.keys(gone))
    if not hit.all():
        raise AssertionError(f"{label}: {(~hit).sum()} deletes missed")
    ver[gone] = -1

    def check_get(lo, what):
        return ck.check(lo, *skv.get(ck.keys(lo)), what)

    batches = [ck.mix(rng, p["get_b"], gone) for _ in range(p["gets"])]
    bcast = ck.mix(rng, p["bcast_b"], gone)
    fused.launches.clear()
    x0, t0 = xch(), time.monotonic()
    hits = sum(check_get(lo, f"a2a GET {j}") for j, lo in enumerate(batches))
    t_get = time.monotonic() - t0
    x_get = xch() - x0
    skv.dispatch = "broadcast"  # the same plane, its other dispatch
    hits += check_get(bcast, "broadcast GET")
    skv.dispatch = "a2a"
    launches = fused.launches["fused_get_linear_flat"]
    phases = p["gets"] + 1
    if launches != p["per_proc"] * phases:
        raise AssertionError(f"{label}: {launches} fused-GET launches for "
                             f"{phases} GET phases x {p['per_proc']} shards")
    s = scale_stats(label, skv)

    # the kernel against plain on this process's first shard, full
    st = skv.states[0]
    flat, _ = get_index_ops(cfg.index.kind).scan(st.index)
    flat = u32.to_numpy(flat)
    present = flat[flat[:, 0] == np.uint32(hi), 1]
    widths = (8, n * pair_capacity(p["get_b"] // n, n))
    smi = nvidia_smi() if p["timed"] else "rehearsal"

    def kernel(state, present, widths, what, hi=hi):
        out = {}
        for r in range(p["world"]):  # one process at a time on the card
            if r == rank:
                out = plane_kernel(sm, state, present, pw, widths,
                                   f"{p['label']} rank {rank} {what}", smi,
                                   hi=hi, timed=p["timed"] and rank == 0)
            dist.barrier()
        return out

    times = kernel(st, present, widths, "shard 0")

    # the plane verbs (both parts), then part (a)'s fast lane, restores,
    # tiered plane and 2 x 2 grid
    more = {}
    plane = scale_verbs(sm, p, skv, hi, ver, gone, digests, label)
    more["plane"] = {"launches": plane["launches"], "wl": plane["wl"],
                     "took": plane["took"], "stats": plane["stats"],
                     "times": kernel(st, present, (plane["wl"],),
                                     "plane shard 0")}
    if p["more"]:
        # JAX's semantics put a host mirror of every pool in every
        # process: on the whole plane when the host holds two of them
        need = 2 * p["world"] * sum(
            x.pool.pages.numel() * 4 for x in skv.states) * 5 // 4
        fits = [mem_available() > need]
        dist.broadcast_object_list(fits, src=0)
        if fits[0]:
            more["fast"] = scale_fast(sm, p, skv, hi, ver, digests, label)
        del skv, st
        free_card(torch)
        more["restore"] = scale_restore(sm, p, rank, digests, label)
        if not fits[0]:
            side = ShardedKV(KVConfig(index=IndexConfig(
                **p["restore_index"]), bloom=BloomConfig(
                num_bits=p["restore_bloom_bits"])), mesh=make_mesh())
            side_hi = hi + 5
            side_ver = scale_fill(side, side_hi, 3 * side.capacity() // 4,
                                  p["ins_b"], pw)
            log("scale", f"{label}: MemAvailable {mem_available()} bytes "
                f"under the {need} two whole-plane mirrors need: the fast "
                f"lane runs on a {side.capacity()}-slot plane")
            more["fast"] = scale_fast(sm, p, side, side_hi, side_ver,
                                      digests, label)
            del side
            free_card(torch)
        tiered = scale_tiered(sm, p, rank, digests, label)
        more["tiered"] = {
            "launches": tiered["launches"], "wl": tiered["wl"],
            "took": tiered["took"], "stats": tiered["stats"],
            "times": kernel(tiered["skv"].states[0], tiered["present"],
                            (8, tiered["wl"]), "tiered shard 0",
                            hi=tiered["hi"])}
        del tiered
        free_card(torch)
        more["grid2d"] = scale_grid2d(sm, p, rank, digests, label)
    return {"rank": rank, "shards": n, "n_fill": n_fill, "fill_s": t_fill,
            "drops": drops, "overflow": overflow, "inserts": n_ins,
            "x_fill": x_fill.tolist(), "gets": p["gets"],
            "get_keys": p["gets"] * p["get_b"], "get_s": t_get,
            "x_get": x_get.tolist(), "hits": hits, "launches": launches,
            "phases": phases, "digests": digests,
            "stats": {k: s[k] for k in ("puts", "gets", "hits", "misses",
                                        "evictions", "drops")},
            "widths": widths, "times": times, "more": more,
            "max_err": sm.max_err.get("fused_get_linear_flat", 0),
            "max_err_tiered": sm.max_err.get("fused_get_linear_tiered", 0)}


def scale_dir():
    """Where part (a) writes its one-process plane's snapshots:
    `build/scale` under the checkout (git-ignored)."""
    from pathlib import Path

    return Path(__file__).resolve().parent / "build" / "scale"


def mem_available() -> int:
    """The host's MemAvailable, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise AssertionError("no MemAvailable in /proc/meminfo")


class ScaleCheck:
    """One process's checks of a plane's GET phases: the keys' versions
    (-1 absent, 0 the first page, 1 rewritten with `XOR`), every present
    key hits, every deleted or never-inserted key misses, every hit
    byte-exact, every miss zeroed; each phase's digest goes to
    `digests`."""

    XOR = 0x5A5A5A5A

    def __init__(self, label, hi, pw, ver, digests):
        self.label, self.hi, self.pw = label, hi, pw
        self.ver, self.digests = ver, digests

    def keys(self, lo):
        import numpy as np

        lo = np.asarray(lo, np.uint32)
        return np.stack([np.full(len(lo), self.hi, np.uint32), lo], -1)

    def expect(self, lo):
        import numpy as np

        pages = pages_np(self.hi, lo, self.pw)
        v = np.full(len(lo), -1, np.int8)
        known = lo < len(self.ver)
        v[known] = self.ver[lo[known]]
        pages[v == 1] ^= np.uint32(self.XOR)
        return pages, v

    def check(self, lo, out, found, what, legal_misses=None):
        """-> hits; with `legal_misses` (a callable of the count), present
        keys may miss up to what it allows (a tiered pool's legal
        misses)."""
        import zlib

        import numpy as np

        want, v = self.expect(lo)
        must, never = v >= 0, v < 0
        missed = int((~found[must]).sum())
        if missed and (legal_misses is None or not legal_misses(missed)):
            raise AssertionError(f"{self.label} {what}: {missed} present "
                                 "keys missed")
        if found[never].any():
            raise AssertionError(f"{self.label} {what}: a deleted or "
                                 "never-inserted key hit")
        if not np.array_equal(out[found], want[found]):
            raise AssertionError(f"{self.label} {what}: a hit's page "
                                 "differs")
        if out[~found].any():
            raise AssertionError(f"{self.label} {what}: a miss is not "
                                 "zeroed")
        self.digests.append(zlib.crc32(np.ascontiguousarray(out).tobytes(),
                                       zlib.crc32(found.tobytes())))
        return int(found.sum())

    def mix(self, rng, b, gone):
        """A GET batch: 5/8 present, 1/8 deleted, 1/8 never inserted, 1/8
        any."""
        import numpy as np

        k = b // 8
        lo = np.concatenate([
            rng.choice(np.flatnonzero(self.ver >= 0), 5 * k),
            rng.choice(gone, k),
            rng.integers(NEVER_LO, 1 << 32, k, dtype=np.uint32),
            rng.integers(0, len(self.ver), b - 7 * k, dtype=np.uint32)])
        return rng.permutation(lo).astype(np.uint32)


def scale_stats(label, skv) -> dict:
    """`misses == Σ miss_*` on `stats()` and on every shard's row."""
    import numpy as np

    from pmdfc_tpu_torch.kv import MISS_CAUSE_NAMES as causes

    s, rep = skv.stats(), skv.shard_report()["stats"]
    if s["misses"] != sum(s[c] for c in causes) or not np.array_equal(
            rep["misses"], np.sum([rep[c] for c in causes], axis=0)):
        raise AssertionError(f"{label}: misses != the sum of the causes")
    return s


def scale_launched(fused, name, want, label) -> int:
    n = fused.launches[name]
    if n != want:
        raise AssertionError(f"{label}: {n} {name} launches, {want} "
                             "expected (one per owned shard and lane per "
                             "GET phase)")
    return n


def scale_fill(skv, hi, n, b, pw):
    """Pages (hi, i < n) through `plane_insert` in b-key batches -> the
    version array (-1 where a key was dropped or evicted)."""
    import numpy as np

    ver = np.full(n, -1, np.int8)
    for i in range(0, n, b):
        lo = np.arange(i, min(i + b, n), dtype=np.uint32)
        keys = np.stack([np.full(len(lo), hi, np.uint32), lo], -1)
        res = skv.plane_insert(keys, pages_np(hi, lo, pw)).fetch()
        ver[lo[~np.asarray(res.dropped)]] = 0
        ev = np.asarray(res.evicted)
        ev = ev[ev[:, 0] == np.uint32(hi), 1]
        ver[ev[ev < n]] = -1
    return ver


def scale_verbs(sm, p, skv, hi, ver, gone, digests, label) -> dict:
    """The plane verbs through `PlaneBackend` in step: plane puts
    (rewrites of present keys), deletes, extents, GET phases and
    `plane_get_extent`, each checked; one fused-GET launch per owned
    shard per GET phase."""
    import numpy as np

    from pmdfc_tpu_torch.parallel.plane import PlaneBackend

    t0 = time.monotonic()
    fused = sm.fused
    be = PlaneBackend(skv)
    pw = skv.config.page_words
    rng = np.random.default_rng(p["seed"] + 1)
    ck = ScaleCheck(f"{label} plane", hi, pw, ver, digests)
    s0 = skv.stats()
    for _ in range(p["plane_puts"]):
        lo = rng.choice(np.flatnonzero(ver >= 0), p["ins_b"], replace=False)
        be.put(ck.keys(lo), pages_np(hi, lo, pw) ^ np.uint32(ck.XOR))
        ver[lo] = 1
    s1 = skv.stats()
    if s1["evictions"] != s0["evictions"] or s1["drops"] != s0["drops"]:
        raise AssertionError(f"{label} plane: a rewrite evicted or dropped")
    dele = rng.choice(np.flatnonzero(ver >= 0), p["delete"], replace=False)
    if not be.invalidate(ck.keys(dele)).all():
        raise AssertionError(f"{label} plane: a plane delete missed")
    ver[dele] = -1
    gone = np.concatenate([gone, dele]).astype(np.uint32)
    exts = []
    for j in range(p["extents"]):
        # the host verb PlaneBackend.insert_extent calls, for its result:
        # a cover may evict a page key
        base = (j + 1) << 22
        val = (j, (0xFFFFF000 - 4096 * j) % (1 << 32))
        res, unc = skv.insert_extent(np.array([EXT_HI, base], np.uint32),
                                     np.array(val, np.uint32), 64 + j)
        if unc or res.dropped.any():
            raise AssertionError(f"{label} plane: an extent left {unc} "
                                 "pages uncovered or dropped a cover")
        ev = np.asarray(res.evicted)
        ev = ev[ev[:, 0] == np.uint32(hi), 1]
        ver[ev[ev < len(ver)]] = -1
        exts.append((base, 64 + j, val))
    fused.launches.clear()
    hits, t_get = 0, 0.0
    for j in range(p["plane_gets"]):
        lo = ck.mix(rng, p["get_b"], gone)
        t1 = time.monotonic()
        out, found = be.get(ck.keys(lo))
        t_get += time.monotonic() - t1
        hits += ck.check(lo, out, found, f"plane GET {j}")
    launches = scale_launched(fused, "fused_get_linear_flat",
                              p["per_proc"] * p["plane_gets"],
                              f"{label} plane")
    wl = skv._router.width(int(np.bincount(
        skv.node_of(ck.keys(lo)), minlength=skv.n_shards).max()))
    probe, want = [], []
    for base, n, val in exts:
        for o in (0, n - 1, n // 2, n + 3):
            probe.append([EXT_HI, base + o])
            want.append((o < n, (((val[0] << 32) | val[1]) + 4096 * o)
                         % (1 << 64)))
    out, found = be.get_extent(np.array(probe, np.uint32))
    got = np.asarray(out).astype(np.uint64)
    addr = (got[:, 0] << np.uint64(32)) | got[:, 1]
    wf = np.array([w[0] for w in want])
    wa = np.array([w[1] for w in want], np.uint64)
    if not np.array_equal(found, wf) or not np.array_equal(
            addr[found], wa[found]) or addr[~found].any():
        raise AssertionError(f"{label} plane: plane_get_extent differs")
    s = scale_stats(f"{label} plane", skv)
    took = time.monotonic() - t0
    log("scale", f"{label} plane verbs through PlaneBackend: "
        f"{p['plane_puts']} puts of {p['ins_b']} rewrites, {p['delete']} "
        f"deletes, {p['extents']} extents, {p['plane_gets']} GET phases of "
        f"{p['get_b']} keys in {t_get:.3f} s = "
        f"{p['plane_gets'] * p['get_b'] / t_get:.0f} keys/s ({hits} hits "
        f"byte-exact, every miss zeroed), "
        f"plane_get_extent of {len(probe)} keys exact; "
        f"fused_get_linear_flat {launches} launches = {p['per_proc']} "
        f"owned shards x {p['plane_gets']} phases; misses == sum of the "
        f"causes on stats() and every shard; took {took:.1f} s")
    return {"launches": launches, "wl": wl, "took": took,
            "stats": {k: s[k] for k in ("gets", "hits", "misses")}}


def scale_fast(sm, p, skv, hi, ver, digests, label) -> dict:
    """The fast lane: `directory_snapshot`, then rewrites of a part of a
    sample of it, then `fast_view` (a host mirror of every pool in every
    process) and `read` of the sample with the directory's digests: the
    rewritten keys' old digests are refused, every other lane is served
    with the key's current page, and a stale epoch refuses every lane."""
    import numpy as np

    t0 = time.monotonic()
    pw = skv.config.page_words
    rng = np.random.default_rng(p["seed"] + 2)
    ck = ScaleCheck(f"{label} fast", hi, pw, ver, digests)
    d = skv.directory_snapshot(max_entries=1 << 30)
    t_dir = time.monotonic() - t0
    sel = np.flatnonzero(d["keys"][:, 0] == np.uint32(hi))
    sel = rng.choice(sel, min(p["fast_keys"], len(sel)), replace=False)
    lo = d["keys"][sel, 1]
    sh, rows, digs = d["shards"][sel], d["rows"][sel], d["digs"][sel]
    n_rw = p["fast_rewrite"]
    rw = lo[:n_rw]
    res = skv.plane_insert(ck.keys(rw), pages_np(hi, rw, pw) ^ np.uint32(
        0x0F0F0F0F)).fetch()
    if res.dropped.any():
        raise AssertionError(f"{label} fast: a rewrite dropped")
    ver[rw] = -1  # a third page: out of the later checks' key sets
    t1 = time.monotonic()
    fv = skv.fast_view()
    t_view = time.monotonic() - t1
    ok, pages, _ = fv.read(fv.epoch, sh, rows, digs)
    if ok[:n_rw].any() or not ok[n_rw:].all():
        raise AssertionError(f"{label} fast: {int(ok[:n_rw].sum())} stale "
                             f"rows served, {int((~ok[n_rw:]).sum())} fresh "
                             "directory lanes refused")
    ck.check(lo[n_rw:], pages, ok[n_rw:], "fast read")
    if fv.read(fv.epoch ^ 2, sh, rows, digs)[0].any():
        raise AssertionError(f"{label} fast: a stale epoch was served")
    took = time.monotonic() - t0
    log("scale", f"{label} fast lane: directory_snapshot "
        f"{len(d['keys'])} entries in {t_dir:.3f} s; after {n_rw} rewrites "
        f"of a {len(sel)}-entry sample of it, fast_view() (the host mirror "
        f"of {skv.n_shards} pools) in {t_view:.3f} s; the read refused "
        f"the rewritten rows' old digests and served the rest, each the "
        f"key's own page; a stale epoch refused; took {took:.1f} s")
    return {"entries": len(d["keys"]), "view_s": t_view, "took": took}


def scale_restore(sm, p, rank, digests, label) -> dict:
    """A one-process plane of 2 shards (rank 0 builds it on its card and
    writes a full and a delta snapshot), then `restore_chain` of both
    onto a 2-shard grid of one shard a process, and a reshard `restore`
    of the full onto the 4-shard grid: every key each snapshot held hits
    byte-exact, every deleted key misses, the replay drops nothing."""
    import shutil

    import numpy as np
    import torch.distributed as dist

    from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, KVConfig
    from pmdfc_tpu_torch.parallel.shard import Mesh, ShardedKV, make_mesh

    t0 = time.monotonic()
    cfg = KVConfig(index=IndexConfig(**p["restore_index"]),
                   bloom=BloomConfig(num_bits=p["restore_bloom_bits"]))
    pw, hi = cfg.page_words, p["hi"] + 2
    root = p["dir"]
    files = {k: f"{root}/{k}.npz" for k in ("full", "delta", "keys")}
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
        import os

        os.makedirs(root)
        one = ShardedKV(cfg, mesh=make_mesh([p["device"]] * 2))
        n = one.capacity() // 2
        scale_fill(one, hi, n, p["ins_b"], pw)
        s_full = one.stats()
        one.save(files["full"])
        d_full = one.directory_snapshot(max_entries=1 << 30)["keys"]
        rng = np.random.default_rng(p["seed"] + 3)
        held = d_full[d_full[:, 0] == np.uint32(hi), 1]
        rw = rng.choice(held, p["ins_b"], replace=False)
        one.plane_insert(np.stack([np.full(len(rw), hi, np.uint32), rw], -1),
                         pages_np(hi, rw, pw) ^ np.uint32(
                             ScaleCheck.XOR)).fetch()
        dele = rng.choice(np.setdiff1d(held, rw), p["delete"],
                          replace=False)
        one.plane_delete(np.stack([np.full(len(dele), hi, np.uint32), dele],
                                  -1)).fetch()
        one.save(files["delta"], delta=True)
        d_delta = one.directory_snapshot(max_entries=1 << 30)["keys"]
        np.savez(files["keys"], full=d_full, delta=d_delta, rewritten=rw,
                 deleted=dele, drops=np.asarray(s_full["drops"]))
        del one
        free_card(sm.torch)
    dist.barrier()
    t_write = time.monotonic() - t0
    with np.load(files["keys"]) as z:
        d_full, d_delta, rw, dele = (z[k] for k in (
            "full", "delta", "rewritten", "deleted"))
        drops_full = int(z["drops"])

    def serves(skv, keys, ver_rw, what):
        lo = keys[keys[:, 0] == np.uint32(hi), 1]
        ver = np.full(int(lo.max()) + 1, -1, np.int8)
        ver[lo] = 0
        if ver_rw:
            ver[rw] = 1
        ck = ScaleCheck(f"{label} {what}", hi, pw, ver, digests)
        for i in range(0, len(lo), p["get_b"]):
            part = lo[i:i + p["get_b"]]
            g = skv.plane_get(ck.keys(part)).fetch()
            ck.check(part, g.dense(), g.found, "GET")
        g = skv.plane_get(ck.keys(dele)).fetch()
        if ver_rw and g.found.any():
            raise AssertionError(f"{label} {what}: a deleted key hit")
        return len(lo)

    grid = make_mesh()
    two = Mesh(grid.devices[::2], grid.axis_names, owners=grid.owners[::2])
    skv = ShardedKV(cfg, mesh=two)
    t1 = time.monotonic()
    skv.restore_chain([files["full"], files["delta"]])
    skv._sync()
    t_chain = time.monotonic() - t1
    n_chain = serves(skv, d_delta, True, "restore_chain")
    del skv
    free_card(sm.torch)
    skv = ShardedKV(cfg, mesh=grid)
    t1 = time.monotonic()
    skv.restore(files["full"])
    skv._sync()
    t_rs = time.monotonic() - t1
    if skv.stats()["drops"] != drops_full:
        raise AssertionError(f"{label} reshard restore: the replay "
                             "dropped pages")
    n_full = serves(skv, d_full, False, "reshard restore")
    del skv
    free_card(sm.torch)
    dist.barrier()
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    took = time.monotonic() - t0
    log("scale", f"{label} restore: a one-process plane of 2 shards x "
        f"{p['restore_index']['capacity']} slots wrote a full and a delta "
        f"({t_write:.1f} s with its fill); restore_chain onto 2 shards over "
        f"2 processes in {t_chain:.3f} s, all {n_chain} live keys hit "
        f"byte-exact, the deleted keys miss; reshard restore of the full "
        f"onto 4 shards in {t_rs:.3f} s, all {n_full} keys hit byte-exact, "
        f"the replay dropped 0; took {took:.1f} s")
    return {"chain_s": t_chain, "reshard_s": t_rs, "took": took}


def scale_tiered(sm, p, rank, digests, label) -> dict:
    """A tiered plane (`TierConfig()` with `AdmitConfig()`, 2 GiB) over
    the 4-shard grid: the fill through `plane_insert`, GET phases on both
    cadences (every second one counting), each hit byte-exact and present
    keys missing only by their legal causes; one `linear · tiered` launch
    per owned shard per phase; the tier and gate verbs equal on every
    process; the kernel against plain on an owned shard."""
    import json
    import zlib

    import numpy as np

    from pmdfc_tpu_torch.config import (AdmitConfig, BloomConfig,
                                        IndexConfig, KVConfig, TierConfig)
    from pmdfc_tpu_torch.models.base import get_index_ops
    from pmdfc_tpu_torch.parallel.shard import ShardedKV, make_mesh
    from pmdfc_tpu_torch.utils import u32

    t0 = time.monotonic()
    fused = sm.fused
    cfg = KVConfig(index=IndexConfig(**p["tier_index"]),
                   bloom=BloomConfig(num_bits=p["side_bloom_bits"]),
                   tier=TierConfig(admit=AdmitConfig()))
    pw, hi = cfg.page_words, p["hi"] + 3
    skv = ShardedKV(cfg, mesh=make_mesh())
    n = 3 * skv.capacity() // 4
    ver = scale_fill(skv, hi, n, p["ins_b"], pw)
    rng = np.random.default_rng(p["seed"] + 4)
    ck = ScaleCheck(f"{label} tiered", hi, pw, ver, digests)
    s0 = skv.stats()
    fused.launches.clear()
    hits = 0
    for j in range(2 * p["plane_gets"]):
        lo = ck.mix(rng, p["get_b"], np.asarray([NEVER_LO], np.uint32))
        g = skv.plane_get(ck.keys(lo)).fetch()
        s1 = skv.stats()
        legal = sum(s1[c] - s0[c] for c in ("miss_evicted", "miss_stale",
                                            "miss_parked"))
        hits += ck.check(lo, g.dense(), g.found, f"GET {j}",
                         lambda k: k <= legal)
        s0 = s1
    launches = scale_launched(fused, "fused_get_linear_tiered",
                              p["per_proc"] * 2 * p["plane_gets"],
                              f"{label} tiered")
    wl = skv._router.width(int(np.bincount(
        skv.node_of(ck.keys(lo)), minlength=skv.n_shards).max()))
    s = scale_stats(f"{label} tiered", skv)
    tier = skv.tier_stats()
    gate = skv.admit_state()
    if tier["promotions"] <= 0 or gate is None:
        raise AssertionError(f"{label} tiered: no promotion on the "
                             f"counting GETs ({tier}) or no gate")
    digests.append(zlib.crc32(json.dumps(
        [tier, gate, skv.balloon_state()], sort_keys=True).encode()))
    st = skv.states[0]
    flat, _ = get_index_ops(cfg.index.kind).scan(st.index)
    flat = u32.to_numpy(flat)
    present = flat[flat[:, 0] == np.uint32(hi), 1]
    took = time.monotonic() - t0
    log("scale", f"{label} tiered plane ({cfg.tier}): {n} pages through "
        f"plane_insert, {2 * p['plane_gets']} GET phases of {p['get_b']} "
        f"keys on both cadences ({hits} hits byte-exact, every miss "
        f"zeroed, present keys missed only by their legal causes); "
        f"fused_get_linear_tiered {launches} launches = {p['per_proc']} "
        f"owned shards x {2 * p['plane_gets']} phases; tier_stats "
        f"promotions {tier['promotions']}, hot_hits {tier['hot_hits']}, "
        f"admit threshold {gate['threshold']}; took {took:.1f} s")
    return {"skv": skv, "present": present, "hi": hi, "wl": wl,
            "launches": launches, "took": took,
            "stats": {k: s[k] for k in ("gets", "hits", "misses")}}


def scale_grid2d(sm, p, rank, digests, label) -> dict:
    """`make_mesh2d(2, 2)` across the two processes (each holds one shard
    and both of its lanes): the fill, lane 0 corrupted, GET phases served
    byte-exact around it with lane 0's refusals counted, `replica_repair`
    repairing it, and GETs served by lane 0 again; one launch per lane per
    owned shard per phase."""
    import numpy as np

    from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, KVConfig
    from pmdfc_tpu_torch.parallel.shard import ShardedKV, make_mesh2d

    t0 = time.monotonic()
    fused = sm.fused
    cfg = KVConfig(index=IndexConfig(**p["index_2d"]),
                   bloom=BloomConfig(num_bits=p["side_bloom_bits"]))
    pw, hi = cfg.page_words, p["hi"] + 4
    skv = ShardedKV(cfg, mesh=make_mesh2d(2, 2))
    n = 3 * skv.capacity() // 4
    ver = scale_fill(skv, hi, n, p["ins_b"], pw)
    rng = np.random.default_rng(p["seed"] + 5)
    ck = ScaleCheck(f"{label} 2x2", hi, pw, ver, digests)
    gone = np.asarray([NEVER_LO], np.uint32)
    skv.corrupt_replica_lane(0)
    fused.launches.clear()
    served = np.zeros(2, np.int64)
    refused = np.zeros(2, np.int64)
    for j in range(p["plane_gets"]):
        lo = ck.mix(rng, p["get_b"], gone)
        g = skv.plane_get(ck.keys(lo)).fetch()
        ck.check(lo, g.dense(), g.found, f"GET {j} around lane 0")
        served += g.lane_served
        refused += g.lane_refused
    launches = scale_launched(fused, "fused_get_linear_flat",
                              2 * p["plane_gets"], f"{label} 2x2")
    if served[0] or not refused[0] or not served[1]:
        raise AssertionError(f"{label} 2x2: lane 0 served {served[0]}, "
                             f"refused {refused[0]}; lane 1 served "
                             f"{served[1]}")
    repaired = skv.replica_repair()
    lo = ck.mix(rng, p["get_b"], gone)
    g = skv.plane_get(ck.keys(lo)).fetch()
    ck.check(lo, g.dense(), g.found, "GET after the repair")
    if not repaired or g.lane_refused.any() or not g.lane_served[0]:
        raise AssertionError(f"{label} 2x2: replica_repair repaired "
                             f"{repaired} rows, then lanes refused "
                             f"{g.lane_refused.tolist()}")
    digests.append(int(repaired))
    scale_stats(f"{label} 2x2", skv)
    del skv
    free_card(sm.torch)
    took = time.monotonic() - t0
    log("scale", f"{label} 2 x 2 over 2 processes ({p['index_2d']} "
        f"slots a shard): lane 0 corrupted, {p['plane_gets']} GET phases "
        f"byte-exact around it (lane 0 refused {refused[0]}, lane 1 served "
        f"{served[1]}), {launches} launches = 2 lanes x {p['plane_gets']} "
        f"phases; replica_repair repaired {repaired} rows, then lane 0 "
        f"served {g.lane_served[0]} with no refusal; took {took:.1f} s")
    return {"repaired": repaired, "took": took}


def scale_spawn(target, world: int, args: tuple, label: str) -> list:
    """`world` spawned processes (CUDA cannot be forked) running
    `target(rank, port, *args, q)` -> their messages in rank order. A
    worker that reports an error, dies, or outlives SCALE_TIMEOUT_S fails
    the phase; every worker is stopped on the way out."""
    import multiprocessing as mp
    import queue
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, port, *args, q))
             for r in range(world)]
    got = {}
    deadline = time.monotonic() + SCALE_TIMEOUT_S
    try:
        for pr in procs:
            pr.start()
        while len(got) < world:
            try:
                rank, status, body = q.get(timeout=1.0)
                got[rank] = (status, body)
                if status == "error":
                    # a peer's failure often follows from this one's: wait
                    # a little for every report, then name them all
                    end = time.monotonic() + 5.0
                    while len(got) < world and time.monotonic() < end:
                        try:
                            r, st, b = q.get(timeout=0.5)
                            got[r] = (st, b)
                        except queue.Empty:
                            pass
                    raise AssertionError("\n".join(
                        f"{label} rank {r} failed:\n{b}"
                        for r, (st, b) in sorted(got.items())
                        if st == "error"))
            except queue.Empty:
                dead = [r for r, pr in enumerate(procs)
                        if r not in got and pr.exitcode is not None]
                if dead:
                    raise AssertionError(
                        f"{label}: worker {dead[0]} died (exit code "
                        f"{procs[dead[0]].exitcode}) with no report")
                if time.monotonic() > deadline:
                    raise AssertionError(f"{label}: workers outlived "
                                         f"{SCALE_TIMEOUT_S} s")
        for r, pr in enumerate(procs):
            pr.join(timeout=60)
            if pr.exitcode != 0:
                raise AssertionError(f"{label}: worker {r} exited "
                                     f"{pr.exitcode}")
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join(timeout=10)
    return [got[r] for r in range(world)]


def scale_part(label: str) -> dict:
    """One multi-process plane (part a: 2 processes over gloo; part b:
    one process in an NCCL group), checked across its processes ->
    rank 0's numbers with the launches of every rank."""
    p = scale_params(label)
    res = [body for _, body in scale_spawn(scale_child, p["world"], (p,),
                                           f"scale {label}")]
    if any(r["digests"] != res[0]["digests"] for r in res):
        raise AssertionError(f"scale {label}: the processes returned "
                             "different results")
    r0 = res[0]
    r0["launches_all"] = sum(r["launches"] for r in res)
    r0["max_err"] = max(r["max_err"] for r in res)
    r0["max_err_tiered"] = max(r["max_err_tiered"] for r in res)
    for step in ("plane", "tiered"):
        if step in r0["more"]:
            r0["more"][step]["launches_all"] = sum(
                r["more"][step]["launches"] for r in res)
    ins_s, get_s = r0["fill_s"], r0["get_s"]
    xf, xg = r0["x_fill"], r0["x_get"]
    log("scale", f"{label}: {p['world']} process(es) x {p['per_proc']} "
        f"shards over {p['backend']}, {r0['shards']} shards of "
        f"{p['index']['capacity']} slots: fill {r0['n_fill']} pages in "
        f"{r0['inserts']} a2a inserts of {p['ins_b']} in {ins_s:.3f} s = "
        f"{r0['n_fill'] / ins_s:.0f} pages/s; a2a pair overflow "
        f"{r0['overflow']} rows, drops {r0['drops']}; GETs "
        f"{r0['get_keys']} keys in {get_s:.3f} s = "
        f"{r0['get_keys'] / get_s:.0f} keys/s, {r0['hits']} hits "
        f"byte-exact (broadcast batch included), every miss zeroed, "
        f"identical on every process; exchange per insert "
        f"{xf[1] / r0['inserts']:.0f} bytes sent, "
        f"{xf[2] / r0['inserts'] * 1e3:.2f} ms ({xf[0] / r0['inserts']:.0f} "
        f"collectives); per GET {xg[1] / r0['gets']:.0f} bytes, "
        f"{xg[2] / r0['gets'] * 1e3:.2f} ms; fused-GET launches "
        f"{r0['launches_all']} over every process for {r0['phases']} GET "
        f"phases; stats {r0['stats']} ({nvidia_smi()})")
    return r0


def scale_refuse_child(rank: int, port: int, device: str, q) -> None:
    """One of two NCCL ranks naming the same card: the join must refuse."""
    from pmdfc_tpu_torch.parallel import shard as shard_mod

    try:
        shard_mod.connect_multihost(f"localhost:{port}", 2, rank,
                                    timeout_s=SCALE_JOIN_S, backend="nccl",
                                    devices=[device])
    except shard_mod.SharedDeviceError as e:
        q.put((rank, "refused", str(e)))
        return
    except BaseException:
        import traceback

        q.put((rank, "error", traceback.format_exc()))
        raise
    shard_mod.shutdown_multihost()
    q.put((rank, "error", "two NCCL ranks on one card joined"))


def scale_refusal() -> None:
    got = scale_spawn(scale_refuse_child, 2, (DEVICE,), "scale nccl x2")
    log("scale", f"nccl with two ranks on one card: both refused with "
        f"SharedDeviceError before any collective ({got[0][1][:120]})")


class Lanes:
    """Harness processes side by side, at most `n` at a time, each started
    as a lane frees in the order queued; a phase collects its own rows.
    The whole smoke queues phase 14's child, phase 15's two sweeps,
    phase 12's harnesses, phase 13's, phase 15's client child and the
    children of phases 17, 18 and 19 at phase 12's start, so the tail's
    host-bound soaks, the chaos child and the sweeps run beside phase 12's
    plane and phase 13's sweeps (the client waits in its lane for phase
    15's server; the failure, store and sanitize children, queued last,
    run beside phases 13 to 16)."""

    def __init__(self, n: int):
        from concurrent.futures import ThreadPoolExecutor

        self.ex = ThreadPoolExecutor(n)
        self.tmp = tempfile.TemporaryDirectory()  # the tail's --out files
        self.futs: dict[str, list] = {}
        # a child phase -> (start, end) in seconds since the smoke's start
        self.spans: dict[str, tuple] = {}
        # phase 15's rendezvous: the server writes its address here, the
        # client child waits for it (or for `abort`)
        self.trace_root = os.path.join(self.tmp.name, "trace")

    def _child(self, phase: str, run, seed: int, after=()):
        """A phase's child process in a lane, started once the futures
        `after` are done, its span kept."""
        from concurrent.futures import wait

        def go():
            wait(after)
            t0 = time.monotonic() - T0
            try:
                return run(seed)
            finally:
                self.spans[phase] = (t0, time.monotonic() - T0)

        return [self.ex.submit(go)]

    def queue(self, phase: str, seed: int = 0) -> "Lanes":
        if phase == "chaos":
            self.futs[phase] = self._child(phase, chaos_subprocess, seed)
        elif phase == "failure":
            self.futs[phase] = self._child(phase, failure_subprocess, seed)
        elif phase == "store":
            self.futs[phase] = self._child(phase, store_subprocess, seed)
        elif phase == "sanitize":
            # its engine clients spin on the host's cores: it starts once
            # phase 14's child, whose reconnect storm counts dials in a
            # 0.7 s window, is done
            self.futs[phase] = self._child(phase, sanitize_subprocess, seed,
                                           self.futs.get("chaos", ()))
        elif phase == "trace":
            self.futs[phase] = [
                self.ex.submit(trace_sweep, name, args, self.tmp.name)
                for name, args in TRACE_SWEEPS]
        elif phase == "trace-client":
            os.makedirs(self.trace_root, exist_ok=True)
            self.futs[phase] = [self.ex.submit(
                trace_client_subprocess, self.trace_root, seed)]
        elif phase == "scale":
            self.futs[phase] = [self.ex.submit(run_harness, name, args)
                                for name, args in SCALE_HARNESSES]
        else:
            self.futs[phase] = [
                self.ex.submit(tail_harness, name, args, self.tmp.name)
                for name, args in TAIL_LANE_RUNS]
        return self

    def rows(self, phase: str) -> list:
        return [f.result() for f in self.futs.pop(phase)]

    def span(self, phase: str) -> str:
        t0, t1 = self.spans.get(phase, (float("nan"), float("nan")))
        return f"from {t0:.1f} to {t1:.1f} s since the start"

    def close(self) -> None:
        """Drop what has not started, wait for what has (a harness ends
        within run_harness's timeout; a phase 15 client still waiting for
        its server is told to stop)."""
        if os.path.isdir(self.trace_root):
            open(os.path.join(self.trace_root, "abort"), "w").close()
        self.ex.shutdown(wait=True, cancel_futures=True)
        self.tmp.cleanup()


def harness_check(name: str, args, row: dict) -> str:
    """The harness's own correctness gate on its row -> what held."""
    fails = []
    if name == "multihost_bench":
        if row["hits"] != row["n"] or row.get("wrong_values"):
            fails.append(f"hits {row['hits']} of {row['n']}")
    elif name == "test_kv":
        if row["failed_search"] != 0:
            fails.append(f"failed_search {row['failed_search']}")
    elif name == "paging_sim" and row.get("job") == "scan_mix":
        for arm in ("admit_on", "admit_off"):
            if row[arm]["verify_failures"]:
                fails.append(f"{arm} verify_failures")
            row[f"{arm}_zipf_hit_rate"] = row[arm]["zipf_hit_rate"]
            row[f"{arm}_get_p99_us"] = row[arm]["get_p99_us"]
    elif name == "replay":
        if row["wrong_values"]:
            fails.append(f"wrong_values {row['wrong_values']}")
    elif name == "multinode":
        if row["errors"] or row["ok"] != row["clients"]:
            fails.append(f"client errors {row['errors']}")
    if row.get("verify_failures"):
        fails.append(f"verify_failures {row['verify_failures']}")
    if row.get("device") != torch_device_type():
        fails.append(f"ran on {row.get('device')}")
    if fails:
        raise AssertionError(f"harness {name} {' '.join(args)}: "
                             + "; ".join(fails))
    keep = ("value", "unit", "insert_mops", "hits", "n", "failed_search",
            "found", "verify_failures", "cc_hits", "disk_reads", "iops",
            "swap_hits", "pages_per_sec", "read_mib_per_sec", "read_hits",
            "read_misses", "wrong_values", "evictions", "ok",
            "total_pages_per_sec", "secs", "exchange_bytes",
            "exchange_seconds", "p99_batch_ms", "admit_on_zipf_hit_rate",
            "admit_off_zipf_hit_rate", "admit_on_get_p99_us",
            "admit_off_get_p99_us", "hit_rate_ratio_on_vs_off")
    return json.dumps({k: row[k] for k in keep if k in row})


def torch_device_type() -> str:
    import torch

    return torch.device(DEVICE).type


def scale_entry(r: dict, path: str) -> dict:
    """The kernels entry of a part (scale-gloo, scale-nccl) or of part
    (a)'s plane GETs (scale-plane on the flat plane, scale-tiered)."""
    name, err = "fused_get_linear_flat", r["max_err"]
    if path in ("scale-plane", "scale-tiered"):
        step = r["more"][path[6:]]
        launches, times, widest = (step["launches_all"], step["times"],
                                   step["wl"])
        if path == "scale-tiered":
            name, err = "fused_get_linear_tiered", r["max_err_tiered"]
    else:
        launches, times, widest = (r["launches_all"], r["times"],
                                   r["widths"][-1])
    ms, plain_ms, bound_ms = times.get(widest, (None,) * 3)
    return {"name": name, "route": "cuda",
            "source": "pmdfc_tpu_torch/ops/csrc/fused_get.cu",
            "replaces": "pmdfc_tpu/ops/fused.py:414",
            "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None, "path": path}


def run_scale(sm: Smoke, lanes: Lanes | None = None):
    """The multi-process plane and the workload harnesses (phase 12): the
    harnesses run in `lanes` (queued there by the caller; its own when
    none is given) beside the two parts. -> the kernel entries of its two
    multi-process planes."""
    t_phase = time.monotonic()
    free_card(sm.torch)
    own = lanes is None
    if own:
        lanes = Lanes(HARNESS_LANES).queue("scale")
    try:
        gloo = scale_part("gloo")
        t_a = time.monotonic() - t_phase
        solo = scale_part("nccl")
        scale_refusal()
        t_b = time.monotonic() - t_phase - t_a
        rows = lanes.rows("scale")
    finally:
        if own:
            lanes.close()
    for (name, args), row in zip(SCALE_HARNESSES, rows):
        log("scale", f"harness {name} {' '.join(args)}: "
            f"{harness_check(name, args, row)} ({nvidia_smi()})")
    steps = {k: round(v["took"], 1) for k, v in gloo["more"].items()}
    t_all = time.monotonic() - t_phase
    log("scale", f"phase 12 took {t_all:.1f} s: part (a) {t_a:.1f} s (its "
        f"plane steps, rank 0, s: {steps}), part (b) and the refusal "
        f"{t_b:.1f} s (its plane verbs {solo['more']['plane']['took']:.1f} "
        f"s), then {t_all - t_a - t_b:.1f} s more for the harnesses")
    return [scale_entry(gloo, "scale-gloo"), scale_entry(solo, "scale-nccl"),
            scale_entry(gloo, "scale-plane"),
            scale_entry(gloo, "scale-tiered")]


# ---------------------------------------------------------------------------
# phase 13, tail: the bench tail's harnesses on the card
# ---------------------------------------------------------------------------

def uncounted(fused, fn):
    """Run `fn` and take back the fused-GET launches it made: the launches
    that compare a kernel with its plain version do not count."""
    before = dict(fused.launches)
    try:
        return fn()
    finally:
        fused.launches.clear()
        fused.launches.update(before)


def tail_kernel(sm, kv, keys, label: str, smi):
    """Kernel against plain on a harness's full-size state at TAIL_WIDTHS,
    on batches of its inserted keys with an eighth never inserted, timed
    at each -> {w: (ms, plain_ms, bound_ms)} (these launches uncounted)."""
    torch = sm.torch
    n = len(keys)
    present = torch.from_numpy(keys.view(sm.np.int32)).to(sm.dev)

    def batch(w):
        n_never = max(1, w // 8)
        lo = torch.randint(n + 1, 1 << 30, (n_never,), device=sm.dev,
                           generator=sm.gen)
        never = torch.stack([lo >> 16, lo], -1).to(torch.int32)
        keys_w = torch.cat([sm.pick(present, w - n_never), never])
        return keys_w[torch.randperm(w, device=sm.dev, generator=sm.gen)]

    return uncounted(sm.fused, lambda: plane_kernel(
        sm, kv.state, None, kv.config.page_words, TAIL_WIDTHS, label, smi,
        batch=batch))


def tail_check(name: str, row: dict) -> str:
    """A tail harness's own gates on its row (beyond its exit code) ->
    what held."""
    fails = []
    for k in ("wrong_bytes", "serve_errors", "verify_failures",
              "mismatches", "deleted_hits", "conformance_violations"):
        if row.get(k):
            fails.append(f"{k} {row[k]}")
    if name == "recovery_soak":
        if row["miss_recovering"] <= 0 or row["pages_lost"] > row["rpo_bound"]:
            fails.append(f"miss_recovering {row['miss_recovering']}, lost "
                         f"{row['pages_lost']} of bound {row['rpo_bound']}")
    elif name == "replica_soak":
        if row["hit_rate_ratio"] < 0.8:
            fails.append(f"hit_rate_ratio {row['hit_rate_ratio']}")
    elif name == "containment_soak":
        iso = row["isolation"]
        if iso["poison_ops"] != 1 or iso["bisect_failures"] > row["bound"] \
                or not row["readmitted"] or row["proof"]["poison_ops"]:
            fails.append(f"isolation {iso}, readmitted {row['readmitted']}, "
                         f"proof {row['proof']}")
    elif name == "qos_soak":
        if not row["miss_shed"] or row["lanes"]["good"].get("shed_edge"):
            fails.append(f"miss_shed {row['miss_shed']}, lanes "
                         f"{row['lanes']}")
    elif name == "train_pressure":
        if not row["loss_last"] < row["loss_first"]:
            fails.append(f"loss {row['loss_first']} -> {row['loss_last']}")
    elif name == "soak":
        if not (row["clean_cache_invariant_ok"] and row["causes_ok"]):
            fails.append("clean-cache invariant or miss causes broken")
    if row.get("device") != torch_device_type():
        fails.append(f"ran on {row.get('device')}")
    if fails:
        raise AssertionError(f"harness {name}: " + "; ".join(fails))
    skip = ("rows", "lanes", "client", "tier", "teledoc")
    return json.dumps({k: v for k, v in row.items() if k not in skip})


def tail_harness(name: str, args, tmp: str):
    """One tail harness as its own process -> (its last JSON row, with the
    rows it wrote to `--out` for the harnesses in TAIL_ROWS; seconds)."""
    t0 = time.monotonic()
    out = os.path.join(tmp, f"{name}.json")
    extra = ("--out", out) if name in TAIL_ROWS else ()
    row = run_harness(name, (*args, *extra))
    if extra:
        with open(out) as f:
            row["rows"] = json.load(f)["rows"]
    return row, time.monotonic() - t0


def tail_log(name: str, args, row: dict, secs: float) -> None:
    log("tail", f"harness {name} {' '.join(args)} ({secs:.1f} s): "
        f"{tail_check(name, row)} ({nvidia_smi()})")
    keep = ("transport", "n_shards", "value", "unit", "p50_us", "p95_us",
            "gets_per_s", "cpu_us_per_get")
    for r in row.get("rows", ()):
        log("tail", f"  {name} row {r['metric']}: "
            + json.dumps({k: r[k] for k in keep if k in r}))


def run_tail(sm, lanes: Lanes | None = None):
    """The bench tail (phase 13): fused_get and tier_sweep in this
    process, their launches counted, beside mesh_sweep, the soak and the
    host-bound harnesses in `lanes` (queued there by the caller; its own,
    from the phase's start, when none is given). -> the kernel entries of
    its path."""
    import argparse

    from pmdfc_tpu_torch.bench import fused_get as fg
    from pmdfc_tpu_torch.bench import tier_sweep as ts

    fused, torch = sm.fused, sm.torch
    t_phase = time.monotonic()
    free_card(torch)
    smi = nvidia_smi()
    times = {}
    own = lanes is None
    if own:
        lanes = Lanes(HARNESS_LANES).queue("tail")
    try:
        fused.launches.clear()
        for fam, cap in TAIL_FUSED:
            t0 = time.monotonic()
            args = argparse.Namespace(
                capacity=cap, families=[fam], seed=sm.seed, device=DEVICE,
                out=None, history=None, smoke=False, **TAIL_FUSED_ARGS)

            def keep(f, kv, keys):
                times[variant_of(kv.state)] = tail_kernel(
                    sm, kv, keys, f"tail fused_get {f}·flat", smi)

            out = fg.run(args, keep=keep)
            for r in out["sweeps"]:
                log("tail", f"fused_get {fam}·flat zipf {r['zipf']} batch "
                    f"{r['batch']}: kernel side {r['ms_fused']:.4f} ms, "
                    f"composed chain {r['ms_composed']:.4f} ms per GET "
                    f"(CUDA event window) = "
                    f"{r['speedup_fused_vs_composed']}x; {r['hits']} hits "
                    f"of {r['gets']}, parity bit for bit on every batch, "
                    f"one launch per kernel-side GET, none composed ({smi})")
            free_card(torch)
            log("tail", f"fused_get {fam}·flat took "
                f"{time.monotonic() - t0:.1f} s (its fill "
                f"{out['sweeps'][0]['fill_s']} s)")
        t0 = time.monotonic()
        args = argparse.Namespace(seed=sm.seed, device=DEVICE, out=None,
                                  history=None, smoke=False,
                                  **TAIL_TIER_ARGS)

        def keep_tier(kv, keys):
            times[variant_of(kv.state)] = tail_kernel(
                sm, kv, keys, "tail tier_sweep linear·tiered", smi)

        out = ts.run(args, keep=keep_tier)
        for r in out["sweeps"]:
            log("tail", f"tier_sweep zipf {r['zipf']}: tiered "
                f"{r['stream_mops_tier']} Mops/s, flat "
                f"{r['stream_mops_flat']} Mops/s (KV.get, host clock); hot "
                f"gather {r['hot_gather_us_tier']} vs "
                f"{r['hot_gather_us_flat']} us (CUDA events); hits "
                f"{r['hits_tier']} / {r['hits_flat']}, every hit byte-exact, "
                f"every miss zeroed, misses == sum of causes; promotions "
                f"{r['tier']['promotions']} ({smi})")
        launches = dict(fused.launches)
        free_card(torch)
        log("tail", f"tier_sweep took {time.monotonic() - t0:.1f} s")
        for want in times:
            if not launches.get(want):
                raise AssertionError(f"tail: {want} was never launched")
        log("tail", f"fused-GET launches of the in-process sweeps: "
            f"{launches}")
        log("tail", f"main thread done at {time.monotonic() - t_phase:.1f} s")
        for (name, args), got in zip(TAIL_LANE_RUNS, lanes.rows("tail")):
            tail_log(name, args, *got)
    finally:
        if own:
            lanes.close()
    log("tail", f"phase 13 took {time.monotonic() - t_phase:.1f} s")
    return [plane_entry(sm, "tail", launches[name], t[TAIL_TIMED_W], name)
            for name, t in times.items()]


# ---------------------------------------------------------------------------
# phase 14, chaos: the failure ladder through ChaosProxy on the card
# ---------------------------------------------------------------------------

CHAOS_INDEX = dict(capacity=1 << 18)  # a 1 GiB pool of 4 KiB pages
CHAOS_BLOOM_BITS = 1 << 21
CHAOS_PAGE_WORDS = 1024
CHAOS_STEPS = 120          # ops of each soak, unpipelined then pipelined
CHAOS_VERB = 1 << 11       # pages of the widest verb
CHAOS_WINDOW = 8           # the pipelined soak's window
# tests/test_chaos.py's RATES
CHAOS_RATES = {"flip": 0.04, "truncate": 0.02, "duplicate": 0.04,
               "delay": 0.02, "reorder": 0.02}
CHAOS_PROBE = 1 << 10      # keys put directly, poisoned in place, probed
CHAOS_GET_B = 1 << 14      # direct GETs over the whole key set
CHAOS_HI = 0xC4000000
CHAOS_OP_TIMEOUT_S = 1.0   # the soak client's TcpBackend, as test_chaos
CHAOS_TIMEOUT_S = 600.0    # the phase's child process, spawn to exit
XRAY_SHARDS = 4
XRAY_INDEX = dict(capacity=1 << 16)  # a shard
XRAY_BLOOM_BITS = 1 << 19
XRAY_KEYS = 1 << 17        # the zipf stream's key space
XRAY_STEPS = 24
XRAY_VERB = 1 << 11        # keys of each soak verb
XRAY_ZIPF = 0.99
XRAY_RATES = {"flip": 0.01, "duplicate": 0.005}  # test_xray's soak
XRAY_HI = 0xC5000000
COLLECTOR_WAIT_S = 1.1     # a collector window (1 s) and some slack
DRILL_INDEX = dict(capacity=1 << 16)  # the wire drills' KV and shards
DRILL_VERB = 1 << 11       # keys of each drill verb
DRILL_HI = 0xC6000000


def pull_all(kv, keys, b: int):
    """`kv.get` over host keys in batches of b -> (pages, found)."""
    import numpy as np

    outs, founds = [], []
    for a in range(0, len(keys), b):
        out, found = kv.get(keys[a:a + b])
        outs.append(np.asarray(out))
        founds.append(np.asarray(found, bool))
    return np.concatenate(outs), np.concatenate(founds)


def wrong_pages(out, found, want) -> int:
    """Hits whose page differs from the key's page."""
    return int((out[found] != want[found]).any(axis=1).sum())


def launched(fused) -> int:
    return sum(fused.launches.values())


def chaos_poison(sm, kv, keys, pages, label: str) -> int:
    """Hazard (r) on the card: put `keys` directly, XOR every pool byte in
    place under the KV's lock and on its device, and GET them: the GET
    launches the kernel, which misses every one of them as corrupt (the
    digest check is the kernel's) -> the corrupt pages it counted."""
    kv.insert(keys, pages)
    out, found = kv.get(keys)
    if not found.all() or wrong_pages(out, found, pages):
        raise AssertionError(f"{label}: a probe key did not serve its page "
                             "before the poison")
    before, n0 = kv.stats()["corrupt_pages"], launched(sm.fused)
    with kv._lock, kv._on_device():
        kv.state.pool.pages.bitwise_xor_(1 << 9)
    out, found = kv.get(keys)
    detected = kv.stats()["corrupt_pages"] - before
    n = launched(sm.fused) - n0
    if found.any() or detected < len(keys) or n < 1:
        raise AssertionError(
            f"{label}: poisoned probe served {int(found.sum())} hits, "
            f"{detected} corrupt pages counted of {len(keys)}, {n} kernel "
            "launches")
    return detected


def chaos_soak(sm, cfg, *, steps: int, seed: int, rates: dict, kill_at,
               root, pipe: bool = False, n_fill: int = 0, n_ops: int = 224,
               max_verb: int = 16, n_warm: int = 16, n_probe: int = 16,
               poison: bool = True, label: str = "chaos") -> dict:
    """`tests/test_chaos.py`'s seeded soak at any size: a `KV` (its first
    `n_fill` op keys put directly) behind `NetServer` and a `ChaosProxy`
    at `rates`, driven through `IntegrityBackend` over
    `ReconnectingClient` over `TcpBackend` (pipelined with `pipe`) with
    `steps` seeded puts, GETs and invalidates of 1..max_verb-1 op keys;
    with `poison` the pool poisoned a quarter in (`chaos_poison` on the
    probe keys);
    at each step of `kill_at` a durable snapshot and a torn newer one,
    the server killed and restored from the durable one. Raises when a
    restore breaks its invariants; the caller gates the rest -> counts."""
    import numpy as np

    from pmdfc_tpu_torch import checkpoint
    from pmdfc_tpu_torch.checkpoint import CheckpointCorruptError
    from pmdfc_tpu_torch.client.backends import (DirectBackend,
                                                 IntegrityBackend)
    from pmdfc_tpu_torch.runtime.failure import (ChaosProxy,
                                                 ReconnectingClient)
    from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend

    pw = cfg.page_words
    rng = np.random.default_rng(seed)
    n = n_ops + n_warm + n_probe
    lo = rng.choice(1 << 30, size=n, replace=False).astype(np.uint32)
    keys = np.stack([np.full(n, CHAOS_HI, np.uint32), lo], -1)
    warm = slice(n_ops, n_ops + n_warm)
    probe = slice(n_ops + n_warm, n)

    def pages(sel):
        return pages_np(CHAOS_HI, lo[sel], pw)

    kv = sm.kv_mod.KV(cfg, device=sm.dev)
    t0 = time.monotonic()
    for a in range(0, n_fill, CHAOS_GET_B):
        b = min(a + CHAOS_GET_B, n_fill)
        kv.insert(keys[a:b], pages(slice(a, b)))
    t_fill = time.monotonic() - t0
    servers, proxies = [], []

    def serve(kv, proxy_seed):
        srv = NetServer(lambda: DirectBackend(kv)).start()
        servers.append(srv)
        px = ChaosProxy("127.0.0.1", srv.port, seed=proxy_seed, rates=rates,
                        delay_s=0.02, reorder_wait_s=0.05)
        proxies.append(px)
        return srv, px

    srv, px = serve(kv, seed)
    # the kernel's first launch and the GET at the verb widths, on a
    # chaos-free connection before the faulted window (test_chaos warms
    # its compile the same way): every warm key must serve its page
    with TcpBackend("127.0.0.1", srv.port, page_words=pw, keepalive_s=None,
                    op_timeout_s=120.0) as w:
        w.put(keys[warm], pages(warm))
        out, found = w.get(keys[warm])
        if not found.all() or wrong_pages(out, found, pages(warm)):
            raise AssertionError(f"{label}: the warm GET served a wrong "
                                 "page or missed")
        w.invalidate(keys[warm])
    port = [px.port]

    def factory():
        return TcpBackend("127.0.0.1", port[0], page_words=pw,
                          keepalive_s=None, op_timeout_s=CHAOS_OP_TIMEOUT_S,
                          pipeline=pipe, window=CHAOS_WINDOW)

    rc = ReconnectingClient(factory, page_words=pw, retry_delay_s=0.005,
                            max_retry_delay_s=0.1, seed=seed)
    be = IntegrityBackend(rc)
    st = dict(wrong_bytes=0, gets=0, found_gets=0, poisoned=0, restores=0,
              corrupt_detected=0, torn_refused=0, restored_hits=0,
              fill_s=t_fill)

    def restart(kv, step):
        """Kill and restore: a durable snapshot, a newer one torn at 70%
        (it must be refused), the server stopped, a KV restored from the
        durable file, which must serve exactly the hit set and pages the
        killed one served -> the restored KV."""
        durable = os.path.join(root, f"durable_{seed}_{step}.npz")
        torn = os.path.join(root, f"torn_{seed}_{step}.npz")
        want, want_found = pull_all(kv, keys, CHAOS_GET_B)
        kv.snapshot(durable)
        kv.snapshot(torn)
        os.truncate(torn, int(os.path.getsize(torn) * 0.7))
        srv.stop()
        px.close()
        try:
            checkpoint.load(torn, cfg, device=sm.dev)
        except CheckpointCorruptError:
            st["torn_refused"] += 1
        else:
            raise AssertionError(f"{label}: the torn snapshot loaded")
        kv = sm.kv_mod.KV(cfg, state=checkpoint.load(
            durable, cfg, device=sm.dev), device=sm.dev)
        for f in (durable, torn):
            os.remove(f)
        out, found = pull_all(kv, keys, CHAOS_GET_B)
        if not np.array_equal(found, want_found):
            raise AssertionError(
                f"{label}: the restored KV serves {int(found.sum())} keys, "
                f"the durable one served {int(want_found.sum())} "
                f"({int((found != want_found).sum())} differ)")
        if wrong_pages(out, found, want) \
                or wrong_pages(out, found, pages(slice(0, n))):
            raise AssertionError(f"{label}: the restored KV serves a wrong "
                                 "page")
        st["restores"] += 1
        st["restored_hits"] += int(found.sum())
        return kv

    t0 = time.monotonic()
    for step in range(steps):
        op = int(rng.integers(4))
        a = int(rng.integers(0, n_ops))
        sel = slice(a, min(a + int(rng.integers(1, max_verb)), n_ops))
        if op == 0:
            be.put(keys[sel], pages(sel))
        elif op in (1, 2):
            out, found = be.get(keys[sel])
            found = np.asarray(found, bool)
            st["gets"] += len(found)
            st["found_gets"] += int(found.sum())
            st["wrong_bytes"] += wrong_pages(np.asarray(out), found,
                                             pages(sel))
        else:
            be.invalidate(keys[sel])
        if not rc.stats()["connected"]:
            # disconnected ops fail locally in microseconds: pace them so
            # a reconnect is part of every run (as test_chaos does)
            time.sleep(0.02)
        if poison and step == steps // 4:
            st["corrupt_detected"] += chaos_poison(
                sm, kv, keys[probe], pages(probe), label)
            st["poisoned"] += 1
        if step in kill_at:
            kv = restart(kv, step)
            srv, px = serve(kv, seed + step)
            port[0] = px.port  # the factory dials the new proxy
    st["soak_s"] = time.monotonic() - t0
    be.close()
    px.close()  # the earlier ones were closed at their restart
    srv.stop()
    st["corrupt_detected"] += int(be.counters["corrupt_pages"])
    chaos = {}
    for x in proxies:
        for k, v in x.stats.items():
            chaos[k] = chaos.get(k, 0) + int(v)
    st["chaos"] = chaos
    st["client"] = {k: v for k, v in rc.stats().items()
                    if isinstance(v, (int, float, bool))}
    st["serve_errors"] = sum(int(x.stats["serve_errors"]) for x in servers)
    st["nacks_sent"] = sum(int(x.stats.snapshot()["nacks_sent"])
                           for x in servers)
    st["kv"] = kv
    st["present_lo"] = lo[:n_ops]
    return st


def chaos_gates(label: str, st: dict, restores: int,
                poisoned: int = 1) -> None:
    """The soak's gates (test_chaos's invariants and the wire's error
    counters)."""
    fails = []
    if st["wrong_bytes"]:
        fails.append(f"{st['wrong_bytes']} wrong pages served")
    if st["restores"] != restores or st["torn_refused"] != restores:
        fails.append(f"{st['restores']} restores, {st['torn_refused']} torn "
                     f"snapshots refused of {restores}")
    if st["poisoned"] != poisoned \
            or (poisoned and st["corrupt_detected"] <= 0):
        fails.append(f"poisoned {st['poisoned']}, corrupt_detected "
                     f"{st['corrupt_detected']}")
    if st["serve_errors"] or st["nacks_sent"]:
        fails.append(f"serve_errors {st['serve_errors']}, nacks_sent "
                     f"{st['nacks_sent']}")
    if fails:
        raise AssertionError(f"{label}: " + "; ".join(fails))


def chaos_cfg(index, bloom_bits, pw, tier=None):
    from pmdfc_tpu_torch.config import (BloomConfig, IndexConfig, KVConfig,
                                        TierConfig)

    if tier is not None:
        tier = TierConfig(**tier)
    return KVConfig(index=IndexConfig(**index),
                    bloom=BloomConfig(num_bits=bloom_bits), page_words=pw,
                    tier=tier)


def run_chaos_soaks(sm, root, smi):
    """Phase 14 (a): the soak unpipelined (the pool poisoned a quarter
    in, one kill and restore midway), then pipelined on a fresh 1 GiB KV
    -> (its kernels entry, the last soak's counts)."""
    cfg = chaos_cfg(CHAOS_INDEX, CHAOS_BLOOM_BITS, CHAOS_PAGE_WORDS)
    n_fill = int(CHAOS_INDEX["capacity"] * 0.75)
    sm.fused.launches.clear()
    last = None
    for pipe in (False, True):
        mode = "pipelined" if pipe else "unpipelined"
        kills = () if pipe else (CHAOS_STEPS // 2,)
        st = chaos_soak(sm, cfg, steps=CHAOS_STEPS, seed=sm.seed + 5,
                        rates=CHAOS_RATES, kill_at=kills, root=root,
                        pipe=pipe, n_fill=n_fill, n_ops=n_fill,
                        max_verb=CHAOS_VERB, n_warm=CHAOS_VERB,
                        n_probe=CHAOS_PROBE, poison=not pipe,
                        label=f"chaos {mode}")
        chaos_gates(f"chaos {mode}", st, len(kills), int(not pipe))
        held = ("the pool poisoned in place and every probe refused by the "
                f"kernel's digest check, a torn snapshot refused, the "
                f"restored hit set == durable ({st['restored_hits']} keys), "
                f"corrupt_detected {st['corrupt_detected']}"
                if not pipe else "window 8")
        client = {k: st["client"][k] for k in ("disconnects", "reconnects")
                  if k in st["client"]}
        log("chaos", f"soak {mode}: {CHAOS_STEPS} steps in "
            f"{st['soak_s']:.1f} s (fill {n_fill} pages in "
            f"{st['fill_s']:.1f} s), {st['found_gets']} hits of "
            f"{st['gets']} GET keys, 0 wrong bytes, {held}, no NACK, no "
            f"serve error; chaos {st['chaos']}; client {client} ({smi})")
        if last is not None:
            del last["kv"]
        last = st
        free_card(sm.torch)
    launches = sm.fused.launches["fused_get_linear_flat"]
    if launches <= 0:
        raise AssertionError("chaos: the fused GET never launched")
    kv = last.pop("kv")
    t = uncounted(sm.fused, lambda: plane_kernel(
        sm, kv.state, last["present_lo"], CHAOS_PAGE_WORDS, (CHAOS_VERB,),
        "chaos linear·flat", smi, hi=CHAOS_HI))
    del kv
    free_card(sm.torch)
    return plane_entry(sm, "chaos", launches, t[CHAOS_VERB]), last


def xray_plane(cfg, n: int):
    from pmdfc_tpu_torch.config import NetConfig
    from pmdfc_tpu_torch.parallel.plane import PlaneBackend
    from pmdfc_tpu_torch.parallel.shard import ShardedKV, make_mesh
    from pmdfc_tpu_torch.runtime.net import NetServer

    skv = ShardedKV(cfg, mesh=make_mesh([DEVICE] * n))
    be = PlaneBackend(skv)
    srv = NetServer(lambda: be, net=NetConfig(flush_timeout_us=200,
                                              settle_us=50)).start()
    return skv, srv


def reconciled(stats, where: str) -> None:
    from pmdfc_tpu_torch.kv import MISS_CAUSE_NAMES

    total = sum(int(stats[k]) for k in MISS_CAUSE_NAMES)
    if int(stats["misses"]) != total:
        raise AssertionError(f"{where}: misses {stats['misses']} != "
                             f"sum of causes {total}")


def shards_reconciled(rep: dict, where: str) -> None:
    from pmdfc_tpu_torch.kv import MISS_CAUSE_NAMES

    st = rep["stats"]
    for i in range(rep["n_shards"]):
        total = sum(int(st[k][i]) for k in MISS_CAUSE_NAMES)
        if int(st["misses"][i]) != total:
            raise AssertionError(f"{where}: shard {i} misses "
                                 f"{st['misses'][i]} != causes {total}")


def run_xray(sm, smi):
    """Phase 14 (b): `tests/test_xray.py`'s acceptance soak on the card ->
    its kernels entry."""
    import io
    import threading

    import numpy as np

    from pmdfc_tpu_torch.bench.tier_sweep import _zipf_stream
    from pmdfc_tpu_torch.config import TelemetryConfig
    from pmdfc_tpu_torch.kv import MISS_CAUSE_NAMES
    from pmdfc_tpu_torch.runtime import telemetry, timeseries
    from pmdfc_tpu_torch.runtime.failure import (ChaosProxy,
                                                 ReconnectingClient)
    from pmdfc_tpu_torch.runtime.net import TcpBackend
    from pmdfc_tpu_torch.runtime.server import KVServer
    from pmdfc_tpu_torch.tools import teletop
    from pmdfc_tpu_torch.tools.check_teledump import check

    telemetry.configure(TelemetryConfig(enabled=True))
    cap = XRAY_INDEX["capacity"]
    pw = CHAOS_PAGE_WORDS
    tier = dict(balloon_step=max(1, cap // 8), ghost_rows=max(1, cap // 16))
    cfg = chaos_cfg(XRAY_INDEX, XRAY_BLOOM_BITS, pw, tier)
    skv, srv = xray_plane(cfg, XRAY_SHARDS)
    skv2, srv2 = xray_plane(dataclasses.replace(cfg, tier=None), 2)
    rng = np.random.default_rng(sm.seed + 23)
    space = rng.choice(1 << 30, size=XRAY_KEYS, replace=False).astype(
        np.uint32)
    verb = XRAY_VERB
    # the kernel's first launch on every shard, chaos-free
    with TcpBackend("127.0.0.1", srv.port, page_words=pw,
                    keepalive_s=None, op_timeout_s=120.0) as w:
        k = np.stack([np.full(verb, XRAY_HI, np.uint32), space[:verb]], -1)
        w.get(k)
    proxy = ChaosProxy("127.0.0.1", srv.port, seed=11, rates=XRAY_RATES)
    cli = ReconnectingClient(
        lambda: TcpBackend("127.0.0.1", proxy.port, page_words=pw,
                           keepalive_s=None, op_timeout_s=5.0),
        page_words=pw, retry_delay_s=0.01)
    put_lo = set()
    sm.fused.launches.clear()
    t0 = time.monotonic()
    hits = gets = 0
    try:
        zipf = _zipf_stream(rng, XRAY_KEYS, XRAY_STEPS * verb, XRAY_ZIPF)
        for step in range(XRAY_STEPS):
            lo = space[zipf[step * verb:(step + 1) * verb]]
            keys = np.stack([np.full(verb, XRAY_HI, np.uint32), lo], -1)
            want = pages_np(XRAY_HI, lo, pw)
            if step % 3 == 0:
                cli.put(keys, want)
                put_lo.update(lo.tolist())
            out, found = cli.get(keys)
            found = np.asarray(found, bool)
            hits, gets = hits + int(found.sum()), gets + verb
            if wrong_pages(np.asarray(out), found, want):
                raise AssertionError(f"xray: step {step}: a hit's page "
                                     "differs from the key's page")
            if step == XRAY_STEPS // 2 and not skv.balloon_shrink(cap):
                raise AssertionError("xray: the balloon did not shrink")
            if step % 5 == 0:
                cli.invalidate(keys[:16])
        t_soak = time.monotonic() - t0
        launches = sm.fused.launches["fused_get_linear_tiered"]
        if launches <= 0:
            raise AssertionError("xray: the fused GET never launched")
        with TcpBackend("127.0.0.1", srv2.port, page_words=pw,
                        keepalive_s=None) as b2:
            k2 = np.stack([np.full(verb, XRAY_HI, np.uint32),
                           space[:verb]], -1)
            b2.put(k2[:verb // 2], pages_np(XRAY_HI, space[:verb // 2], pw))
            b2.get(k2)
        s = skv.stats()
        if not (s["gets"] > 0 and s["misses"] > 0):
            raise AssertionError(f"xray: gets {s['gets']}, misses "
                                 f"{s['misses']}")
        reconciled(s, "xray ShardedKV.stats")
        rep = skv.shard_report()
        shards_reconciled(rep, "xray shard_report")
        for k in ("misses", *MISS_CAUSE_NAMES):
            if sum(rep["stats"][k]) != s[k]:
                raise AssertionError(f"xray: shard rows of {k} sum to "
                                     f"{sum(rep['stats'][k])}, not {s[k]}")
        if s["miss_stale"] + s["miss_parked"] <= 0:
            raise AssertionError(f"xray: the shrink left no stale or parked "
                                 f"miss: {s}")
        ksrv = KVServer(cfg, kv=skv)
        reconciled(ksrv.health()["kv"], "xray KVServer.health")
        ksrv.engine.close()
        with TcpBackend("127.0.0.1", srv.port, page_words=pw,
                        keepalive_s=None) as mon:
            doc = mon.server_stats()
        reconciled(doc, "xray MSG_STATS")
        now = skv.stats()
        for k in ("misses", *MISS_CAUSE_NAMES):
            if int(doc[k]) != now[k]:
                raise AssertionError(f"xray: the wire's {k} {doc[k]} != "
                                     f"{now[k]}")
        shards_reconciled(doc["shard_report"], "xray MSG_STATS shards")
        errs = check(doc)
        if errs:
            raise AssertionError(f"xray: check_teledump: {errs[:5]}")
        # the port has no compile time to pad the soak: with light GETs
        # on the second server all the while, wait until the collector
        # has closed a window that holds them (one window, 1 s, once the
        # counters are armed), so teletop's one poll has a rate to read
        done = threading.Event()

        def light():
            with TcpBackend("127.0.0.1", srv2.port, page_words=pw,
                            keepalive_s=None) as b2:
                while not done.is_set():
                    b2.get(k2[:16])
                    done.wait(0.02)

        light_t = threading.Thread(target=light, name="xray-light")
        light_t.start()
        buf = io.StringIO()
        stdout, sys.stdout = sys.stdout, buf
        try:
            ring = timeseries.ensure_collector().ring
            deadline = time.monotonic() + 5 * COLLECTOR_WAIT_S
            while time.monotonic() < deadline and not any(
                    k.endswith(".ops") and v for w in ring.tail()[-1:]
                    for k, v in w["counters"].items()):
                time.sleep(0.05)
            rc = teletop.main([f"127.0.0.1:{srv.port}",
                               f"127.0.0.1:{srv2.port}", "--once", "--json",
                               "--page-words", str(pw)])
        finally:
            sys.stdout = stdout
            done.set()
            light_t.join(30)
        rows = json.loads(buf.getvalue())["servers"]
        r0 = rows[0] if rows else {}
        bad = [] if rc == 0 else [f"teletop exited {rc}"]
        if len(rows) != 2 or not all(r["ok"] for r in rows):
            bad.append(f"rows {rows}")
        elif (not all(r["ops_rate"] for r in rows) or r0["p99_us"] is None
              or not 0.0 <= r0["hit_rate"] <= 1.0
              or not 0 < r0["working_set"] <= 4 * r0["capacity"]
              or len(r0["shards"]) != XRAY_SHARDS
              or len(rows[1]["shards"]) != 2
              or r0["misses"] != sum(r0["miss_causes"].values())
              or any(x["misses"] != sum(x["miss_causes"].values())
                     for x in r0["shards"])):
            bad.append(f"row {json.dumps(r0)[:600]}")
        if bad or "teletop" not in teletop.render(rows):
            raise AssertionError("xray: teletop --once --json: "
                                 + "; ".join(bad))
        chaos = {k: int(v) for k, v in proxy.stats.items()}
    finally:
        cli.close()
        proxy.close()
        srv.stop()
        srv2.stop()
    log("xray", f"zipf {XRAY_ZIPF} soak over {XRAY_SHARDS} shards x {cap} "
        f"slots: {XRAY_STEPS} steps of {verb} keys in {t_soak:.1f} s, "
        f"{hits} hits of {gets}, every hit byte-exact; misses == sum of "
        f"causes on stats, {XRAY_SHARDS} shard rows, KVServer.health and "
        f"MSG_STATS (stale {s['miss_stale']}, parked {s['miss_parked']}, "
        f"cold {s['miss_cold']}, evicted {s['miss_evicted']}); "
        f"check_teledump clean; teletop rows: ops_rate "
        f"{r0['ops_rate']:.1f}/s (the last window, light GETs on the "
        f"second server), p99 {r0['p99_us']:.0f} us, hit_rate "
        f"{r0['hit_rate']:.3f}, per-shard gets "
        f"{[x['gets'] for x in r0['shards']]}; chaos {chaos}; "
        f"{launches} launches ({smi})")
    # each shard is held to the keys the plane routes to it, as the soak's
    # GETs reached it: another shard's keys would only miss its index
    present = np.fromiter(put_lo, np.uint32, len(put_lo))
    owner = skv.node_of(np.stack([np.full(len(present), XRAY_HI, np.uint32),
                                  present], -1))
    t = uncounted(sm.fused, lambda: plane_kernel(
        sm, skv._st[0][0], present[owner == 0], pw, (verb,),
        "xray shard 0 linear·tiered", smi, hi=XRAY_HI))
    for i in range(1, XRAY_SHARDS):
        uncounted(sm.fused, lambda i=i: plane_kernel(
            sm, skv._st[i][0], present[owner == i], pw, (verb,),
            f"xray shard {i} linear·tiered", smi, hi=XRAY_HI, timed=False))
    del skv, skv2
    free_card(sm.torch)
    return plane_entry(sm, "xray-plane", launches, t[verb],
                       "fused_get_linear_tiered")


def drill_keys(n: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    lo = rng.choice(1 << 30, size=n, replace=False).astype(np.uint32)
    return np.stack([np.full(n, DRILL_HI, np.uint32), lo], -1)


def drill_pages(keys, pw: int):
    return pages_np(keys[:, 0], keys[:, 1], pw)


def drill_bisection(sm, kv, pw: int) -> str:
    """Poison bisection on the card: 4 connections GET their own 2^11-key
    batches in one fused flush, the first connection's keys poisoned at
    the fault seam -> what held."""
    import math
    import threading

    import numpy as np

    from pmdfc_tpu_torch.client.backends import DirectBackend
    from pmdfc_tpu_torch.config import NetConfig, TelemetryConfig
    from pmdfc_tpu_torch.runtime import telemetry
    from pmdfc_tpu_torch.runtime.failure import FaultPlan, FaultyBackend
    from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend

    telemetry.configure(TelemetryConfig(ring_capacity=1 << 15))
    b, verb = 4, DRILL_VERB
    plan = FaultPlan()
    shared = FaultyBackend(DirectBackend(kv), plan)
    srv = NetServer(lambda: shared, net=NetConfig(
        flush_timeout_us=150_000, settle_us=40_000)).start()
    try:
        bes = [TcpBackend("127.0.0.1", srv.port, page_words=pw,
                          keepalive_s=None, op_timeout_s=60.0)
               for _ in range(b)]
        pools = [drill_keys(verb, 50 + i) for i in range(b)]
        for be, ks in zip(bes, pools):
            be.put(ks, drill_pages(ks, pw))
        plan.poison_keys(pools[0])
        barrier = threading.Barrier(b)
        errs, got = [], [None] * b

        def worker(i):
            try:
                barrier.wait()
                got[i] = bes[i].get(pools[i])
            except Exception as e:  # noqa: BLE001 - reported below
                errs.append((i, repr(e)))

        n0 = launched(sm.fused)
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(b)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        n_bisect = launched(sm.fused) - n0
        st = srv.stats.snapshot()
        fails = [f"an op raised through a NACK: {errs}"] if errs else []
        if st["poison_ops"] != 1 or st["nacks_sent"] < 1 \
                or st["bisect_failures"] > math.ceil(math.log2(b)):
            fails.append(f"poison_ops {st['poison_ops']}, nacks "
                         f"{st['nacks_sent']}, bisect_failures "
                         f"{st['bisect_failures']}")
        if got[0] is not None and np.asarray(got[0][1]).any():
            fails.append("the culprit's GET reported hits")
        for i in range(1, b):
            if got[i] is None:
                continue
            out, found = np.asarray(got[i][0]), np.asarray(got[i][1], bool)
            if not found.all() or wrong_pages(out, found,
                                              drill_pages(pools[i], pw)):
                fails.append(f"conn{i} lost or garbled its batch")
        out, found = bes[0].get(pools[1])
        if not np.asarray(found).all():
            fails.append("the victim's connection was dropped")
        bes[0].get(pools[0])  # the resubmit: refused at staging
        st2 = srv.stats.snapshot()
        if st2["poison_refused"] < 1 or st2["poison_ops"] != 1:
            fails.append(f"resubmit: refused {st2['poison_refused']}, "
                         f"poison_ops {st2['poison_ops']}")
        # the fingerprint is seeded with the verb: a PUT of the culprit's
        # keys is its own op (isolated, not refused), its resubmit is
        bad = pools[0]
        bes[0].put(bad, drill_pages(bad, pw))
        st3 = srv.stats.snapshot()
        bes[0].put(bad, drill_pages(bad, pw))
        st4 = srv.stats.snapshot()
        if st3["poison_ops"] != 2 \
                or st3["poison_refused"] != st2["poison_refused"] \
                or st4["poison_refused"] <= st3["poison_refused"]:
            fails.append(f"verb-seeded fingerprint: poison_ops "
                         f"{st3['poison_ops']}, refused "
                         f"{st2['poison_refused']} -> "
                         f"{st3['poison_refused']} -> "
                         f"{st4['poison_refused']}")
        if st2["serve_errors"]:
            fails.append(f"serve_errors {st2['serve_errors']}")
        for be in bes:
            be.close()
    finally:
        srv.stop()
    nacked = {r["src"] for r in telemetry.get().ring
               if r.get("kind") == "span" and not r.get("ok", True)
               and str(r.get("err", "")).startswith("nack:")
               and "span" in r and "trace" in r}
    if not {"client", "server"} <= nacked:
        fails.append(f"NACKed ops closed failed v2 spans only on {nacked}")
    if fails:
        raise AssertionError("drill bisection: " + "; ".join(fails))
    return (f"poison bisection over {b} connections x {verb} keys: 1 "
            f"culprit NACKed, bisect_failures {st['bisect_failures']} <= "
            f"{math.ceil(math.log2(b))}, {st['nacks_sent']} NACKs, no "
            f"connection dropped, resubmit refused; {n_bisect} kernel "
            f"launches in the bisected flush; a PUT of its keys isolated "
            f"on its own and its resubmit refused; the NACKed ops' client "
            f"and server spans closed failed")


def drill_deadline(sm, kv, pw: int, present) -> str:
    """A 1 ms budget against a 120 ms settle: the sweep sheds the staged
    GETs before dispatch (no launch) into `miss_deadline`."""
    import numpy as np

    from pmdfc_tpu_torch.client.backends import DirectBackend
    from pmdfc_tpu_torch.config import NetConfig
    from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend

    srv = NetServer(lambda: DirectBackend(kv), net=NetConfig(
        flush_timeout_us=200_000, settle_us=120_000)).start()
    try:
        s0, n0 = kv.stats(), launched(sm.fused)
        with TcpBackend("127.0.0.1", srv.port, page_words=pw,
                        keepalive_s=None, deadline_ms=1.0) as be:
            if not be.nack:
                raise AssertionError("drill deadline: NACK not negotiated")
            _, f1 = be.get(present)
            _, f2 = be.get(present[:4])
        n = launched(sm.fused) - n0
        st, s = srv.stats.snapshot(), kv.stats()
        # deadline_ms=0 (the default, an old peer's stamp) never sheds
        fresh = drill_keys(len(present), 5)
        with TcpBackend("127.0.0.1", srv.port, page_words=pw,
                        keepalive_s=None) as be:
            be.put(fresh, drill_pages(fresh, pw))
            out, f0 = be.get(fresh)
        f0 = np.asarray(f0, bool)
        if not f0.all() or wrong_pages(np.asarray(out), f0,
                                       drill_pages(fresh, pw)) \
                or srv.stats.snapshot()["deadline_shed"] != st[
                    "deadline_shed"]:
            raise AssertionError("drill deadline: a GET without a deadline "
                                 "was shed or served wrong")
    finally:
        srv.stop()
    shed = s["miss_deadline"] - s0["miss_deadline"]
    reconciled(s, "drill deadline KV.stats")
    if np.asarray(f1).any() or np.asarray(f2).any() or n \
            or st["deadline_shed"] < 1 or shed < len(present):
        raise AssertionError(
            f"drill deadline: hits {int(np.asarray(f1).sum())}, launches "
            f"{n}, deadline_shed {st['deadline_shed']}, miss_deadline "
            f"+{shed} of {len(present)}")
    return (f"deadline: {len(present)} + 4 expired GET keys shed before "
            f"dispatch ({st['deadline_shed']} ops, miss_deadline +{shed}, "
            f"no kernel launch); deadline 0 served all {len(present)} "
            f"fresh keys")


def drill_quarantine(sm, pw: int) -> str:
    """Plane shard quarantine on the card: a 4-shard plane, one shard
    failed at the seam until its breaker trips, its rows miss as
    `miss_quarantined` while the others serve, then healed and re-admitted
    through the half-open probe with its keys intact."""
    import numpy as np

    from pmdfc_tpu_torch.config import ContainmentConfig
    from pmdfc_tpu_torch.parallel.plane import make_serving_backend
    from pmdfc_tpu_torch.parallel.shard import make_mesh
    from pmdfc_tpu_torch.runtime.failure import FaultPlan, ShardFault

    plan = FaultPlan()
    cfg = chaos_cfg(DRILL_INDEX, 1 << 16, pw)
    be = make_serving_backend(
        cfg, mesh=make_mesh([DEVICE] * 4),
        containment=ContainmentConfig(quarantine_failures=2,
                                      quarantine_cooldown_s=0.05,
                                      quarantine_max_cooldown_s=0.2),
        fault_plan=plan)
    skv = be.skv
    pool = drill_keys(DRILL_VERB, 7)
    be.put(pool, drill_pages(pool, pw))
    _, res = be.get(pool)
    pool = pool[np.asarray(res, bool)]
    node = skv.node_of(pool)
    k = int(np.bincount(node, minlength=4).argmax())
    on_k = pool[node == k]
    plan.fail_shard(k)
    for _ in range(8):
        try:
            be.get(pool[:256])
        except ShardFault:
            pass
        if be.quarantine.quarantined():
            break
    if be.quarantine.quarantined() != [k]:
        raise AssertionError(f"drill quarantine: quarantined "
                             f"{be.quarantine.quarantined()}, not [{k}]")
    out, found = be.get(pool)
    f = np.asarray(found, bool)
    st = skv.stats()
    rep = skv.shard_report()
    reconciled(st, "drill quarantine stats")
    shards_reconciled(rep, "drill quarantine shard_report")
    if f[node == k].any() or not f[node != k].all() \
            or wrong_pages(np.asarray(out), f, drill_pages(pool, pw)) \
            or st["miss_quarantined"] < int((node == k).sum()) \
            or rep["stats"]["miss_quarantined"][k] <= 0:
        raise AssertionError(f"drill quarantine: sick rows hit "
                             f"{int(f[node == k].sum())}, healthy missed "
                             f"{int((~f[node != k]).sum())}, "
                             f"miss_quarantined {st['miss_quarantined']}")
    plan.heal_shard(k)
    deadline = time.monotonic() + 10.0
    while be.quarantine.quarantined() and time.monotonic() < deadline:
        time.sleep(0.02)
        try:
            be.get(on_k[:16])
        except ShardFault:
            pass
    out, found = be.get(on_k)
    found = np.asarray(found, bool)
    if be.quarantine.quarantined() or not found.all() \
            or wrong_pages(np.asarray(out), found, drill_pages(on_k, pw)):
        raise AssertionError("drill quarantine: the healed shard was not "
                             "re-admitted with its keys")
    reconciled(skv.stats(), "drill quarantine after re-admission")
    readmits = be.quarantine.report()["stats"]["readmits"]
    del be, skv
    free_card(sm.torch)
    return (f"plane quarantine: shard {k} tripped, {int((node == k).sum())}"
            f" rows miss_quarantined, the other shards served byte-exact, "
            f"shard rows reconciled, re-admitted ({readmits}) with its "
            f"{len(on_k)} keys intact")


def drill_qos(sm, kv, pw: int) -> str:
    """The QoS wire shed drill: a tenant whose 2^11-page verbs exceed its
    bucket's burst sheds at the edge; every shed lands in `miss_shed` on
    the KV and the wire document, the untagged tenant is untouched."""
    import numpy as np

    from pmdfc_tpu_torch.client.backends import DirectBackend
    from pmdfc_tpu_torch.config import NetConfig, QosConfig, TenantConfig
    from pmdfc_tpu_torch.runtime import qos
    from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend
    from pmdfc_tpu_torch.tools.check_teledump import check

    verb = DRILL_VERB
    qcfg = QosConfig(tenant_bits=4, tenants=(
        TenantConfig(tid=2, rate_ops_per_s=1.0, burst_ops=4),))
    s0 = kv.stats()
    srv = NetServer(lambda: DirectBackend(kv), net=NetConfig(),
                    qos=qcfg).start()
    try:
        with TcpBackend("127.0.0.1", srv.port, page_words=pw,
                        keepalive_s=None) as be:
            good = drill_keys(verb, 1)
            be.put(good, drill_pages(good, pw))
            out, found = be.get(good)
            ok = bool(np.asarray(found).all()) and not wrong_pages(
                np.asarray(out), np.asarray(found, bool),
                drill_pages(good, pw))
            bad = drill_keys(3 * verb, 2)
            bad[:, 0] = qos.tag_oids(bad[:, 0], 2, 4)
            be.put(bad[:verb], drill_pages(bad[:verb], pw))
            shed_hits = 0
            for i in range(3):
                _, found = be.get(bad[i * verb:(i + 1) * verb])
                shed_hits += int(np.asarray(found).sum())
            doc = be.server_stats()
        sc = dict(srv.qos_plane().scope(2))
        edge0 = dict(srv.qos_plane().scope(0))["shed_edge"]
    finally:
        srv.stop()
    s = kv.stats()
    shed = s["miss_shed"] - s0["miss_shed"]
    reconciled(s, "drill qos KV.stats")
    reconciled(doc, "drill qos MSG_STATS")
    errs = check(doc)
    if not ok or shed_hits or shed != 3 * verb \
            or s["drops"] - s0["drops"] < verb \
            or int(doc["miss_shed"]) - s0["miss_shed"] != 3 * verb \
            or (sc["ops"], sc["shed_edge"], sc["staged"], sc["shed_ladder"],
                sc["shed_gets"], sc["shed_puts"]) != (4, 4, 0, 0, 3, 1) \
            or edge0 or errs:
        raise AssertionError(f"drill qos: compliant served {ok}, shed hits "
                             f"{shed_hits}, miss_shed +{shed}, lanes {sc}, "
                             f"default edge sheds {edge0}, {errs[:3]}")
    return (f"qos: 4 verbs of tenant 2 ({verb} pages each, burst 4) shed at "
            f"the edge, miss_shed +{shed} on KV.stats and MSG_STATS, the "
            f"untagged tenant served whole, teledump clean")


class env_set:
    """`os.environ[name] = value` inside the block, restored after."""

    def __init__(self, name: str, value: str):
        self.name, self.value = name, value

    def __enter__(self):
        self.old = os.environ.get(self.name)
        os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.old


def drill_negotiation(sm, kv, pw: int) -> str:
    """`MSG_NACK` negotiation and its kill switches (either side's
    `PMDFC_CONTAINMENT=off` withholds it), and an unnegotiated peer's
    contract: its poisoned op drops the connection, nothing is a NACK,
    the server serves a fresh one."""
    import numpy as np

    from pmdfc_tpu_torch.client.backends import DirectBackend
    from pmdfc_tpu_torch.config import NetConfig
    from pmdfc_tpu_torch.runtime.failure import FaultPlan, FaultyBackend
    from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend

    plan = FaultPlan()
    shared = FaultyBackend(DirectBackend(kv), plan)

    def server():
        return NetServer(lambda: shared, net=NetConfig(
            flush_timeout_us=150_000, settle_us=40_000)).start()

    def tcp(srv, **kw):
        return TcpBackend("127.0.0.1", srv.port, page_words=pw,
                          keepalive_s=None, **kw)

    srv = server()
    with env_set("PMDFC_CONTAINMENT", "off"):
        srv_off = server()
    try:
        with tcp(srv) as be:
            on = be.nack
        with env_set("PMDFC_CONTAINMENT", "off"):
            with tcp(srv) as be:
                client_off = be.nack
        with tcp(srv_off) as be:
            server_off = be.nack
        if not on or client_off or server_off:
            raise AssertionError(f"drill negotiation: nack {on}, client off "
                                 f"{client_off}, server off {server_off}")
        bad = drill_keys(DRILL_VERB, 70)
        plan.poison_keys(bad)
        dropped = False
        with env_set("PMDFC_CONTAINMENT", "off"):
            be = tcp(srv, op_timeout_s=30.0)
            try:
                be.put(bad, drill_pages(bad, pw))
                be.get(bad)  # the drop may land on the next roundtrip
            except (ConnectionError, OSError):
                dropped = True
            be.close()
        ks = drill_keys(DRILL_VERB, 71)
        with tcp(srv) as be:
            be.put(ks, drill_pages(ks, pw))
            out, found = be.get(ks)
        found = np.asarray(found, bool)
        if not dropped or not found.all() or wrong_pages(
                np.asarray(out), found, drill_pages(ks, pw)):
            raise AssertionError(f"drill negotiation: unnegotiated peer "
                                 f"dropped {dropped}, the server then "
                                 f"served {int(found.sum())} of {len(ks)}")
    finally:
        srv.stop()
        srv_off.stop()
    return ("NACK negotiated by default and withheld by either side's "
            "PMDFC_CONTAINMENT=off; an unnegotiated peer's poisoned op "
            "dropped its connection and the server served a fresh one")


def drill_plane_off(sm, pw: int) -> str:
    """`PMDFC_CONTAINMENT=off` on the plane: no quarantine, verbs served
    as before, a shard failure raised as it comes."""
    import numpy as np

    from pmdfc_tpu_torch.parallel.plane import make_serving_backend
    from pmdfc_tpu_torch.parallel.shard import make_mesh
    from pmdfc_tpu_torch.runtime.failure import FaultPlan, ShardFault

    plan = FaultPlan()
    with env_set("PMDFC_CONTAINMENT", "off"):
        be = make_serving_backend(chaos_cfg(DRILL_INDEX, 1 << 16, pw),
                                  mesh=make_mesh([DEVICE] * 4),
                                  fault_plan=plan)
    pool = drill_keys(DRILL_VERB, 9)
    be.put(pool, drill_pages(pool, pw))
    out, found = be.get(pool)
    f = np.asarray(found, bool)
    raised = False
    plan.fail_shard(0)
    try:
        for _ in range(4):
            be.get(pool)
    except ShardFault:
        raised = True
    st = be.skv.stats()
    if be.quarantine is not None or not f.any() or wrong_pages(
            np.asarray(out), f, drill_pages(pool, pw)) or not raised \
            or st["miss_quarantined"] or st["miss_deadline"]:
        raise AssertionError(f"drill plane off: quarantine "
                             f"{be.quarantine}, raised {raised}, {st}")
    del be
    free_card(sm.torch)
    return ("plane with PMDFC_CONTAINMENT=off: no quarantine, "
            f"{int(f.sum())} hits byte-exact, the shard fault raised raw, "
            "nothing attributed to miss_quarantined or miss_deadline")


def drill_qos_off(sm, kv, pw: int) -> str:
    """`PMDFC_QOS=off`: a server built with a QosConfig carries no plane
    and no tenant scope and serves the throttled tenant whole; the client
    edge stops tagging."""
    import numpy as np

    from pmdfc_tpu_torch.client.backends import DirectBackend, LocalBackend
    from pmdfc_tpu_torch.client.cleancache import CleanCacheClient
    from pmdfc_tpu_torch.config import (NetConfig, QosConfig,
                                        TelemetryConfig, TenantConfig)
    from pmdfc_tpu_torch.runtime import qos, telemetry
    from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend

    # a fresh registry: the QoS drill's tenant scopes stay in the last one
    telemetry.configure(TelemetryConfig(enabled=True))
    qcfg = QosConfig(tenant_bits=4, tenants=(
        TenantConfig(tid=2, rate_ops_per_s=1.0, burst_ops=1),))
    with env_set("PMDFC_QOS", "off"):
        srv = NetServer(lambda: DirectBackend(kv), net=NetConfig(),
                        qos=qcfg).start()
        try:
            keys = drill_keys(DRILL_VERB, 4)
            keys[:, 0] = qos.tag_oids(keys[:, 0], 2, 4)
            with TcpBackend("127.0.0.1", srv.port, page_words=pw,
                            keepalive_s=None) as be:
                be.put(keys, drill_pages(keys, pw))
                out, found = be.get(keys)
                doc = be.server_stats()
            plane = srv._qos
        finally:
            srv.stop()
        cc = CleanCacheClient(LocalBackend(page_words=pw, capacity=1 << 10),
                              tenant=5, tenant_bits=4)
        oids = np.array([1, 2, 3], np.uint32)
        untagged = np.array_equal(cc._tag(oids), oids)
    found = np.asarray(found, bool)
    snap = doc.get("telemetry") or {}
    scopes = [k for sect in ("counters", "gauges")
              for k in (snap.get(sect) or {}) if ".qos.t" in k]
    if plane is not None or not found.all() or wrong_pages(
            np.asarray(out), found, drill_pages(keys, pw)) or scopes \
            or not untagged:
        raise AssertionError(f"drill qos off: plane {plane}, served "
                             f"{int(found.sum())}, scopes {scopes[:3]}, "
                             f"client untagged {untagged}")
    return (f"PMDFC_QOS=off: no plane, no tenant scope, the throttled "
            f"tenant's {len(keys)} pages served whole, the client untagged")


def drill_storm(sm, kv, pw: int) -> str:
    """An unnegotiated client against a server whose every phase fails
    drops and redials; once the server is gone its dials are spaced by
    backoff, not one per degraded op."""
    import numpy as np

    from pmdfc_tpu_torch.client.backends import DirectBackend
    from pmdfc_tpu_torch.config import NetConfig
    from pmdfc_tpu_torch.runtime.failure import (FaultPlan, FaultyBackend,
                                                 ReconnectingClient)
    from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend

    plan = FaultPlan()
    shared = FaultyBackend(DirectBackend(kv), plan)
    keys = drill_keys(DRILL_VERB, 31)
    plan.poison_keys(keys)
    with env_set("PMDFC_CONTAINMENT", "off"):
        srv = NetServer(lambda: shared, net=NetConfig(
            flush_timeout_us=20_000, settle_us=2_000)).start()
        rc = ReconnectingClient(
            lambda: TcpBackend("127.0.0.1", srv.port, page_words=pw,
                               keepalive_s=None, op_timeout_s=30.0),
            page_words=pw, retry_delay_s=0.02, max_retry_delay_s=0.3,
            backoff=2.0, seed=31)
        hits = 0
        try:
            for _ in range(3):
                hits += int(np.asarray(rc.get(keys)[1]).sum())
                deadline = time.monotonic() + 0.25
                while not rc.connected and time.monotonic() < deadline:
                    rc.get(keys[:1])
                    time.sleep(0.01)
            disconnects = rc.stats()["disconnects"]
        finally:
            srv.stop()
        rc.get(keys)
        b0 = rc.stats()["reconnect_backoffs"]
        t_end = time.monotonic() + 0.7
        ops = 0
        while time.monotonic() < t_end:
            hits += int(np.asarray(rc.get(keys)[1]).sum())
            ops += 1
        attempts = rc.stats()["reconnect_backoffs"] - b0
        rc.close()
    if hits or disconnects < 3 or ops <= 50 or not 2 <= attempts <= 10:
        raise AssertionError(f"drill storm: hits {hits}, disconnects "
                             f"{disconnects}, {ops} degraded ops, "
                             f"{attempts} dials in 0.7 s")
    return (f"reconnect storm: {disconnects} dropped connections, then "
            f"{ops} degraded ops against the dead server cost {attempts} "
            f"dials in 0.7 s")


def run_drills(sm, smi) -> None:
    """Phase 14 (c): the wire drills on a 2^16-slot KV on the card (each
    the card's counterpart of a JAX drill marked `slow`)."""
    pw = CHAOS_PAGE_WORDS
    kv = sm.kv_mod.KV(chaos_cfg(DRILL_INDEX, 1 << 16, pw), device=sm.dev)
    present = drill_keys(DRILL_VERB, 3)
    kv.insert(present, drill_pages(present, pw))
    for drill in (lambda: drill_bisection(sm, kv, pw),
                  lambda: drill_negotiation(sm, kv, pw),
                  lambda: drill_deadline(sm, kv, pw, present),
                  lambda: drill_quarantine(sm, pw),
                  lambda: drill_plane_off(sm, pw),
                  lambda: drill_qos(sm, kv, pw),
                  lambda: drill_qos_off(sm, kv, pw),
                  lambda: drill_storm(sm, kv, pw)):
        log("drill", f"{drill()} ({smi})")
    del kv
    free_card(sm.torch)


def chaos_dir():
    """Where phase 14 writes its snapshots (git-ignored, on the checkout's
    disk); removed at the end of the phase."""
    from pathlib import Path

    return Path(__file__).resolve().parent / "build" / "chaos"


def run_chaos(sm):
    """Phase 14, in this process: (a), (b) and (c) -> the kernel entries
    of its two GET paths."""
    import shutil

    t_phase = time.monotonic()
    smi = nvidia_smi()
    root = chaos_dir()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        t0 = time.monotonic()
        chaos, _ = run_chaos_soaks(sm, str(root), smi)
        t_a = time.monotonic() - t0
        xray = run_xray(sm, smi)
        t_b = time.monotonic() - t0 - t_a
        run_drills(sm, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t_all = time.monotonic() - t_phase
    log("chaos", f"phase 14 took {t_all:.1f} s: (a) {t_a:.1f} s, (b) "
        f"{t_b:.1f} s, (c) {t_all - t_a - t_b:.1f} s")
    return [chaos, xray]


def chaos_subprocess(seed: int):
    """`run_chaos` in a child process of this script (`--chaos`) -> (its
    kernel entries, its log lines, seconds). A child that fails fails
    the phase."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--chaos", "--seed",
         str(seed)], capture_output=True, text=True,
        timeout=CHAOS_TIMEOUT_S)
    entries, lines = None, []
    for line in proc.stdout.splitlines():
        if line.startswith("CHAOS "):
            entries = json.loads(line[len("CHAOS "):])
        else:
            lines.append(line)
    if proc.returncode != 0 or entries is None:
        raise AssertionError(f"chaos child exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    return entries, lines, time.monotonic() - t0


def collect_chaos(lanes: "Lanes"):
    """Phase 14's child, queued in `lanes` at phase 12's start: its lines
    echoed, its kernel entries returned."""
    (entries, lines, secs), = lanes.rows("chaos")
    for line in lines:
        print(line, flush=True)
    log("chaos", f"phase 14's child took {secs:.1f} s (in the lanes, "
        f"{lanes.span('chaos')})")
    return entries


# ---------------------------------------------------------------------------
# phase 15, trace: causal tracing across processes and the SLO watchdog
# ---------------------------------------------------------------------------

TRACE_SHARDS = 4
TRACE_INDEX = dict(capacity=1 << 17)  # a shard: 512 MiB of 4 KiB pages
TRACE_BLOOM_BITS = 1 << 20
TRACE_PAGE_WORDS = 1024
TRACE_FILL = 0.75          # of the plane's slots, through plane_fill (a2a)
TRACE_CONNS = 8            # the client child's connections
TRACE_PUTS = 4             # PUT verbs of TRACE_VERB keys per connection
TRACE_GETS = 16            # GET verbs of TRACE_VERB keys per connection
TRACE_VERB = 1 << 11
TRACE_HI = 0xC7000000      # the pre-fill's keys are (TRACE_HI, i)
TRACE_PUT_HI = 0xC7100000  # connection c puts (TRACE_PUT_HI + c, i)
TRACE_RING = 1 << 16       # each process's flight ring holds the window
TRACE_WAIT_S = 1150.0      # the client child's wait for the server
TRACE_CLIENT_TIMEOUT_S = 1200.0
# CUDA events time to about half a microsecond: a flush span shorter
# than its device window by less than this is the timer's resolution
TRACE_EVENT_SLACK_NS = 1000
# the SLO drills: JAX's injected-latency drill (20 ms lag, a 2 ms p99
# GET target, two burn windows) and the healthy control (10x the warm-up
# p99, at least three evaluated windows)
TRACE_LAG_S = 0.02
TRACE_BREACH_TARGET_US = 2000.0
TRACE_SLO_GETS = 6         # GET verbs per window of the breach drill
TRACE_WARMUP_GETS = 16     # the healthy control's warm-up verbs
TRACE_HEALTHY_WINDOWS = 3
TRACE_HEALTHY_GETS = 8     # GET verbs per healthy window
TRACE_CHAIN = (("group", "get"), ("group", "attempt"), ("client", "get"),
               ("server", "get"), ("server", "phase"),
               ("server", "flush:get"), ("server", "shard_program"))
TRACE_STAGES = ("flush:get", "shard:get", "server:queue_wait")
# the two sweeps, each its own process in the lanes at 4 KiB pages
TRACE_SWEEPS = (
    ("net_sweep", ("--smoke", "--page-words", "1024", "--capacity",
                   str(1 << 17))),
    ("autotune_sweep", ("--smoke", "--backend", "direct", "--page-words",
                        "1024")),
)


def trace_client(root: str) -> int:
    """Phase 15's client process (`--trace-client DIR`): waits for the
    server's address and the phase's sizes in DIR/server.json (or for
    DIR/abort), drives one `ReplicaGroup(rf 1) -> ReconnectingClient ->
    pipelined TcpBackend` per connection, each in its own thread (PUT
    verbs of its own keys, then GET verbs of pre-filled, own and
    never-inserted keys), checks every page it gets, writes its flight
    dump and prints `TRACE_CLIENT {...}`. It touches no device."""
    import threading

    import numpy as np

    from pmdfc_tpu_torch.client.replica import ReplicaGroup
    from pmdfc_tpu_torch.config import ReplicaConfig, TelemetryConfig
    from pmdfc_tpu_torch.runtime import telemetry as tele
    from pmdfc_tpu_torch.runtime.failure import ReconnectingClient
    from pmdfc_tpu_torch.runtime.net import TcpBackend

    deadline = time.monotonic() + TRACE_WAIT_S
    spec = os.path.join(root, "server.json")
    while not os.path.exists(spec):
        if os.path.exists(os.path.join(root, "abort")) \
                or time.monotonic() > deadline:
            print("trace client: no server", file=sys.stderr)
            return 1
        time.sleep(0.05)
    with open(spec) as f:
        p = json.load(f)
    pw, verb = p["page_words"], p["verb"]
    dump_dir = os.path.join(root, "client")
    os.makedirs(dump_dir, exist_ok=True)
    tele.configure(TelemetryConfig(enabled=True, ring_capacity=p["ring"],
                                   dump_records=p["ring"], dump_dir=dump_dir,
                                   dump_min_interval_s=0.0))

    def group(c):
        def factory():
            return TcpBackend("127.0.0.1", p["port"], page_words=pw,
                              pipeline=True, op_timeout_s=120.0)

        rc = ReconnectingClient(factory, page_words=pw, seed=c)
        return rc, ReplicaGroup(
            [rc], page_words=pw, seed=c,
            cfg=ReplicaConfig(n_replicas=1, rf=1, repair_interval_s=0.0))

    conns = [group(c) for c in range(p["conns"])]
    out = [None] * len(conns)

    def drive(c):
        g = conns[c][1]
        rng = np.random.default_rng(p["seed"] * 1000 + c)
        r = dict(hits=0, keys=0, wrong=0, nonzero=0, never_hits=0,
                 acked_misses=0, put_ms=[], get_ms=[])
        hi_own = p["put_hi"] + c
        for v in range(p["puts"]):
            lo = np.arange(v * verb, (v + 1) * verb, dtype=np.uint32)
            his = np.full(verb, hi_own, np.uint32)
            t0 = time.perf_counter()
            g.put(np.stack([his, lo], -1), pages_np(his, lo, pw))
            r["put_ms"].append((time.perf_counter() - t0) * 1e3)
        n_own, n_never = verb // 4, verb // 8
        n_pre = verb - n_own - n_never
        for _ in range(p["gets"]):
            his = np.concatenate([
                np.full(n_pre, p["hi"], np.uint32),
                np.full(n_own, hi_own, np.uint32),
                np.full(n_never, p["hi"], np.uint32)])
            los = np.concatenate([
                rng.integers(0, p["fill"], n_pre),
                rng.integers(0, p["puts"] * verb, n_own),
                rng.integers(NEVER_LO, 1 << 32, n_never)]).astype(np.uint32)
            never = np.arange(verb) >= n_pre + n_own
            perm = rng.permutation(verb)
            his, los, never = his[perm], los[perm], never[perm]
            t0 = time.perf_counter()
            got, found = g.get(np.stack([his, los], -1))
            r["get_ms"].append((time.perf_counter() - t0) * 1e3)
            got, found = np.asarray(got, np.uint32), np.asarray(found, bool)
            want = pages_np(his, los, pw)
            r["keys"] += verb
            r["hits"] += int(found.sum())
            r["wrong"] += int((got[found] != want[found]).any(1).sum())
            r["nonzero"] += int(got[~found].any(1).sum())
            r["never_hits"] += int((found & never).sum())
            r["acked_misses"] += int((~found & ~never).sum())
        out[c] = r

    def run(c):
        try:
            drive(c)
        except Exception as e:  # noqa: BLE001 — reported to the server
            out[c] = {"error": repr(e)}

    threads = [threading.Thread(target=run, args=(c,))
               for c in range(len(conns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rcs = [rc.stats() for rc, _ in conns]
    for _, g in conns:
        g.close()
    errors = [r["error"] for r in out if "error" in r]
    held = len(tele.get().ring)
    res = {"errors": errors, "ring": held,
           "dump": tele.dump_now("trace_client")}
    if not errors:
        for k in ("hits", "keys", "wrong", "nonzero", "never_hits",
                  "acked_misses"):
            res[k] = sum(r[k] for r in out)
        for k in ("put_ms", "get_ms"):
            xs = np.concatenate([r[k] for r in out])
            res[k] = [float(np.percentile(xs, q)) for q in (50, 99)]
    for k in ("disconnects", "dropped_puts", "missed_gets"):
        res[k] = sum(int(s[k]) for s in rcs)
    print("TRACE_CLIENT " + json.dumps(res), flush=True)
    return 0


def trace_client_subprocess(root: str, seed: int):
    """`trace_client` as a child process of this script -> (its result,
    its log lines, seconds). A child that fails fails the phase."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--trace-client", root,
         "--seed", str(seed)], capture_output=True, text=True,
        timeout=TRACE_CLIENT_TIMEOUT_S)
    res, lines = None, []
    for line in proc.stdout.splitlines():
        if line.startswith("TRACE_CLIENT "):
            res = json.loads(line[len("TRACE_CLIENT "):])
        else:
            lines.append(line)
    if proc.returncode != 0 or res is None:
        raise AssertionError(f"trace client exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    return res, lines, time.monotonic() - t0


def trace_sweep(name: str, args, tmp: str):
    """One of phase 15's sweeps as its own process on DEVICE, held to its
    own gate (exit 0 and its `smoke OK` line) -> (its summary with its
    rows, seconds)."""
    t0 = time.monotonic()
    out = os.path.join(tmp, f"trace_{name}.json")
    proc = subprocess.run(
        [sys.executable, "-m", f"pmdfc_tpu_torch.bench.{name}", "--device",
         DEVICE, *args, "--out", out], capture_output=True, text=True,
        timeout=600)
    if proc.returncode != 0 or f"[{name}] smoke OK" not in proc.stdout:
        raise AssertionError(f"sweep {name} exited {proc.returncode} "
                             f"without its smoke OK: {proc.stdout[-2000:]} "
                             f"{proc.stderr[-2000:]}")
    with open(out) as f:
        return json.load(f), time.monotonic() - t0


def has_chain(node, chain) -> bool:
    """Does a path from `node` down its joined children name `chain`'s
    (src, op) pairs in order?"""
    if (node.rec.get("src"), node.op) != chain[0]:
        return False
    return len(chain) == 1 or any(has_chain(k, chain[1:])
                                  for k in node.all_children())


def quantiles(xs, qs=(50, 95)) -> list:
    import numpy as np

    return [float(np.percentile(xs, q)) for q in qs]


def trace_joined(dumps, conns: int, n_gets: int, smi: str) -> list:
    """Phase 15 (a)'s checks through the port's `tracetool` and
    `check_teledump` over the two processes' flight dumps (`dumps`:
    [(path, the records its process's ring held)], the client's first) ->
    the server dump's span records."""
    from pmdfc_tpu_torch.tools import check_teledump as chk
    from pmdfc_tpu_torch.tools import tracetool

    for path, held in dumps:
        with open(path) as f:
            doc = json.load(f)
        errs = chk.check_flight(doc)
        if errs:
            raise AssertionError(f"trace: check_flight on {path}: {errs[:5]}")
        if len(doc["records"]) < held:
            raise AssertionError(f"trace: {path} holds {len(doc['records'])}"
                                 f" records of the {held} its ring held")
    records = tracetool.load_dumps([path for path, _ in dumps])
    nodes = tracetool.build_tree(records)
    roots = [n for n in nodes[(-1, 0)].children
             if n.pid == 0 and n.rec.get("src") == "group"
             and n.op == "get" and n.rec.get("ok")]
    if len(roots) != n_gets:
        raise AssertionError(f"trace: {len(roots)} traced group GETs in the "
                             f"client dump, {n_gets} driven")
    n_events = []
    for n in roots:
        t = n.rec["trace"]
        if n.depth() < 6 or not has_chain(n, TRACE_CHAIN):
            held = [(pid, r.get("src"), r.get("op"), r.get("conn"))
                    for pid, r in records if r.get("trace") == t]
            raise AssertionError(
                f"trace: GET trace {t:#010x} is {n.depth()} deep without "
                f"the chain {' -> '.join(f'{s}:{o}' for s, o in TRACE_CHAIN)}"
                f" across the two dumps (its records: {held})")
        n_events.append(len(tracetool.chrome_trace(records, t)
                            ["traceEvents"]))
    if min(n_events) < 6:
        raise AssertionError(f"trace: a GET trace exports {min(n_events)} "
                             "Chrome events, fewer than 6")
    offsets, _ = tracetool.clock_offsets(records)
    clocks = [r for pid, r in records if r.get("kind") == "clock"]
    wire = {r["conn"] for pid, r in records if pid == 0
            and r.get("kind") == "span" and r.get("src") == "client"}
    if len(offsets) != conns or set(offsets) != wire:
        raise AssertionError(f"trace: clock offsets for {sorted(offsets)}, "
                             f"{conns} connections {sorted(wire)}")
    for r in clocks:
        if abs(r["offset_ns"]) >= r["rtt_ns"]:
            raise AssertionError(f"trace: connection {r['conn']}'s clock "
                                 f"offset {r['offset_ns']} ns is not below "
                                 f"its round trip {r['rtt_ns']} ns")
    rows = tracetool.breakdown(records)
    missing = set(TRACE_STAGES) - {r["stage"] for r in rows}
    if missing:
        raise AssertionError(f"trace: the breakdown has no {missing}")
    for r in rows:
        log("trace", f"stage {r['stage']}: {r['count']} spans, p50 "
            f"{r['p50_us']} us, p95 {r['p95_us']} us, max {r['max_us']} us "
            f"({smi})")
    log("trace", f"{len(roots)} GET traces joined across the client's and "
        f"the server's dumps, each at least 6 deep with the chain "
        f"{' -> '.join(o for _, o in TRACE_CHAIN)}; Chrome events per "
        f"trace {min(n_events)}-{max(n_events)}; clock offsets of "
        f"{len(offsets)} connections {min(offsets.values())}.."
        f"{max(offsets.values())} ns, each under its round trip "
        f"({min(r['rtt_ns'] for r in clocks)}.."
        f"{max(r['rtt_ns'] for r in clocks)} ns); check_flight clean on "
        "both dumps")
    return [r for pid, r in records if pid == 1 and r.get("kind") == "span"]


def trace_device_windows(spans: list, windows: dict, smi: str) -> None:
    """Phase 15 (c): every `flush:get` span lasts at least the device
    window (the plane handle's CUDA event pair) of the launches it holds;
    the device shares of `flush:get` and of `shard_program` are logged."""
    flush = [r for r in spans if r["op"] == "flush:get"]
    if not flush:
        raise AssertionError("trace: no flush:get span in the server dump")
    by_parent: dict = {}
    for r in spans:
        if r["op"] == "shard_program" and r.get("phase") == "get":
            by_parent.setdefault(r["parent"], []).append(r)
    flush_share, shard_share = [], []
    for r in flush:
        dev = windows.get(r["span"], [])
        if len(dev) != 1:
            raise AssertionError(f"trace: flush:get span {r['span']} holds "
                                 f"{len(dev)} device windows, not 1")
        dev_ns = dev[0] * 1e3
        span_ns = r["t1_ns"] - r["t0_ns"]
        if span_ns + TRACE_EVENT_SLACK_NS < dev_ns:
            raise AssertionError(
                f"trace: flush:get span of {span_ns} ns is shorter than "
                f"the {dev_ns:.0f} ns device window it holds")
        flush_share.append(dev_ns / span_ns)
        for s in by_parent.get(r["span"], ()):
            shard_share.append(dev_ns / max(s["t1_ns"] - s["t0_ns"], 1))
    if not shard_share:
        raise AssertionError("trace: no shard_program span under a "
                             "flush:get span")
    f50, f95 = quantiles(flush_share)
    s50, s95 = quantiles(shard_share)
    log("trace", f"device windows: every one of {len(flush)} flush:get spans "
        f"holds its CUDA-event window (within {TRACE_EVENT_SLACK_NS} ns); "
        f"device share of flush:get p50 {f50:.3f}, p95 {f95:.3f}; of each "
        f"of {len(shard_share)} shard_program spans p50 {s50:.3f}, p95 "
        f"{s95:.3f} (over 1: the kernel began before the fetch window) "
        f"({smi})")


def trace_breach_drill(sm, root: str, smi: str) -> None:
    """Phase 15 (d), breach: JAX's injected-latency drill on a `KV` on the
    card behind `NetServer`: the 20 ms lag breaches the 2 ms p99 GET
    target and the breach dump names `flush:get`."""
    import numpy as np

    from pmdfc_tpu_torch.tools import check_teledump as chk
    from pmdfc_tpu_torch.client.backends import DirectBackend
    from pmdfc_tpu_torch.config import (BloomConfig, IndexConfig, KVConfig,
                                        NetConfig, TelemetryConfig)
    from pmdfc_tpu_torch.runtime import slo
    from pmdfc_tpu_torch.runtime import telemetry as tele
    from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend

    d = os.path.join(root, "breach")
    os.makedirs(d, exist_ok=True)
    tele.configure(TelemetryConfig(enabled=True, ring_capacity=TRACE_RING,
                                   dump_dir=d, dump_min_interval_s=0.0))
    pw = TRACE_PAGE_WORDS
    kv = sm.kv_mod.KV(KVConfig(index=IndexConfig(**DRILL_INDEX),
                               bloom=BloomConfig(num_bits=1 << 16),
                               page_words=pw), device=sm.dev)

    class Laggy(DirectBackend):
        def get(self, keys):
            time.sleep(TRACE_LAG_S)  # the injected fault
            return super().get(keys)

    shared = Laggy(kv)
    wd = slo.SloWatchdog(slo.SloConfig(targets=(slo.SloTarget(
        "get_p99", "latency_p99", "net.client.get_us",
        TRACE_BREACH_TARGET_US),), window_s=0.5, burn_windows=2,
        min_count=4))
    lo = np.arange(TRACE_VERB, dtype=np.uint32)
    his = np.full(TRACE_VERB, TRACE_HI, np.uint32)
    keys, pages = np.stack([his, lo], -1), pages_np(his, lo, pw)
    breaches = []
    t0 = time.monotonic()
    with NetServer(lambda: shared, net=NetConfig()).start() as srv, \
            TcpBackend("127.0.0.1", srv.port, page_words=pw,
                       op_timeout_s=30.0) as be:
        be.put(keys, pages)
        out, found = be.get(keys)
        if not found.all() or not np.array_equal(out, pages):
            raise AssertionError("trace breach drill: a put page did not "
                                 "come back")
        wd.tick()  # prime the window state
        for _ in range(2):
            for _ in range(TRACE_SLO_GETS):
                be.get(keys)
            breaches += wd.tick()
    if not breaches:
        raise AssertionError(f"trace breach drill: the p99 target never "
                             f"breached ({dict(wd.stats)})")
    dumps = sorted(f for f in os.listdir(d)
                   if f.startswith("flight_slo_breach_")
                   and f.endswith(".json"))
    if not dumps:
        raise AssertionError("trace breach drill: no slo_breach dump")
    with open(os.path.join(d, dumps[-1])) as f:
        doc = json.load(f)
    det = doc["detail"]
    errs = chk.check_flight(doc)
    if det["stage"] != "flush:get" or det["target"] != "get_p99" \
            or not det["value"] > det["threshold"] or errs:
        raise AssertionError(f"trace breach drill: dump names stage "
                             f"{det['stage']} for {det['target']} "
                             f"({det['value']} vs {det['threshold']}); "
                             f"check_flight {errs[:3]}")
    log("trace", f"breach drill: {TRACE_LAG_S * 1e3:.0f} ms lag on a "
        f"KV on {sm.dev} behind NetServer breached get_p99 "
        f"({det['value']:.0f} us > {det['threshold']:.0f} us over "
        f"{det['burn_windows']} windows); the dump names {det['stage']} "
        f"(stages {json.dumps(det['stages'])}); check_flight clean; "
        f"{time.monotonic() - t0:.1f} s ({smi})")
    del kv, shared
    free_card(sm.torch)


def trace_healthy(sm, be, keys, root: str, smi: str) -> None:
    """Phase 15 (d), control: the same watchdog on the healthy plane of
    (a), its GET p99 target 10x the warm-up window's p99: no breach over
    at least TRACE_HEALTHY_WINDOWS evaluated windows."""
    import numpy as np

    from pmdfc_tpu_torch.config import NetConfig, TelemetryConfig
    from pmdfc_tpu_torch.runtime import slo
    from pmdfc_tpu_torch.runtime import telemetry as tele
    from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend

    d = os.path.join(root, "healthy")
    os.makedirs(d, exist_ok=True)
    reg = tele.configure(TelemetryConfig(
        enabled=True, ring_capacity=TRACE_RING, dump_dir=d,
        dump_min_interval_s=0.0))
    rng = np.random.default_rng(sm.seed)
    pw = be.page_words

    def gets(n):
        for _ in range(n):
            k = keys[rng.integers(0, len(keys), TRACE_VERB)]
            out, found = tcp.get(k)
            want = pages_np(k[:, 0], k[:, 1], pw)
            if (np.asarray(out)[found] != want[found]).any() \
                    or np.asarray(out)[~found].any():
                raise AssertionError("trace healthy control: wrong bytes")

    with NetServer(lambda: be, net=NetConfig()).start() as srv, \
            TcpBackend("127.0.0.1", srv.port, page_words=pw,
                       pipeline=True, op_timeout_s=60.0) as tcp:
        gets(TRACE_WARMUP_GETS)
        p99 = reg.metric("net.client.get_us").snapshot()["p99"]
        wd = slo.SloWatchdog(slo.SloConfig(targets=(slo.SloTarget(
            "get_p99", "latency_p99", "net.client.get_us", 10 * p99),),
            window_s=1.0, burn_windows=2, min_count=4))
        wd.tick()  # prime the window state
        breaches = []
        for _ in range(TRACE_HEALTHY_WINDOWS):
            gets(TRACE_HEALTHY_GETS)
            breaches += wd.tick()
    st = dict(wd.stats)
    if breaches or st["breaches"] \
            or st["evaluations"] < TRACE_HEALTHY_WINDOWS:
        raise AssertionError(f"trace healthy control: {len(breaches)} "
                             f"breaches at 10x the warm-up p99 {p99:.0f} "
                             f"us ({st})")
    dumps = [f for f in os.listdir(d) if f.startswith("flight_slo_breach_")]
    if dumps:
        raise AssertionError(f"trace healthy control: breach dumps {dumps}")
    log("trace", f"healthy control: warm-up GET p99 {p99:.0f} us over "
        f"{TRACE_WARMUP_GETS} verbs of {TRACE_VERB} keys, target "
        f"{10 * p99:.0f} us: no breach over {st['evaluations']} windows "
        f"({st}) ({smi})")


def run_trace(sm, lanes: "Lanes | None" = None):
    """Phase 15: the cross-process trace on a 4-shard plane on the card,
    spans against counters and device windows, the SLO drills, the two
    sweeps (in `lanes`, queued by the caller; its own, from the phase's
    start, when none is given) -> its kernels entry."""
    import numpy as np

    from pmdfc_tpu_torch.config import (BloomConfig, IndexConfig, KVConfig,
                                        NetConfig, TelemetryConfig)
    from pmdfc_tpu_torch.parallel.plane import PlaneBackend
    from pmdfc_tpu_torch.parallel.shard import ShardedKV, make_mesh
    from pmdfc_tpu_torch.runtime import profiler
    from pmdfc_tpu_torch.runtime import telemetry as tele
    from pmdfc_tpu_torch.runtime.net import NetServer

    fused, torch = sm.fused, sm.torch
    t_phase = time.monotonic()
    free_card(torch)
    smi = nvidia_smi()
    own = lanes is None
    if own:
        lanes = Lanes(HARNESS_LANES).queue("trace").queue("trace-client",
                                                          sm.seed)
    root = lanes.trace_root
    try:
        cfg = KVConfig(index=IndexConfig(**TRACE_INDEX),
                       bloom=BloomConfig(num_bits=TRACE_BLOOM_BITS),
                       page_words=TRACE_PAGE_WORDS)
        pw, n = cfg.page_words, TRACE_SHARDS
        skv = ShardedKV(cfg, mesh=make_mesh([DEVICE] * n))
        fill = int(skv.capacity() * TRACE_FILL)
        t_fill, drops, _ = plane_fill(skv, fill, TRACE_HI, plane=False)
        pool_b = sum(st.pool.pages.numel() * 4 for st in skv.states)
        log("trace", f"ShardedKV over {n} shards on {skv.mesh}: "
            f"{skv.capacity()} slots, pools {pool_b / 2**30:.2f} GiB; fill "
            f"{fill} pages in {t_fill:.3f} s, drops {drops} ({smi})")

        # (a) the server half in this process, its ring and profiler fresh
        server_dir = os.path.join(root, "server")
        os.makedirs(server_dir, exist_ok=True)
        reg = tele.configure(TelemetryConfig(
            enabled=True, ring_capacity=TRACE_RING, dump_records=TRACE_RING,
            dump_dir=server_dir, dump_min_interval_s=0.0))
        prof = profiler.install()
        windows: dict = {}
        note = prof.note_launch

        def note_launch(program, phase, device_us, *a, **kw):
            # the plane GET's device window, keyed by the flush span the
            # flush loop holds open around the launch and the fetch
            if program == "plane.get":
                stack = tele._SPAN_TLS.stack
                windows.setdefault(stack[-1].sid if stack else 0,
                                   []).append(device_us)
            return note(program, phase, device_us, *a, **kw)

        prof.note_launch = note_launch
        be = PlaneBackend(skv)
        counts = PlaneCounts(skv)
        fused.launches.clear()
        ops0, stats0 = shard_ops(be), skv.stats()
        t0 = time.monotonic()
        srv = NetServer(lambda: be, net=NetConfig()).start()
        try:
            spec = dict(port=srv.port, page_words=pw, verb=TRACE_VERB,
                        conns=TRACE_CONNS, puts=TRACE_PUTS, gets=TRACE_GETS,
                        hi=TRACE_HI, put_hi=TRACE_PUT_HI, fill=fill,
                        ring=TRACE_RING, seed=sm.seed)
            tmp = os.path.join(root, "server.json.tmp")
            with open(tmp, "w") as f:
                json.dump(spec, f)
            os.replace(tmp, os.path.join(root, "server.json"))
            (client, lines, secs), = lanes.rows("trace-client")
        finally:
            srv.stop()
        t_a = time.monotonic() - t0
        for line in lines:
            print(line, flush=True)
        torch.cuda.synchronize()
        n_gets = TRACE_CONNS * TRACE_GETS
        s = skv.stats()
        lost = s["evictions"] + s["drops"]
        for ok, msg in [
                (not client["errors"], f"client errors {client['errors']}"),
                (client.get("wrong") == 0, f"{client.get('wrong')} hits "
                 "with wrong bytes"),
                (client.get("nonzero") == 0, f"{client.get('nonzero')} "
                 "misses not zeroed"),
                (client.get("never_hits") == 0, f"{client.get('never_hits')}"
                 " never-inserted keys hit"),
                (client.get("acked_misses", lost + 1) <= lost,
                 f"{client.get('acked_misses')} acknowledged keys missed, "
                 f"more than evictions + drops {lost}"),
                (client["disconnects"] == 0 and client["dropped_puts"] == 0
                 and client["missed_gets"] == 0,
                 f"disconnects {client['disconnects']}, dropped puts "
                 f"{client['dropped_puts']}, missed GETs "
                 f"{client['missed_gets']}"),
                (client["ring"] < TRACE_RING and len(reg.ring) < TRACE_RING,
                 f"a flight ring filled ({client['ring']}, {len(reg.ring)} "
                 f"of {TRACE_RING})")]:
            if not ok:
                raise AssertionError(f"trace: {msg}")
        launches = plane_checks(sm, skv, be, srv, [], counts, n, ops0,
                                stats0, "trace")
        held = len(reg.ring)
        server_dump = tele.dump_now("trace_server")
        log("trace", f"client child ({secs:.1f} s in the lanes): "
            f"{TRACE_CONNS} connections x ({TRACE_PUTS} PUT + {TRACE_GETS} "
            f"GET verbs of {TRACE_VERB} keys) through ReplicaGroup(rf 1) -> "
            f"ReconnectingClient -> pipelined TcpBackend: {client['hits']} "
            f"hits of {client['keys']} GET keys, every hit byte-exact, every"
            f" miss zeroed, no never-inserted key served, "
            f"{client['acked_misses']} acknowledged misses <= evictions + "
            f"drops {lost}; put verb p50/p99 {client['put_ms'][0]:.2f}/"
            f"{client['put_ms'][1]:.2f} ms, get verb "
            f"{client['get_ms'][0]:.2f}/{client['get_ms'][1]:.2f} ms ({smi})")
        log("trace", f"server: {srv.stats['flushes']} flushes of "
            f"{srv.stats['coalesced_ops']} verbs "
            f"({srv.stats['coalesced_ops'] / max(srv.stats['flushes'], 1):.2f}"
            f" a flush); GET phases {counts.get_phases}, widest per-shard "
            f"width {counts.wl_max}; fused_get_linear_flat launches "
            f"{launches} = {n} per GET phase; no serve error")
        spans = trace_joined([(client["dump"], client["ring"]),
                              (server_dump, held)], TRACE_CONNS,
                             n_gets, smi)

        # (b) the shard spans against the mesh counters
        sums = [0] * n
        for r in spans:
            if r["op"] == "shard_program":
                sums[r["shard"]] += r["ops"]
        ctr = [int(c.value) for c in be._c_shard]
        if sums != ctr:
            raise AssertionError(f"trace: shard_program ops {sums} != "
                                 f"mesh.shard{{i}}_ops {ctr}")
        log("trace", f"shard_program ops per shard {sums} == "
            f"mesh.shard{{i}}_ops; one launch per shard per GET phase")

        # (c) what the spans cover on the device
        trace_device_windows(spans, windows, smi)

        # (f) the kernel at the widest per-shard GET width (a) launched
        keys = np.stack([np.full(fill, TRACE_HI, np.uint32),
                         np.arange(fill, dtype=np.uint32)], -1)
        own0 = plane_held(skv, TRACE_HI)
        own0 = own0[skv.node_of(np.stack(
            [np.full(len(own0), TRACE_HI, np.uint32), own0], -1)) == 0]
        kt = uncounted(fused, lambda: plane_kernel(
            sm, skv.states[0], own0, pw, [counts.wl_max], "trace shard 0",
            smi, hi=TRACE_HI))
        entry = plane_entry(sm, "trace-plane", launches, kt[counts.wl_max])

        # (d) the SLO watchdog on the card
        t0 = time.monotonic()
        trace_healthy(sm, be, keys, root, smi)
        del skv, be, srv, counts
        free_card(torch)
        trace_breach_drill(sm, root, smi)
        t_d = time.monotonic() - t0
        log("trace", f"in-process part took {time.monotonic() - t_phase:.1f}"
            f" s: (a)-(c) {t_a:.1f} s with the client's run, (d) {t_d:.1f} s")

        # (e) the two sweeps, collected from the lanes
        for (name, args), (summary, secs) in zip(TRACE_SWEEPS,
                                                 lanes.rows("trace")):
            log("trace", f"sweep {name} {' '.join(args)} ({secs:.1f} s): "
                f"exit 0, smoke OK; " + json.dumps(
                    {k: v for k, v in summary.items() if k != "rows"}))
            for r in summary["rows"]:
                if r.get("device") != torch_device_type():
                    raise AssertionError(f"sweep {name} ran on "
                                         f"{r.get('device')}")
                log("trace", f"  {name} row {r['metric']}: " + json.dumps(
                    {k: r[k] for k in ("transport", "connections", "window",
                                       "verb_keys", "value", "unit",
                                       "p50_us") if k in r})
                    + f" ({smi})")
    finally:
        tele.configure()
        if own:
            lanes.close()
    log("trace", f"phase 15 took {time.monotonic() - t_phase:.1f} s")
    return [entry]


# ---------------------------------------------------------------------------
# phase 16, ops: the operator pull where JAX is absent, and the fast lane's
# structural drills under serving traffic
# ---------------------------------------------------------------------------

# Widths kept: 4 KiB pages, verbs of 2^11 keys. Depth cut: a linear·tiered
# KV of 2^18 slots (the serving size is 2^21) and a 4-shard plane of 2^16
# slots a shard (the plane phase's shards hold 2^17), filled to 30% so the
# 2-shard plane it is resharded onto holds it at 60%.
OPS_INDEX = dict(capacity=1 << 18)
OPS_TIER = dict()          # TierConfig()'s defaults
OPS_BLOOM_BITS = 1 << 21
OPS_PAGE_WORDS = 1024
OPS_FILL = 0.75            # of the KV's slots, through KV.insert
OPS_VERB = 1 << 11         # keys of each GET, PUT and invalidate verb
OPS_READ = 4               # verbs of a read pass
OPS_SHRINK_EVICT = 2 * 1024  # live rows the mid-serve shrink takes past the free
OPS_MIDSERVE = 4           # verbs the serving reader reads after a change
OPS_SHARDS, OPS_RESHARD = 4, 2
OPS_PLANE_INDEX = dict(capacity=1 << 16)  # a shard
OPS_PLANE_BLOOM_BITS = 1 << 20
OPS_PLANE_FILL = 0.3       # of the 4-shard plane's slots
OPS_HI = 0xC8000000        # the KV's keys are (OPS_HI, i)
OPS_PLANE_HI = 0xC8100000  # the plane's keys are (OPS_PLANE_HI, i)
OPS_XOR = 0x5A5A5A5A       # a re-put page is the key's page XOR this
OPS_CHILD_TIMEOUT_S = 120.0
OPS_TOOLS = "pmdfc_tpu_torch.tools"

# The prelude of the operator pull's child interpreters: importing JAX or
# the JAX package raises there, so a tool that needs either fails.
NO_JAX_PRELUDE = '''
import sys


class _NoJax:
    """Refuses JAX, the JAX package and its root operator tools in this
    interpreter."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "pmdfc_tpu", "tools"):
            raise ImportError(f"{name} is refused in this interpreter")
        return None


sys.meta_path.insert(0, _NoJax())
for _name in ("jax", "pmdfc_tpu", "tools"):
    try:
        __import__(_name)
    except ImportError:
        pass
    else:
        raise SystemExit(f"{_name} imported past the blocker")
'''


def no_jax_argv(module: str, *args: str) -> list:
    """argv of `python -m module args...` in an interpreter where importing
    JAX or the JAX package raises (run from the repo's root)."""
    argv = [module, *args]
    return [sys.executable, "-c", NO_JAX_PRELUDE + (
        f"import runpy\nsys.argv = {argv!r}\n"
        f"runpy.run_module({module!r}, run_name='__main__', "
        "alter_sys=True)\n")]


def start_no_jax(procs: dict) -> dict:
    """Start each {name: argv} child (no JAX) side by side from the repo's
    root -> {name: Popen}."""
    root = os.path.dirname(os.path.abspath(__file__))
    return {name: subprocess.Popen(
        argv, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, argv in procs.items()}


def wait_no_jax(label: str, started: dict) -> dict:
    """Wait for children `start_no_jax` started -> {name: stdout}; a
    nonzero exit or a timeout fails the phase (every child is reaped)."""
    outs, fails = {}, []
    deadline = time.monotonic() + OPS_CHILD_TIMEOUT_S
    for name, p in started.items():
        try:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            fails.append(f"{name}: timed out")
            continue
        if p.returncode != 0:
            fails.append(f"{name}: exit {p.returncode}: "
                         f"{err.strip().splitlines()[-3:]}")
        outs[name] = out
    if fails:
        raise AssertionError(f"{label}: {fails}")
    return outs


class OpsPull:
    """Phase 16 (a): the operator pull against the live server on `port`,
    each tool in a child interpreter without JAX. `__init__` starts
    `teledump HOST PORT --out`, `--format prom` and `check_teledump
    --live` side by side; `finish` waits for them, runs `check_teledump
    PATH` on the pulled document, and requires each to exit 0 and the
    document to pass `check` and `check_fastpath` with the server scope
    `prefix`'s fast-lane counters at `expect` (the server quiet
    meanwhile)."""

    def __init__(self, port: int, pw: int, root: str, prefix: str,
                 expect: dict):
        self.t0 = time.monotonic()
        self.prefix, self.expect = prefix, expect
        self.doc_path = os.path.join(root, "teledump.json")
        host, words = "127.0.0.1", ("--page-words", str(pw))
        self.started = start_no_jax({
            "teledump --out": no_jax_argv(f"{OPS_TOOLS}.teledump", host,
                                          str(port), *words, "--out",
                                          self.doc_path),
            "teledump --format prom": no_jax_argv(
                f"{OPS_TOOLS}.teledump", host, str(port), *words,
                "--format", "prom"),
            "check_teledump --live": no_jax_argv(
                f"{OPS_TOOLS}.check_teledump", "--live", host, str(port),
                *words)})

    def kill(self) -> None:
        for p in self.started.values():
            if p.poll() is None:
                p.kill()
                p.communicate()

    def finish(self, smi: str) -> None:
        from pmdfc_tpu_torch.tools import check_teledump as chk

        outs = wait_no_jax("ops (a)", self.started)
        outs.update(wait_no_jax("ops (a)", start_no_jax({
            "check_teledump PATH": no_jax_argv(
                f"{OPS_TOOLS}.check_teledump", self.doc_path)})))
        with open(self.doc_path) as f:
            doc = json.load(f)
        errs = chk.check(doc) + chk.check_fastpath(doc["telemetry"])
        if errs:
            raise AssertionError(f"ops (a): the pulled document: {errs[:5]}")
        ctr = doc["telemetry"]["counters"]
        got = {k: ctr.get(f"{self.prefix}.{k}") for k in self.expect}
        if got != self.expect:
            raise AssertionError(f"ops (a): the pulled fast-lane counters "
                                 f"{got} != the server's {self.expect}")
        prom = outs["teledump --format prom"]
        if "fastpath_hits" not in prom:
            raise AssertionError("ops (a): the Prometheus text lacks the "
                                 "fast lane's counters")
        for name in ("check_teledump --live", "check_teledump PATH"):
            if not outs[name].startswith("[check_teledump] OK"):
                raise AssertionError(f"ops (a): {name}: {outs[name]!r}")
        log("ops", f"(a) operator pull without JAX (4 child interpreters "
            f"refusing jax and pmdfc_tpu): teledump --out, --format prom "
            f"({len(prom.splitlines())} lines), check_teledump --live and "
            f"PATH exit 0; the document passes check and check_fastpath, "
            f"{self.prefix}.fastpath_hits/stale {got['fastpath_hits']}/"
            f"{got['fastpath_stale']} as served; "
            f"{outs['check_teledump --live'].strip()}; "
            f"{time.monotonic() - self.t0:.1f} s from the start, beside the "
            f"plane's part ({smi})")


class OpsKeys:
    """The keys (hi, i < n) of one phase-16 store and the page each holds
    now: a re-put key's page is its first page XOR OPS_XOR; a deleted key
    must miss."""

    def __init__(self, hi: int, n: int, pw: int):
        import numpy as np

        self.np, self.hi, self.pw = np, hi, pw
        self.xored = np.zeros(n, bool)
        self.gone = np.zeros(n, bool)

    def keys(self, lo):
        np = self.np
        return np.stack([np.full(len(lo), self.hi, np.uint32),
                         np.asarray(lo, np.uint32)], -1)

    def want(self, lo):
        page = pages_np(self.hi, lo, self.pw)
        page[self.xored[lo]] ^= self.np.uint32(OPS_XOR)
        return page


class OpsReader:
    """A directory connection (`TcpBackend(directory=True)`) whose every GET
    is checked lane by lane: the fast lanes it read (`_fast_read`) and the
    lanes it re-asked through the verb path (`_get_verb`), both spied."""

    def __init__(self, port: int, ks: OpsKeys, label: str):
        from pmdfc_tpu_torch.runtime.net import TcpBackend

        self.ks, self.label = ks, label
        self.be = TcpBackend("127.0.0.1", port, page_words=ks.pw,
                             op_timeout_s=120.0, directory=True)
        if not self.be.fastpath:
            raise AssertionError(f"{label}: the server refused the fast "
                                 "lane")
        self.lanes = self.hits = self.stale = self.verbs = 0
        self.c0 = self.client_lanes()
        fast_read, get_verb = self.be._fast_read, self.be._get_verb

        def spy_fast(keys, *a):
            ok, hit, epoch = fast_read(keys, *a)
            self._fast = (keys.copy(), ok.copy(), hit.copy())
            return ok, hit, epoch

        def spy_verb(keys):
            out, found = get_verb(keys)
            self._verb = (keys.copy(), out.copy(), found.copy())
            return out, found

        self.be._fast_read, self.be._get_verb = spy_fast, spy_verb

    def client_lanes(self):
        c = self.be.directory.counters
        return (c["fastpath_gets"], c["fastpath_hits"], c["fastpath_stale"])

    def refresh(self) -> None:
        if not (self.be.dir_refresh() and self.be.directory.ready()):
            raise AssertionError(f"{self.label}: a directory pull failed")

    def read(self, lo, ref=None) -> int:
        """One GET verb of keys (hi, lo): every hit the key's current page
        (a fast hit too), every deleted key missed, every miss zeroed,
        every stale lane re-asked through the verb path and, with `ref` (a
        plain connection, the store quiet), answered as `ref` answers it.
        -> hits."""
        np, ks, label = self.ks.np, self.ks, self.label
        self._fast = self._verb = None
        out, found = self.be.get(ks.keys(lo))
        want, gone = ks.want(lo), ks.gone[lo]
        if self._fast is not None:
            fk, ok, hit = self._fast
            flo = fk[:, 1]
            if (ok & ks.gone[flo]).any():
                raise AssertionError(f"{label}: a fast hit on a deleted key")
            bad = (hit != ks.want(flo[ok])).any(axis=1)
            if bad.any():
                raise AssertionError(
                    f"{label}: {int(bad.sum())} fast hits are not the key's "
                    "current page")
            stale = flo[~ok]
            asked = self._verb[0][:, 1] if self._verb is not None else []
            if not np.isin(stale, asked).all():
                raise AssertionError(f"{label}: a stale lane was not re-asked"
                                     " through the verb path")
            if ref is not None and len(stale):
                idx = np.nonzero(np.isin(lo, stale))[0]
                r_out, r_found = ref.get(ks.keys(lo[idx]))
                if not (np.array_equal(r_found, found[idx])
                        and np.array_equal(r_out, out[idx])):
                    raise AssertionError(f"{label}: the stale lanes' answer "
                                         "differs from the verb path's")
            self.lanes += len(ok)
            self.hits += int(ok.sum())
            self.stale += int((~ok).sum())
        if (found & gone).any():
            raise AssertionError(f"{label}: a deleted key hit")
        bad = found & (out != want).any(axis=1)
        if bad.any():
            raise AssertionError(f"{label}: {int(bad.sum())} hits are not the"
                                 " key's current page")
        if out[~found].any():
            raise AssertionError(f"{label}: a miss returned nonzero bytes")
        self.verbs += 1
        return int(found.sum())

    def read_pass(self, los, ref=None) -> int:
        return sum(self.read(los[i:i + OPS_VERB], ref)
                   for i in range(0, len(los), OPS_VERB))

    def counted(self) -> tuple:
        """(lanes, hits, stale) this reader read, checked against its own
        directory's counters."""
        c = tuple(a - b for a, b in zip(self.client_lanes(), self.c0))
        mine = (self.lanes, self.hits, self.stale)
        if c != mine or self.hits + self.stale != self.lanes:
            raise AssertionError(f"{self.label}: client lanes {c} != the "
                                 f"lanes read {mine}")
        return mine

    def close(self) -> None:
        self.be.close()


def ops_server(backend, shards):
    """A `NetServer(NetConfig())` over `backend` whose GET phases are
    counted, each with the shard count `shards()` serves it, and whose
    widest GET batch is kept for each shard count -> (server, phases,
    widest)."""
    from pmdfc_tpu_torch.config import NetConfig
    from pmdfc_tpu_torch.runtime.net import NetServer

    phases: list = []
    widest: dict = {}
    real_get = backend.get

    def get(keys):
        n = shards()
        phases.append(n)
        if len(keys) >= len(widest.get(n, ())):
            widest[n] = keys.copy()
        return real_get(keys)

    backend.get = get
    return NetServer(lambda: backend, net=NetConfig()).start(), phases, widest


def ops_midserve(reader, los, change, label: str) -> float:
    """`change()` while `reader` serves GET verbs of `los` in another
    thread: the reader reads two verbs, the change runs, the reader reads
    OPS_MIDSERVE verbs begun after it -> the change's seconds."""
    import threading

    started, done = threading.Event(), threading.Event()
    took = []

    def serve():
        i = after = 0
        try:
            while after < OPS_MIDSERVE:
                changed = done.is_set()
                j = (i * OPS_VERB) % len(los)
                reader.read(los[j:j + OPS_VERB])
                i += 1
                after += changed
                if i == 2:
                    started.set()
        finally:
            started.set()  # a reader that failed frees the change

    def drive():
        started.wait(PHASE_TIMEOUT_S)
        t0 = time.monotonic()
        try:
            change()
        finally:
            took.append(time.monotonic() - t0)
            done.set()

    run_threads([serve, drive], label)
    return took[0]


def ops_accounting(srv, readers, s0, label: str) -> tuple:
    """`fastpath_hits + fastpath_stale` on the server since `s0` equals the
    fast lanes the readers read, lane for lane, as each reader's directory
    counts them; no serve error, no NACK, no failed or shed phase."""
    lanes = [r.counted() for r in readers]
    tot = tuple(sum(x[i] for x in lanes) for i in range(3))
    s = dict(srv.stats)
    h, st = (int(s[k]) - s0[k] for k in ("fastpath_hits", "fastpath_stale"))
    if (h + st, h, st) != tot:
        raise AssertionError(f"{label}: server fast lanes {(h + st, h, st)}"
                             f" != the readers' {tot}")
    bad = {k: s[k] for k in ("serve_errors", "nacks_sent", "bisect_failures",
                             "poison_ops", "deadline_shed") if int(s[k])}
    if bad:
        raise AssertionError(f"{label}: the server failed: {bad}")
    return tot


def replay_evictions(skv, out: dict) -> None:
    """Count in out["evicted"] the live entries `skv`'s plane inserts
    evict: a reshard restore's replay evicts where a cluster of the smaller
    grid overflows, and neither package's restore carries those evictions
    onto its counters (only the replay's drops)."""
    import numpy as np

    out["evicted"] = 0
    real = skv.plane_insert

    class Counted:
        def __init__(self, handle):
            self.handle = handle

        def fetch(self):
            r = self.handle.fetch()
            ev = np.asarray(r.evicted)
            out["evicted"] += int((~(ev == 0xFFFFFFFF).all(-1)).sum())
            return r

    def plane_insert(keys, pages):
        return Counted(real(keys, pages))

    skv.plane_insert = plane_insert


def ops_kernel(sm, state, batch, label: str, smi):
    """Kernel against plain on `batch` (the keys of a GET phase the server
    served, padding included), timed -> (ms, plain_ms, bound_ms)."""
    torch = sm.torch
    keys = torch.from_numpy(batch.view(sm.np.int32)).to(sm.dev)
    w = keys.shape[0]
    t = uncounted(sm.fused, lambda: plane_kernel(
        sm, state, None, state.pool.pages.shape[1], [w], label, smi,
        batch=lambda _w: keys))
    return w, t[w]


def ops_kv(sm, root: str, smi: str):
    """Phase 16's `KV` part: a linear·tiered `KV` behind `NetServer`, the
    delete, promotion and balloon drills through directory connections,
    then (a) started against the quiet server -> (its kernels entry, the
    server, the started pull); the caller stops both."""
    import numpy as np

    from pmdfc_tpu_torch.client import DirectBackend
    from pmdfc_tpu_torch.config import (BloomConfig, IndexConfig, KVConfig,
                                        TierConfig)
    from pmdfc_tpu_torch.runtime.net import TcpBackend

    fused, torch = sm.fused, sm.torch
    cfg = KVConfig(index=IndexConfig(**OPS_INDEX),
                   bloom=BloomConfig(num_bits=OPS_BLOOM_BITS),
                   page_words=OPS_PAGE_WORDS, tier=TierConfig(**OPS_TIER))
    kv = sm.kv_mod.KV(cfg, device=DEVICE)
    pw = cfg.page_words
    n = int(kv.capacity() * OPS_FILL)
    t0 = time.monotonic()
    for i in range(0, n, INS_B):
        lo = torch.arange(i, min(i + INS_B, n), device=sm.dev)
        keys = sm.keys_of(OPS_HI, lo)
        kv.insert(keys, sm.pages_of(keys, pw))
    torch.cuda.synchronize()
    t_fill = time.monotonic() - t0
    with kv._lock:
        flat, _ = kv._ops.scan(kv.state.index)
        held = flat[flat[:, 0] == sm.u32.narrow(torch.tensor(OPS_HI))]
        present = np.sort(sm.u32.to_numpy(held[:, 1]))
    ks = OpsKeys(OPS_HI, n, pw)
    perm = np.random.default_rng(sm.seed).permutation(present).astype(
        np.uint32)
    k = OPS_READ * OPS_VERB
    sample, dele, hot = perm[:k], perm[k:k + OPS_VERB], \
        perm[k + OPS_VERB:k + 2 * OPS_VERB]
    serve_set = perm[k + 2 * OPS_VERB:2 * k + 2 * OPS_VERB]
    pool_b = kv.state.pool.pages.numel() * 4
    log("ops", f"linear·tiered KV on {kv.device}: {kv.capacity()} slots "
        f"(cut from 2^21), pools {pool_b / 2**30:.2f} GiB of {pw}-word "
        f"pages; fill {n} pages through KV.insert in {t_fill:.3f} s, "
        f"{len(present)} held ({smi})")

    srv, phases, widest = ops_server(DirectBackend(kv), lambda: 1)
    fused.launches.clear()
    conns = []
    try:
        plain = TcpBackend("127.0.0.1", srv.port, page_words=pw,
                           op_timeout_s=120.0)
        conns.append(plain)
        a = OpsReader(srv.port, ks, "ops a")
        conns.append(a)
        s0 = {k_: int(srv.stats[k_])
              for k_ in ("fastpath_hits", "fastpath_stale")}
        t0 = time.monotonic()
        a.refresh()
        n_dir = len(a.be.directory)
        a.read_pass(sample, plain)
        if a.stale or a.hits != len(sample):
            raise AssertionError(f"ops: the first fast pass: {a.hits} hits, "
                                 f"{a.stale} stale of {len(sample)}")
        # (b1) a delete's epoch bump: every lane of the next fast read is
        # stale, the verb path answers, a refresh re-arms
        e0 = kv.dir_epoch
        if not plain.invalidate(ks.keys(dele)).all():
            raise AssertionError("ops: an invalidate missed a held key")
        ks.gone[dele] = True
        if kv.dir_epoch != e0 + 1:
            raise AssertionError(f"ops: the delete moved the epoch by "
                                 f"{kv.dir_epoch - e0}, not 1")
        h1 = (a.hits, a.stale)
        mixed = np.concatenate([dele[:OPS_VERB // 2], sample[:OPS_VERB // 2]])
        a.read(mixed, plain)
        if (a.hits, a.stale) != (h1[0], h1[1] + OPS_VERB):
            raise AssertionError(f"ops: after the epoch bump the fast lanes "
                                 f"read {(a.hits, a.stale)} from {h1}, not "
                                 f"{OPS_VERB} stale")
        a.refresh()
        a.read(mixed, plain)
        d1 = a.hits - h1[0]
        # (b2) a tier promotion, then a re-put: the directory's rows are
        # vacated and re-digested, the stale lanes serve the new bytes
        prom0 = kv.tier_stats()["promotions"]
        for _ in range(3):
            plain.get(ks.keys(hot))
        prom = kv.tier_stats()["promotions"] - prom0
        if prom <= 0:
            raise AssertionError("ops: no promotion from the hot set")
        plain.put(ks.keys(hot), ks.want(hot) ^ np.uint32(OPS_XOR))
        ks.xored[hot] = True
        h2 = a.stale
        a.read(hot, plain)
        if a.stale == h2:
            raise AssertionError("ops: no stale lane after the re-put")
        d2 = a.stale - h2
        a.refresh()
        a.read(hot, plain)
        # (b3) a balloon shrink mid-serve
        c = OpsReader(srv.port, ks, "ops serving")
        conns.append(c)
        c.refresh()
        e0 = kv.dir_epoch
        ev0 = kv.tier_stats()["shrink_evictions"]

        def shrink():
            if not kv.balloon_shrink(kv.balloon_state()["free"]
                                     + OPS_SHRINK_EVICT):
                raise AssertionError("ops: the balloon refused to shrink")

        t_shrink = ops_midserve(c, serve_set, shrink, "ops balloon shrink")
        evicted = kv.tier_stats()["shrink_evictions"] - ev0
        if kv.dir_epoch == e0 or evicted <= 0:
            raise AssertionError(f"ops: the shrink evicted {evicted} rows, "
                                 f"epoch moved {kv.dir_epoch - e0}")
        a.refresh()
        served = a.read_pass(sample, plain)
        t_b = time.monotonic() - t0
        tot = ops_accounting(srv, [a, c], s0, "ops KV")
        log("ops", f"(b) directory of {n_dir} entries; delete of "
            f"{len(dele)} keys: epoch +1, the next {OPS_VERB} fast lanes "
            f"stale, the verb path answered, after the refresh {d1} fast "
            f"hits (stale lanes leave the client's directory); {prom} "
            f"promotions then a re-put of {len(hot)} keys: {d2} stale lanes"
            f" served the new bytes by the verb path; balloon shrink "
            f"mid-serve in {t_shrink:.3f} s evicted {evicted} rows, the "
            f"serving reader's {c.verbs} verbs read {c.hits} fast hits and "
            f"{c.stale} stale lanes; {served} of {len(sample)} sample keys "
            f"served after it; fast lanes (read, hits, stale) {tot} on both "
            f"sides; {t_b:.1f} s")
    finally:
        for x in conns:
            x.close()
    torch.cuda.synchronize()
    launches = fused.launches["fused_get_linear_tiered"]
    if not phases or launches != len(phases):
        srv.stop()
        raise AssertionError(f"ops: {launches} fused-GET launches for "
                             f"{len(phases)} fallback GET phases")
    s = kv.stats()
    if s["misses"] != sum(s[c_] for c_ in sm.kv_mod.MISS_CAUSE_NAMES):
        srv.stop()
        raise AssertionError("ops: misses != the sum of the miss causes")
    # (a) against this server, quiet from here on, beside the plane's part
    pull = OpsPull(srv.port, pw, root, srv.stats.prefix,
                   {k_: int(srv.stats[k_])
                    for k_ in ("fastpath_hits", "fastpath_stale")})
    try:
        w, t = ops_kernel(sm, kv.state, widest[1], "ops KV", smi)
    except BaseException:
        pull.kill()
        srv.stop()
        raise
    log("ops", f"fused_get_linear_tiered: {launches} launches = one per "
        f"fallback GET phase ({len(phases)}); the widest phase's batch "
        f"(w = {w}): kernel == plain, {t[0]:.4f} ms vs bound {t[2]:.4f} ms,"
        f" plain {t[1]:.4f} ms ({smi})")
    return (plane_entry(sm, "ops-tiered", launches, t,
                        name="fused_get_linear_tiered"), srv, pull)


def ops_plane(sm, root: str, smi: str) -> dict:
    """Phase 16's plane part: a 4-shard plane behind `NetServer` through
    `DirectBackend`, resharded onto 2 shards mid-serve -> its kernels
    entry."""
    import numpy as np

    from pmdfc_tpu_torch.client import DirectBackend
    from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, KVConfig
    from pmdfc_tpu_torch.parallel.shard import ShardedKV, make_mesh
    from pmdfc_tpu_torch.runtime.net import TcpBackend

    fused, torch = sm.fused, sm.torch
    cfg = KVConfig(index=IndexConfig(**OPS_PLANE_INDEX),
                   bloom=BloomConfig(num_bits=OPS_PLANE_BLOOM_BITS),
                   page_words=OPS_PAGE_WORDS)
    pw = cfg.page_words
    skv4 = ShardedKV(cfg, mesh=make_mesh([DEVICE] * OPS_SHARDS))
    n = int(skv4.capacity() * OPS_PLANE_FILL)
    t_fill, drops, _ = plane_fill(skv4, n, OPS_PLANE_HI, plane=False)
    ks = OpsKeys(OPS_PLANE_HI, n, pw)
    perm = np.random.default_rng(sm.seed).permutation(
        plane_held(skv4, OPS_PLANE_HI)).astype(np.uint32)
    k = OPS_READ * OPS_VERB
    sample, serve_set = perm[:k], perm[k:2 * k]
    db = DirectBackend(skv4)
    srv, phases, widest = ops_server(db, lambda: db.kv.n_shards)
    fused.launches.clear()
    path = os.path.join(root, "plane4.ckpt")
    conns = []
    try:
        plain = TcpBackend("127.0.0.1", srv.port, page_words=pw,
                           op_timeout_s=120.0)
        conns.append(plain)
        a = OpsReader(srv.port, ks, "ops plane a")
        conns.append(a)
        c = OpsReader(srv.port, ks, "ops plane serving")
        conns.append(c)
        s0 = {k_: int(srv.stats[k_])
              for k_ in ("fastpath_hits", "fastpath_stale")}
        t0 = time.monotonic()
        a.refresh()
        c.refresh()
        owners4 = sorted({e[0] for e in a.be.directory._map.values()})
        a.read_pass(sample, plain)
        if a.stale or len(owners4) != OPS_SHARDS:
            raise AssertionError(f"ops plane: first pass {a.stale} stale, "
                                 f"owners {owners4}")
        rs = {}

        def reshard():
            t1 = time.monotonic()
            skv4.save(path)
            rs["save"] = time.monotonic() - t1
            skv2 = ShardedKV(cfg, mesh=make_mesh([DEVICE] * OPS_RESHARD))
            replay_evictions(skv2, rs)
            skv2.restore(path)
            skv2._sync()
            del skv2.plane_insert
            rs["restore"] = time.monotonic() - t1 - rs["save"]
            db.kv = skv2   # swapped in mid-serve

        t_rs = ops_midserve(c, serve_set, reshard, "ops reshard")
        skv2 = db.kv
        lost = {"drops": skv2.stats()["drops"] - skv4.stats()["drops"],
                "evicted": rs["evicted"]}
        h3 = (a.hits, a.stale)
        served = a.read_pass(sample, plain)
        if a.hits != h3[0] or a.stale == h3[1]:
            raise AssertionError("ops plane: the reshard left a fast lane "
                                 "valid")
        if len(sample) - served > sum(lost.values()):
            raise AssertionError(f"ops plane: {len(sample) - served} keys "
                                 f"lost, the replay's losses {lost}")
        a.refresh()
        owners2 = sorted({e[0] for e in a.be.directory._map.values()})
        h4 = a.hits
        a.read_pass(sample, plain)
        if not set(owners2) <= set(range(OPS_RESHARD)) or a.hits == h4:
            raise AssertionError(f"ops plane: after the refresh owners "
                                 f"{owners2}, {a.hits - h4} fast hits")
        t_b = time.monotonic() - t0
        tot = ops_accounting(srv, [a, c], s0, "ops plane")
    finally:
        for x in conns:
            x.close()
        srv.stop()
        if os.path.exists(path):
            os.remove(path)
    torch.cuda.synchronize()
    launches = fused.launches["fused_get_linear_flat"]
    if not phases or launches != sum(phases):
        raise AssertionError(f"ops plane: {launches} fused-GET launches for "
                             f"{len(phases)} fallback GET phases of "
                             f"{sum(phases)} shard programs")
    log("ops", f"(b) plane: {OPS_SHARDS} x {skv4.capacity() // OPS_SHARDS} "
        f"slots, fill {n} pages in {t_fill:.3f} s (drops {drops}); 4 -> 2 "
        f"reshard mid-serve in {t_rs:.1f} s (save {rs['save']:.1f} s, "
        f"restore {rs['restore']:.1f} s, replay {lost}); every fast lane of"
        f" the swapped plane stale, the verb path served {served} of "
        f"{len(sample)}; after the refresh owners {owners2}; the serving "
        f"reader's {c.verbs} verbs {c.hits} fast hits, {c.stale} stale; "
        f"fast lanes {tot} on both sides; {launches} launches = one per "
        f"shard per fallback GET phase ({len(phases)}); {t_b:.1f} s")
    batch = widest[OPS_RESHARD]
    real = batch[~(batch == 0xFFFFFFFF).all(axis=1)]
    own = real[skv2.node_of(real) == 0]
    own = np.concatenate([own, np.full(
        (sm.kv_mod._pad_pow2(len(own)) - len(own), 2), 0xFFFFFFFF,
        np.uint32)])
    w, t = ops_kernel(sm, skv2.states[0], own, "ops plane shard 0", smi)
    log("ops", f"fused_get_linear_flat: the widest 2-shard phase's shard-0 "
        f"batch (w = {w}): kernel == plain, {t[0]:.4f} ms vs bound "
        f"{t[2]:.4f} ms, plain {t[1]:.4f} ms ({smi})")
    return plane_entry(sm, "ops-plane", launches, t)


def run_ops(sm):
    """Phase 16: the operator pull without JAX against a live port server,
    and the fast lane's structural drills under serving traffic -> its two
    kernels entries."""
    from pmdfc_tpu_torch.config import TelemetryConfig
    from pmdfc_tpu_torch.runtime import telemetry as tele

    torch = sm.torch
    t_phase = time.monotonic()
    free_card(torch)
    smi = nvidia_smi()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "ops")
    os.makedirs(root, exist_ok=True)
    tele.configure(TelemetryConfig(enabled=True))
    try:
        kv_entry, srv, pull = ops_kv(sm, root, smi)
        try:
            plane_entry_ = ops_plane(sm, root, smi)
            pull.finish(smi)
        finally:
            pull.kill()
            srv.stop()
    finally:
        tele.configure()
        free_card(torch)
        shutil.rmtree(root, ignore_errors=True)
    log("ops", f"phase 16 took {time.monotonic() - t_phase:.1f} s")
    return [kv_entry, plane_entry_]


# ---------------------------------------------------------------------------
# phase 17, failure: the failure ladder on the engine-backed server
# ---------------------------------------------------------------------------

FAIL_INDEX = dict(capacity=1 << 18)  # a 1 GiB pool of 4 KiB pages
FAIL_BLOOM_BITS = 1 << 21
FAIL_PAGE_WORDS = 1024
FAIL_FILL = 0.75           # of the slots, put through the engine
FAIL_CLIENTS = 8           # ReconnectingClients, one engine queue each
FAIL_VERB = 1 << 11        # pages (keys) of every verb
FAIL_ARENA_SLICES = 32     # the engine arena in verb slices: the clients',
#                            the drills' and the quarantined ones
FAIL_STREAM = 2            # verbs of its own keys each streaming thread puts
FAIL_PAUSE_S = 0.05        # between a streaming thread's verbs
FAIL_DOWN_S = 0.5          # the streams run on against the killed server
FAIL_CLIENT_TIMEOUT_US = 120_000_000
FAIL_DRILL_TIMEOUT_US = 1_000_000  # the dropped and stalled drills' clients
FAIL_DROPS = 3             # drop_next(n)
FAIL_STALLS = (6, 0.25)    # stall_next(n, seconds)
FAIL_STALL_QUEUE = 64      # queue_cap (and flush cap) of the stalled engine
FAIL_STALL_VERBS = 6       # put verbs into the stalled driver
FAIL_BAD_FRAMES = 4        # of drill (d)'s malformed connections, the ones
#                            a reader can name (bad magic, oversized payload,
#                            unknown verb, CRC); the truncated one is an EOF
FAIL_HI = 0xC9000000       # client t fills (FAIL_HI + t, i)
FAIL_STREAM_HI = 0xC9100000  # thread t streams (FAIL_STREAM_HI + t, i)
FAIL_POST_HI = 0xC9200000  # put after the durable snapshot, and while down
FAIL_DRILL_HI = 0xC9300000  # drills (b), (c) and (d) put (FAIL_DRILL_HI + j, i)
FAIL_TIMEOUT_S = 900.0     # the phase's child process, spawn to exit


def fail_keys(hi, lo):
    """[n, 2] uint32 host keys (hi, lo), hi a word or one per key."""
    import numpy as np

    lo = np.asarray(lo, np.uint32)
    return np.stack([np.broadcast_to(np.asarray(hi, np.uint32), lo.shape),
                     lo], -1).astype(np.uint32)


def key64(keys):
    import numpy as np

    return (keys[:, 0].astype(np.uint64) << np.uint64(32)) \
        | keys[:, 1].astype(np.uint64)


def fail_check(out, found, keys, pw: int, label: str, expect=None) -> int:
    """One GET verb's reply: every hit the key's page, every miss zeroed,
    and with `expect` the found mask exactly that -> hits."""
    import numpy as np

    found = np.asarray(found, bool)
    wrong = wrong_pages(out, found, pages_np(keys[:, 0], keys[:, 1], pw))
    if wrong:
        raise AssertionError(f"{label}: {wrong} hits served a wrong page")
    if out[~found].any():
        raise AssertionError(f"{label}: a miss returned nonzero bytes")
    if expect is not None and not np.array_equal(found, expect):
        raise AssertionError(
            f"{label}: {int((found & ~expect).sum())} keys hit that must "
            f"miss, {int((~found & expect).sum())} missed that must hit")
    return int(found.sum())


class FailServers:
    """Phase 17's `KVServer`s in turn behind one registry: `srv` is the
    live one (None while it is down), which every client's factory dials.
    Each engine's `wait_many` is watched for -2 statuses."""

    def __init__(self, cfg):
        import threading

        self.cfg, self.srv, self.all = cfg, None, []
        self.minus_two = 0
        self._lock = threading.Lock()

    def start(self, kv=None, fi=None, warm: bool = False, **eng):
        from pmdfc_tpu_torch.runtime import Engine, KVServer

        pw = self.cfg.page_words
        e = dict(num_queues=FAIL_CLIENTS, queue_cap=2 * FAIL_VERB,
                 batch=FAIL_CLIENTS * FAIL_VERB, timeout_us=200,
                 arena_pages=FAIL_ARENA_SLICES * FAIL_VERB, page_bytes=pw * 4)
        e.update(eng)
        srv = KVServer(self.cfg, engine=Engine(**e), kv=kv,
                       fault_injector=fi, device=DEVICE)
        real = srv.engine.wait_many

        def wait_many(base, n, timeout_us=10_000_000):
            st = real(base, n, timeout_us=timeout_us)
            bad = int((st == -2).sum())
            if bad:
                with self._lock:
                    self.minus_two += bad
            return st

        srv.engine.wait_many = wait_many
        if warm:  # the kernel's first launch, on this thread
            srv.warmup(FAIL_VERB)
        self.all.append(srv.start())
        self.srv = srv
        return srv

    def kill(self) -> None:
        srv, self.srv = self.srv, None
        srv.stop()

    def client(self, queue: int, timeout_us: int = FAIL_CLIENT_TIMEOUT_US):
        """A `ReconnectingClient` over `EngineBackend`s of the live server
        (ConnectionError while none is), `FAIL_VERB`-page slices."""
        from pmdfc_tpu_torch.client import EngineBackend
        from pmdfc_tpu_torch.runtime.failure import ReconnectingClient

        def factory():
            srv = self.srv
            if srv is None:
                raise ConnectionError("server down")
            return EngineBackend(srv, queue=queue, slice_pages=FAIL_VERB,
                                 timeout_us=timeout_us)

        return ReconnectingClient(factory, page_words=self.cfg.page_words,
                                  retry_delay_s=0.005,
                                  max_retry_delay_s=0.05, seed=queue)

    def get_flushes(self) -> int:
        return sum(s.op_batches["get"] for s in self.all)

    def serve_errors(self) -> int:
        return sum(s.errors for s in self.all)


def fail_connect(rc, probe, label: str) -> None:
    """GET `probe` (keys that must miss) until the client is attached."""
    deadline = time.monotonic() + 30
    while not rc.connected:
        if time.monotonic() > deadline:
            raise AssertionError(f"{label}: the client never reattached")
        out, found = rc.get(probe)
        if found.any() or out.any():
            raise AssertionError(f"{label}: a probe key hit")
        time.sleep(0.01)


class FailStream:
    """A client thread of drill (a): alternately re-puts one of its own
    `FAIL_STREAM` verbs of keys (FAIL_STREAM_HI + t, i) and GETs
    `FAIL_VERB` keys drawn from its fill and its own keys, every reply
    checked, until told to stop. A verb that starts and ends while the
    server is down is a downtime verb: a GET must miss every key (zeroed),
    a put must count every page dropped."""

    def __init__(self, reg, rc, t: int, n_fill: int, seed: int):
        import numpy as np

        self.reg, self.rc, self.t = reg, rc, t
        self.rng = np.random.default_rng([seed, t, 17])
        self.own = fail_keys(FAIL_STREAM_HI + t,
                             np.arange(FAIL_STREAM * FAIL_VERB))
        self.pool = np.concatenate([
            fail_keys(FAIL_HI + t, np.arange(n_fill)), self.own])
        self.puts = self.gets = self.hits = 0
        self.down_gets = self.down_puts = 0
        self.error = None

    def run(self, stop) -> None:
        try:
            self._run(stop)
        except BaseException as e:  # noqa: BLE001 — raised by the phase
            self.error = e

    def _run(self, stop) -> None:
        rc, pw, v = self.rc, self.reg.cfg.page_words, FAIL_VERB
        i = 0
        while not stop.is_set():
            down = self.reg.srv is None
            if i % 2 == 0:
                j = (i // 2) % FAIL_STREAM
                ks = self.own[j * v:(j + 1) * v]
                d0 = rc.stats()["dropped_puts"]
                rc.put(ks, pages_np(ks[:, 0], ks[:, 1], pw))
                self.puts += 1
                if down and self.reg.srv is None:
                    if rc.stats()["dropped_puts"] - d0 != v:
                        raise AssertionError(
                            f"failure stream {self.t}: a downtime put was "
                            "not counted dropped")
                    self.down_puts += 1
            else:
                ks = self.pool[self.rng.integers(0, len(self.pool), v)]
                out, found = rc.get(ks)
                hits = fail_check(out, found, ks, pw,
                                  f"failure stream {self.t}")
                self.gets += 1
                self.hits += hits
                if down and self.reg.srv is None:
                    if hits:
                        raise AssertionError(
                            f"failure stream {self.t}: a downtime GET hit")
                    self.down_gets += 1
            i += 1
            time.sleep(FAIL_PAUSE_S if rc.connected else FAIL_PAUSE_S / 5)


def fail_held(sm, kv):
    """The keys the KV's index holds, as sorted uint64 (caller holds the
    KV's lock, on its device)."""
    import numpy as np

    flat, _ = kv._ops.scan(kv.state.index)
    keys = sm.u32.to_numpy(flat)
    return np.sort(key64(keys[~(keys == 0xFFFFFFFF).all(axis=1)]))


def fail_kill_restore(sm, reg, root: str, smi: str) -> dict:
    """Drill (a): the fill through the engine, then eight streaming
    client threads across a durable checkpoint, an invalidation, more
    puts, a torn newest checkpoint, the kill and the downtime; the torn
    file refused, the durable one restored; every key ever put read back
    against the durable cut minus the invalidated keys."""
    import threading

    import numpy as np

    from pmdfc_tpu_torch import checkpoint
    from pmdfc_tpu_torch.checkpoint import CheckpointCorruptError
    from pmdfc_tpu_torch.runtime.failure import FaultInjector

    cfg, pw, v = reg.cfg, reg.cfg.page_words, FAIL_VERB
    out = {}
    srv = reg.srv
    n_fill = int(srv.kv.capacity() * FAIL_FILL) // (FAIL_CLIENTS * v) * v
    clients = [reg.client(t) for t in range(FAIL_CLIENTS)]

    def fill(t):
        rc = clients[t]
        for a in range(0, n_fill, v):
            ks = fail_keys(FAIL_HI + t, np.arange(a, a + v))
            rc.put(ks, pages_np(ks[:, 0], ks[:, 1], pw))
        if rc.stats()["dropped_puts"]:
            raise AssertionError(f"failure fill {t}: a put was dropped")

    out["fill_s"] = run_threads([lambda t=t: fill(t)
                                 for t in range(FAIL_CLIENTS)],
                                "failure fill")
    n_all = n_fill * FAIL_CLIENTS
    log("failure", f"(a) fill: {n_all} pages through the engine by "
        f"{FAIL_CLIENTS} ReconnectingClients over EngineBackend slices of "
        f"{v} pages in {out['fill_s']:.3f} s = "
        f"{n_all / out['fill_s']:.0f} pages/s ({smi})")

    stop = threading.Event()
    streams = [FailStream(reg, clients[t], t, n_fill, sm.seed)
               for t in range(FAIL_CLIENTS)]
    threads = [threading.Thread(target=s.run, args=(stop,),
                                name=f"failure-stream-{s.t}")
               for s in streams]
    for th in threads:
        th.start()
    ctl = reg.client(0)
    durable = os.path.join(root, "durable.ckpt")
    newest = os.path.join(root, "newest.ckpt")
    post = fail_keys(FAIL_POST_HI, np.arange(2 * v))
    # attached before it invalidates: a client whose invalidate opens its
    # connection replays that invalidation at the connect and drops it
    # from its journal, so a later restore would not replay it
    fail_connect(ctl, post[:1], "failure control")
    try:
        time.sleep(4 * FAIL_PAUSE_S)  # every stream under way
        kv = srv.kv
        t0 = time.monotonic()
        with kv._lock, kv._on_device():
            held = fail_held(sm, kv)  # the durable cut, at one op boundary
            srv.checkpoint(durable)
        out["save_s"] = time.monotonic() - t0
        size = os.path.getsize(durable)
        out["save_gbs"] = size / out["save_s"] / 1e9
        fill_held = held[((held >> np.uint64(32)) - np.uint64(FAIL_HI))
                         < np.uint64(FAIL_CLIENTS)]
        gone64 = np.random.default_rng(sm.seed).choice(
            fill_held, v, replace=False)
        gone = np.stack([(gone64 >> np.uint64(32)).astype(np.uint32),
                         (gone64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                        -1)
        inval_hits = int(ctl.invalidate(gone).sum())
        ctl.put(post[:v], pages_np(post[:v, 0], post[:v, 1], pw))
        t0 = time.monotonic()
        srv.checkpoint(newest)
        out["save2_s"] = time.monotonic() - t0
        os.truncate(newest, os.path.getsize(newest) // 2)
        reg.kill()  # the streams run on against the dead server
        t_kill = time.monotonic()
        probe = fail_keys(FAIL_HI, np.arange(v))
        got, found = ctl.get(probe)
        if found.any() or got.any():
            raise AssertionError("failure: a GET hit while the server was "
                                 "down")
        d0 = ctl.stats()["dropped_puts"]
        ctl.put(post[v:], pages_np(post[v:, 0], post[v:, 1], pw))
        if ctl.stats()["dropped_puts"] - d0 != v:
            raise AssertionError("failure: a downtime put was not counted "
                                 "dropped")
        try:
            checkpoint.load(newest, cfg, device=DEVICE)
        except CheckpointCorruptError:
            pass
        else:
            raise AssertionError("failure: the torn snapshot loaded")
        time.sleep(max(0.0, FAIL_DOWN_S - (time.monotonic() - t_kill)))
    finally:
        stop.set()
        for th in threads:
            th.join(PHASE_TIMEOUT_S)
    for s in streams:
        if s.error is not None:
            raise AssertionError(f"failure stream {s.t}: {s.error}") \
                from s.error
    down_gets = sum(s.down_gets for s in streams)
    down_puts = sum(s.down_puts for s in streams)
    if not down_gets or not down_puts:
        raise AssertionError(f"failure: the streams ran {down_gets} GET and "
                             f"{down_puts} put verbs while down")
    out["streams"] = {k: sum(getattr(s, k) for s in streams)
                      for k in ("puts", "gets", "hits")}
    del srv, kv

    t0 = time.monotonic()
    state = checkpoint.load(durable, cfg, device=DEVICE)
    out["load_s"] = time.monotonic() - t0
    fi = FaultInjector()
    srv = reg.start(kv=sm.kv_mod.KV(cfg, state=state, device=DEVICE), fi=fi)
    fail_connect(ctl, post[:1], "failure control")  # replays the journal
    got, found = ctl.get(gone)
    out["recovery_s"] = time.monotonic() - t0
    if found.any():
        raise AssertionError(f"failure: {int(found.sum())} invalidated keys "
                             f"were served after the restore (the control "
                             f"client's counters {ctl.stats()})")
    fail_check(got, found, gone, pw, "failure invalidated")
    replayed = ctl.stats()["replayed_invalidates"]
    if replayed < v:
        raise AssertionError(f"failure: {replayed} invalidations replayed "
                             f"of {v}")
    # every key ever put: exactly the durable cut, less the invalidated
    every = np.concatenate(
        [fail_keys(FAIL_HI + t, np.arange(n_fill))
         for t in range(FAIL_CLIENTS)]
        + [s.own for s in streams] + [post])
    expect = np.isin(key64(every), held) & ~np.isin(key64(every), gone64)
    inval = np.isin(key64(every), gone64)
    parts = np.array_split(np.arange(len(every)), FAIL_CLIENTS)
    hits = [0] * FAIL_CLIENTS

    def verify(t):
        rc = clients[t]
        fail_connect(rc, post[:1], f"failure client {t}")
        for a in range(0, len(parts[t]), v):
            sel = parts[t][a:a + v]
            got, found = rc.get(every[sel])
            if np.asarray(found)[inval[sel]].any():
                raise AssertionError(f"failure client {t}: an invalidated "
                                     "key was served after the restore")
            hits[t] += fail_check(got, found, every[sel], pw,
                                  f"failure restored {t}", expect[sel])

    out["verify_s"] = run_threads([lambda t=t: verify(t)
                                   for t in range(FAIL_CLIENTS)],
                                  "failure verify")
    if sum(hits) != int(expect.sum()):
        raise AssertionError(f"failure: {sum(hits)} hits after the restore, "
                             f"the durable cut holds {int(expect.sum())}")
    log("failure", f"(a) {FAIL_CLIENTS} streaming threads ({out['streams']}"
        f" verbs and hits; {down_gets} GET and {down_puts} put verbs while "
        f"down, every one a zeroed miss or a counted drop); durable "
        f"checkpoint of {size / 2**30:.2f} GiB in {out['save_s']:.3f} s = "
        f"{out['save_gbs']:.3f} GB/s under load, the newest in "
        f"{out['save2_s']:.3f} s, torn to half and refused "
        f"(CheckpointCorruptError); {inval_hits} of {v} invalidations hit "
        f"before the kill; load {out['load_s']:.3f} s, recovery (restart to "
        f"the first full GET, the journal's {replayed} invalidations "
        f"replayed) {out['recovery_s']:.3f} s; {len(every)} keys read back "
        f"in {out['verify_s']:.3f} s: {sum(hits)} hits byte-exact = the "
        f"durable cut ({len(held)} keys) less the {v} invalidated, every "
        f"invalidated and post-durable key a zeroed miss ({smi})")
    out.update(clients=clients, ctl=ctl, expect=every[expect], fi=fi)
    return out


def fail_dropped(sm, reg, fi, smi: str) -> dict:
    """Drill (b): `drop_next(FAIL_DROPS)` on the restored server; the
    dropped batches' requests recorded as the driver pops them."""
    import numpy as np

    from pmdfc_tpu_torch.runtime import OP_GET, OP_PUT

    pw, v, fused = reg.cfg.page_words, FAIL_VERB, sm.fused
    srv = reg.srv
    dropped = []
    real = fi.on_batch

    def on_batch(reqs):
        r = real(reqs)
        if r == "drop":
            dropped.append(reqs.copy())
        return r

    fi.on_batch = on_batch
    rc = reg.client(1, FAIL_DRILL_TIMEOUT_US)
    acked = fail_keys(FAIL_DRILL_HI, np.arange(v))
    lost = fail_keys(FAIL_DRILL_HI, np.arange(v, 2 * v))
    never = fail_keys(FAIL_DRILL_HI + 8, np.arange(1))
    t_drill = time.monotonic()
    fail_connect(rc, never, "failure (b)")
    rc.put(acked, pages_np(acked[:, 0], acked[:, 1], pw))
    got, found = rc.get(acked)
    fail_check(got, found, acked, pw, "failure (b) acked",
               np.ones(v, bool))
    g0, l0 = srv.op_batches["get"], launched(fused)
    s0 = dict(rc.stats())
    fi.drop_next(FAIL_DROPS)
    t0 = time.monotonic()
    rc.put(lost, pages_np(lost[:, 0], lost[:, 1], pw))
    t_put = time.monotonic() - t0
    if t_put >= 5.0:
        raise AssertionError(f"failure (b): the dropped put took {t_put} s")
    deadline = time.monotonic() + 60
    while fi._drop_left > 0:
        if time.monotonic() > deadline:
            raise AssertionError("failure (b): the armed drops never drained")
        got, found = rc.get(acked)
        fail_check(got, found, acked, pw, "failure (b) drain")
        time.sleep(0.01)
    fail_connect(rc, never, "failure (b)")
    got, found = rc.get(acked)
    fail_check(got, found, acked, pw, "failure (b) after the drops",
               np.ones(v, bool))
    reqs = np.concatenate(dropped) if dropped else np.zeros(0, np.uint32)
    put_lost = fail_keys(reqs["khi"], reqs["klo"])[reqs["op"] == OP_PUT] \
        if len(dropped) else np.zeros((0, 2), np.uint32)
    get_lost = int((reqs["op"] == OP_GET).sum()) if len(dropped) else 0
    got, found = rc.get(lost)
    if np.asarray(found)[np.isin(key64(lost), key64(put_lost))].any():
        raise AssertionError("failure (b): a dropped batch's key hit")
    fail_check(got, found, lost, pw, "failure (b) dropped verb")
    s = rc.stats()
    launches = launched(fused) - l0
    gets = srv.op_batches["get"] - g0
    fails = []
    if fi.stats["dropped_batches"] != FAIL_DROPS or len(dropped) != FAIL_DROPS:
        fails.append(f"{fi.stats['dropped_batches']} batches dropped")
    if s["dropped_puts"] - s0["dropped_puts"] < len(put_lost):
        fails.append(f"{len(put_lost)} put requests dropped, "
                     f"{s['dropped_puts'] - s0['dropped_puts']} counted")
    if s["missed_gets"] - s0["missed_gets"] < get_lost:
        fails.append(f"{get_lost} GET requests dropped, "
                     f"{s['missed_gets'] - s0['missed_gets']} counted")
    if launches != gets:
        fails.append(f"{launches} kernel launches for {gets} GET flushes "
                     "that were not dropped")
    if fails:
        raise AssertionError("failure (b): " + "; ".join(fails))
    rc.close()
    secs = time.monotonic() - t_drill
    log("failure", f"(b) drop_next({FAIL_DROPS}): the {v}-page put timed out "
        f"in {t_put:.3f} s (client timeout "
        f"{FAIL_DRILL_TIMEOUT_US / 1e6:.1f} s), {len(put_lost)} put and "
        f"{get_lost} GET requests in the dropped batches, each counted "
        f"(dropped_puts +{s['dropped_puts'] - s0['dropped_puts']}, "
        f"missed_gets +{s['missed_gets'] - s0['missed_gets']}); after the "
        f"drops drained every acknowledged key hit byte-exact and no "
        f"dropped put landed; {launches} kernel launches = {gets} GET "
        f"flushes not dropped, one per flush; {secs:.1f} s ({smi})")
    return {"secs": secs, "acked": acked}


def fail_malformed(sm, reg, keys, smi: str) -> dict:
    """Drill (d): a `NetServer` of `EngineBackend`s over the live server;
    garbage, a truncated header, an oversized payload, an unknown verb, a
    CRC-flipped put and a handshake with the wrong page words, then a GET
    of `keys` (present, `FAIL_VERB` of them) through the wire."""
    import socket
    import zlib

    import numpy as np

    from pmdfc_tpu_torch.client import EngineBackend
    from pmdfc_tpu_torch.runtime import net

    pw, v = reg.cfg.page_words, FAIL_VERB
    srv = reg.srv
    t0 = time.monotonic()
    ns = net.NetServer(lambda: EngineBackend(
        srv, slice_pages=v, timeout_us=FAIL_CLIENT_TIMEOUT_US)).start()
    socks = []
    try:
        addr = ("127.0.0.1", ns.port)
        s1 = socket.create_connection(addr)
        socks.append(s1)
        s1.sendall(b"\xde\xad\xbe\xef" * 9)  # bad magic
        s2 = socket.create_connection(addr)
        s2.sendall(b"\x13\xfc")  # a truncated header, then close
        s2.close()
        s3 = socket.create_connection(addr)
        socks.append(s3)
        s3.sendall(net._HDR.pack(net.MAGIC, 0, 0, 0, 0, 0, 1 << 40, 0))
        s4 = socket.create_connection(addr)
        socks.append(s4)
        s4.settimeout(30)
        net._send_msg(s4, net.MSG_HOLA, count=77, words=pw)
        s4.recv(4096)
        net._send_msg(s4, 99)  # a valid frame, an unknown verb
        s5 = socket.create_connection(addr)
        socks.append(s5)
        s5.settimeout(30)
        net._send_msg(s5, net.MSG_HOLA, count=78, words=pw)
        s5.recv(4096)
        flip = fail_keys(FAIL_DRILL_HI + 3, np.arange(4))
        body = flip.tobytes() + pages_np(flip[:, 0], flip[:, 1], pw).tobytes()
        hdr0 = net._HDR.pack(net.MAGIC, net.MSG_PUTPAGE, 0, 4, pw, 0,
                             len(body), 0)
        crc = zlib.crc32(body, zlib.crc32(hdr0))
        frame = bytearray(hdr0[:-4] + crc.to_bytes(4, "little") + body)
        frame[net._HDR.size + 10] ^= 0x40  # the in-flight bit flip
        s5.sendall(bytes(frame))
        try:
            net.TcpBackend(addr[0], addr[1], page_words=2 * pw)
        except net.ProtocolError:
            pass
        else:
            raise AssertionError("failure (d): a handshake with the wrong "
                                 "page words was accepted")
        deadline = time.monotonic() + 30
        while ns.stats["bad_frames"] < FAIL_BAD_FRAMES:
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
        time.sleep(0.2)
        bad = int(ns.stats["bad_frames"])
        good = net.TcpBackend(addr[0], addr[1], page_words=pw,
                              keepalive_s=None, op_timeout_s=120.0)
        try:
            got, found = good.get(keys)
            fail_check(got, found, keys, pw, "failure (d) wire GET",
                       np.ones(v, bool))
            got, found = good.get(flip)
            fail_check(got, found, flip, pw, "failure (d) flipped put",
                       np.zeros(4, bool))
        finally:
            good.close()
        errors = int(ns.stats["serve_errors"])
    finally:
        for s in socks:
            s.close()
        ns.stop()
    if bad != FAIL_BAD_FRAMES or errors:
        raise AssertionError(f"failure (d): bad_frames {bad} (want "
                             f"{FAIL_BAD_FRAMES}), serve_errors {errors}")
    secs = time.monotonic() - t0
    log("failure", f"(d) NetServer of EngineBackends: garbage, a truncated "
        f"header, an oversized payload, an unknown verb and a CRC-flipped "
        f"put -> bad_frames {bad}, the flipped put not applied; a handshake "
        f"of {2 * pw} page words refused (ProtocolError); serve_errors 0; a "
        f"{v}-key GET through the wire byte-exact; {secs:.1f} s ({smi})")
    return {"secs": secs, "bad_frames": bad}


def fail_stalled(sm, reg, smi: str) -> dict:
    """Drill (c): a server over the same KV whose engine queues hold
    `FAIL_STALL_QUEUE` requests, its driver stalled by
    `stall_next(*FAIL_STALLS)` under `FAIL_STALL_VERBS` put verbs."""
    import numpy as np

    from pmdfc_tpu_torch.runtime.failure import FaultInjector

    pw, v = reg.cfg.page_words, FAIL_VERB
    kv = reg.srv.kv
    reg.kill()
    fi = FaultInjector()
    reg.start(kv=kv, fi=fi, queue_cap=FAIL_STALL_QUEUE,
              batch=FAIL_STALL_QUEUE, timeout_us=100)
    t0 = time.monotonic()
    rc = reg.client(2, FAIL_DRILL_TIMEOUT_US)
    warm = fail_keys(FAIL_DRILL_HI + 1, np.arange(v))
    keys = fail_keys(FAIL_DRILL_HI + 2, np.arange(FAIL_STALL_VERBS * v))
    fail_connect(rc, fail_keys(FAIL_DRILL_HI + 8, np.arange(1)),
                 "failure (c)")
    deadline = time.monotonic() + 60
    while True:
        # service before the stall; on a loaded host a put or GET past the
        # 1 s client timeout is a legal, counted loss: every miss must be
        # one the client counted, then the warm keys are put again
        s0 = rc.stats()
        rc.put(warm, pages_np(warm[:, 0], warm[:, 1], pw))
        got, found = rc.get(warm)
        fail_check(got, found, warm, pw, "failure (c) warm")
        s1 = rc.stats()
        lost = sum(s1[k] - s0[k] for k in ("dropped_puts", "missed_gets"))
        if int((~found).sum()) > lost:
            raise AssertionError(f"failure (c) warm: {int((~found).sum())} "
                                 f"keys missed, {lost} counted lost")
        if found.all():
            break
        if time.monotonic() > deadline:
            raise AssertionError("failure (c): no service before the stall")
    d0 = rc.stats()["dropped_puts"]
    fi.stall_next(*FAIL_STALLS)
    for a in range(0, len(keys), v):
        ks = keys[a:a + v]
        rc.put(ks, pages_np(ks[:, 0], ks[:, 1], pw))
    dropped = rc.stats()["dropped_puts"] - d0
    got, found = rc.get(keys[:2 * v])
    hits_under = fail_check(got, found, keys[:2 * v], pw,
                            "failure (c) under pressure")
    deadline = time.monotonic() + 60
    while True:
        rc.put(keys[:v], pages_np(keys[:v, 0], keys[:v, 1], pw))
        got, found = rc.get(keys[:v])
        fail_check(got, found, keys[:v], pw, "failure (c) recovery")
        if found.all():
            break
        if time.monotonic() > deadline:
            raise AssertionError("failure (c): service never returned")
        time.sleep(0.1)
    stalled = fi.stats["stalled_batches"]
    if stalled < 1 or dropped > len(keys):
        raise AssertionError(f"failure (c): {stalled} stalled batches, "
                             f"{dropped} dropped of {len(keys)}")
    rc.close()
    secs = time.monotonic() - t0
    log("failure", f"(c) stall_next{FAIL_STALLS} under queues of "
        f"{FAIL_STALL_QUEUE}: {stalled} batches stalled, {dropped} of "
        f"{len(keys)} put pages dropped and counted, {hits_under} hits "
        f"under pressure, each byte-exact; full service after it, "
        f"byte-exact; {secs:.1f} s ({smi})")
    return {"secs": secs}


def failure_dir():
    """Where phase 17 writes its checkpoints (git-ignored, on the
    checkout's disk); removed at the end of the phase."""
    from pathlib import Path

    return Path(__file__).resolve().parent / "build" / "failure"


def run_failure(sm):
    """Phase 17: the failure ladder on the engine-backed server on the
    card: (a) kill and restore under load, (b) dropped completions, (d)
    malformed frames through a `NetServer`, (c) a stalled driver -> its
    kernels entry."""
    import shutil

    import numpy as np

    from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, KVConfig

    torch, fused = sm.torch, sm.fused
    t_phase = time.monotonic()
    free_card(torch)
    smi = nvidia_smi()
    root = failure_dir()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cfg = KVConfig(index=IndexConfig(**FAIL_INDEX),
                   bloom=BloomConfig(num_bits=FAIL_BLOOM_BITS),
                   page_words=FAIL_PAGE_WORDS)
    reg = FailServers(cfg)
    times = {}
    try:
        srv = reg.start(warm=True)
        log("failure", f"KVServer on {srv.kv.device}: linear·flat, "
            f"{srv.kv.capacity()} slots (clusters of "
            f"{srv.kv.state.index.table.shape[1] // 4}), pool "
            f"{srv.kv.state.pool.pages.numel() * 4 / 2**30:.2f} GiB of "
            f"{cfg.page_words}-word pages; engine of {FAIL_CLIENTS} queues, "
            f"arena {FAIL_ARENA_SLICES} x {FAIL_VERB} pages ({smi})")
        torch.cuda.synchronize()
        fused.launches.clear()  # the main path from here
        t0 = time.monotonic()
        a = fail_kill_restore(sm, reg, str(root), smi)
        times["a"] = time.monotonic() - t0
        b = fail_dropped(sm, reg, a["fi"], smi)
        times["b"] = b["secs"]
        times["d"] = fail_malformed(sm, reg, b["acked"], smi)["secs"]
        kv = reg.srv.kv
        times["c"] = fail_stalled(sm, reg, smi)["secs"]
        reg.kill()
        for rc in a["clients"] + [a["ctl"]]:
            rc.close()
        torch.cuda.synchronize()
        launches = fused.launches["fused_get_linear_flat"]
        flushes = reg.get_flushes()
        s = kv.stats()
        fails = []
        if launches != flushes or not launches:
            fails.append(f"{launches} kernel launches for {flushes} GET "
                         "flushes that were not dropped")
        if s["misses"] != sum(s[c] for c in sm.kv_mod.MISS_CAUSE_NAMES):
            fails.append("misses != the sum of the miss causes")
        if reg.serve_errors():
            fails.append(f"serve_errors {reg.serve_errors()}")
        if reg.minus_two:
            fails.append(f"{reg.minus_two} requests completed with -2")
        if fails:
            raise AssertionError("failure: " + "; ".join(fails))
        log("failure", f"gates: no wrong byte, every miss zeroed, misses == "
            f"sum of the miss causes on the restored KV (hits {s['hits']}, "
            f"misses {s['misses']}), serve_errors 0 on {len(reg.all)} "
            f"servers, no -2 status; {launches} fused-GET launches = "
            f"{flushes} GET flushes not dropped ({smi})")
        present = a["expect"]
        n = len(present)

        def batch(w):
            n_never = max(1, w // 8)
            lo = torch.randint(NEVER_LO, 1 << 32, (n_never,), device=sm.dev,
                               generator=sm.gen)
            never = sm.keys_of(FAIL_DRILL_HI + 9, lo)
            pick = np.random.default_rng(sm.seed + w).integers(
                0, n, w - n_never)
            keys = torch.cat([torch.from_numpy(
                present[pick].view(np.int32)).to(sm.dev), never])
            return keys[torch.randperm(w, device=sm.dev, generator=sm.gen)]

        t = uncounted(fused, lambda: plane_kernel(
            sm, kv.state, None, cfg.page_words, [FAIL_VERB],
            "failure restored", smi, batch=batch))[FAIL_VERB]
        log("failure", f"fused_get_linear_flat w = {FAIL_VERB} on the "
            f"restored KV: kernel == plain, {t[0]:.4f} ms vs bound "
            f"{t[2]:.4f} ms ({t[2] / t[0]:.0%}), plain {t[1]:.4f} ms; "
            f"{launches} launches on the phase's path ({smi})")
    finally:
        if reg.srv is not None:
            reg.kill()
        free_card(torch)
        shutil.rmtree(root, ignore_errors=True)
    t_all = time.monotonic() - t_phase
    log("failure", f"phase 17 took {t_all:.1f} s: (a) {times['a']:.1f} s, "
        f"(b) {times['b']:.1f} s, (d) {times['d']:.1f} s, (c) "
        f"{times['c']:.1f} s")
    return [plane_entry(sm, "failure", launches, t)]


def failure_subprocess(seed: int):
    """`run_failure` in a child process of this script (`--failure`) ->
    (its kernel entries, its log lines, seconds). A child that fails
    fails the phase."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--failure", "--seed",
         str(seed)], capture_output=True, text=True,
        timeout=FAIL_TIMEOUT_S)
    entries, lines = None, []
    for line in proc.stdout.splitlines():
        if line.startswith("FAILURE "):
            entries = json.loads(line[len("FAILURE "):])
        else:
            lines.append(line)
    if proc.returncode != 0 or entries is None:
        raise AssertionError(f"failure child exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    return entries, lines, time.monotonic() - t0


def collect_failure(lanes: "Lanes"):
    """Phase 17's child, queued in `lanes` at phase 12's start: its lines
    echoed, its kernel entries returned."""
    t0 = time.monotonic()
    (entries, lines, secs), = lanes.rows("failure")
    for line in lines:
        print(line, flush=True)
    log("failure", f"phase 17's child took {secs:.1f} s (in the lanes, "
        f"{lanes.span('failure')}; waited {time.monotonic() - t0:.1f} s "
        "for it here)")
    return entries


# ---------------------------------------------------------------------------
# phase 18, store: the store's own suites' card-only drills
# ---------------------------------------------------------------------------

STORE_INDEX = dict(capacity=1 << 18)  # (a): a 1 GiB pool of 4 KiB pages
STORE_TIER_INDEX = dict(capacity=1 << 17)  # (b): cut from 2^18 for phase 19
STORE_TIER = dict()        # (b): TierConfig()'s defaults
STORE_BLOOM_BITS = 1 << 21
STORE_PAGE_WORDS = 1024
STORE_FILL = 0.75          # of the slots, through KV.insert
STORE_GET_B = 1 << 14      # keys of (a)'s and (b)'s GETs and churn inserts
STORE_VERB = 1 << 11       # keys of every wire verb
STORE_CHURN = 4            # (a): the churn inserts this many times the slots
STORE_POISON_EVERY = 1024  # (a): one pool row in this many is poisoned
STORE_EXTENT = 1 << 16     # (a): pages of the long extent
STORE_CAP_COVERS = 4       # (a): extent_max_covers of the capped KV
STORE_HOT_GETS = 3         # (b): promoting GETs of the hot set
STORE_PLANE_INDEX = dict(capacity=1 << 16)  # (c): a lane (cut from 2^18)
STORE_PLANE_BLOOM_BITS = 1 << 20
STORE_PLANE_FILL = 0.5     # (c): of the plane's slots, put before the storm
STORE_CONNS = 8            # (c): the storm's connections
STORE_STEPS = 12           # (c): verbs per connection, half before the fault
STORE_TRANSCRIPT = 12      # (c): verbs of the PMDFC_MESH2D=off transcript
STORE_NODE_INDEX = dict(capacity=1 << 16)   # (d): a node
STORE_NODE_BLOOM_BITS = 1 << 20
STORE_NODE_KEYS = 1 << 14  # (d): keys put through the group
STORE_REPLACE_S = 0.05     # (d): auto_replace_after_s
STORE_HI = 0xCA000000      # (a), (b): the fill's keys are (STORE_HI, i)
STORE_ONES = 0xFFFFFFFF    # (a): the all-ones hi word
STORE_CHURN_HI = 0xCA100000
STORE_EXT_HI = 0xCA200000
STORE_PLANE_HI = 0xCA300000  # (c): the GET set
STORE_PUT_HI = 0xCA400000    # (c): connection c puts (STORE_PUT_HI + c, i)
STORE_GROUP_HI = 0xCA500000  # (c): the groups' keys
STORE_NODE_HI = 0xCA600000   # (d)
STORE_XOR = 0x3C3C3C3C     # a re-put page is the key's page XOR this
STORE_TIMEOUT_S = 600.0    # the phase's child process, spawn to exit
# (e): `tests/test_admit.py`'s fast-aging gate (`ADMIT_FAST`, :60), on
# (b)'s depth; the zipf set is half the hot rows, the scan this many
# times the hot rows, inserted and read twice in STORE_VERB-key GETs
STORE_ADMIT = dict(sketch_width=1 << 10, door_bits=1 << 11, reset_ops=64,
                   threshold=2)
STORE_ADMIT_SCAN = 4
STORE_ADMIT_HI = 0xCA700000  # (e): zipf (hi, 1..), scan (hi, NEVER_LO - n..)
# (f): `tests/test_replica.py`'s slow-primary hedge and multi-endpoint
# chaos soak on (d)'s nodes, each behind a ChaosProxy: the hedge drill's
# hedge_ms and armed delay, the soak's rates, breaker and kill/restore
# schedule, its 520 steps cut to STORE_SOAK_STEPS (the schedule scaled)
STORE_REPLICA_KEYS = 1 << 13  # (f): keys put through the group
STORE_REPLICA_HI = 0xCA800000
STORE_HEDGE_MS = 40.0
STORE_HEDGE_DELAY_S = 0.6     # (f1): the delay armed on one frame of node 0
STORE_SOAK_RATES = {"flip": 0.02, "truncate": 0.01, "duplicate": 0.02,
                    "delay": 0.01}
STORE_SOAK_STEPS = 16  # 52, 36, 24 steps took 9.4, 8.8, 8.9 s of (f) on the card
STORE_SOAK_SCHEDULE = ((60, "kill", 2), (200, "restore", 2),
                       (280, "kill", 0), (420, "restore", 0))  # of 520


def store_dir():
    """Where phase 18 writes its snapshot (git-ignored, on the checkout's
    disk); removed at the end of the phase."""
    from pathlib import Path

    return Path(__file__).resolve().parent / "build" / "store"


def store_cfg(index, bloom_bits, tier=None, **kw):
    from pmdfc_tpu_torch.config import (BloomConfig, IndexConfig, KVConfig,
                                        TierConfig)

    return KVConfig(index=IndexConfig(**index),
                    bloom=BloomConfig(num_bits=bloom_bits),
                    page_words=STORE_PAGE_WORDS,
                    tier=None if tier is None else TierConfig(**tier), **kw)


def store_check(sm, out, found, keys, label: str, xor: int = 0) -> int:
    """A device GET's reply: every hit the key's page (XOR `xor`), every
    miss zeroed -> hits."""
    want = sm.pages_of(keys, out.shape[1])
    if xor:
        want = want ^ xor
    wrong = int((out[found] != want[found]).any(dim=1).sum())
    if wrong:
        raise AssertionError(f"{label}: {wrong} hits served a wrong page")
    if bool(out[~found].any()):
        raise AssertionError(f"{label}: a miss returned nonzero bytes")
    return int(found.sum())


def store_held(sm, kv, hi: int):
    """The lo words (int64, on the device) of the keys (hi, .) the KV's
    index holds now."""
    torch = sm.torch
    with kv._lock, kv._on_device():
        flat, _ = kv._ops.scan(kv.state.index)
        lo = flat[flat[:, 0] == sm.u32.narrow(torch.tensor(hi))][:, 1]
    return sm.u32.widen(lo)


def store_key64(sm, keys):
    """[n, 2] int32 device keys -> int64 (hi << 32 | lo)."""
    return (sm.u32.widen(keys[:, 0]) << 32) | sm.u32.widen(keys[:, 1])


def store_rows(sm, kv, keys):
    """The pool row each key's index entry points at (-1 where absent)."""
    with kv._lock, kv._on_device():
        res = kv._ops.get_batch(kv.state.index, keys)
    return sm.torch.where(res.found, res.values[:, 1], -1)


class StoreLaunches:
    """Counts one `KV`'s GET verbs (`get_async`, `get_compact_async`) that
    carried keys: each launches the fused GET once."""

    def __init__(self, kv):
        self.n = 0
        for name in ("get_async", "get_compact_async"):
            real = getattr(kv, name)

            def counted(keys, *a, _real=real, **kw):
                self.n += len(keys) > 0
                return _real(keys, *a, **kw)

            setattr(kv, name, counted)


def store_fill(sm, kv, n: int, hi: int, ones: int = 0):
    """Pages (hi, i < n - ones) and (STORE_ONES, i < ones) put through
    `KV.insert` in batches of STORE_GET_B - 16 keys, so `_pad_pow2` pads
    every batch with INVALID rows -> the all-ones keys (every one placed,
    none dropped)."""
    torch = sm.torch
    pw = kv.config.page_words
    b = STORE_GET_B - 16
    lo = torch.arange(n - ones, device=sm.dev)
    for i in range(0, len(lo), b):
        keys = sm.keys_of(hi, lo[i:i + b])
        kv.insert(keys, sm.pages_of(keys, pw))
    ones_keys = sm.keys_of(STORE_ONES, torch.arange(ones, device=sm.dev))
    for i in range(0, ones, b):
        keys = ones_keys[i:i + b]
        res = kv.insert(keys, sm.pages_of(keys, pw))
        if bool((res.slots < 0).any()) or bool(res.dropped.any()):
            raise AssertionError(
                f"store (a): {int((res.slots < 0).sum())} all-ones keys "
                f"not placed, {int(res.dropped.sum())} dropped")
    return ones_keys


def store_edges(sm, smi: str) -> dict:
    """Part (a): a linear·flat `KV` filled to STORE_FILL (its last
    STORE_GET_B keys with the all-ones hi word), churned with STORE_CHURN
    times its slots, deletes and re-puts, poisoned rows on the GET and
    compact paths, the long and the capped extent -> its kernel entry."""
    import numpy as np

    torch, fused = sm.torch, sm.fused
    cfg = store_cfg(STORE_INDEX, STORE_BLOOM_BITS)
    kv = sm.kv_mod.KV(cfg, device=DEVICE)
    pw, cap = cfg.page_words, kv.capacity()
    count = StoreLaunches(kv)
    n = int(cap * STORE_FILL)
    t0 = time.monotonic()
    torch.cuda.synchronize()
    fused.launches.clear()  # (a)'s path from here
    ones = store_fill(sm, kv, n, STORE_HI, STORE_GET_B)
    out, found = kv.get(ones)
    hits = store_check(sm, out, found, ones, "store (a) all-ones GET")
    if hits != len(ones):
        raise AssertionError(f"store (a): {len(ones) - hits} all-ones keys "
                             f"missed of {len(ones)}")
    # every fill key the index holds (evicting inserts recycled rows)
    fill_held = store_held(sm, kv, STORE_HI)
    for i in range(0, len(fill_held), STORE_GET_B):
        keys = sm.keys_of(STORE_HI, fill_held[i:i + STORE_GET_B])
        out, found = kv.get(keys)
        if store_check(sm, out, found, keys, "store (a) fill") != len(keys):
            raise AssertionError("store (a): a held fill key missed")
    # the churn: STORE_CHURN x the slots in STORE_GET_B-page inserts
    s0 = kv.stats()
    m = STORE_CHURN * cap
    lo = torch.arange(m, device=sm.dev)
    for i in range(0, m, STORE_GET_B):
        keys = sm.keys_of(STORE_CHURN_HI, lo[i:i + STORE_GET_B])
        kv.insert(keys, sm.pages_of(keys, pw))
    churn_hits = 0
    for i in range(0, m, STORE_GET_B):
        keys = sm.keys_of(STORE_CHURN_HI, lo[i:i + STORE_GET_B])
        out, found = kv.get(keys)
        churn_hits += store_check(sm, out, found, keys, "store (a) churn")
    s1 = kv.stats()
    lost = (s1["evictions"] - s0["evictions"]) + (s1["drops"] - s0["drops"])
    top, live = int(kv.state.pool.top), round(kv.utilization() * cap)
    if not 0 < churn_hits < m or m - churn_hits > lost \
            or top != cap - live:
        raise AssertionError(
            f"store (a): churn of {m} keys: {churn_hits} hits, "
            f"{m - churn_hits} misses vs evictions + drops {lost}; pool top "
            f"{top} vs capacity - live {cap - live}")
    # deletes free rows; re-puts and updates re-digest them
    held = store_held(sm, kv, STORE_CHURN_HI)
    perm = torch.randperm(len(held), device=sm.dev, generator=sm.gen)
    half = STORE_GET_B // 2
    dele = sm.keys_of(STORE_CHURN_HI, held[perm[:half]])
    upd = sm.keys_of(STORE_CHURN_HI, held[perm[half:2 * half]])
    top0 = int(kv.state.pool.top)
    if not bool(kv.delete(dele).all()) \
            or int(kv.state.pool.top) != top0 + half:
        raise AssertionError(f"store (a): deleting {half} held keys moved "
                             f"the pool top by {int(kv.state.pool.top) - top0}")
    both = torch.cat([dele, upd])
    res = kv.insert(both, sm.pages_of(both, pw) ^ STORE_XOR)
    # a re-put into the full index evicts (FIFO) as JAX's does: a key of
    # this batch the insert reported evicted is a legal miss
    ev = res.evicted[~(res.evicted == -1).all(dim=1)]
    gone = torch.isin(store_key64(sm, both), store_key64(sm, ev))
    out, found = kv.get(both)
    store_check(sm, out, found, both, "store (a) re-put", xor=STORE_XOR)
    if not torch.equal(found, ~gone) or kv.stats()["corrupt_pages"]:
        raise AssertionError(
            f"store (a): {int((~found[:half] & ~gone[:half]).sum())} re-put "
            f"and {int((~found[half:] & ~gone[half:]).sum())} updated keys "
            f"missed that were not evicted, corrupt_pages "
            f"{kv.stats()['corrupt_pages']}")
    # one pool row in STORE_POISON_EVERY poisoned in place
    held = store_held(sm, kv, STORE_CHURN_HI)
    pick = held[torch.randperm(len(held), device=sm.dev,
                               generator=sm.gen)[:STORE_GET_B]]
    probe = sm.keys_of(STORE_CHURN_HI, pick)
    xored = torch.isin(probe[:, 1], both[:, 1])
    rows = store_rows(sm, kv, probe)
    bad = (rows >= 0) & (rows % STORE_POISON_EVERY == 0)
    c0 = kv.stats()["corrupt_pages"]
    with kv._lock, kv._on_device():
        kv.state.pool.pages[::STORE_POISON_EVERY] ^= 1 << 9
    want = sm.pages_of(probe, pw) ^ torch.where(
        xored, STORE_XOR, 0).to(torch.int32)[:, None]
    out, found = kv.get(probe)
    if not torch.equal(found, ~bad) or int((out[found] != want[found])
                                           .any(dim=1).sum()) \
            or bool(out[~found].any()) \
            or kv.stats()["corrupt_pages"] - c0 != int(bad.sum()):
        raise AssertionError(
            f"store (a): poisoned GET: {int((found & bad).sum())} poisoned "
            f"keys hit, {int((~found & ~bad).sum())} clean keys missed, "
            f"corrupt_pages +{kv.stats()['corrupt_pages'] - c0} for "
            f"{int(bad.sum())} poisoned")
    out, order, _, nfound, _ = kv.get_compact_async(probe)
    nf = int(nfound)
    order = order[:nf].long()
    if nf != int((~bad).sum()) or bool(bad[order].any()) \
            or not torch.equal(order, (~bad).nonzero().flatten()) \
            or int((out[:nf] != want[order]).any(dim=1).sum()):
        raise AssertionError(
            f"store (a): get_compact served {nf} rows for "
            f"{int((~bad).sum())} clean keys, {int(bad[order].sum())} of "
            "them poisoned, or out of request order or with wrong bytes")
    with kv._lock, kv._on_device():
        kv.state.pool.pages[::STORE_POISON_EVERY] ^= 1 << 9
    # the long extent, and a capped KV's truncated tail
    base = np.array([STORE_EXT_HI, 0], np.uint32)
    _, unc = kv.insert_extent(base, np.array([0, 1 << 20], np.uint32),
                              STORE_EXTENT)
    probe_e = np.array([[STORE_EXT_HI, STORE_EXTENT * 5 // 8],
                        [STORE_EXT_HI, STORE_EXTENT - 1],
                        [STORE_EXT_HI, STORE_EXTENT]], np.uint32)
    vals, efound = kv.get_extent(probe_e)
    addr = (vals[:, 0].astype(np.uint64) << np.uint64(32)) | vals[:, 1]
    if unc or list(efound) != [True, True, False] or list(addr[:2]) != [
            (1 << 20) + 4096 * int(k) for k in probe_e[:2, 1]]:
        raise AssertionError(f"store (a): the {STORE_EXTENT}-page extent: "
                             f"uncovered {unc}, found {list(efound)}")
    capped = sm.kv_mod.KV(store_cfg(dict(capacity=1 << 12), 1 << 14,
                                    extent_max_covers=STORE_CAP_COVERS),
                          device=DEVICE)
    _, tail = capped.insert_extent(np.array([STORE_EXT_HI, 1], np.uint32),
                                   np.array([0, 0], np.uint32), 1000)
    if tail <= 0:
        raise AssertionError("store (a): the capped extent reported no "
                             "uncovered tail")
    torch.cuda.synchronize()
    launches = fused.launches["fused_get_linear_flat"]
    if launches != count.n:
        raise AssertionError(f"store (a): {launches} fused-GET launches for "
                             f"{count.n} GETs")
    s = kv.stats()
    if s["misses"] != sum(s[c] for c in sm.kv_mod.MISS_CAUSE_NAMES):
        raise AssertionError("store (a): misses != the sum of the causes")
    secs = time.monotonic() - t0
    log("store", f"(a) linear·flat KV on {kv.device}: {cap} slots, pool "
        f"{kv.state.pool.pages.numel() * 4 / 2**30:.2f} GiB of {pw}-word "
        f"pages; fill {n} pages, the last {len(ones)} with hi 0xFFFFFFFF in "
        f"padded batches of {STORE_GET_B - 16}: every one placed and hit "
        f"byte-exact by a w = {STORE_GET_B} GET, every other held key "
        f"({len(fill_held)}) too; churn of {m} pages: {churn_hits} "
        f"hits byte-exact, {m - churn_hits} misses <= evictions + drops "
        f"{lost}, pool top {top} == capacity - live; {half} deletes freed "
        f"{half} rows, {2 * half} re-puts and updates served their new "
        f"bytes ({int(gone.sum())} evicted by their own batch), "
        f"corrupt_pages 0; {int(bad.sum())} of {STORE_GET_B} probe "
        f"keys on poisoned rows (1 in {STORE_POISON_EVERY}): missed as "
        f"corrupt on the GET and left out of the compacted rows ({nf} in "
        f"request order, byte-exact); {STORE_EXTENT}-page extent reachable, "
        f"a {STORE_CAP_COVERS}-cover cap left {tail} pages uncovered; "
        f"{launches} fused-GET launches = {count.n} GETs; {secs:.1f} s "
        f"({smi})")
    present = store_held(sm, kv, STORE_CHURN_HI).cpu().numpy()
    t = uncounted(fused, lambda: plane_kernel(
        sm, kv.state, present, pw, [STORE_GET_B], "store (a)", smi,
        hi=STORE_CHURN_HI))[STORE_GET_B]
    del kv, capped
    free_card(torch)
    return plane_entry(sm, "store", launches, t)


def store_tiered(sm, root: str, smi: str) -> dict:
    """Part (b): a linear·tiered `KV` filled to STORE_FILL, promoting GETs
    then a compacted GET, a snapshot loaded into a fresh `KV` (every key,
    the promoted ones among them, served byte-exact through the kernel,
    every state leaf equal), `tier_stats` over `MSG_STATS` -> its kernel
    entry."""
    import os

    import numpy as np

    from pmdfc_tpu_torch import carry, checkpoint
    from pmdfc_tpu_torch.client import DirectBackend
    from pmdfc_tpu_torch.config import NetConfig
    from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend

    torch, fused = sm.torch, sm.fused
    cfg = store_cfg(STORE_TIER_INDEX, STORE_BLOOM_BITS, tier=STORE_TIER)
    kv = sm.kv_mod.KV(cfg, device=DEVICE)
    pw, cap = cfg.page_words, kv.capacity()
    count = StoreLaunches(kv)
    n = int(cap * STORE_FILL)
    t0 = time.monotonic()
    torch.cuda.synchronize()
    fused.launches.clear()  # (b)'s path from here
    store_fill(sm, kv, n, STORE_HI)
    held = store_held(sm, kv, STORE_HI)
    perm = held[torch.randperm(len(held), device=sm.dev, generator=sm.gen)]
    hot = sm.keys_of(STORE_HI, perm[:STORE_VERB])
    for _ in range(STORE_HOT_GETS):
        out, found = kv.get(hot)
        store_check(sm, out, found, hot, "store (b) hot GET")
    prom = kv.tier_stats()["promotions"]
    never = sm.keys_of(STORE_HI, torch.arange(
        NEVER_LO, NEVER_LO + STORE_GET_B // 2, device=sm.dev))
    probe = torch.cat([sm.keys_of(STORE_HI, perm[:STORE_GET_B // 2]), never])
    probe = probe[torch.randperm(len(probe), device=sm.dev,
                                 generator=sm.gen)]
    out, order, _, nfound, _ = kv.get_compact_async(probe)
    nf = int(nfound)
    order = order[:nf].long()
    present = probe[:, 0] == sm.u32.narrow(torch.tensor(STORE_HI))
    present &= probe[:, 1] < NEVER_LO
    if prom <= 0 or nf != int(present.sum()) \
            or not torch.equal(order, present.nonzero().flatten()) \
            or int((out[:nf] != sm.pages_of(probe[order], pw))
                   .any(dim=1).sum()):
        raise AssertionError(
            f"store (b): {prom} promotions; get_compact served {nf} rows "
            f"for {int(present.sum())} held keys, not hits-first in request "
            "order byte-exact")
    with kv._lock, kv._on_device():
        h = kv.state.pool.hfree.shape[0]
    rows = store_rows(sm, kv, sm.keys_of(STORE_HI, held))
    in_hot = (rows >= 0) & (rows < h)
    path = os.path.join(root, "tiered.ckpt")
    ts = time.monotonic()
    kv.snapshot(path)
    t_snap = time.monotonic() - ts
    snap_bytes = os.path.getsize(path)
    ts = time.monotonic()
    kv2 = sm.kv_mod.KV(cfg, state=checkpoint.load(path, cfg, device=DEVICE),
                       device=DEVICE)
    t_load = time.monotonic() - ts
    os.remove(path)
    a = dict(carry.leaves(kv.state))
    b2 = carry.leaves(kv2.state)
    diff = [k for k, v in b2 if k not in a or not torch.equal(a[k], v)]
    diff += sorted(set(a) - {k for k, _ in b2})
    del a, b2
    count2 = StoreLaunches(kv2)
    served = lost_hot = 0
    for i in range(0, len(held), STORE_GET_B):
        keys = sm.keys_of(STORE_HI, held[i:i + STORE_GET_B])
        out, found = kv2.get(keys)
        served += store_check(sm, out, found, keys, "store (b) restored")
        lost_hot += int((~found & in_hot[i:i + STORE_GET_B]).sum())
    if served != len(held) or not int(in_hot.sum()):
        raise AssertionError(
            f"store (b): the restored KV lost {len(held) - served} keys "
            f"({lost_hot} of them promoted to hot rows) of {len(held)}; "
            f"{int(in_hot.sum())} keys on hot rows at the snapshot")
    if diff:
        raise AssertionError(f"store (b): restored leaves differ: {diff}")
    srv = NetServer(lambda: DirectBackend(kv2), net=NetConfig()).start()
    try:
        with TcpBackend("127.0.0.1", srv.port, page_words=pw,
                        keepalive_s=None) as tb:
            keys = sm.u32.to_numpy(hot[:STORE_VERB].cpu())
            out, found = tb.get(keys)
            fail_check(out, found, keys, pw, "store (b) wire GET",
                       expect=np.ones(len(keys), bool))
            doc = tb.server_stats()
        tier = kv2.tier_stats()
        if {k: doc.get(k) for k in tier} != tier \
                or int(srv.stats["serve_errors"]):
            raise AssertionError(f"store (b): MSG_STATS tier counters "
                                 f"{ {k: doc.get(k) for k in tier} } != {tier}")
    finally:
        srv.stop()
    torch.cuda.synchronize()
    launches = fused.launches["fused_get_linear_tiered"]
    if launches != count.n + count2.n:
        raise AssertionError(f"store (b): {launches} fused-GET launches for "
                             f"{count.n + count2.n} GETs")
    s = kv2.stats()
    if s["misses"] != sum(s[c] for c in sm.kv_mod.MISS_CAUSE_NAMES):
        raise AssertionError("store (b): misses != the sum of the causes")
    secs = time.monotonic() - t0
    log("store", f"(b) linear·tiered KV on {kv.device}: {cap} slots, pools "
        f"{(kv.state.pool.pages.numel() * 4) / 2**30:.2f} GiB; fill {n} "
        f"pages; {STORE_HOT_GETS} GETs of {len(hot)} hot keys: {prom} "
        f"promotions; get_compact over {len(probe)} keys served {nf} hits "
        f"first in request order, byte-exact; snapshot {snap_bytes / 2**30:.2f}"
        f" GiB in {t_snap:.2f} s, loaded in {t_load:.2f} s into a fresh KV: "
        f"all {len(held)} keys ({int(in_hot.sum())} on hot rows) served "
        f"byte-exact through the kernel, every state leaf equal; tier_stats "
        f"over MSG_STATS equal the KV's ({tier['promotions']} promotions, "
        f"{tier['hot_hits']} hot hits); {launches} fused-GET launches = "
        f"{count.n + count2.n} GETs; {secs:.1f} s ({smi})")
    present = held.cpu().numpy()
    t = uncounted(fused, lambda: plane_kernel(
        sm, kv2.state, present, pw, [STORE_GET_B], "store (b) restored",
        smi, hi=STORE_HI))[STORE_GET_B]
    del kv, kv2
    free_card(torch)
    return plane_entry(sm, "store-tiered", launches, t,
                       name="fused_get_linear_tiered")


class local_devices:
    """The port's serving factory sees `devs` as the host's devices inside
    the block: one card stands in for the four devices of a 2 x 2 grid,
    as every plane phase builds its grids (`[cuda] * 4`)."""

    def __init__(self, devs):
        self.devs = devs

    def __enter__(self):
        from pmdfc_tpu_torch.parallel import plane

        self.old = plane._local_devices
        plane._local_devices = lambda: list(self.devs)

    def __exit__(self, *exc):
        from pmdfc_tpu_torch.parallel import plane

        plane._local_devices = self.old


def store_transcript(be, pw: int, seed: int) -> list:
    """A seeded mixed run of STORE_VERB-key verbs straight against a
    backend -> its transcript (found masks, digests of the served bytes)."""
    import hashlib

    import numpy as np

    rng = np.random.default_rng([seed, 18])
    universe = fail_keys(STORE_GROUP_HI + 7, np.arange(4 * STORE_VERB))
    out = []
    for _ in range(STORE_TRANSCRIPT):
        op = int(rng.integers(5))
        lo = int(rng.integers(0, 3 * STORE_VERB))
        sel = universe[lo:lo + int(rng.integers(1, STORE_VERB + 1))]
        if op == 0:
            be.put(sel, pages_np(sel[:, 0], sel[:, 1], pw))
            out.append(("put", len(sel)))
        elif op in (1, 2):
            pages, found = be.get(sel)
            out.append(("get", found.tolist(), hashlib.sha1(
                np.ascontiguousarray(pages[found])).hexdigest()))
        elif op == 3:
            out.append(("inval", be.invalidate(sel).tolist()))
        else:
            vals, ef = be.get_extent(sel)
            out.append(("gext", ef.tolist(), vals[ef].tolist()))
    be.insert_extent(np.array([STORE_EXT_HI, 0], np.uint32),
                     np.array([0, 4096], np.uint32), 32)
    vals, ef = be.get_extent(np.array([[STORE_EXT_HI, 5],
                                       [STORE_EXT_HI, 40]], np.uint32))
    out.append(("ext", ef.tolist(), vals.tolist()))
    return out


class StoreConn:
    """One connection of (c)'s storm: a pipelined `TcpBackend`; a step is
    a put of a fresh verb of its own keys (one in four) or a GET of
    STORE_VERB keys drawn from the GET set, every reply checked."""

    def __init__(self, port: int, c: int, pw: int, seed: int, los):
        import numpy as np

        from pmdfc_tpu_torch.runtime.net import TcpBackend

        self.be = TcpBackend("127.0.0.1", port, page_words=pw,
                             keepalive_s=None, window=8, op_timeout_s=120.0)
        self.c, self.pw, self.los = c, pw, los
        self.rng = np.random.default_rng([seed, c, 18])
        self.puts = self.gets = self.hits = 0

    def step(self) -> None:
        import numpy as np

        v = STORE_VERB
        if self.rng.integers(4) == 0:
            keys = fail_keys(STORE_PUT_HI + self.c,
                             np.arange(self.puts * v, (self.puts + 1) * v))
            self.be.put(keys, pages_np(keys[:, 0], keys[:, 1], self.pw))
            self.puts += 1
        else:
            self.get()

    def get(self) -> int:
        keys = fail_keys(STORE_PLANE_HI, self.los[self.rng.integers(
            0, len(self.los), STORE_VERB)])
        out, found = self.be.get(keys)
        hits = fail_check(out, found, keys, self.pw,
                          f"store (c) connection {self.c}")
        self.gets += 1
        self.hits += hits
        return hits

    def run(self, steps: int):
        return lambda: [self.step() for _ in range(steps)]


def store_stale_rows(skv) -> int:
    """The rows a replica repair has to fix: on each shard and lane, the
    pool rows that fail their digest there and validate on another lane."""
    import torch

    from pmdfc_tpu_torch.ops.pagepool import page_digest

    n = 0
    with skv._lock:
        for row in skv._st:
            oks = torch.stack([(page_digest(st.pool.pages) == st.pool.sums)
                               .cpu() for st in row])
            for r in range(len(row)):
                other = torch.cat([oks[:r], oks[r + 1:]]).any(dim=0)
                n += int((~oks[r] & other).sum())
    return n


def store_lane_delta(r0: dict, r1: dict) -> dict:
    return {k: [b - a for a, b in zip(r0[k], r1[k])]
            for k in ("served", "digest_refused", "repaired")}


def store_plane(sm, smi: str) -> dict:
    """Part (c): a 2 x 2 plane behind the coalescing `NetServer`, warmed
    then filled; STORE_CONNS connections storm it and lane 1 is corrupted
    between the storm's halves; MSG_RREPAIR heals it; three
    `ReplicaGroup`s over its server (fused delegation and the
    device-repair cadence; the host loops with `fused_plane=False` and
    with `PMDFC_MESH2D=off` at connect); then `PMDFC_MESH2D=off` through
    the factory against a plain plane, and an unpaged 2 x 2 plane -> its
    kernel entry."""
    import numpy as np

    from pmdfc_tpu_torch.client.replica import ReplicaGroup
    from pmdfc_tpu_torch.config import MeshConfig, NetConfig, ReplicaConfig
    from pmdfc_tpu_torch.parallel.plane import (PlaneBackend,
                                                make_serving_backend)
    from pmdfc_tpu_torch.parallel.shard import ShardedKV, make_mesh2d
    from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend

    torch, fused = sm.torch, sm.fused
    causes = sm.kv_mod.MISS_CAUSE_NAMES
    ns, nr = 2, 2
    cfg = store_cfg(STORE_PLANE_INDEX, STORE_PLANE_BLOOM_BITS)
    pw = cfg.page_words
    t0 = time.monotonic()
    skv = ShardedKV(cfg, mesh=make_mesh2d(ns, nr, [DEVICE] * (ns * nr)))
    be = PlaneBackend(skv)
    warmed = be.warmup(STORE_VERB)
    s = skv.stats()
    if not warmed or s["gets"] or s["puts"]:
        raise AssertionError(f"store (c): warmup ran {warmed} programs and "
                             f"counted gets {s['gets']}, puts {s['puts']}")
    n = int(skv.capacity() * STORE_PLANE_FILL)
    plane_fill(skv, n, STORE_PLANE_HI, plane=True)
    los = plane_held(skv, STORE_PLANE_HI)
    counts = PlaneCounts(skv)
    srv = NetServer(lambda: be, net=NetConfig()).start()
    conns: list = []
    torch.cuda.synchronize()
    fused.launches.clear()  # (c)'s path from here
    try:
        conns = [StoreConn(srv.port, c, pw, sm.seed, los)
                 for c in range(STORE_CONNS)]
        if {c.be.replica_lanes for c in conns} != {nr}:
            raise AssertionError("store (c): a connection did not negotiate "
                                 f"{nr} replica lanes")
        half = STORE_STEPS // 2
        r0 = skv.replica_report()
        run_threads([c.run(half) for c in conns], "store (c) storm")
        r1 = skv.replica_report()
        skv.corrupt_replica_lane(1)  # mid-soak: the storm resumes after it
        h0 = sum(c.hits for c in conns)
        run_threads([c.run(STORE_STEPS - half) for c in conns],
                    "store (c) storm, lane 1 corrupt")
        r2 = skv.replica_report()
        before, after = store_lane_delta(r0, r1), store_lane_delta(r1, r2)
        served = sum(c.hits for c in conns) - h0
        if any(before["digest_refused"]) or after["served"][1] \
                or after["served"][0] != served \
                or after["digest_refused"][1] != after["served"][0] \
                or not served or after["digest_refused"][0]:
            raise AssertionError(f"store (c): lanes before the fault "
                                 f"{before}, after it {after}, {served} hits")
        st = skv.stats()
        rep = skv.shard_report()["stats"]
        wire = conns[0].be.server_stats()
        if not (st["misses"] == sum(st[c] for c in causes)
                and all(rep["misses"][i] == sum(rep[c][i] for c in causes)
                        for i in range(ns))
                and wire["misses"] == sum(int(wire[c]) for c in causes)
                == st["misses"]):
            raise AssertionError("store (c): misses != the sum of the causes "
                                 "on stats(), a shard row or MSG_STATS")
        stale = store_stale_rows(skv)
        repaired = conns[0].be.replica_repair()
        left = store_stale_rows(skv)
        r3 = skv.replica_report()
        run_threads([lambda c=c: c.get() for c in conns], "store (c) healed")
        healed = store_lane_delta(r3, skv.replica_report())
        skv.corrupt_replica_lane(0)
        r4 = skv.replica_report()
        h1 = sum(c.hits for c in conns)
        run_threads([lambda c=c: c.get() for c in conns],
                    "store (c) lane 0 corrupt")
        rescue = store_lane_delta(r4, skv.replica_report())
        got = sum(c.hits for c in conns) - h1
        if repaired != stale or not stale \
                or left or any(healed["digest_refused"]) \
                or rescue["served"][1] != got or not got \
                or rescue["digest_refused"][0] != got:
            raise AssertionError(
                f"store (c): MSG_RREPAIR repaired {repaired} of {stale} "
                f"stale rows; after it {healed}; lane 0 corrupt: {rescue} for "
                f"{got} hits")
        skv.replica_repair()
        # two groups over this server, each with two endpoints on it: the
        # fused plane takes each put once (the lanes carry the rf) and runs
        # the device repair on its cadence; fused_plane=False keeps the
        # host's rf-way loops
        def group(**kw):
            return ReplicaGroup(
                [TcpBackend("127.0.0.1", srv.port, page_words=pw,
                            keepalive_s=None) for _ in range(2)],
                page_words=pw, cfg=ReplicaConfig(
                    n_replicas=2, rf=2, repair_interval_s=0, **kw))

        g = group(device_repair_ticks=2)
        try:
            gk = fail_keys(STORE_GROUP_HI, np.arange(STORE_VERB))
            p0 = skv.stats()["puts"]
            g.put(gk, pages_np(gk[:, 0], gk[:, 1], pw))
            delegated = dict(g.counters)["fused_delegated"]
            fused_puts = skv.stats()["puts"] - p0
            skv.corrupt_replica_lane(1)
            stale2 = store_stale_rows(skv)
            g.repair_tick()
            first = dict(g.counters)["device_repair_rows"]
            moved = g.repair_tick()
            out, found = g.get(gk)
            fail_check(out, found, gk, pw, "store (c) group GET",
                       expect=np.ones(len(gk), bool))
        finally:
            g.close()
        host = []
        for j, off in enumerate((False, True)):
            # fused_plane=False; then endpoints that connect under
            # PMDFC_MESH2D=off, which never ask for the lanes
            with env_set("PMDFC_MESH2D", "off" if off else "on"):
                g2 = group(fused_plane=off)
            try:
                lanes = {ep.replica_lanes for ep in g2.endpoints}
                gk2 = fail_keys(STORE_GROUP_HI + 1 + j,
                                np.arange(STORE_VERB))
                p0 = skv.stats()["puts"]
                g2.put(gk2, pages_np(gk2[:, 0], gk2[:, 1], pw))
                host.append((dict(g2.counters)["fused_delegated"],
                             skv.stats()["puts"] - p0, lanes))
            finally:
                g2.close()
        if delegated < STORE_VERB or fused_puts != STORE_VERB or first \
                or moved != stale2 or not moved \
                or host != [(0, 2 * STORE_VERB, {nr}),
                            (0, 2 * STORE_VERB, {1})]:
            raise AssertionError(
                f"store (c): the fused group delegated {delegated} of "
                f"{STORE_VERB} keys ({fused_puts} puts landed); device "
                f"repair rows {first} then {moved} of {stale2} stale; the "
                f"host-loop groups (delegated, puts, lanes) {host}")
        torch.cuda.synchronize()
        launches = fused.launches["fused_get_linear_flat"]
        health = dict(srv.stats)
        bad = {k: health[k] for k in ("serve_errors", "nacks_sent",
                                      "bisect_failures", "poison_ops",
                                      "deadline_shed") if int(health[k])}
        if bad or launches != ns * nr * counts.get_phases:
            raise AssertionError(f"store (c): server {bad}; {launches} "
                                 f"fused-GET launches for "
                                 f"{counts.get_phases} GET phases x "
                                 f"{ns * nr}")
        widest = counts.wl_max
    finally:
        srv.stop()
        for c in conns:
            c.be.close()
    t_storm = time.monotonic() - t0
    log("store", f"(c) ShardedKV {ns} shards x {nr} lanes on {skv.mesh}: "
        f"{skv.capacity()} distinct slots; warmup ran {warmed} programs, "
        f"counted nothing; fill {n} pages; {STORE_CONNS} connections x "
        f"{STORE_STEPS} verbs of {STORE_VERB} keys, lane 1 corrupted after "
        f"{half}: no wrong byte, lane 1 refused {after['digest_refused'][1]}"
        f" = lane 0 served {after['served'][0]} after it; misses == sum of "
        f"causes on stats(), every shard row and MSG_STATS; MSG_RREPAIR "
        f"repaired {repaired} rows (every stale one), then lane 1 validated "
        f"and served {rescue['served'][1]} with lane 0 corrupt; a group of "
        f"rf 2 delegated {delegated} keys ({fused_puts} puts landed), its "
        f"device repair fired on tick 2 ({moved} rows); the host-loop "
        f"groups, fused_plane=False and PMDFC_MESH2D=off at connect "
        f"(lanes 1), delegated 0 ({host[0][1]} and {host[1][1]} puts); "
        f"{launches} fused-GET launches = {ns * nr} x {counts.get_phases} "
        f"GET phases; {t_storm:.1f} s ({smi})")
    own0 = skv.node_of(fail_keys(STORE_PLANE_HI, los)) == 0
    t = uncounted(fused, lambda: plane_kernel(
        sm, skv.states[0], los[own0], pw, [widest], "store (c) shard 0",
        smi, hi=STORE_PLANE_HI))[widest]
    del skv, be
    free_card(torch)
    # PMDFC_MESH2D=off: the same factory call, a 1-D plane, the transcript
    # of a plain plane
    t1 = time.monotonic()
    mc = MeshConfig(n_shards=ns, replica_axis=nr)
    with local_devices([sm.dev] * (ns * nr)):
        with env_set("PMDFC_MESH2D", "off"):
            off = make_serving_backend(cfg, mc)
        plain = make_serving_backend(cfg, MeshConfig(n_shards=ns,
                                                     replica_axis=1))
    if off.replica_lanes != 1 or off.skv.n_replicas != 1 \
            or off.skv.mesh.devices.ndim != 1:
        raise AssertionError("store (c): PMDFC_MESH2D=off built a 2-D plane")
    n0 = launched(fused)
    got_off = store_transcript(off, pw, sm.seed)
    got_plain = store_transcript(plain, pw, sm.seed)
    if got_off != got_plain:
        raise AssertionError("store (c): the PMDFC_MESH2D=off transcript "
                             "differs from a plain plane's")
    gets = sum(op[0] == "get" for op in got_off)
    if launched(fused) - n0 != 2 * ns * gets:
        raise AssertionError(f"store (c): {launched(fused) - n0} launches "
                             f"for {2 * gets} GETs over {ns} shards")
    fused.launches.clear()
    del off, plain
    free_card(torch)
    # an unpaged 2 x 2 plane serves values; nothing to digest-compare
    ucfg = store_cfg(STORE_PLANE_INDEX, STORE_PLANE_BLOOM_BITS, paged=False)
    unpaged = PlaneBackend(ShardedKV(ucfg, mesh=make_mesh2d(
        ns, nr, [DEVICE] * (ns * nr))))
    uk = fail_keys(STORE_GROUP_HI + 9, np.arange(STORE_VERB))
    uv = np.stack([uk[:, 0] ^ 7, uk[:, 1] + 1], -1).astype(np.uint32)
    unpaged.put(uk, uv)
    out, found = unpaged.get(uk)
    if not found.all() or not np.array_equal(out, uv) \
            or unpaged.replica_repair() != 0 or launched(fused):
        raise AssertionError(f"store (c): the unpaged 2 x 2 plane served "
                             f"{int(found.sum())} of {len(uk)} values")
    del unpaged
    log("store", f"(c) PMDFC_MESH2D=off: the factory's {ns} x {nr} request "
        f"gave a 1-D plane of {ns} shards; {len(got_off)} verbs of up to "
        f"{STORE_VERB} keys, transcript equal to a plain plane's; an unpaged "
        f"{ns} x {nr} plane served {len(uk)} values, repair 0, no kernel "
        f"launched; {time.monotonic() - t1:.1f} s ({smi})")
    free_card(torch)
    return plane_entry(sm, "store-2x2", launches, t)


class StoreNodes:
    """(d)'s `NetServer`s over `KV`s on the card, spawned and stopped (slots
    append-only), each KV's GETs counted."""

    def __init__(self, cfg, n: int):
        self.cfg, self.kvs, self.servers, self.ports = cfg, [], [], []
        self.counts: list = []
        for _ in range(n):
            self.spawn()

    def spawn(self, i: int | None = None) -> int:
        """A node in a new slot, or cold in slot i (a restore in place)."""
        from pmdfc_tpu_torch.client import DirectBackend
        from pmdfc_tpu_torch.kv import KV
        from pmdfc_tpu_torch.runtime.net import NetServer

        if i is None:
            i = len(self.servers)
            for xs in (self.kvs, self.servers, self.ports):
                xs.append(None)
        kv = KV(self.cfg, device=DEVICE)
        self.counts.append(StoreLaunches(kv))
        srv = NetServer(lambda kv=kv: DirectBackend(kv)).start()
        self.kvs[i], self.servers[i] = kv, srv
        self.ports[i] = self.front(i, srv.port)
        return i

    def front(self, i: int, port: int) -> int:
        """The port that node i's endpoint dials: its server's own."""
        return port

    def stop(self, i: int) -> None:
        if self.servers[i] is not None:
            self.servers[i].stop()
            self.servers[i] = None

    def endpoint(self, i: int):
        from pmdfc_tpu_torch.runtime.failure import ReconnectingClient
        from pmdfc_tpu_torch.runtime.net import TcpBackend

        def factory(i=i):
            return TcpBackend("127.0.0.1", self.ports[i],
                              page_words=self.cfg.page_words,
                              keepalive_s=None, op_timeout_s=10.0)

        return ReconnectingClient(factory, page_words=self.cfg.page_words,
                                  retry_delay_s=0.005,
                                  max_retry_delay_s=0.05, seed=97 + i)

    def close(self) -> None:
        for i in range(len(self.servers)):
            self.stop(i)


def store_replace(sm, smi: str) -> int:
    """Part (d): three card-backed nodes behind a `ReplicaGroup` (rf 2,
    breaker-driven auto-replacement); node 1 killed under STORE_VERB-key
    GETs, its breaker latched, one repair tick replaces it with a spare,
    the migration drains, every acknowledged key served byte-exact -> its
    fused-GET launches."""
    import numpy as np

    from pmdfc_tpu_torch.client.replica import ReplicaGroup
    from pmdfc_tpu_torch.config import ReplicaConfig, RingConfig
    from pmdfc_tpu_torch.runtime.failure import CircuitBreaker

    torch, fused = sm.torch, sm.fused
    cfg = store_cfg(STORE_NODE_INDEX, STORE_NODE_BLOOM_BITS)
    pw = cfg.page_words
    t0 = time.monotonic()
    nodes = StoreNodes(cfg, 3)
    spares: list = []

    def spare_factory(failed_slot):
        i = nodes.spawn()
        spares.append((failed_slot, i))
        return nodes.endpoint(i)

    g = ReplicaGroup([nodes.endpoint(i) for i in range(3)], page_words=pw,
                     cfg=ReplicaConfig(
                         n_replicas=3, rf=2, repair_interval_s=0, hedge_ms=0,
                         breaker_failures=2, breaker_cooldown_s=30.0,
                         breaker_jitter=0.0,
                         auto_replace_after_s=STORE_REPLACE_S,
                         ring=RingConfig(migrate_pages_per_s=0)),
                     spare_factory=spare_factory)
    torch.cuda.synchronize()
    n0 = fused.launches["fused_get_linear_flat"]
    try:
        keys = fail_keys(STORE_NODE_HI, np.arange(STORE_NODE_KEYS))
        pages = pages_np(keys[:, 0], keys[:, 1], pw)
        for i in range(0, len(keys), STORE_VERB):
            g.put(keys[i:i + STORE_VERB], pages[i:i + STORE_VERB])
        g.repair_tick()
        if dict(g.counters)["auto_replacements"]:
            raise AssertionError("store (d): a healthy fleet was replaced")
        nodes.stop(1)
        gets = 0
        while g.breakers[1].state == CircuitBreaker.CLOSED and gets < 16:
            j = gets * STORE_VERB % len(keys)
            out, found = g.get(keys[j:j + STORE_VERB])
            fail_check(out, found, keys[j:j + STORE_VERB], pw,
                       "store (d) GET, node 1 down")
            gets += 1
        latched = g.breakers[1].state != CircuitBreaker.CLOSED \
            and g.breakers[1].down_for() > 0
        time.sleep(STORE_REPLACE_S + 0.05)
        g.repair_tick()
        replaced = dict(g.counters)["auto_replacements"]
        members = g.ring.members
        drained = g.drain_migration(60)
        g.repair_tick()
        if not latched or replaced != 1 or spares != [(1, 3)] \
                or members != (0, 2, 3) or not drained or 1 not in g._dead \
                or dict(g.counters)["auto_replacements"] != 1:
            raise AssertionError(
                f"store (d): breaker latched {latched} after {gets} GETs; "
                f"auto-replacement fired {replaced} times, spares {spares}, "
                f"members {members}, drained {drained}")
        hits = 0
        for i in range(0, len(keys), STORE_VERB):
            out, found = g.get(keys[i:i + STORE_VERB])
            hits += fail_check(out, found, keys[i:i + STORE_VERB], pw,
                               "store (d) after the replacement",
                               expect=np.ones(len(found), bool))
        errors = sum(int(s.stats["serve_errors"]) for s in nodes.servers
                     if s is not None)
        torch.cuda.synchronize()
        launches = fused.launches["fused_get_linear_flat"] - n0
        asked = sum(c.n for c in nodes.counts)
        if errors or launches != asked:
            raise AssertionError(f"store (d): serve_errors {errors}; "
                                 f"{launches} fused-GET launches for {asked} "
                                 "GETs on the nodes")
        mig = dict(g.migrator.scope)
    finally:
        g.close()
        nodes.close()
    log("store", f"(d) {len(nodes.kvs)} nodes of {cfg.index.capacity} slots "
        f"on {DEVICE} behind a ReplicaGroup (rf 2, auto_replace_after_s "
        f"{STORE_REPLACE_S}); {len(keys)} keys put; node 1 killed, its "
        f"breaker latched after {gets} GETs of {STORE_VERB} keys; one repair "
        f"tick replaced it (auto_replacements 1, members {members}); the "
        f"migration moved {mig['moved_pages']} pages; all {hits} keys served "
        f"byte-exact after it; {launches} fused-GET launches = the nodes' "
        f"{asked} GETs (counted in the store entry); "
        f"{time.monotonic() - t0:.1f} s ({smi})")
    del nodes, g
    free_card(torch)
    return launches


def admit_resident(sm, kv, keys) -> int:
    """How many of `keys` hold hot rows of the tiered `kv` now."""
    torch = sm.torch
    with kv._lock, kv._on_device():
        hk = kv.state.pool.hot_keys
        occ = hk[~sm.is_invalid(hk)]
        return int(torch.isin(store_key64(sm, keys),
                              store_key64(sm, occ)).sum())


def admit_gets(sm, kv, keys, label: str) -> tuple:
    """`keys` read in STORE_VERB-key GETs, each reply checked -> (hits,
    misses)."""
    hits = 0
    for i in range(0, len(keys), STORE_VERB):
        ks = keys[i:i + STORE_VERB]
        out, found = kv.get(ks)
        hits += store_check(sm, out, found, ks, label)
    return hits, len(keys) - hits


def admit_run(sm, gated: bool) -> dict:
    """One build of part (e): a linear·tiered `KV` of STORE_TIER_INDEX
    slots (with `tests/test_admit.py`'s fast-aging gate or with none), the
    zipf set put and promoted, the scan put and read twice -> its counts
    (and the `KV` itself)."""
    from pmdfc_tpu_torch.config import AdmitConfig

    torch, fused = sm.torch, sm.fused
    label = f"store (e) {'gated' if gated else 'no gate'}"
    cfg = store_cfg(STORE_TIER_INDEX, STORE_BLOOM_BITS, tier=dict(
        promote_touches=1, max_promotes_per_batch=STORE_VERB,
        admit=AdmitConfig(**STORE_ADMIT) if gated else None))
    kv = sm.kv_mod.KV(cfg, device=DEVICE)
    pw = cfg.page_words
    count = StoreLaunches(kv)
    with kv._lock, kv._on_device():
        h = kv.state.pool.hfree.shape[0]
    zipf = sm.keys_of(STORE_ADMIT_HI, torch.arange(1, h // 2 + 1,
                                                   device=sm.dev))
    scan = sm.keys_of(STORE_ADMIT_HI, torch.arange(
        NEVER_LO - STORE_ADMIT_SCAN * h, NEVER_LO, device=sm.dev))
    torch.cuda.synchronize()
    fused.launches.clear()
    for i in range(0, len(zipf), STORE_GET_B):
        kv.insert(zipf[i:i + STORE_GET_B], sm.pages_of(
            zipf[i:i + STORE_GET_B], pw))
    refused = 0
    if gated:
        # what both packages do: a gate whose epoch (reset_ops 64) is
        # shorter than one GET ages inside every GET, so no zipf key's
        # estimate reaches the threshold and none is promoted
        _, miss = admit_gets(sm, kv, zipf, f"{label} zipf at threshold 2")
        refused = kv.admit_state()["admit_denied"]
        if miss or refused != len(zipf) \
                or kv.tier_stats()["promotions"]:
            raise AssertionError(
                f"{label}: at threshold {STORE_ADMIT['threshold']} the zipf "
                f"GETs were denied {refused} of {len(zipf)} promotions and "
                f"made {kv.tier_stats()['promotions']}; JAX and the port "
                "deny every one at this width")
        kv.set_admit_threshold(0)  # the live knob opens the gate
    for _ in range(3):
        _, miss = admit_gets(sm, kv, zipf, f"{label} zipf")
        if miss:
            raise AssertionError(f"{label}: {miss} zipf keys missed")
    if gated:
        kv.set_admit_threshold(STORE_ADMIT["threshold"])
    before = admit_resident(sm, kv, zipf)
    if before != len(zipf):
        raise AssertionError(f"{label}: {before} of {len(zipf)} zipf keys "
                             "promoted before the scan")
    for i in range(0, len(scan), STORE_GET_B):
        kv.insert(scan[i:i + STORE_GET_B], sm.pages_of(
            scan[i:i + STORE_GET_B], pw))
    misses = 0
    for p in range(2):
        misses += admit_gets(sm, kv, scan, f"{label} scan pass {p}")[1]
    torch.cuda.synchronize()
    launches = fused.launches["fused_get_linear_tiered"]
    s, ts = kv.stats(), kv.tier_stats()
    if launches != count.n:
        raise AssertionError(f"{label}: {launches} fused-GET launches for "
                             f"{count.n} GETs")
    if s["misses"] != sum(s[c] for c in sm.kv_mod.MISS_CAUSE_NAMES):
        raise AssertionError(f"{label}: misses != the sum of the causes")
    if misses > s["evictions"] + s["drops"]:
        raise AssertionError(f"{label}: {misses} scan misses > evictions "
                             f"{s['evictions']} + drops {s['drops']}")
    return dict(kv=kv, hot=h, zipf=len(zipf), scan=len(scan),
                refused=refused, resident=admit_resident(sm, kv, zipf),
                denied=(kv.admit_state() or {}).get("admit_denied", 0)
                - refused,
                gets=count.n, launches=launches, scan_misses=misses, **ts)


def store_admit(sm, smi: str) -> dict:
    """Part (e): `tests/test_admit.py`'s scan-flood drill at the serving
    widths: the gated and the gateless builds, held to the drill's
    invariants -> its kernel entry."""
    torch = sm.torch
    t0 = time.monotonic()
    g = admit_run(sm, gated=True)
    kv = g.pop("kv")
    t = uncounted(sm.fused, lambda: plane_kernel(
        sm, kv.state, store_held(sm, kv, STORE_ADMIT_HI).cpu().numpy(),
        kv.config.page_words, [STORE_VERB], "store (e) gated", smi,
        hi=STORE_ADMIT_HI))[STORE_VERB]
    del kv
    free_card(torch)
    n = admit_run(sm, gated=False)
    del n["kv"]
    free_card(torch)
    floor = g["zipf"] * 3 // 4
    if not (g["denied"] > 0 and g["resident"] >= floor
            and g["admit_ghost_override"] <= g["ghost_readmits"]):
        raise AssertionError(
            f"store (e): the gate denied {g['denied']} scan promotions; the "
            f"zipf set kept {g['resident']} of {g['zipf']} hot rows (floor "
            f"{floor}); ghost override {g['admit_ghost_override']} of "
            f"{g['ghost_readmits']} readmits")
    if not (n["resident"] < g["resident"]
            and n["demotions"] > g["demotions"]):
        raise AssertionError(
            f"store (e): without the gate the zipf set kept {n['resident']} "
            f"hot rows ({g['resident']} gated) after {n['demotions']} "
            f"demotions ({g['demotions']} gated)")
    secs = time.monotonic() - t0
    log("store", f"(e) scan flood on linear·tiered, {g['hot']} hot rows: a "
        f"zipf set of {g['zipf']} keys, a scan of {g['scan']} put and read "
        f"twice in {STORE_VERB}-key GETs; gated (sketch 2^10, door 2^11, "
        f"reset_ops {STORE_ADMIT['reset_ops']}, threshold "
        f"{STORE_ADMIT['threshold']}): the zipf GETs at threshold "
        f"{STORE_ADMIT['threshold']} denied {g['refused']} of {g['zipf']} "
        f"promotions as JAX does, promoted at threshold 0; then the "
        f"scan was denied {g['denied']} promotions, the zipf set kept "
        f"{g['resident']} of {g['zipf']} hot rows, {g['demotions']} demotions, ghost override "
        f"{g['admit_ghost_override']} <= readmits {g['ghost_readmits']}; no "
        f"gate: kept {n['resident']}, {n['demotions']} demotions; scan "
        f"misses {g['scan_misses']} / {n['scan_misses']} (legal), every hit "
        f"byte-exact; {g['launches']} + {n['launches']} fused-GET launches "
        f"= {g['gets']} + {n['gets']} GETs; {secs:.1f} s ({smi})")
    return plane_entry(sm, "store-admit", g["launches"] + n["launches"], t,
                       name="fused_get_linear_tiered")


class ReplicaNodes(StoreNodes):
    """(f)'s nodes: (d)'s `NetServer`s over `KV`s on the card, each behind
    its own `ChaosProxy` (seeded as `tests/test_replica.py`'s `_Cluster`
    seeds them), killed and cold-restored in place: the endpoint dials the
    live proxy's port. Every `KV` ever built keeps its GET count, and a
    killed node's serve errors, cause sums and fired faults are kept. Each
    endpoint keeps the keys of every copy it lost on the wire: a put it
    dropped since its node's last restore (`lost_puts`), a repair read it
    degraded to a miss (`lost_reads`: a GET on the thread that ticks
    repair; the group's own GETs run on its pool)."""

    def __init__(self, cfg, n: int, seed: int):
        import threading

        self.seed, self.rates = seed, {}
        self.proxies: list = []
        self.errors, self.fired, self.unbalanced = 0, 0, []
        self.lost_puts: dict = {}
        self.lost_reads: dict = {}
        self.ticker = threading.get_ident()
        super().__init__(cfg, n)

    def front(self, i: int, port: int) -> int:
        from pmdfc_tpu_torch.runtime.failure import ChaosProxy

        px = ChaosProxy("127.0.0.1", port, seed=self.seed * 97 + i,
                        rates=self.rates, delay_s=0.02, reorder_wait_s=0.05)
        self.proxies += [None] * (i + 1 - len(self.proxies))
        self.proxies[i] = px
        self.lost_puts[i] = set()
        return px.port

    def endpoint(self, i: int):
        import threading

        import numpy as np

        client = super().endpoint(i)
        put, get = client.put, client.get
        reads = self.lost_reads.setdefault(i, set())

        def lost(keys) -> set:
            return set(map(tuple, np.asarray(keys).reshape(-1, 2).tolist()))

        def put_kept(keys, pages):
            n = client.stats()["dropped_puts"]
            put(keys, pages)
            if client.stats()["dropped_puts"] != n:
                self.lost_puts[i] |= lost(keys)

        def get_kept(keys):
            n = client.stats()["missed_gets"]
            out = get(keys)
            if threading.get_ident() == self.ticker \
                    and client.stats()["missed_gets"] != n:
                reads.update(lost(keys))
            return out

        client.put, client.get = put_kept, get_kept
        return client

    def set_rates(self, rates: dict) -> None:
        self.rates = dict(rates)
        for px in self.proxies:
            if px is not None:
                px.rates = dict(rates)

    def settle(self, i: int, causes) -> None:
        """Node i's serve errors, fired faults and cause sum, taken once
        (before it is killed, or at the end)."""
        st = self.kvs[i].stats()
        if st["misses"] != sum(st[c] for c in causes):
            self.unbalanced.append(i)
        self.errors += int(self.servers[i].stats["serve_errors"])
        self.fired += sum(v for k, v in self.proxies[i].stats.items()
                          if k.endswith("_frames")
                          and k != "forwarded_frames")

    def kill(self, i: int, causes) -> None:
        self.settle(i, causes)
        self.proxies[i].close()
        self.stop(i)
        self.proxies[i] = self.kvs[i] = None

    def close(self) -> None:
        for px in self.proxies:
            if px is not None:
                px.close()
        super().close()


def replica_heal(g, i: int, probe, deadline_s: float = 10.0) -> bool:
    """Probe the group until node i's breaker closes, then tick repair
    until its queue drains -> whether both happened in time."""
    from pmdfc_tpu_torch.runtime.failure import CircuitBreaker

    end = time.monotonic() + deadline_s
    while g.breakers[i].state != CircuitBreaker.CLOSED \
            and time.monotonic() < end:
        g.get(probe)
        time.sleep(0.01)
    while time.monotonic() < end:
        g.repair_tick()
        if not g._repair_pending:
            return g.breakers[i].state == CircuitBreaker.CLOSED
        time.sleep(0.01)
    return False


def store_replica(sm, smi: str) -> dict:
    """Part (f): `tests/test_replica.py`'s two `slow` drills that no phase
    ran, on three card-backed nodes of (d)'s size, each behind a
    `ChaosProxy`, and one `ReplicaGroup` (rf 2, repair by ticks): (f1)
    node 0's proxy slowed under a GET of keys it is primary for, (f2) the
    rolling kill and cold restore under chaos on every endpoint -> its
    kernel entry."""
    import numpy as np

    from pmdfc_tpu_torch.client.replica import ReplicaGroup
    from pmdfc_tpu_torch.config import ReplicaConfig

    torch, fused = sm.torch, sm.fused
    causes = sm.kv_mod.MISS_CAUSE_NAMES
    cfg = store_cfg(STORE_NODE_INDEX, STORE_NODE_BLOOM_BITS)
    pw = cfg.page_words
    t0 = time.monotonic()
    nodes = ReplicaNodes(cfg, 3, seed=77)
    g = ReplicaGroup([nodes.endpoint(i) for i in range(3)], page_words=pw,
                     cfg=ReplicaConfig(
                         n_replicas=3, rf=2, hedge_ms=STORE_HEDGE_MS,
                         breaker_failures=4, breaker_cooldown_s=0.05,
                         breaker_max_cooldown_s=0.4, repair_interval_s=0.0,
                         repair_batch=STORE_VERB), seed=77)
    torch.cuda.synchronize()
    n0 = fused.launches["fused_get_linear_flat"]
    keys = fail_keys(STORE_REPLICA_HI, np.arange(STORE_REPLICA_KEYS))
    pages = pages_np(keys[:, 0], keys[:, 1], pw)
    try:
        for i in range(0, len(keys), STORE_VERB):
            g.put(keys[i:i + STORE_VERB], pages[i:i + STORE_VERB])
        # (f1): the keys whose primary is node 0; one armed delay on its
        # proxy holds the GET's request frame (JAX arms 8 frames; the
        # rest would hold (f2)'s first frames)
        sub = keys[np.asarray(g._members(keys))[:, 0] == 0][:STORE_VERB]
        every = np.ones(len(sub), bool)
        if len(sub) < STORE_VERB:
            raise AssertionError(f"store (f1): {len(sub)} keys have node 0 "
                                 "for primary")
        fail_check(*g.get(sub), sub, pw, "store (f1) warm GET",
                   expect=every)
        fired0 = dict(g.counters)["hedges_fired"]
        nodes.proxies[0].delay_next(1, seconds=STORE_HEDGE_DELAY_S)
        t1 = time.monotonic()
        out, found = g.get(sub)
        hedge_s = time.monotonic() - t1
        hedges = dict(g.counters)["hedges_fired"] - fired0
        fail_check(out, found, sub, pw, "store (f1) hedged GET",
                   expect=every)
        if hedges < 1 or hedge_s >= STORE_HEDGE_DELAY_S:
            raise AssertionError(
                f"store (f1): the GET of {len(sub)} keys behind node 0's "
                f"slowed proxy fired {hedges} hedges and took {hedge_s:.3f} "
                f"s (the armed delay {STORE_HEDGE_DELAY_S} s)")
        f1_s = time.monotonic() - t0
        # (f2): the soak's rates on every proxy, its schedule scaled
        t2 = time.monotonic()
        nodes.set_rates(STORE_SOAK_RATES)
        sched = {round(s * STORE_SOAK_STEPS / 520): (act, i)
                 for s, act, i in STORE_SOAK_SCHEDULE}
        rng = np.random.default_rng(77)
        gets = hits = 0
        rejoined = []
        for step in range(STORE_SOAK_STEPS):
            act = sched.get(step)
            if act is not None and act[0] == "kill":
                nodes.kill(act[1], causes)
            elif act is not None:
                nodes.spawn(act[1])
                rejoined.append(act[1])
            g.repair_tick()
            op = rng.integers(4)
            lo = int(rng.integers(0, len(keys) - STORE_VERB))
            sel = slice(lo, lo + STORE_VERB)
            if op == 0:
                g.put(keys[sel], pages[sel])
            else:
                out, found = g.get(keys[sel])
                gets += 1
                hits += fail_check(out, found, keys[sel], pw,
                                   f"store (f2) GET at step {step}")
        soak_s = time.monotonic() - t2
        # the faults stop; each rejoined node probed back in and its repair
        # drained
        nodes.set_rates({})
        healed = all(replica_heal(g, i, keys[:8]) for i in rejoined)
        repaired = dict(g.counters)["repair_pages"]
        for i in range(0, len(keys), STORE_VERB):
            fail_check(*g.get(keys[i:i + STORE_VERB]), keys[i:i + STORE_VERB],
                       pw, "store (f2) after the repair")
        # a rejoined node holds every key the ring gives it that the key's
        # other member holds, but for a copy the wire lost after its
        # restore (a put dropped on it, a repair read degraded to a miss):
        # the group sends no such copy again while the node's breaker stays
        # closed (ROADMAP Queue 3 item 9), so those are counted, and any
        # other lack fails
        members = np.asarray(g._members(keys))
        present = np.zeros((3, len(keys)), bool)
        for n in range(3):
            for j in range(0, len(keys), STORE_VERB):
                sel = slice(j, j + STORE_VERB)
                out, found = nodes.kvs[n].get(keys[sel])
                fail_check(out, found, keys[sel], pw,
                           f"store (f2) node {n} after the repair")
                present[n, sel] = found
        held, gap, unexplained = {}, {}, {}
        for i in rejoined:
            mine = (members == i).any(axis=1)
            other = np.where(members[:, 0] == i, members[:, 1], members[:, 0])
            own = mine & present[other, np.arange(len(keys))]
            lack = set(map(tuple, keys[own & ~present[i]].tolist()))
            reads = set().union(*(nodes.lost_reads[s] for s in range(3)
                                  if s != i))
            held[i] = (int((own & present[i]).sum()), int(own.sum()))
            gap[i] = (len(lack & nodes.lost_puts[i]),
                      len((lack & reads) - nodes.lost_puts[i]))
            unexplained[i] = len(lack - nodes.lost_puts[i] - reads)
        for i in range(3):
            nodes.settle(i, causes)
        torch.cuda.synchronize()
        launches = fused.launches["fused_get_linear_flat"] - n0
        asked = sum(c.n for c in nodes.counts)
        if not (hits and nodes.fired and healed and repaired
                and not any(unexplained.values()) and not nodes.errors
                and not nodes.unbalanced and launches == asked):
            raise AssertionError(
                f"store (f2): {hits} hits in {gets} GETs; {nodes.fired} "
                f"faults fired; healed {healed}, repair_pages {repaired}; "
                f"rejoined nodes holding (held, owed) {held}, lacking "
                f"(put lost, repair read lost) {gap} and {unexplained} "
                f"keys whose every copy reached the wire; serve_errors "
                f"{nodes.errors}; misses != the causes on "
                f"{nodes.unbalanced}; {launches} fused-GET launches for "
                f"{asked} GETs on the nodes")
        kv = nodes.kvs[1]
        t = uncounted(fused, lambda: plane_kernel(
            sm, kv.state, store_held(sm, kv, STORE_REPLICA_HI).cpu().numpy(),
            pw, [STORE_VERB], "store (f) node 1", smi,
            hi=STORE_REPLICA_HI))[STORE_VERB]
        counters = dict(g.counters)
    finally:
        g.close()
        nodes.close()
    log("store", f"(f1) slow primary: 3 nodes of {cfg.index.capacity} slots "
        f"on {DEVICE}, each behind a ChaosProxy, one ReplicaGroup (rf 2, "
        f"hedge_ms {STORE_HEDGE_MS}); {len(keys)} keys put; a GET of the "
        f"{len(sub)} keys node 0 is primary for, its proxy holding the "
        f"request {STORE_HEDGE_DELAY_S} s: {hedges} hedges fired, every key "
        f"served byte-exact in {hedge_s * 1e3:.1f} ms; {f1_s:.1f} s ({smi})")
    log("store", f"(f2) chaos soak: rates {STORE_SOAK_RATES} on every "
        f"proxy, {STORE_SOAK_STEPS} steps of {STORE_VERB}-key verbs, node 2 "
        f"killed and cold-restored, then node 0 (steps "
        f"{sorted(sched)}); {hits} hits in {gets} GETs, no wrong byte, every "
        f"miss zeroed; {nodes.fired} faults fired; {counters['hedges_fired']} "
        f"hedges, {counters['failover_gets']} failover GETs; repair_pages "
        f"{repaired} once the rejoined nodes were probed back in; rejoined "
        f"nodes hold (held, owed) {held} of the keys the ring gives them "
        f"that the other member holds, each lack a copy lost on the wire "
        f"after the restore and never sent again (put lost, repair read "
        f"lost) {gap} (ROADMAP Queue 3 item 9); misses == sum of the causes "
        f"on every node; "
        f"serve_errors 0; {launches} fused-GET launches = the nodes' "
        f"{asked} GETs; soak {soak_s:.1f} s ({smi})")
    log("store", f"(f) took {time.monotonic() - t0:.1f} s")
    del nodes, g, kv
    free_card(torch)
    return plane_entry(sm, "store-replica", launches, t)


def run_store(sm):
    """Phase 18: the store's own suites' card-only drills: (a) `KV` edges
    on linear·flat, (b) a tiered snapshot restored, (c) a 2 x 2 plane's
    lane corrupted mid-soak, (d) breaker-driven auto-replacement, (e) the
    admission gate's scan flood, (f) the slow-primary hedge and the
    multi-endpoint chaos soak -> its kernel entries."""
    import shutil

    torch = sm.torch
    t_phase = time.monotonic()
    free_card(torch)
    smi = nvidia_smi()
    root = store_dir()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    times = {}
    try:
        t0 = time.monotonic()
        a = store_edges(sm, smi)
        times["a"] = time.monotonic() - t0
        t0 = time.monotonic()
        b = store_tiered(sm, str(root), smi)
        times["b"] = time.monotonic() - t0
        t0 = time.monotonic()
        c = store_plane(sm, smi)
        times["c"] = time.monotonic() - t0
        t0 = time.monotonic()
        d = store_replace(sm, smi)
        times["d"] = time.monotonic() - t0
        a["launches"] += d
        t0 = time.monotonic()
        e_ = store_admit(sm, smi)
        times["e"] = time.monotonic() - t0
        t0 = time.monotonic()
        f = store_replica(sm, smi)
        times["f"] = time.monotonic() - t0
    finally:
        free_card(torch)
        shutil.rmtree(root, ignore_errors=True)
    for e in (a, b, c, e_, f):
        log("store", f"{e['name']} ({e['path']}): kernel == plain, "
            f"{e['ms']:.4f} ms vs bound {e['bound_ms']:.4f} ms "
            f"({e['bound_ms'] / e['ms']:.0%}), plain {e['plain_ms']:.4f} ms; "
            f"{e['launches']} launches on the phase's path ({smi})")
    log("store", "gates: no wrong byte, every miss zeroed, misses == sum of "
        "the causes, serve_errors 0, one fused-GET launch per GET (per "
        "shard and lane on the plane); no engine on this path, so no -2 "
        "status can arise")
    log("store", f"phase 18 took {time.monotonic() - t_phase:.1f} s: (a) "
        f"{times['a']:.1f} s, (b) {times['b']:.1f} s, (c) {times['c']:.1f} "
        f"s, (d) {times['d']:.1f} s, (e) {times['e']:.1f} s, (f) "
        f"{times['f']:.1f} s")
    return [a, b, c, e_, f]


def store_subprocess(seed: int):
    """`run_store` in a child process of this script (`--store`) -> (its
    kernel entries, its log lines, seconds). A child that fails fails the
    phase."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--store", "--seed",
         str(seed)], capture_output=True, text=True,
        timeout=STORE_TIMEOUT_S)
    entries, lines = None, []
    for line in proc.stdout.splitlines():
        if line.startswith("STORE "):
            entries = json.loads(line[len("STORE "):])
        else:
            lines.append(line)
    if proc.returncode != 0 or entries is None:
        raise AssertionError(f"store child exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    return entries, lines, time.monotonic() - t0


def collect_store(lanes: "Lanes"):
    """Phase 18's child, queued last in `lanes` at phase 12's start: its
    lines echoed, its kernel entries returned."""
    t0 = time.monotonic()
    (entries, lines, secs), = lanes.rows("store")
    for line in lines:
        print(line, flush=True)
    log("store", f"phase 18's child took {secs:.1f} s (in the lanes, "
        f"{lanes.span('store')}; waited {time.monotonic() - t0:.1f} s for "
        "it here)")
    return entries


# ---------------------------------------------------------------------------
# phase 19, sanitize: the serving path under the runtime lock sanitizer
# ---------------------------------------------------------------------------

SAN_INDEX = dict(capacity=1 << 18)  # (a), (b): a 1 GiB pool of 4 KiB pages
SAN_TIER = dict()          # (a): TierConfig()'s defaults
SAN_BLOOM_BITS = 1 << 21
SAN_PAGE_WORDS = 1024
SAN_FILL = 0.75            # of the slots, through KV.insert
SAN_VERB = 1 << 11         # pages (keys) of the widest verb
SAN_WORKERS = 4            # (a): ReconnectingClients through the proxy
SAN_OWN = 1 << 15          # (a): keys a worker cycles its puts over
SAN_SOAK_S = 15.0          # (a): the soak's length
SAN_NET = dict(flush_ops=64, flush_timeout_us=500, settle_us=100)  # JAX's
SAN_RATES = {"flip": 0.01, "duplicate": 0.005, "delay": 0.01}
SAN_DELAY_S = 0.002
SAN_OP_TIMEOUT_S = 2.0     # the JAX drill's client timeout
SAN_WINDOWS = (32, 4, 64)  # (a): the fifth connection's live window
SAN_HOLD_MS = 200.0        # JAX's long-hold limit
SAN_BALLOON_EXTENTS = 3    # (a): balloon_max_extents
SAN_ENGINE_CLIENTS = 8     # (b): ReconnectingClients over EngineBackend
SAN_ENGINE_S = 10.0        # (b): the stream's length
SAN_ENGINE_OWN = 1 << 13   # (b): keys a client cycles its puts over
SAN_TRACE_VERBS = 300      # (c)
SAN_TRACE_KEYS = 1 << 14   # (c): the traced key set
SAN_TRACE_WINDOW = 8
SAN_TRACE_RATES = {"flip": 0.01, "truncate": 0.005, "duplicate": 0.01}
SAN_TRACE_SEED = 17        # test_telemetry's seed
SAN_TRACE_OP_TIMEOUT_S = 1.0
SAN_RING = 1 << 17         # the flight ring holds (c)'s spans
SAN_HI = 0xCB000000        # (a): the fill's keys are (SAN_HI, i)
SAN_PUT_HI = 0xCB100000    # (a): worker t puts (SAN_PUT_HI + t, i)
SAN_TRACE_HI = 0xCB200000  # (c)
SAN_ENG_HI = 0xCB300000    # (b): the fill's keys are (SAN_ENG_HI, i)
SAN_ENG_PUT_HI = 0xCB400000  # (b): client t puts (SAN_ENG_PUT_HI + t, i)
# long holds that JAX's twin shows JAX makes too, on the same lock across
# the same call (ROADMAP Queue 3): printed, not failed. None is known.
SAN_SHARED_HOLDS: dict = {}
SAN_TIMEOUT_S = 600.0      # the phase's child process, spawn to exit


def san_fill(sm, kv, hi: int) -> tuple:
    """Fill SAN_FILL of `kv`'s slots with keys (hi, i) through `KV.insert`
    in INS_B batches -> (pages put, seconds, the lo words held)."""
    import numpy as np

    torch = sm.torch
    n = int(kv.capacity() * SAN_FILL)
    t0 = time.monotonic()
    for i in range(0, n, INS_B):
        lo = torch.arange(i, min(i + INS_B, n), device=sm.dev)
        keys = sm.keys_of(hi, lo)
        kv.insert(keys, sm.pages_of(keys, kv.config.page_words))
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    with kv._lock, kv._on_device():
        flat, _ = kv._ops.scan(kv.state.index)
        held = flat[flat[:, 0] == sm.u32.narrow(torch.tensor(hi))]
        present = np.sort(sm.u32.to_numpy(held[:, 1])).astype(np.uint32)
    return n, secs, present


def san_violations(san, label: str) -> list:
    """The sanitizer's reports so far, each printed; the long holds JAX
    shares (SAN_SHARED_HOLDS) set apart -> the reports that fail."""
    bad = []
    for v in san.violations():
        shared = v.get("kind") == "long_hold" \
            and v.get("lock") in SAN_SHARED_HOLDS
        log("sanitize", f"{label}: violation {v}"
            + (f" (shared with JAX: {SAN_SHARED_HOLDS[v['lock']]})"
               if shared else ""))
        if not shared:
            bad.append(v)
    return bad


class SanWorker:
    """Phase 19 (a)'s client: a `ReconnectingClient` over `TcpBackend`
    through the chaos proxy, alternately putting 1..SAN_VERB of its own
    keys and GETting 1..SAN_VERB keys, half its own and half the fill's,
    every reply checked (hits byte-exact, misses zeroed)."""

    def __init__(self, port: int, t: int, pw: int, present, seed: int):
        import numpy as np

        from pmdfc_tpu_torch.runtime.failure import ReconnectingClient
        from pmdfc_tpu_torch.runtime.net import TcpBackend

        self.t, self.pw, self.present = t, pw, present
        self.rc = ReconnectingClient(
            lambda: TcpBackend("127.0.0.1", port, page_words=pw,
                               op_timeout_s=SAN_OP_TIMEOUT_S,
                               keepalive_s=None),
            page_words=pw, retry_delay_s=0.01, seed=t)
        self.rng = np.random.default_rng([seed, t, 19])
        self.next = 0
        self.puts = self.gets = self.hits = 0

    def run(self, stop) -> None:
        import numpy as np

        rng, pw, t = self.rng, self.pw, self.t
        while not stop.is_set():
            n = int(rng.integers(1, SAN_VERB + 1))
            lo = (self.next + np.arange(n)) % SAN_OWN
            self.next = (self.next + n) % SAN_OWN
            own = fail_keys(SAN_PUT_HI + t, lo)
            self.rc.put(own, pages_np(own[:, 0], own[:, 1], pw))
            self.puts += 1
            k = int(rng.integers(1, SAN_VERB + 1))
            keys = np.concatenate([
                own[:k // 2], fail_keys(SAN_HI, self.present[
                    rng.integers(0, len(self.present), k - min(k // 2, n))])])
            out, found = self.rc.get(keys)
            self.hits += fail_check(out, found, keys, pw,
                                    f"sanitize (a) worker {t}")
            self.gets += 1


def san_window(port: int, pw: int, present, stop, seed: int) -> dict:
    """Phase 19 (a)'s fifth connection: a pipelined `TcpBackend` straight
    to the server whose window is set live, 32 -> 4 -> 64, while the
    workers serve; GET verbs of the fill's keys at each width, checked."""
    import numpy as np

    from pmdfc_tpu_torch.runtime.net import TcpBackend

    rng = np.random.default_rng([seed, 5, 19])
    be = TcpBackend("127.0.0.1", port, page_words=pw, op_timeout_s=120.0,
                    keepalive_s=None, pipeline=True, window=SAN_WINDOWS[0])
    out = {"limits": [], "gets": 0, "hits": 0}
    try:
        for i, w in enumerate(SAN_WINDOWS):
            got = be.set_window(w)
            if got != w or be._window_sem.limit != w:
                raise AssertionError(
                    f"sanitize (a): set_window({w}) -> {got}, the gate's "
                    f"limit {be._window_sem.limit}")
            out["limits"].append(be._window_sem.limit)
            t_end = time.monotonic() + SAN_SOAK_S / (len(SAN_WINDOWS) + 1)
            while time.monotonic() < t_end and not stop.is_set():
                keys = fail_keys(SAN_HI, present[rng.integers(
                    0, len(present), int(rng.integers(1, SAN_VERB + 1)))])
                pages, found = be.get(keys)
                out["hits"] += fail_check(pages, found, keys, pw,
                                          f"sanitize (a) window {w}")
                out["gets"] += 1
        out["doc"] = be.server_stats()
    finally:
        be.close()
    return out


def san_balloon_spy(kv, moves: list) -> None:
    """Record each balloon call the controller makes on `kv`: (verb, rows
    asked, circulating rows before and after)."""
    for name in ("balloon_grow", "balloon_shrink"):
        real = getattr(kv, name)

        def spy(rows, _real=real, _name=name):
            c0 = kv.balloon_state()["circulating"]
            r = _real(rows)
            moves.append((_name, int(rows), c0,
                          kv.balloon_state()["circulating"]))
            return r

        setattr(kv, name, spy)


def san_soak(sm, root: str, smi: str) -> dict:
    """Phase 19 (a) then (c): JAX's acceptance soak on the card, a
    linear·tiered `KV` behind a coalescing `NetServer` and a `ChaosProxy`
    with the controller attached and bound to the KV's balloon, then the
    traced chaos soak against the same server -> its kernels entry."""
    import json
    import threading

    from pmdfc_tpu_torch.client import DirectBackend
    from pmdfc_tpu_torch.config import (AutotuneConfig, BloomConfig,
                                        IndexConfig, KVConfig, NetConfig,
                                        TierConfig)
    from pmdfc_tpu_torch.runtime import autotune
    from pmdfc_tpu_torch.runtime import sanitizer as san
    from pmdfc_tpu_torch.runtime.failure import ChaosProxy
    from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend
    from pmdfc_tpu_torch.tools import check_teledump as checker

    fused = sm.fused
    cfg = KVConfig(index=IndexConfig(**SAN_INDEX),
                   bloom=BloomConfig(num_bits=SAN_BLOOM_BITS),
                   page_words=SAN_PAGE_WORDS, tier=TierConfig(**SAN_TIER))
    kv = sm.kv_mod.KV(cfg, device=DEVICE)
    pw = cfg.page_words
    n, t_fill, present = san_fill(sm, kv, SAN_HI)
    log("sanitize", f"(a) linear·tiered KV on {kv.device}: {kv.capacity()} "
        f"slots, pools {kv.state.pool.pages.numel() * 4 / 2**30:.2f} GiB of "
        f"{pw}-word pages; {n} pages through KV.insert in {t_fill:.3f} s, "
        f"{len(present)} held ({smi})")
    moves: list = []
    san_balloon_spy(kv, moves)
    step = kv.balloon_state()["step"]
    backend = DirectBackend(kv)
    phases: list = []  # the width of every GET phase
    widest: dict = {}
    real_get = backend.get

    def get(keys):
        phases.append(len(keys))
        if len(keys) >= len(widest.get("keys", ())):
            widest["keys"] = keys.copy()
        return real_get(keys)

    backend.get = get
    srv = NetServer(lambda: backend, net=NetConfig(**SAN_NET)).start()
    ctl = None
    workers: list = []
    try:
        with TcpBackend("127.0.0.1", srv.port, page_words=pw,
                        keepalive_s=None, op_timeout_s=120.0) as w:
            keys = fail_keys(SAN_HI, present[:SAN_VERB])
            out, found = w.get(keys)  # the kernel's first launch
            fail_check(out, found, keys, pw, "sanitize (a) warm")
        del phases[:]
        fused.launches.clear()
        s0 = kv.stats()
        proxy = ChaosProxy("127.0.0.1", srv.port, seed=7, rates=SAN_RATES,
                           delay_s=SAN_DELAY_S)
        workers = [SanWorker(proxy.port, t, pw, present, sm.seed)
                   for t in range(SAN_WORKERS)]
        ctl = autotune.attach(
            server=srv, client=workers[0].rc,
            cfg=AutotuneConfig(interval_s=0.1, hysteresis_windows=1,
                               balloon_every=1,
                               balloon_max_extents=SAN_BALLOON_EXTENTS),
            start=True)
        ctl.bind_balloon(kv)
        stop = threading.Event()
        win: dict = {}
        t0 = time.monotonic()

        def soak_clock():
            try:
                win.update(san_window(srv.port, pw, present, stop,
                                      sm.seed))
                time.sleep(max(0.0, SAN_SOAK_S - (time.monotonic() - t0)))
            finally:
                stop.set()

        with proxy:
            t_soak = run_threads(
                [lambda w=w: w.run(stop) for w in workers] + [soak_clock],
                "sanitize (a)")
            fired = sum(v for k, v in proxy.stats.items()
                        if k.endswith("_frames")
                        and k != "forwarded_frames")
        ctl.stop()
        doc = win["doc"]
        for w in workers:
            w.rc.close()
        # gates of (a)
        fails = []
        bad = san_violations(san, "sanitize (a)")
        if bad:
            fails.append(f"{len(bad)} sanitizer violations")
        errs = checker.check_autotune(doc["telemetry"])
        if errs:
            fails.append(f"check_autotune: {errs}")
        path = os.path.join(root, "msg_stats.json")
        with open(path, "w") as f:
            json.dump(doc, f)
        if checker.main([path]) != 0:
            fails.append("the port's check_teledump refused MSG_STATS")
        odd = [m for m in moves if m[1] != step or abs(m[3] - m[2]) > m[1]]
        if odd:
            fails.append(f"balloon moves of other than one {step}-row "
                         f"extent: {odd[:4]}")
        knobs = ctl.knob_values()
        bx = knobs.get("balloon_x", 0)
        if abs(bx) > SAN_BALLOON_EXTENTS:
            fails.append(f"balloon offset {bx} outside +-"
                         f"{SAN_BALLOON_EXTENTS} extents")
        if fails:
            raise AssertionError("sanitize (a): " + "; ".join(fails))
        puts = sum(w.puts for w in workers)
        gets = sum(w.gets for w in workers)
        hits = sum(w.hits for w in workers)
        log("sanitize", f"(a) soak {t_soak:.1f} s: {SAN_WORKERS} "
            f"ReconnectingClients through ChaosProxy {SAN_RATES} (delay "
            f"{SAN_DELAY_S * 1e3:.0f} ms, {fired} frames faulted), "
            f"NetConfig({SAN_NET}): {puts} put and {gets} GET verbs of 1.."
            f"{SAN_VERB} pages, {hits} hits byte-exact, every miss zeroed; "
            f"window 32 -> 4 -> 64 live ({win['gets']} verbs, limits "
            f"{win['limits']}); PMDFC_SAN=on at {san._STATE.hold_ms:.0f} ms: "
            f"violations [] ({smi})")
        log("sanitize", f"(a) controller: {int(ctl.stats['decisions'])} "
            f"decisions, knobs {knobs}; {len(moves)} balloon moves of one "
            f"{step}-row extent each, offset {bx} within +-"
            f"{SAN_BALLOON_EXTENTS}; check_autotune over MSG_STATS [] and "
            f"the port's check_teledump passes it")
        c = san_traced(srv, pw, smi)
        if san_violations(san, "sanitize (c)"):
            raise AssertionError("sanitize (c): sanitizer violations")
        s = kv.stats()
        st = dict(srv.stats)
        n_phases = len(phases)
        launches = fused.launches["fused_get_linear_tiered"]
        fails = []
        if s["misses"] != sum(s[k] for k in sm.kv_mod.MISS_CAUSE_NAMES):
            fails.append("misses != the sum of the miss causes")
        if int(st["serve_errors"]):
            fails.append(f"serve_errors {st['serve_errors']}")
        if launches != n_phases or not launches:
            fails.append(f"{launches} kernel launches for {n_phases} GET "
                         "phases")
        if fails:
            raise AssertionError("sanitize (a): " + "; ".join(fails))
        log("sanitize", f"(a) and (c) on the KV: gets {s['gets'] - s0['gets']}"
            f", misses == sum of the causes ({s['misses']}), serve_errors 0; "
            f"{launches} fused-GET launches = {n_phases} GET phases")
        w_, t = ops_kernel(sm, kv.state, widest["keys"],
                           "sanitize (a) widest", smi)
        log("sanitize", f"fused_get_linear_tiered w = {w_} at (a)'s widest "
            f"GET phase: kernel == plain, {t[0]:.4f} ms vs bound "
            f"{t[2]:.4f} ms ({t[2] / t[0]:.0%}), plain {t[1]:.4f} ms ({smi})")
        entry = plane_entry(sm, "sanitize-tiered", launches, t,
                            name="fused_get_linear_tiered")
        return {"entry": entry, "trace": c}
    finally:
        if ctl is not None:
            ctl.stop()
        for w in workers:
            w.rc.close()
        srv.stop()


def san_traced(srv, pw: int, smi: str) -> dict:
    """Phase 19 (c): `tests/test_telemetry.py`'s traced chaos soak against
    (a)'s server: one pipelined `ReconnectingClient` (window 8) through a
    `ChaosProxy` at seed 17, SAN_TRACE_VERBS verbs of 1..SAN_VERB keys over
    a SAN_TRACE_KEYS-key set; every completed verb's trace joins a server
    span, every failed span is closed with its error and a span id, every
    hit byte-exact."""
    import numpy as np

    from pmdfc_tpu_torch.runtime import telemetry as tele
    from pmdfc_tpu_torch.runtime.failure import ChaosProxy, ReconnectingClient
    from pmdfc_tpu_torch.runtime.net import TcpBackend

    keys = fail_keys(SAN_TRACE_HI, np.arange(SAN_TRACE_KEYS))
    pages = pages_np(keys[:, 0], keys[:, 1], pw)
    rng = np.random.default_rng(SAN_TRACE_SEED)
    reg = tele.get()
    t_start = time.monotonic_ns()
    t0 = time.monotonic()
    hits = 0
    with ChaosProxy("127.0.0.1", srv.port, seed=SAN_TRACE_SEED,
                    rates=SAN_TRACE_RATES) as px:
        def factory():
            return TcpBackend("127.0.0.1", px.port, page_words=pw,
                              keepalive_s=None,
                              op_timeout_s=SAN_TRACE_OP_TIMEOUT_S,
                              pipeline=True, window=SAN_TRACE_WINDOW)

        rc = ReconnectingClient(factory, page_words=pw, retry_delay_s=0.002,
                                max_retry_delay_s=0.02, seed=SAN_TRACE_SEED)
        try:
            for _ in range(SAN_TRACE_VERBS):
                n = int(rng.integers(1, SAN_VERB + 1))
                lo = int(rng.integers(0, SAN_TRACE_KEYS - n + 1))
                if rng.integers(2):
                    rc.put(keys[lo:lo + n], pages[lo:lo + n])
                else:
                    out, found = rc.get(keys[lo:lo + n])
                    hits += fail_check(out, found, keys[lo:lo + n], pw,
                                       "sanitize (c)")
                if not rc.connected:
                    time.sleep(0.003)
        finally:
            rc.close()
        fired = sum(v for k, v in px.stats.items()
                    if k.endswith("_frames") and k != "forwarded_frames")
    secs = time.monotonic() - t0
    spans = [r for r in reg.ring_tail() if r.get("kind") == "span"]
    server = {s["trace"] for s in spans if s["src"] == "server"}
    verbs = [s for s in spans if s["src"] == "client"
             and s["op"] in ("put", "get", "invalidate")
             and s.get("t0_ns", 0) >= t_start]
    done = [s for s in verbs if s["ok"]]
    failed = [s for s in verbs if not s["ok"]]
    missing = [s for s in done if s["trace"] not in server]
    open_ = [s for s in failed if not s.get("err")
             or not 0 < s.get("span", 0) <= 0xFFFFFFFF
             or s["t1_ns"] < s["t0_ns"] or s["dur_us"] < 0]
    fails = []
    if len(done) <= 50:
        fails.append(f"only {len(done)} verbs completed")
    if not fired or not failed:
        fails.append(f"{fired} faults fired, {len(failed)} failed spans")
    if missing:
        fails.append(f"{len(missing)} of {len(done)} completed verbs have "
                     "no server span")
    if open_:
        fails.append(f"{len(open_)} failed spans not closed with an error "
                     "and a span id")
    if fails:
        raise AssertionError("sanitize (c): " + "; ".join(fails))
    log("sanitize", f"(c) traced soak {secs:.1f} s: {SAN_TRACE_VERBS} verbs of "
        f"1..{SAN_VERB} keys over {SAN_TRACE_KEYS} keys through ChaosProxy "
        f"{SAN_TRACE_RATES} seed {SAN_TRACE_SEED}, window "
        f"{SAN_TRACE_WINDOW}: {fired} frames faulted, {len(done)} verbs "
        f"completed, each joined to a server span; {len(failed)} failed "
        f"spans closed with their errors; {hits} hits byte-exact ({smi})")
    return {"secs": secs, "completed": len(done), "failed": len(failed)}


def san_engine(sm, smi: str) -> dict:
    """Phase 19 (b): the engine-backed `KVServer` under the sanitizer, a
    linear·flat `KV` of SAN_INDEX slots, eight `ReconnectingClient`s over
    `EngineBackend` slices streaming puts and GETs of SAN_VERB pages for
    SAN_ENGINE_S with the bloom push on -> its kernels entry."""
    import threading

    import numpy as np

    from pmdfc_tpu_torch.client import EngineBackend
    from pmdfc_tpu_torch.client.cleancache import CleanCacheClient
    from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, KVConfig
    from pmdfc_tpu_torch.runtime import Engine, KVServer
    from pmdfc_tpu_torch.runtime import sanitizer as san
    from pmdfc_tpu_torch.runtime.failure import ReconnectingClient

    torch, fused = sm.torch, sm.fused
    cfg = KVConfig(index=IndexConfig(**SAN_INDEX),
                   bloom=BloomConfig(num_bits=SAN_BLOOM_BITS),
                   page_words=SAN_PAGE_WORDS)
    kv = sm.kv_mod.KV(cfg, device=DEVICE)
    pw, v, nc = cfg.page_words, SAN_VERB, SAN_ENGINE_CLIENTS
    n, t_fill, present = san_fill(sm, kv, SAN_ENG_HI)
    eng = Engine(num_queues=nc + 1, queue_cap=2 * v, batch=nc * v,
                 timeout_us=200, arena_pages=4 * (nc + 1) * v,
                 page_bytes=pw * 4)
    srv = KVServer(cfg, engine=eng, kv=kv, device=DEVICE,
                   bf_push_s=BF_PUSH_S)
    minus_two = []
    real_wait = eng.wait_many

    def wait_many(base, n_, timeout_us=10_000_000):
        st = real_wait(base, n_, timeout_us=timeout_us)
        if (st == -2).any():
            minus_two.append(int((st == -2).sum()))
        return st

    eng.wait_many = wait_many
    srv.warmup(v)  # the kernel's first launch, on this thread
    srv.start()
    widest: dict = {}
    real_get = fused.fused_get

    def fused_get(keys, *a, **kw):
        if keys.shape[0] >= widest.get("w", 0):
            widest["w"], widest["keys"] = keys.shape[0], keys.clone()
        return real_get(keys, *a, **kw)

    cc = CleanCacheClient(EngineBackend(srv, queue=nc, slice_pages=v))
    srv.register_bf_client(cc)
    clients = []
    for t in range(nc):
        def factory(t=t):
            return EngineBackend(srv, queue=t, slice_pages=v,
                                 timeout_us=FAIL_CLIENT_TIMEOUT_US)

        clients.append(ReconnectingClient(factory, page_words=pw,
                                          retry_delay_s=0.005,
                                          max_retry_delay_s=0.05, seed=t))
    counts = [[0, 0, 0] for _ in range(nc)]  # puts, gets, hits
    stop = threading.Event()

    def stream(t):
        rng = np.random.default_rng([sm.seed, t, 23])
        rc, i = clients[t], 0
        while not stop.is_set():
            own = fail_keys(SAN_ENG_PUT_HI + t,
                            (i * v + np.arange(v)) % SAN_ENGINE_OWN)
            rc.put(own, pages_np(own[:, 0], own[:, 1], pw))
            counts[t][0] += 1
            keys = np.concatenate([own[:v // 2], fail_keys(
                SAN_ENG_HI, present[rng.integers(0, len(present), v // 2)])])
            out, found = rc.get(keys)
            counts[t][2] += fail_check(out, found, keys, pw,
                                       f"sanitize (b) client {t}")
            counts[t][1] += 1
            i += 1

    def clock():
        time.sleep(SAN_ENGINE_S)
        stop.set()

    try:
        fused.launches.clear()
        g0 = srv.op_batches["get"]
        fused.fused_get = fused_get
        try:
            secs = run_threads([lambda t=t: stream(t) for t in range(nc)]
                               + [clock], "sanitize (b)")
        finally:
            fused.fused_get = real_get
        torch.cuda.synchronize()
        flushes = srv.op_batches["get"] - g0
        launches = fused.launches["fused_get_linear_flat"]
        s = kv.stats()
        fails = []
        bad = san_violations(san, "sanitize (b)")
        if bad:
            fails.append(f"{len(bad)} sanitizer violations")
        if minus_two:
            fails.append(f"{sum(minus_two)} requests completed with -2")
        if srv.errors:
            fails.append(f"serve errors {srv.errors}")
        if launches != flushes or not launches:
            fails.append(f"{launches} kernel launches for {flushes} GET "
                         "flushes")
        if s["misses"] != sum(s[k] for k in sm.kv_mod.MISS_CAUSE_NAMES):
            fails.append("misses != the sum of the miss causes")
        pushes = dict(srv.bf_push_stats)
        if not pushes["cycles"] or pushes.get("errors", 0):
            fails.append(f"bloom push {pushes}")
        if fails:
            raise AssertionError("sanitize (b): " + "; ".join(fails))
        puts, gets, hits = (sum(c[i] for c in counts) for i in range(3))
        log("sanitize", f"(b) engine-backed KVServer on {kv.device}: "
            f"linear·flat {kv.capacity()} slots, {n} pages through KV.insert "
            f"in {t_fill:.3f} s; {nc} ReconnectingClients over EngineBackend "
            f"slices of {v} pages for {secs:.1f} s: {puts} put and {gets} "
            f"GET verbs, {hits} hits byte-exact, every miss zeroed, no -2 "
            f"status, serve errors 0; bloom push {pushes}; "
            f"{launches} fused-GET launches = {flushes} GET flushes; "
            f"PMDFC_SAN=on: violations [] ({smi})")
        w = widest["keys"]
        batch = w.cpu().numpy().view(np.uint32)
        w_, t = ops_kernel(sm, kv.state, batch, "sanitize (b) widest", smi)
        log("sanitize", f"fused_get_linear_flat w = {w_} at (b)'s widest "
            f"flush: kernel == plain, {t[0]:.4f} ms vs bound {t[2]:.4f} ms "
            f"({t[2] / t[0]:.0%}), plain {t[1]:.4f} ms ({smi})")
        return plane_entry(sm, "sanitize", launches, t)
    finally:
        stop.set()
        for rc in clients:
            rc.close()
        cc.close()
        cc.backend.close()
        srv.stop()


def sanitize_dir():
    """Where phase 19 writes its `MSG_STATS` document (git-ignored, on the
    checkout's disk); removed at the end of the phase."""
    from pathlib import Path

    return Path(__file__).resolve().parent / "build" / "sanitize"


def run_sanitize(sm):
    """Phase 19: the serving path under the runtime lock sanitizer
    (`PMDFC_SAN=on`, JAX's 200 ms hold limit): (a) JAX's acceptance soak
    on the card with the controller and a live window, (c) the traced
    chaos soak, (b) the engine-backed `KVServer` with the bloom push ->
    its kernel entries."""
    import shutil

    from pmdfc_tpu_torch.config import TelemetryConfig
    from pmdfc_tpu_torch.runtime import engine as eng_mod
    from pmdfc_tpu_torch.runtime import sanitizer as san
    from pmdfc_tpu_torch.runtime import telemetry as tele
    from pmdfc_tpu_torch.runtime import timeseries

    torch = sm.torch
    t_phase = time.monotonic()
    at_import = os.environ.get("PMDFC_SAN") == "on"
    was_on = san.enabled()
    san.configure(on=True, strict=False, hold_ms=SAN_HOLD_MS)
    san.reset()
    if at_import and type(eng_mod._lib_lock).__name__ != "SanLock":
        raise AssertionError("sanitize: engine._lib_lock is not "
                             "instrumented under PMDFC_SAN=on")
    free_card(torch)
    smi = nvidia_smi()
    root = sanitize_dir()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    tele.configure(TelemetryConfig(ring_capacity=SAN_RING))
    collector = timeseries.ensure_collector(interval_s=0.25)
    times = {}
    try:
        log("sanitize", f"PMDFC_SAN={'on at import' if at_import else 'on'}"
            f", hold limit {san._STATE.hold_ms:.0f} ms; engine._lib_lock "
            f"{type(eng_mod._lib_lock).__name__} ({smi})")
        t0 = time.monotonic()
        a = san_soak(sm, str(root), smi)
        times["a"] = time.monotonic() - t0 - a["trace"]["secs"]
        times["c"] = a["trace"]["secs"]
        free_card(torch)
        t0 = time.monotonic()
        b = san_engine(sm, smi)
        times["b"] = time.monotonic() - t0
    finally:
        collector.stop()
        san.configure(on=was_on)
        free_card(torch)
        shutil.rmtree(root, ignore_errors=True)
    entries = [a["entry"], b]
    log("sanitize", "gates: violations [] (no inversion, self-deadlock or "
        "long hold), no wrong byte, every miss zeroed, misses == sum of the "
        "causes, serve errors 0, no -2 status, check_autotune [], balloon "
        "moves of one extent inside the envelope, every completed traced "
        "verb joined, one fused-GET launch per GET phase and flush")
    log("sanitize", f"phase 19 took {time.monotonic() - t_phase:.1f} s: (a) "
        f"{times['a']:.1f} s, (c) {times['c']:.1f} s, (b) {times['b']:.1f} s")
    return entries


def sanitize_subprocess(seed: int):
    """`run_sanitize` in a child process of this script (`--sanitize`)
    whose environment has `PMDFC_SAN=on` before any import -> (its kernel
    entries, its log lines, seconds). A child that fails fails the phase."""
    t0 = time.monotonic()
    env = dict(os.environ, PMDFC_SAN="on",
               PMDFC_SAN_HOLD_MS=str(SAN_HOLD_MS))
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--sanitize", "--seed",
         str(seed)], capture_output=True, text=True, env=env,
        timeout=SAN_TIMEOUT_S)
    entries, lines = None, []
    for line in proc.stdout.splitlines():
        if line.startswith("SANITIZE "):
            entries = json.loads(line[len("SANITIZE "):])
        else:
            lines.append(line)
    if proc.returncode != 0 or entries is None:
        raise AssertionError(f"sanitize child exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    return entries, lines, time.monotonic() - t0


def collect_sanitize(lanes: "Lanes"):
    """Phase 19's child, queued last in `lanes` at phase 12's start: its
    lines echoed, its kernel entries returned."""
    t0 = time.monotonic()
    (entries, lines, secs), = lanes.rows("sanitize")
    for line in lines:
        print(line, flush=True)
    log("sanitize", f"phase 19's child took {secs:.1f} s (in the lanes, "
        f"{lanes.span('sanitize')}; waited {time.monotonic() - t0:.1f} s "
        "for it here)")
    return entries


T0 = time.monotonic()  # the smoke's start: phase times are logged from it


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--row-kv", action="store_true",
                    help="run only the row-path KV of phase 11 (the child "
                         "process phase 11 starts with PMDFC_INSERT_PATH=row)")
    ap.add_argument("--chaos", action="store_true",
                    help="run only phase 14 (the child process the whole "
                         "smoke starts in its lanes)")
    ap.add_argument("--trace", action="store_true",
                    help="run only phase 15, with its client child and "
                         "sweeps in its own lanes")
    ap.add_argument("--ops", action="store_true",
                    help="run only phase 16")
    ap.add_argument("--failure", action="store_true",
                    help="run only phase 17 (the child process the whole "
                         "smoke starts in its lanes)")
    ap.add_argument("--store", action="store_true",
                    help="run only phase 18 (the child process the whole "
                         "smoke starts in its lanes)")
    ap.add_argument("--sanitize", action="store_true",
                    help="run only phase 19 under PMDFC_SAN=on (the child "
                         "process the whole smoke starts in its lanes)")
    ap.add_argument("--trace-client", metavar="DIR", default=None,
                    help="phase 15's client child: wait for the server "
                         "named in DIR/server.json and drive it (touches "
                         "no device)")
    args = ap.parse_args()

    if args.trace_client:
        return trace_client(args.trace_client)
    if args.sanitize:  # before any import of the port: every lock it builds
        os.environ["PMDFC_SAN"] = "on"
        os.environ["PMDFC_SAN_HOLD_MS"] = str(SAN_HOLD_MS)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1

    from pmdfc_tpu_torch.ops import _build

    if args.row_kv:
        _build.load("fused_get")
        print("ROWKV " + json.dumps(run_row_kv(Smoke(args.seed))),
              flush=True)
        return 0
    if args.chaos:
        _build.load("fused_get")
        _build.load_host("runtime")
        print("CHAOS " + json.dumps(run_chaos(Smoke(args.seed))), flush=True)
        return 0
    if args.trace:
        _build.load("fused_get")
        log("env", nvidia_smi())
        print("TRACE " + json.dumps(run_trace(Smoke(args.seed))), flush=True)
        return 0
    if args.ops:
        _build.load("fused_get")
        log("env", nvidia_smi())
        print("OPS " + json.dumps(run_ops(Smoke(args.seed))), flush=True)
        return 0
    if args.failure:
        _build.load("fused_get")
        _build.load_host("runtime")
        log("env", nvidia_smi())
        print("FAILURE " + json.dumps(run_failure(Smoke(args.seed))),
              flush=True)
        return 0
    if args.store:
        _build.load("fused_get")
        log("env", nvidia_smi())
        print("STORE " + json.dumps(run_store(Smoke(args.seed))), flush=True)
        return 0
    if args.sanitize:
        _build.load("fused_get")
        _build.load_host("runtime")
        log("env", nvidia_smi())
        print("SANITIZE " + json.dumps(run_sanitize(Smoke(args.seed))),
              flush=True)
        return 0

    # 1. env
    smi = nvidia_smi()
    log("env", smi)
    nvcc_v = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip()
    log("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvcc: {nvcc_v.splitlines()[-1]}")

    # 2. build: nvcc and g++ side by side, then load
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.monotonic()
    with ThreadPoolExecutor(2) as ex:
        for f in [ex.submit(_build.build, "fused_get"),
                  ex.submit(_build.build_host, "runtime")]:
            f.result()
    _build.load("fused_get")
    _build.load_host("runtime")
    log("build", f"fused_get (nvcc) and the engine (g++) built and loaded "
        f"in {time.monotonic() - t0:.2f} s")
    for name, (secs, out) in _build.BUILD_LOG.items():
        for line in out.strip().splitlines():
            log("build", f"{name}: {line.strip()}")

    sm = Smoke(args.seed)

    # 3. kernel against plain, small states, flat then tiered
    for tiered in (False, True):
        pool_name = "tiered" if tiered else "flat"
        for kind, s in (("linear", 16), ("linear", 32), ("cceh", 16),
                        ("cceh", 32)):
            kv, pool, present, covers = sm.small_state(kind, s, tiered)
            sm.kernel_phase(kv, pool, present, covers,
                            f"small {kind}·{pool_name} S={s}")
            del kv
        # the LSB directory: extendible hashing serves through the
        # composed GET, so its state is held here by calling the wrapper
        # with msb=False
        kv, pool, present, covers = sm.small_state("extendible", 32, tiered)
        assert not kv.state.index.msb
        sm.kernel_phase(kv, pool, present, covers,
                        f"small extendible·{pool_name} (msb=False)")
        del kv
    torch.cuda.empty_cache()

    # 4 and 5, one path at a time: each KV is freed before the next fill;
    # from phase 12's start the harness processes of phases 12 and 13 run
    # side by side in one set of lanes
    kernels = []
    log("smoke", f"phases 1-3 took {time.monotonic() - T0:.1f} s")
    lanes = Lanes(HARNESS_LANES)
    try:
        for label, run in (
                ("linear", run_linear), ("cceh", run_cceh),
                ("linear·tiered", lambda sm: run_tiered(sm, "linear")),
                ("cceh·tiered", lambda sm: run_tiered(sm, "cceh")),
                ("families", run_families), ("serve", run_serving),
                ("wire", run_wire), ("fleet", run_fleet),
                ("plane", run_plane), ("control", run_control),
                ("scale", lambda sm: run_scale(
                    sm, lanes.queue("chaos", args.seed).queue("trace")
                    .queue("scale").queue("tail")
                    .queue("trace-client", args.seed)
                    .queue("failure", args.seed)
                    .queue("store", args.seed)
                    .queue("sanitize", args.seed))),
                ("tail", lambda sm: run_tail(sm, lanes)),
                ("chaos", lambda sm: collect_chaos(lanes)),
                ("trace", lambda sm: run_trace(sm, lanes)),
                ("ops", run_ops),
                ("failure", lambda sm: collect_failure(lanes)),
                ("store", lambda sm: collect_store(lanes)),
                ("sanitize", lambda sm: collect_sanitize(lanes))):
            t0 = time.monotonic()
            entry = run(sm)
            log("smoke", f"{label} took {time.monotonic() - t0:.1f} s, "
                f"{time.monotonic() - T0:.1f} s since the start")
            # on stderr too: a run stopped at its time limit shows how far
            # it got in the end of its errors
            print(f"[smoke] {label} done at {time.monotonic() - T0:.1f} s",
                  file=sys.stderr, flush=True)
            if isinstance(entry, list):  # plane .. sanitize
                kernels.extend(entry)
            elif entry is not None:  # the families launch no kernel
                kernels.append(entry)
            torch.cuda.empty_cache()
    finally:
        lanes.close()

    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
