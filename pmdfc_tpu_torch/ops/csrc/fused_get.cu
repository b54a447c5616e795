// Fused serving GET over the flat or the tiered page pool, for Hopper
// (sm_90a): the linear index and CCEH (with its LSB twin, extendible
// hashing).
//
// Replaces: the Pallas TPU kernel `_get_kernel` launched by `_pallas_get`
// (pmdfc_tpu/ops/fused.py:145-343, pallas_call at :414) in all four of its
// variants: family in {linear, cceh} x tiered in {False, True}.
// One kernel body, templated on the address fold and on the pool:
//  - the fold: linear takes bucket row hash & (C - 1); CCEH takes the
//    directory entry of the hash's top Gmax bits (MSB) or low Gmax bits
//    (LSB), times the W windows of a segment, plus the window hash
//    (fused.py:179-185, 209-223). On the TPU the directory sits in SMEM and
//    a scalar loop walks it; here it is one dependent global load per key
//    (at the serving size the directory is 8 KiB and stays in L2).
//  - the pool (fused.py:253-338): the flat pool's entries tag EXTENT by
//    vhi == 0x80000000; the tiered pool's hi word is a generation, so its
//    tag is vhi >> 30 (0 page, 3 NOPAGE, any other EXTENT), and a page
//    entry passes two gates before its page is read: the generation gate
//    (a cold row [H, H+CC) must carry cgen[row - H], any other row gen 0;
//    else STALE) and the liveness gate (hot rows always, cold rows per
//    live[row - H]; else PARKED, as is a negative row). A stale, dead or
//    NOPAGE key reads no page: its output is zeros.
//
// Per key of a padded batch it does the whole GET in one launch: address
// fold and the two evicted-sketch slots; probe of the
// [khi x S | klo x S | vhi x S | vlo x S] table row;
// lane match; EXTENT tag split; gather of the page and its digest word;
// digest recompute; one miss-cause code (later codes win, fused.py:329-338);
// misses zeroed.
//
// Bound: bytes. Per key it reads one table row (16*S bytes; CCEH one
// directory word before it), for a page entry one page (4*PW bytes) plus
// its digest word (tiered: a cold row's generation word and live byte
// first), and writes one page (4*PW bytes) plus three int32 results; the
// arithmetic is a few integer
// ops per word, far below what the card can issue per byte. So the design
// moves each byte once and keeps every intermediate in registers:
//  - one warp per key, kWarpsPerBlock keys per block. With S = 32, lane l
//    owns slot l: the khi/klo groups arrive as two coalesced 128-byte reads;
//    a value lane is read only by the lane that matched. Groups of 32 slots
//    are looped, so any S works (S = 16 leaves half the lanes idle in the
//    probe).
//  - match by __ballot_sync / __ffs (first matching lane = the slot);
//    values are the masked sums over matching lanes (__reduce_add_sync),
//    the same lane_pick the plain version computes, so both agree even on a
//    row holding one key twice.
//  - the page moves as 16-byte vectors, lane-strided (a 4 KiB page is 8
//    rounds of 512 contiguous bytes per warp); each lane folds the digest of
//    the words it moved and __reduce_xor_sync finishes the fold, so the
//    page is read once and written once with no second pass.
//  - keys that are not page entries read no page; a refused page (digest
//    mismatch) is overwritten with zeros, the only case that writes twice.
//
// The plain PyTorch version is `get_core_reference` in ops/fused.py; the
// wrapper `fused_get` there checks the arguments and launches this through
// the C entry points at the bottom (built by ops/_build.py, loaded with
// ctypes).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kInvalid = 0xFFFFFFFFu;
constexpr uint32_t kExtentTag = 0x80000000u;
constexpr uint32_t kSketchSeed0 = 0x0E51C7EDu;
constexpr uint32_t kSketchSeed1 = 0x0E51C7EDu ^ 0x9E3779B9u;
constexpr uint32_t kWindowSeed = 0x77AA55EEu;  // models/cceh.py WINDOW_SEED
constexpr uint32_t kLaneSalt = 0x9E3779B9u;
constexpr uint32_t kFnvPrime = 0x01000193u;
constexpr uint32_t kFinalMix = 0x85EBCA6Bu;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarpsPerBlock = 8;

// cause codes, as ops/fused.py (PARKED and STALE occur only over the tiered
// pool)
constexpr int32_t kHit = 0, kPad = 1, kCold = 2, kEvicted = 3, kExt = 4,
                  kParked = 5, kStale = 6, kDigest = 7;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// murmur3-32 of the 8-byte key (hi << 32 | lo): utils/hashing.py hash_u64
__device__ __forceinline__ uint32_t hash_u64(uint32_t hi, uint32_t lo,
                                             uint32_t seed) {
  uint32_t h = seed;
  const uint32_t words[2] = {lo, hi};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t k = words[i] * 0xCC9E2D51u;
    k = rotl32(k, 15) * 0x1B873593u;
    h = rotl32(h ^ k, 13) * 5u + 0xE6546B64u;
  }
  h ^= 8u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// one word's term of the page digest (ops/pagepool.py page_digest)
__device__ __forceinline__ uint32_t mix_word(uint32_t w, uint32_t lane) {
  const uint32_t x = (w ^ (lane * kLaneSalt)) * kFnvPrime;
  return x ^ (x >> 15);
}

// address folds: key -> table row (ops/fused.py table_rows)
struct LinearFold {
  uint32_t n_clusters;  // a power of two
  __device__ __forceinline__ int64_t row(uint32_t khi, uint32_t klo) const {
    return hash_u64(khi, klo, 0u) & (n_clusters - 1);
  }
};

struct CcehFold {
  const int32_t* dirr;  // [2^gmax] replicated directory
  uint32_t W;           // windows (rows) per segment
  int gmax;             // 1..31
  bool msb;             // MSB (CCEH) or LSB (extendible) bits
  __device__ __forceinline__ int64_t row(uint32_t khi, uint32_t klo) const {
    const uint32_t h = hash_u64(khi, klo, 0u);
    const uint32_t bucket = msb ? h >> (32 - gmax) : h & ((1u << gmax) - 1);
    const uint32_t win = hash_u64(khi, klo, kWindowSeed) & (W - 1);
    return static_cast<int64_t>(dirr[bucket]) * W + win;
  }
};

// the tiered pool's sidecars: per-cold-row generation and live byte over the
// H hot + CC cold rows of the backing array (unused by flat instances)
struct TierSide {
  const uint32_t* cgen;  // [CC]
  const uint8_t* live;   // [CC] (torch bool)
  int64_t H, CC;
};

template <class Fold, bool Tiered>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_get_kernel(
    const Fold fold, const TierSide tier, const uint32_t* __restrict__ keys,
    int w,
    const uint32_t* __restrict__ table, int S,
    const uint32_t* __restrict__ pages, int64_t n_rows, int pw,
    const uint32_t* __restrict__ sums, const uint8_t* __restrict__ sketch,
    uint32_t sketch_bits, uint32_t* __restrict__ out,
    int32_t* __restrict__ cause, int32_t* __restrict__ rows,
    int32_t* __restrict__ slots) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= w) return;  // uniform across the warp

  // stage 1: address fold
  const uint32_t khi = keys[2 * k], klo = keys[2 * k + 1];
  const bool valid = !(khi == kInvalid && klo == kInvalid);
  const int64_t c = fold.row(khi, klo);
  const uint32_t sk0 = hash_u64(khi, klo, kSketchSeed0) & (sketch_bits - 1);
  const uint32_t sk1 = hash_u64(khi, klo, kSketchSeed1) & (sketch_bits - 1);

  // stages 2-3: probe the table row and match lanes
  const uint32_t* row = table + c * 4 * S;
  int first = -1;
  uint32_t vhi = 0, vlo = 0;
  for (int g = 0; g < S; g += 32) {
    const int j = g + lane;
    bool m = false;
    uint32_t ph = 0, pl = 0;
    if (j < S && valid) {
      m = row[j] == khi && row[S + j] == klo;
      if (m) {
        ph = row[2 * S + j];
        pl = row[3 * S + j];
      }
    }
    const unsigned hits = __ballot_sync(kFull, m);
    vhi += __reduce_add_sync(kFull, ph);
    vlo += __reduce_add_sync(kFull, pl);
    if (first < 0 && hits) first = g + __ffs(hits) - 1;
  }
  const bool found0 = first >= 0;
  const int32_t rowv = static_cast<int32_t>(vlo);
  bool ext, f1, nopage = false;
  if constexpr (Tiered) {
    const uint32_t tag = vhi >> 30;
    nopage = found0 && tag == 3;
    ext = found0 && tag != 0 && !nopage;
    f1 = found0 && tag == 0;
  } else {
    ext = found0 && vhi == kExtentTag;
    f1 = found0 && !ext;
  }

  // tiered: generation and liveness gates on the cold row's sidecars
  bool f2 = f1, stale = false, dead = false;
  if constexpr (Tiered) {
    if (f1) {
      const int64_t r = rowv;
      const int64_t crow = r - tier.H < 0 ? 0
                           : (r - tier.H >= tier.CC ? tier.CC - 1 : r - tier.H);
      const bool ec_cold = r >= tier.H && r < tier.H + tier.CC;
      const bool gen_ok = ec_cold ? vhi == tier.cgen[crow] : vhi == 0;
      stale = !gen_ok;
      f2 = gen_ok;
      if (f2) {
        const bool live_ok = (r >= 0 && r < tier.H) ||
                             (r >= tier.H && tier.live[crow] != 0);
        dead = !live_ok;
      }
    }
  }

  // stage 4: page gather + digest (page entries that passed the gates)
  uint32_t* dst = out + static_cast<size_t>(k) * pw;
  bool hit = false, corrupt = false;
  if (f2 && !dead) {
    const int64_t safe_row = rowv < 0 ? 0 : (rowv >= n_rows ? n_rows - 1 : rowv);
    const uint32_t* src = pages + safe_row * pw;
    uint32_t acc = 0;
#pragma unroll 4
    for (int i = lane * 4; i < pw; i += 128) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + i);
      acc ^= mix_word(v.x, i) ^ mix_word(v.y, i + 1) ^ mix_word(v.z, i + 2) ^
             mix_word(v.w, i + 3);
      *reinterpret_cast<uint4*>(dst + i) = v;
    }
    acc = __reduce_xor_sync(kFull, acc);
    uint32_t h = acc * kFinalMix;
    h ^= h >> 13;
    hit = rowv >= 0 && h == sums[safe_row];
    corrupt = !hit;
  }
  if (!hit) {
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int i = lane * 4; i < pw; i += 128)
      *reinterpret_cast<uint4*>(dst + i) = zero;
  }

  // stage 5: classify (later codes override earlier ones)
  if (lane == 0) {
    const bool idx_miss = valid && !found0;
    const bool ev = idx_miss && sketch[sk0] != 0 && sketch[sk1] != 0;
    int32_t code = kHit;
    if (!valid) code = kPad;
    if (idx_miss && !ev) code = kCold;
    if (ev) code = kEvicted;
    if (ext) code = kExt;
    if (nopage || dead) code = kParked;
    if (stale) code = kStale;
    if (corrupt) code = kDigest;
    cause[k] = code;
    rows[k] = f2 ? rowv : -1;
    slots[k] = found0 ? static_cast<int32_t>(c * S + first) : -1;
  }
}

template <bool Tiered, class Fold>
int launch(const Fold& fold, const TierSide& tier, const void* keys, int w,
           const void* table, int S, const void* pages, long long n_rows,
           int pw, const void* sums, const void* sketch, unsigned sketch_bits,
           void* out, void* cause, void* rows, void* slots, void* stream) {
  if (w <= 0) return 0;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((w + kWarpsPerBlock - 1) / kWarpsPerBlock);
  fused_get_kernel<Fold, Tiered><<<grid, block, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      fold, tier, static_cast<const uint32_t*>(keys), w,
      static_cast<const uint32_t*>(table), S,
      static_cast<const uint32_t*>(pages), n_rows, pw,
      static_cast<const uint32_t*>(sums), static_cast<const uint8_t*>(sketch),
      sketch_bits, static_cast<uint32_t*>(out), static_cast<int32_t*>(cause),
      static_cast<int32_t*>(rows), static_cast<int32_t*>(slots));
  return static_cast<int>(cudaGetLastError());
}

CcehFold cceh_fold(const void* dirr, unsigned n_table_rows, unsigned smax,
                   int msb) {
  int gmax = 0;
  while ((1u << gmax) < smax) ++gmax;
  return CcehFold{static_cast<const int32_t*>(dirr), n_table_rows / smax, gmax,
                  msb != 0};
}

constexpr TierSide kFlat{nullptr, nullptr, 0, 0};

TierSide tier_side(const void* cgen, const void* live, long long hot_rows,
                   long long n_rows) {
  return TierSide{static_cast<const uint32_t*>(cgen),
                  static_cast<const uint8_t*>(live), hot_rows,
                  n_rows - hot_rows};
}

}  // namespace

// C entry points (ctypes). Pointers are device pointers of contiguous
// tensors: keys int32[w, 2], table int32[rows, 4*S], pages int32[n_rows,
// pw] (16-byte aligned, pw a multiple of 4), sums int32[n_rows], sketch
// bool[sketch_bits]; outputs out int32[w, pw], cause, rows, slots int32[w].
// The tiered entries add cgen int32[n_rows - hot_rows] and live
// bool[n_rows - hot_rows], the cold rows' sidecars. Launch on `stream`;
// return cudaGetLastError().

// linear·flat: table has n_clusters (a power of two) rows
extern "C" int pmdfc_fused_get_linear_flat(
    const void* keys, int w, const void* table, unsigned n_clusters, int S,
    const void* pages, long long n_rows, int pw, const void* sums,
    const void* sketch, unsigned sketch_bits, void* out, void* cause,
    void* rows, void* slots, void* stream) {
  return launch<false>(LinearFold{n_clusters}, kFlat, keys, w, table, S,
                       pages, n_rows, pw, sums, sketch, sketch_bits, out,
                       cause, rows, slots, stream);
}

// cceh·flat: table has n_table_rows = smax * W rows; dirr int32[smax],
// smax = 2^gmax with 1 <= gmax <= 31; msb != 0 for CCEH, 0 for the LSB
// directory of extendible hashing
extern "C" int pmdfc_fused_get_cceh_flat(
    const void* keys, int w, const void* table, unsigned n_table_rows, int S,
    const void* dirr, unsigned smax, int msb, const void* pages,
    long long n_rows, int pw, const void* sums, const void* sketch,
    unsigned sketch_bits, void* out, void* cause, void* rows, void* slots,
    void* stream) {
  return launch<false>(cceh_fold(dirr, n_table_rows, smax, msb), kFlat, keys,
                       w, table, S, pages, n_rows, pw, sums, sketch,
                       sketch_bits, out, cause, rows, slots, stream);
}

// linear·tiered: linear·flat's arguments plus the tiered pool's hot row
// count and cold sidecars (pages has hot_rows + CC rows)
extern "C" int pmdfc_fused_get_linear_tiered(
    const void* keys, int w, const void* table, unsigned n_clusters, int S,
    const void* pages, long long n_rows, int pw, const void* sums,
    const void* sketch, unsigned sketch_bits, const void* cgen,
    const void* live, long long hot_rows, void* out, void* cause, void* rows,
    void* slots, void* stream) {
  return launch<true>(LinearFold{n_clusters},
                      tier_side(cgen, live, hot_rows, n_rows), keys, w, table,
                      S, pages, n_rows, pw, sums, sketch, sketch_bits, out,
                      cause, rows, slots, stream);
}

// cceh·tiered: cceh·flat's arguments plus the tiered pool's sidecars
extern "C" int pmdfc_fused_get_cceh_tiered(
    const void* keys, int w, const void* table, unsigned n_table_rows, int S,
    const void* dirr, unsigned smax, int msb, const void* pages,
    long long n_rows, int pw, const void* sums, const void* sketch,
    unsigned sketch_bits, const void* cgen, const void* live,
    long long hot_rows, void* out, void* cause, void* rows, void* slots,
    void* stream) {
  return launch<true>(cceh_fold(dirr, n_table_rows, smax, msb),
                      tier_side(cgen, live, hot_rows, n_rows), keys, w, table,
                      S, pages, n_rows, pw, sums, sketch, sketch_bits, out,
                      cause, rows, slots, stream);
}
