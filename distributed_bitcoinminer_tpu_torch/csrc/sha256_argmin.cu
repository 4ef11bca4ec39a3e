// SHA-256 nonce search over one aligned 10^k nonce block, hand-written for
// Hopper: the arg-min kernel (K1), the difficulty-target kernel with its
// early exit (K2), the batched segment-min over many rows (K5), and the
// device-resident chain that folds each block's winner into a carry on the
// card (K6).
//
// K1 replaces the TPU kernel of the JAX package, ops/sha256_pallas.py::
// pallas_search_span (the rolled _kernel_body, not-peel branch), and its
// lex_argmin reduce. It computes the same function: for every lane i in
// i0 + [0, n) that lies inside [lo_i, hi_i], the k ASCII decimal digits of i
// are written into the padded tail template at byte rem + j, the tail's
// nblocks blocks are compressed from the host midstate, and digest words 0
// and 1 become the key (hi, lo). The result is the lexicographic minimum of
// (hi, lo, i) over the valid lanes, or the all-ones sentinel when none is
// valid. The idx component of the key makes the earliest nonce win a hash
// tie, and lets a valid all-ones hash beat the sentinel.
//
// K2 replaces ops/sha256_pallas.py::pallas_search_span_until: K1 plus the
// first (lowest) valid lane whose key (hi, lo) is below the 64-bit target
// (t_hi, t_lo). Out: (found, f_idx, best_hi, best_lo, best_idx); best_* is
// read only when found is 0, since after a hit the lanes a thread skips
// depend on timing.
//
// K5 replaces ops/sha256_pallas.py::pallas_search_span_batch (via
// pallas_segmin), the batched segment-min of cross-request coalescing: R
// rows, each K1's search over its own plan (message, digit class, window),
// reduced to the lexicographic (hi, lo, idx) minimum per SEGMENT, segments
// being contiguous runs of rows (a segment id per row, sorted ascending).
// The TPU entry runs one kernel per row and combines the rows in jnp; here
// it is one search launch over every row of a tail-block count (NB is a
// template parameter, so a batch is at most two search launches) plus one
// segment-reduce launch. Rows differ in rem, k and lane count, which are
// run-time fields of the plan. Ragged rows: each row gets a share of the
// launch's blocks (the host's block table, proportional to its valid
// lanes), and its blocks grid-stride over the row's valid lanes only. The
// R x 49-word plan table lies in device memory (one copy per batch); a
// block copies its row's plan into shared memory once. A block writes one
// partial key; the reduce gives each segment one block, which reduces the
// partials of the segment's rows. No atomics; an empty segment, or one
// whose rows have no valid lane, comes out as the all-ones sentinel.
//
// K6 replaces the single-device entries of the TPU devloop
// (_pallas_devloop_span_jit, _pallas_devloop_until_jit): the K1 or K2
// search, with a reduce that folds the block's winner into a carry of 5
// (arg-min) or 8 (until) words on the device, by the rule of the JAX
// package's ops/searchop.py fold_argmin / fold_until: the 64-bit global
// nonce from the block base, full-lex strict-less on (hash, nonce), the
// minimum of the qualifying nonces. A chain of launches over a span's
// blocks leaves the span's answer on the card for one fetch. The TPU grid
// needed a run-time `live` step count because its grid is static; a CUDA
// launch takes its lane count at run time, so only the found check remains:
// a chained until launch returns at once when an earlier one hit.
//
// What bounds them: the 32-bit integer pipes. A lane reads no memory (the
// plan travels by value as a kernel parameter, the round constants sit in
// the constant bank) and a block writes 12 bytes, so the work is the ~2,000
// to ~4,000 integer instructions of one or two compressions per lane. K2
// adds a compare and one volatile load per lane. K5 reads its row's plan
// from shared memory instead of the parameter bank.
//
// Design. The TPU grid runs its steps in order and carries accumulators from
// step to step; GPU blocks run in parallel in no order. So each thread walks
// its lanes i0 + tid, i0 + tid + stride, ... in ascending order with a
// running strict-less minimum, a warp-shuffle and then a shared-memory min
// reduce each block to one partial on the full (hi, lo, idx) key, and a
// second one-block kernel reduces the partials on the device. The answer
// cannot depend on the order in which blocks run, nor on the grid size.
//
// K2's early exit. The TPU kernel skips its later grid steps on a bare
// found flag, which is sound only because its grid runs in order. Here a
// later block may hit first, so a flag would let it hide an earlier hit.
// Instead a qualifying lane does atomicMin on one device word f_min (reset
// to all-ones before every launch), and a thread stops as soon as its next
// lane lies above f_min. Only lanes above the lowest hit found so far are
// skipped, and that never passes over the true first qualifier.
//
// This first design is simple and right; speed comes later (per-thread lane
// unrolling, hoisting the high digits, a digit-free second block without
// schedule arithmetic, peeling the constant head rounds).

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// The host plan, by value: 49 uint32 words, in this order.
struct Plan {
  uint32_t mid[8];     // state after the prefix's full 64-byte blocks
  uint32_t tmpl[32];   // padded tail block(s), digit bytes zeroed
  uint32_t rem;        // tail bytes before the first digit
  uint32_t k;          // digits per nonce, 1..9
  uint32_t nblocks;    // tail blocks, 1 or 2
  uint32_t i0;         // first lane
  uint32_t lo_i;       // first valid lane
  uint32_t hi_i;       // last valid lane
  uint32_t n;          // lanes
  uint32_t t_hi;       // target, high word (K2 and the until chain only)
  uint32_t t_lo;       // target, low word
};
static_assert(sizeof(Plan) == 49 * sizeof(uint32_t), "plan layout");

__constant__ uint32_t kK[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu,
    0x59F111F1u, 0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u,
    0x243185BEu, 0x550C7DC3u, 0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u,
    0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u, 0x0FC19DC6u, 0x240CA1CCu,
    0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu, 0x983E5152u,
    0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu,
    0x53380D13u, 0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u,
    0xA2BFE8A1u, 0xA81A664Bu, 0xC24B8B70u, 0xC76C51A3u, 0xD192E819u,
    0xD6990624u, 0xF40E3585u, 0x106AA070u, 0x19A4C116u, 0x1E376C08u,
    0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au, 0x5B9CCA4Fu,
    0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

struct Key {
  uint32_t hi, lo, idx;
};

__device__ __forceinline__ Key sentinel() { return Key{~0u, ~0u, ~0u}; }

__device__ __forceinline__ bool key_less(const Key& a, const Key& b) {
  if (a.hi != b.hi) return a.hi < b.hi;
  if (a.lo != b.lo) return a.lo < b.lo;
  return a.idx < b.idx;
}

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// One compression of the 16 words w into the state st (feed-forward added).
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      // In-place mod-16 schedule window:
      // w[t] = w[t-16] + s0(w[t-15]) + w[t-7] + s1(w[t-2]).
      const uint32_t x = w[(t + 1) & 15];
      const uint32_t y = w[(t + 14) & 15];
      const uint32_t s0 = rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3);
      const uint32_t s1 = rotr(y, 17) ^ rotr(y, 19) ^ (y >> 10);
      wt = w[t & 15] + s0 + w[(t + 9) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = g ^ (e & (f ^ g));
    const uint32_t t1 = h + S1 + ch + kK[t] + wt;
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & (b ^ c)) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + S0 + maj;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

// The key of lane i: its k digits written into the tail template, the
// tail's NB blocks compressed from the host midstate, digest words 0 and 1.
// The k digits fill bytes s .. s+k-1 of a 12-byte field that starts at
// tail word a = rem / 4; the field's three words are q0, q1, q2.
template <int NB>
__device__ __forceinline__ Key lane_key(const Plan& p, uint32_t i,
                                        uint32_t s, int a) {
  const uint32_t k = p.k;
  uint32_t q0 = 0u, q1 = 0u, q2 = 0u;
  uint32_t x = i;
#pragma unroll
  for (uint32_t t = 0; t < 9u; ++t) {  // t = 0 is the least significant digit
    if (t < k) {
      const uint32_t digit = x % 10u;
      x /= 10u;
      const uint32_t pos = s + k - 1u - t;
      const uint32_t v = (digit + 48u) << ((3u - (pos & 3u)) * 8u);
      const uint32_t wq = pos >> 2;
      q0 |= wq == 0u ? v : 0u;
      q1 |= wq == 1u ? v : 0u;
      q2 |= wq == 2u ? v : 0u;
    }
  }
  uint32_t st[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) st[r] = p.mid[r];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    uint32_t w[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int off = 16 * b + m - a;
      w[m] = p.tmpl[16 * b + m] |
             (off == 0 ? q0 : off == 1 ? q1 : off == 2 ? q2 : 0u);
    }
    compress(st, w);
  }
  return Key{st[0], st[1], i};
}

__device__ __forceinline__ Key warp_min(Key v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Key o{__shfl_down_sync(0xFFFFFFFFu, v.hi, off),
                __shfl_down_sync(0xFFFFFFFFu, v.lo, off),
                __shfl_down_sync(0xFFFFFFFFu, v.idx, off)};
    if (key_less(o, v)) v = o;
  }
  return v;
}

// Block-wide minimum; the result is valid in thread 0. blockDim.x must be a
// multiple of 32 and every thread of the block must call it.
__device__ __forceinline__ Key block_min(Key v) {
  __shared__ Key warp_best[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_min(v);
  if (lane == 0) warp_best[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? warp_best[lane] : sentinel();
    v = warp_min(v);
  }
  return v;
}

// The block's minimum of the per-thread keys, written by thread 0 as the
// block's partial.
__device__ __forceinline__ void write_partial(Key best,
                                              uint32_t* __restrict__ partials) {
  best = block_min(best);
  if (threadIdx.x == 0) {
    partials[3 * blockIdx.x + 0] = best.hi;
    partials[3 * blockIdx.x + 1] = best.lo;
    partials[3 * blockIdx.x + 2] = best.idx;
  }
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
    sha256_argmin_kernel(const Plan p, uint32_t* __restrict__ partials) {
  const uint32_t s = p.rem & 3u;
  const int a = static_cast<int>(p.rem >> 2);
  const uint32_t stride = gridDim.x * blockDim.x;
  Key best = sentinel();
  // The launcher keeps n <= 2^31 and the grid far below 2^31 threads, so
  // j + stride cannot wrap (a 64-bit counter costs the 2-block variant
  // registers and a resident block per SM).
  for (uint32_t j = blockIdx.x * blockDim.x + threadIdx.x; j < p.n;
       j += stride) {
    const uint32_t i = p.i0 + j;
    if (i < p.lo_i || i > p.hi_i) continue;
    const Key cand = lane_key<NB>(p, i, s, a);
    if (key_less(cand, best)) best = cand;
  }
  write_partial(best, partials);
}

// K2's search; with CHAINED, one launch of K6's until chain, which does
// nothing once an earlier launch of the chain has hit (carry[0] != 0; no
// thread of this launch writes the carry, so every thread sees one value).
// f_min holds the lowest qualifying lane found so far (all-ones: none).
template <int NB, bool CHAINED>
__global__ void __launch_bounds__(kThreads)
    sha256_until_kernel(const Plan p, const uint32_t* __restrict__ carry,
                        uint32_t* f_min, uint32_t* __restrict__ partials) {
  if (CHAINED && carry[0] != 0u) return;
  const uint32_t s = p.rem & 3u;
  const int a = static_cast<int>(p.rem >> 2);
  const uint32_t stride = gridDim.x * blockDim.x;
  const volatile uint32_t* lowest_hit = f_min;
  Key best = sentinel();
  for (uint32_t j = blockIdx.x * blockDim.x + threadIdx.x; j < p.n;
       j += stride) {
    const uint32_t i = p.i0 + j;
    // A thread's lanes ascend: once this one lies above the lowest hit,
    // so do all the rest. The load is volatile, so a hit by any block is
    // seen at the next lane. Breaking still reaches write_partial's
    // barrier with every other thread of the block.
    if (i > *lowest_hit) break;
    if (i < p.lo_i || i > p.hi_i) continue;
    const Key cand = lane_key<NB>(p, i, s, a);
    if (key_less(cand, best)) best = cand;
    if (cand.hi < p.t_hi || (cand.hi == p.t_hi && cand.lo < p.t_lo)) {
      atomicMin(f_min, i);
    }
  }
  write_partial(best, partials);
}

// Every thread's strict-less minimum over a strided share of the partials.
__device__ __forceinline__ Key partials_min(const uint32_t* __restrict__ partials,
                                            int count) {
  Key best = sentinel();
  for (int b = threadIdx.x; b < count; b += blockDim.x) {
    const Key c{partials[3 * b + 0], partials[3 * b + 1], partials[3 * b + 2]};
    if (key_less(c, best)) best = c;
  }
  return best;
}

__global__ void __launch_bounds__(1024)
    reduce_partials_kernel(const uint32_t* __restrict__ partials, int count,
                           uint32_t* __restrict__ out) {
  const Key best = block_min(partials_min(partials, count));
  if (threadIdx.x == 0) {
    out[0] = best.hi;
    out[1] = best.lo;
    out[2] = best.idx;
  }
}

// K2's reduce: (found, f_idx, best_hi, best_lo, best_idx).
__global__ void __launch_bounds__(1024)
    reduce_until_kernel(const uint32_t* __restrict__ partials, int count,
                        const uint32_t* __restrict__ f_min,
                        uint32_t* __restrict__ out) {
  const Key best = block_min(partials_min(partials, count));
  if (threadIdx.x == 0) {
    const uint32_t f = *f_min;
    out[0] = f != ~0u ? 1u : 0u;
    out[1] = f;
    out[2] = best.hi;
    out[3] = best.lo;
    out[4] = best.idx;
  }
}

// Strict lexicographic a < b over n words (element 0 most significant).
__device__ __forceinline__ bool words_less(const uint32_t* a,
                                           const uint32_t* b, int n) {
  for (int w = 0; w < n; ++w) {
    if (a[w] != b[w]) return a[w] < b[w];
  }
  return false;
}

// searchop.fold_argmin on the 5-word carry c = [hash_hi, hash_lo,
// nonce_hi, nonce_lo, seen]; the nonce is base + m.idx in 64 bits.
__device__ __forceinline__ void fold_argmin_words(uint32_t* c, const Key& m,
                                                  uint32_t base_hi,
                                                  uint32_t base_lo) {
  const bool valid = !(m.hi == ~0u && m.lo == ~0u && m.idx == ~0u);
  const uint32_t n_lo = base_lo + m.idx;
  const uint32_t n_hi = base_hi + (n_lo < m.idx ? 1u : 0u);
  const uint32_t cand[4] = {m.hi, m.lo, n_hi, n_lo};
  if (valid && (c[4] == 0u || words_less(cand, c, 4))) {
    for (int w = 0; w < 4; ++w) c[w] = cand[w];
    c[4] = 1u;
  }
}

// searchop.fold_until on the 8-word carry c = [found, f_nonce_hi,
// f_nonce_lo] + the arg-min carry: the lower qualifying 64-bit nonce wins.
__device__ __forceinline__ void fold_until_words(uint32_t* c, uint32_t f_idx,
                                                 const Key& m,
                                                 uint32_t base_hi,
                                                 uint32_t base_lo) {
  if (f_idx != ~0u) {
    const uint32_t f_lo = base_lo + f_idx;
    const uint32_t f[2] = {base_hi + (f_lo < f_idx ? 1u : 0u), f_lo};
    if (c[0] == 0u || words_less(f, c + 1, 2)) {
      c[1] = f[0];
      c[2] = f[1];
    }
    c[0] = 1u;
  }
  fold_argmin_words(c + 3, m, base_hi, base_lo);
}

__global__ void __launch_bounds__(1024)
    reduce_argmin_fold_kernel(const uint32_t* __restrict__ partials,
                              int count, uint32_t* __restrict__ carry,
                              uint32_t base_hi, uint32_t base_lo) {
  const Key best = block_min(partials_min(partials, count));
  if (threadIdx.x == 0) fold_argmin_words(carry, best, base_hi, base_lo);
}

// The until chain's reduce. When an earlier launch hit, the search kernel
// wrote no partials and the carry stays as it is (a fold of "no hit, no
// valid lane" changes nothing). Thread 0 writes the carry only after
// block_min's barrier, so every thread reads the same carry[0].
__global__ void __launch_bounds__(1024)
    reduce_until_fold_kernel(const uint32_t* __restrict__ partials, int count,
                             const uint32_t* __restrict__ f_min,
                             uint32_t* carry, uint32_t base_hi,
                             uint32_t base_lo) {
  if (carry[0] != 0u) return;
  const Key best = block_min(partials_min(partials, count));
  if (threadIdx.x == 0) {
    fold_until_words(carry, *f_min, best, base_hi, base_lo);
  }
}

// K5's search: the blocks of one NB group. Block b serves row
// group_rows[g] for the g with group_blk[g] <= b < group_blk[g + 1]
// (group_blk ascends strictly: a row without a block is not in the group),
// as block b - group_blk[g] of that row's group_blk[g + 1] - group_blk[g],
// and writes its partial at slot part_base + b.
template <int NB>
__global__ void __launch_bounds__(kThreads)
    sha256_segmin_kernel(const uint32_t* __restrict__ plans,
                         const int* __restrict__ group_rows,
                         const int* __restrict__ group_blk, int group_n,
                         int part_base, uint32_t* __restrict__ partials) {
  __shared__ Plan sp;
  __shared__ int s_row, s_local, s_nblk;
  if (threadIdx.x == 0) {
    int lo = 0, hi = group_n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (group_blk[mid] <= static_cast<int>(blockIdx.x)) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    s_row = group_rows[lo];
    s_local = static_cast<int>(blockIdx.x) - group_blk[lo];
    s_nblk = group_blk[lo + 1] - group_blk[lo];
  }
  __syncthreads();
  const uint32_t* src = plans + 49 * s_row;
  uint32_t* dst = reinterpret_cast<uint32_t*>(&sp);
  for (int w = threadIdx.x; w < 49; w += blockDim.x) dst[w] = src[w];
  __syncthreads();
  // The row's valid lanes [first, last]; the launcher keeps i0 + n - 1
  // within 32 bits and n <= 2^31, so the offset j never wraps.
  const uint32_t first = max(sp.lo_i, sp.i0);
  const uint32_t last = min(sp.hi_i, sp.i0 + sp.n - 1u);
  Key best = sentinel();
  if (first <= last) {
    const uint32_t s = sp.rem & 3u;
    const int a = static_cast<int>(sp.rem >> 2);
    const uint32_t stride = static_cast<uint32_t>(s_nblk) * blockDim.x;
    for (uint32_t j = static_cast<uint32_t>(s_local) * blockDim.x +
                      threadIdx.x;
         j <= last - first; j += stride) {
      const Key cand = lane_key<NB>(sp, first + j, s, a);
      if (key_less(cand, best)) best = cand;
    }
  }
  best = block_min(best);
  if (threadIdx.x == 0) {
    const int q = part_base + static_cast<int>(blockIdx.x);
    partials[3 * q + 0] = best.hi;
    partials[3 * q + 1] = best.lo;
    partials[3 * q + 2] = best.idx;
  }
}

// K5's reduce: block s walks the partial slots [pstart[r], pstart[r] +
// pcount[r]) of the rows r in [seg_rows[s], seg_rows[s + 1]); out is the
// (3, nsegs) words seg_hi, seg_lo, seg_idx.
__global__ void __launch_bounds__(kThreads)
    segmin_reduce_kernel(const int* __restrict__ seg_rows,
                         const int* __restrict__ pstart,
                         const int* __restrict__ pcount,
                         const uint32_t* __restrict__ partials, int nsegs,
                         uint32_t* __restrict__ out) {
  const int s = blockIdx.x;
  Key best = sentinel();
  for (int r = seg_rows[s]; r < seg_rows[s + 1]; ++r) {
    for (int b = threadIdx.x; b < pcount[r]; b += blockDim.x) {
      const int q = pstart[r] + b;
      const Key c{partials[3 * q + 0], partials[3 * q + 1],
                  partials[3 * q + 2]};
      if (key_less(c, best)) best = c;
    }
  }
  best = block_min(best);
  if (threadIdx.x == 0) {
    out[s] = best.hi;
    out[nsegs + s] = best.lo;
    out[2 * nsegs + s] = best.idx;
  }
}

bool plan_ok(const Plan& p, int grid) {
  return grid > 0 && grid <= (1 << 20) && p.n <= (1u << 31) &&
         (p.nblocks == 1u || p.nblocks == 2u) && p.k >= 1u && p.k <= 9u &&
         p.rem <= 63u;
}

Plan read_plan(const uint32_t* plan_words) {
  Plan p;
  std::memcpy(&p, plan_words, sizeof(Plan));
  return p;
}

// Launch K1's search kernel; returns cudaGetLastError() after it.
int launch_argmin_search(const Plan& p, uint32_t* partials, int grid,
                         cudaStream_t s) {
  if (p.nblocks == 1u) {
    sha256_argmin_kernel<1><<<grid, kThreads, 0, s>>>(p, partials);
  } else {
    sha256_argmin_kernel<2><<<grid, kThreads, 0, s>>>(p, partials);
  }
  return static_cast<int>(cudaGetLastError());
}

// Reset f_min to all-ones on the stream, then launch K2's search kernel
// (CHAINED: the until chain's); returns the first error seen.
template <bool CHAINED>
int launch_until_search(const Plan& p, const uint32_t* carry, uint32_t* f_min,
                        uint32_t* partials, int grid, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(f_min, 0xFF, sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.nblocks == 1u) {
    sha256_until_kernel<1, CHAINED><<<grid, kThreads, 0, s>>>(p, carry, f_min,
                                                              partials);
  } else {
    sha256_until_kernel<2, CHAINED><<<grid, kThreads, 0, s>>>(p, carry, f_min,
                                                              partials);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int blocks_per_sm(Kernel kernel) {
  int per_sm = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return err == cudaSuccess ? per_sm : 0;
}

}  // namespace

extern "C" {

// Threads per block of the search kernels.
int dbmt_sha256_argmin_threads() { return kThreads; }

// Resident K1 search blocks per SM for a tail of nblocks blocks (0 on error).
int dbmt_sha256_argmin_blocks_per_sm(int nblocks) {
  return nblocks == 2 ? blocks_per_sm(sha256_argmin_kernel<2>)
                      : blocks_per_sm(sha256_argmin_kernel<1>);
}

// Resident K2 search blocks per SM for a tail of nblocks blocks (0 on error).
int dbmt_sha256_until_blocks_per_sm(int nblocks) {
  return nblocks == 2 ? blocks_per_sm(sha256_until_kernel<2, false>)
                      : blocks_per_sm(sha256_until_kernel<1, false>);
}

// Resident K5 search blocks per SM for a tail of nblocks blocks.
int dbmt_sha256_segmin_blocks_per_sm(int nblocks) {
  return nblocks == 2 ? blocks_per_sm(sha256_segmin_kernel<2>)
                      : blocks_per_sm(sha256_segmin_kernel<1>);
}

// K5: `table` is one device buffer of int32 words, in this order: the
// nrows x 49-word plans; pstart[nrows] and pcount[nrows], each row's
// partial slots; seg_rows[nsegs + 1]; then for the 1-block group its
// rows[n1] and block prefix[n1 + 1] (grid1 = prefix[n1] blocks), and the
// same for the 2-block group (n2, grid2). partials: 3 * (grid1 + grid2)
// device words, the 1-block group's slots first; out: 3 * nsegs device
// words. Enqueues the search launch of each non-empty group and the
// reduce on `stream`; returns the first cudaGetLastError() that is not 0.
int dbmt_sha256_segmin(const int* table, int nrows, int nsegs, int n1,
                       int grid1, int n2, int grid2, uint32_t* partials,
                       uint32_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nrows <= 0 || nsegs <= 0 || n1 < 0 || n2 < 0 || grid1 < 0 ||
      grid2 < 0 || grid1 + grid2 > (1 << 21)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t* plans = reinterpret_cast<const uint32_t*>(table);
  const int* pstart = table + 49 * nrows;
  const int* pcount = pstart + nrows;
  const int* seg_rows = pcount + nrows;
  const int* g1_rows = seg_rows + nsegs + 1;
  const int* g1_blk = g1_rows + n1;
  const int* g2_rows = g1_blk + n1 + 1;
  const int* g2_blk = g2_rows + n2;
  if (n1 > 0 && grid1 > 0) {
    sha256_segmin_kernel<1><<<grid1, kThreads, 0, s>>>(plans, g1_rows, g1_blk,
                                                       n1, 0, partials);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  if (n2 > 0 && grid2 > 0) {
    sha256_segmin_kernel<2><<<grid2, kThreads, 0, s>>>(plans, g2_rows, g2_blk,
                                                       n2, grid1, partials);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  segmin_reduce_kernel<<<nsegs, kThreads, 0, s>>>(seg_rows, pstart, pcount,
                                                  partials, nsegs, out);
  return static_cast<int>(cudaGetLastError());
}

// Every entry below takes plan_words, 49 host uint32 words (the Plan
// layout), enqueues on `stream` without synchronising, and returns the
// cudaGetLastError() seen right after its launches (0 when all were
// accepted). partials: 3 * grid device words of scratch.

// K1: the search over `grid` blocks and the partials reduce; out: 3 device
// words (hi, lo, idx).
int dbmt_sha256_argmin(const uint32_t* plan_words, uint32_t* partials,
                       uint32_t* out, int grid, void* stream) {
  const Plan p = read_plan(plan_words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!plan_ok(p, grid)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_argmin_search(p, partials, grid, s);
  if (err != 0) return err;
  reduce_partials_kernel<<<1, 1024, 0, s>>>(partials, grid, out);
  return static_cast<int>(cudaGetLastError());
}

// K2: f_min is one device word of scratch; out: 5 device words (found,
// f_idx, best_hi, best_lo, best_idx).
int dbmt_sha256_until(const uint32_t* plan_words, uint32_t* partials,
                      uint32_t* f_min, uint32_t* out, int grid, void* stream) {
  const Plan p = read_plan(plan_words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!plan_ok(p, grid)) return static_cast<int>(cudaErrorInvalidValue);
  const int err =
      launch_until_search<false>(p, nullptr, f_min, partials, grid, s);
  if (err != 0) return err;
  reduce_until_kernel<<<1, 1024, 0, s>>>(partials, grid, f_min, out);
  return static_cast<int>(cudaGetLastError());
}

// K6, arg-min: K1's search, then its winner folded into the 5-word device
// carry, whose nonces are base + lane in 64 bits.
int dbmt_sha256_argmin_fold(const uint32_t* plan_words, uint32_t* partials,
                            uint32_t* carry, uint32_t base_hi,
                            uint32_t base_lo, int grid, void* stream) {
  const Plan p = read_plan(plan_words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!plan_ok(p, grid)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_argmin_search(p, partials, grid, s);
  if (err != 0) return err;
  reduce_argmin_fold_kernel<<<1, 1024, 0, s>>>(partials, grid, carry, base_hi,
                                               base_lo);
  return static_cast<int>(cudaGetLastError());
}

// K6, until: K2's search (skipped when carry[0] says an earlier launch of
// the chain hit), then the fold into the 8-word device carry.
int dbmt_sha256_until_fold(const uint32_t* plan_words, uint32_t* partials,
                           uint32_t* f_min, uint32_t* carry, uint32_t base_hi,
                           uint32_t base_lo, int grid, void* stream) {
  const Plan p = read_plan(plan_words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!plan_ok(p, grid)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_until_search<true>(p, carry, f_min, partials, grid, s);
  if (err != 0) return err;
  reduce_until_fold_kernel<<<1, 1024, 0, s>>>(partials, grid, f_min, carry,
                                              base_hi, base_lo);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
