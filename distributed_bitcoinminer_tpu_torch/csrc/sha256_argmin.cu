// SHA-256 nonce search over one aligned 10^k nonce block, hand-written for
// Hopper: the arg-min kernel (K1), the difficulty-target kernel with its
// early exit (K2), the batched segment-min over many rows (K5), and the
// device-resident chain that folds each block's winner into a carry on the
// card (K6), with K6's mesh bodies.
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
// the rows fall into three groups by their tail's shape (the variant: a
// 1-block tail, a 2-block tail whose last digit lies in block 1, a 2-block
// tail whose second block holds no digit), each group is one search launch
// of its own instantiation (so each compiles one lane path and keeps its
// own registers), and one segment-reduce launch follows. When more than
// one group has rows, the groups' launches run on side streams forked from
// and joined back to the caller's stream, so that no group waits for
// another's last blocks. Rows differ in rem, k and lane count, which are
// run-time fields of the plan. Ragged rows: each row gets a share of its
// group's blocks (the host's block table, proportional to its runs of
// valid lanes), and its blocks stride over those runs. The R-row plan
// table (49 words a row, 185 under K4) lies in device memory (one copy per
// batch); a block copies its row's plan into shared memory once. A block
// writes one partial key into its group's own slots; the reduce gives
// each segment one block, which reduces the partials of the segment's
// rows. No atomics; an empty segment, or one whose rows have no valid
// lane, comes out as the all-ones sentinel.
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
// K6's mesh bodies replace the JAX package's pallas_devloop_scan and
// pallas_devloop_until_scan (ops/sha256_pallas.py) with the pmin merge and
// the fold around them in the shard_map bodies of parallel/mesh_search.py
// (mesh_devloop_span, mesh_devloop_span_until): a block's valid window is
// cut into contiguous ascending shard windows, one per entry of the mesh.
// Each shard runs K1's search (the arg-min chain) or K2's chained search
// with a reduce into the shard's own 5-word row (the until chain: no lane
// work once the carry on its device says an earlier block hit), and one
// fold launch per device merges the n rows into the exact lexicographic
// minimum (and the lowest first hit) and folds it into that device's copy
// of the carry (mesh_fold_argmin_kernel, mesh_fold_until_kernel). The fold
// is the whole-mesh merge of the TPU's replicated carry; on one card with
// repeated shards it runs once. It reads n x 20 bytes at most: launch
// latency bounds it, so one thread does it.
//
// The TPU's shards run in lockstep and take the pmin after every shard has
// scanned its whole window; the contract is only the block's first
// qualifying lane (or, with none, its arg-min), so here the until shards
// of a block share one lowest-hit word on each card, and across cards a
// hit also lowers every other card's word, written over NVLink through
// peer pointers (reads stay local). The windows ascend with the shard, so
// every lane of a shard that starts above a stored hit lies above it: its
// warps take no run (starts_above_hit), and the shard costs one launch
// and no hash. That is K2's early exit across shards, sound for K2's reason:
// the word only ever holds a qualifying lane of this block. It is reset
// once a block, before the block's first shard on that card; across cards
// no late hit of block b can land after the reset for b + 1, because that
// reset follows, on the card's stream, its fold of block b, which waits
// for every card's shards of b (the row copies are ordered on both cards'
// streams).
// Bounds: the arg-min chain has no early exit, the lane work of K1; the
// until chain to a hit, the lanes of K2 up to it, as in one launch.
//
// What bounds them: integer instruction issue, and within it the INT32
// pipe. A lane reads no memory (the plan travels by value as a kernel
// parameter, the round constants sit in the constant bank) and a block
// writes 12 bytes, so the work is the ~1,400 to ~3,000 integer
// instructions of one or two compressions per lane. An SM issues at most
// 128 lanes' instructions a clock, but the rotates (SHF) and the logic
// (LOP3) run only on the INT32 pipe, 64 lanes a clock; the adds and shifts
// that the pipe helpers below move go to the FMA pipe (IMAD, 64 more), and
// a rotate could go there too, as two IMADs. So a lane's count bounds it
// twice: all its instructions at 128 a clock, and the two pipes' loads at
// 64 each with the rotates split between them so that the slower pipe is
// as fast as it can be. As this source places them, K1's 1-block lane
// issues 74% of its instructions on the INT32 pipe, which caps issue at
// about 68% of 128 a clock; it runs at 58% of 128 and the INT32 pipe at
// about 86% of its 64
// (NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py): a round's serial
// dependences, not one pipe, set the pace. K2 adds a compare a lane and,
// a grab of runs, one atomic (see "K2's early exit"). K5 reads its row's
// plan (under K4, the hoist too) from shared memory instead of the
// parameter bank. K2 and K5 ask for 2 resident blocks a SM (their
// __launch_bounds__), which leaves a lane 90 to 128 registers: they ran
// faster so than at 3 or 4 blocks with fewer registers.
//
// Design. The TPU grid runs its steps in order and carries accumulators from
// step to step; GPU blocks run in parallel in no order. So each thread walks
// its lanes i0 + tid, i0 + tid + stride, ... in ascending order with a
// running strict-less minimum (in runs of lanes, see walk_runs), a
// warp-shuffle and then a shared-memory min reduce each block to one
// partial on the full (hi, lo, idx) key, and a second one-block kernel
// reduces the partials on the device. The answer cannot depend on the
// order in which blocks run, nor on the grid size.
//
// K2's early exit. The TPU kernel skips its later grid steps on a bare
// found flag, which is sound only because its grid runs in order. Here a
// later block may hit first, so a flag would let it hide an earlier hit.
// Instead a qualifying lane does atomicMin on one device word f_min (reset
// to all-ones before every launch), and a thread stops as soon as its next
// run starts above the lowest hit it has read. Only lanes above a hit that
// some thread has found are skipped, and that never passes over the true
// first qualifier. K2's runs are handed out in ascending order from a
// device counter, not by thread index: an SM does not run its resident
// blocks at one pace, and a hit whose lanes a slow block owns would
// otherwise be found late. Neither the counter nor the lowest hit stands
// in front of a run (see UntilWalk): a warp's leader takes 32 x kGrab
// runs with one atomic (in step j of the grab, lane l works its run 32 j +
// l, so runs still ascend within a grab and grabs with the counter), and
// it takes the next grab before the warp works the current one, so the
// atomic's answer arrives during the lane work. A thread reads the lowest
// hit with a relaxed load one run ahead and cuts its next run at that
// value. A value one run stale is safe: it is a hit some thread found, so
// cutting at it skips no lane at or below the lowest qualifying lane; it
// only may leave a few lanes above it computed. Both device words, the
// lowest hit and the counter (kept as its complement), start at all-ones:
// one 8-byte memset resets them (a mesh shard after its card's first of a
// block resets only the counter: the lowest hit is the block's).
//
// The lane body. Every search entry above runs one of three bodies,
// chosen when the library is built (DBMT_BODY; the wrapper builds one
// library per body from this file, in parallel):
//
// 0, rolled (K1's): the tail's blocks compressed whole from the midstate,
//    the run's digits placed into the template's words by their run-time
//    word once per run, and each lane's last digit added to every word
//    with its weight there (zero but in the last digit's word), one IMAD
//    a word; when the last digit lies in the second block, the first
//    block is compressed once per run.
// 1, peel (K3): replaces the peel branch of _kernel_body in
//    ops/sha256_pallas.py (peel on, hoist off). The same function:
//    the rounds of block 0 before its first digit word t* = rem >> 2 read
//    only constant words, so each thread runs them once, before its lane
//    loop (the TPU ran them on its scalar plane); a lane enters block 0 at
//    round t*, with the digit words at fixed places and no schedule math
//    in rounds t*..15; the rest is the full schedule.
// 2, peel fed by the host hoist (K4): replaces _peel_hoisted
//    (peel on, hoist on). The plan carries the host's HoistPlan
//    operands: block 0 enters round t* at the host's deep state, rounds
//    t*..15 add the lane's digits to the host's K[j] + W[j], the
//    expanded words 16..31 compute only their lane-varying taps on top of
//    the host's constant part (cw), and a digit-free second block runs its
//    64 rounds off the host's K[t] + W[t] (ckw) with no schedule math.
//
// Which words and taps vary is fixed per (rem, k) on the TPU, which
// compiles one kernel per pair; here rem and k are run-time plan fields
// (K5 mixes them in one launch). Bodies 1 and 2 therefore hold one
// straight-line copy of block 0's head per shape, built at compile time
// from the same constancy analysis as the host's hoist_structure: per
// t* for K3, per (t*, digit words in block 0) for K4, and per spill shape
// for a second block that holds digits. A lane jumps to its shape's copy
// through one switch on a warp-uniform value, so skipped rounds and
// constant taps cost no per-lane ALU work. The tail's shape is every
// body's template parameter (the variant, tail_variant): a 1-block tail, a
// 2-block tail whose last digit lies in block 1, a 2-block tail whose
// second block holds no digit; each instantiation compiles one lane path.
// Only digest words 0 and 1 leave a body, so the compiler drops round
// 63's e update and the other six feed-forward adds in every body.
//
// The digits are built once per run of 10 lanes (walk_runs) and, when the
// last digit lies in a second tail block, every body compresses the first
// block once per run.

#include <cstdint>
#include <cstring>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Shards a mesh fold takes at most.
constexpr int kMeshRowsMax = 1024;

#ifndef DBMT_BODY
#define DBMT_BODY 0
#endif
static_assert(DBMT_BODY >= 0 && DBMT_BODY <= 2, "DBMT_BODY: 0, 1 or 2");

// The host plan, by value: 49 uint32 words in this order, then for K4 the
// host hoist's 136 in the TPU kernel's order (deep, kw, cw, ckw), the
// per-block sections padded to two blocks.
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
#if DBMT_BODY == 2
  uint32_t deep[8];    // block 0's round state after rounds 0..t*-1
  uint32_t kw[32];     // K[j] + W[j], rounds 0..15 of each block
  uint32_t cw[32];     // constant part of w[16..31] of each block
  uint32_t ckw[64];    // K[t] + W[t] of a digit-free block (else 0)
#endif
};
constexpr int kPlanWords = DBMT_BODY == 2 ? 49 + 136 : 49;
static_assert(sizeof(Plan) == kPlanWords * sizeof(uint32_t), "plan layout");

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

__host__ __device__ __forceinline__ Key sentinel() {
  return Key{~0u, ~0u, ~0u};
}

__host__ __device__ __forceinline__ bool key_less(const Key& a,
                                                  const Key& b) {
  if (a.hi != b.hi) return a.hi < b.hi;
  if (a.lo != b.lo) return a.lo < b.lo;
  return a.idx < b.idx;
}

__host__ __device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(x, x, n);
#else
  return (x >> n) | (x << ((32 - n) & 31));
#endif
}

// ------------------------------------------------------ the two integer pipes
//
// The helpers, the round and schedule code, digit_field and the run walk
// are host and device code; the lane bodies (which read the round
// constants in the constant bank) are device code. The CPU tests compile
// all of it with a host C++ compiler, through a shim for the CUDA names.
//
// An H100 SM issues 128 lanes' instructions a clock (four schedulers, one
// warp instruction each), but its INT32 pipe takes 64: SHF, LOP3, IADD3,
// ISETP, SEL. IMAD runs beside it on the FMA pipe, 64 more a clock. Left to
// ptxas, a SHA-256 lane puts nearly all its work on the INT32 pipe (the
// parent design's K1: 1,498 of 1,686 instructions a nonce, NVIDIA H100
// 80GB HBM3 at 700 W), so that pipe alone set the pace. These helpers put
// chosen adds and shifts on the FMA pipe: an add as IMAD a * kOne + b, a
// right shift as the high word of a product (IMAD.HI). kOne is 1 in the
// constant bank, where the host could change it, so ptxas cannot fold the
// multiplier back into an IADD3 or a shift. On the host they are plain C++.
//
// The split moves only what costs no extra instruction or sits off a
// round's critical path: the schedule's shifts (1 IMAD.HI for 1 SHF), the
// 2-input adds (1 IMAD for 1 IADD3: e = d + t1, K + W, the schedule's
// plain taps) and h + K + W, which is known a round early. The rotates,
// the logic and the 3-input adds on the critical path stay on the INT32
// pipe: a round is 10 INT32 instructions and 2 IADD3 against 3 IMAD. The
// INT32 pipe then carries about three quarters of a lane's instructions,
// neither pipe is full, and a round's chain of dependences sets the pace
// (see "What bounds them" above). Moving more (all the
// adds, as 2-input IMADs, or a rotate as IMAD.SHL and IMAD.HI) balanced
// the pipes exactly but added instructions and latency to the critical
// path, and ran slower on the card (chip_smoke.py reports the split it
// measures, as `pipes`).
__constant__ uint32_t kOne = 1u;

// a + b on the FMA pipe.
__host__ __device__ __forceinline__ uint32_t fadd(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(kOne), "r"(b));
  return d;
#else
  return a + b;
#endif
}

// a * b + c on the FMA pipe (ptxas may not turn it into a select and an
// add when b is 0 or a power of two).
__host__ __device__ __forceinline__ uint32_t fmad(uint32_t a, uint32_t b,
                                                  uint32_t c) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
#else
  return a * b + c;
#endif
}

// x >> N (0 < N < 32) on the FMA pipe: the high word of x * 2^(32 - N).
template <int N>
__host__ __device__ __forceinline__ uint32_t fshr(uint32_t x) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("mul.hi.u32 %0, %1, %2;" : "=r"(d) : "r"(x), "r"(kOne << (32 - N)));
  return d;
#else
  return x >> N;
#endif
}

struct State {
  uint32_t a, b, c, d, e, f, g, h;
};

// One round, given its first add A = h + K[t] + W[t]. The rotates and the
// logic stay on the INT32 pipe, and so do the two 3-input adds on the
// round's critical path (t1 = A + ch + S1, a = t1 + S0 + maj); e = d + t1
// goes to the FMA pipe.
__host__ __device__ __forceinline__ void round_from(State& s, uint32_t A) {
  const uint32_t S1 = rotr(s.e, 6) ^ rotr(s.e, 11) ^ rotr(s.e, 25);
  const uint32_t ch = s.g ^ (s.e & (s.f ^ s.g));
  const uint32_t t1 = A + ch + S1;
  const uint32_t S0 = rotr(s.a, 2) ^ rotr(s.a, 13) ^ rotr(s.a, 22);
  const uint32_t maj = (s.a & (s.b ^ s.c)) ^ (s.b & s.c);
  s.h = s.g;
  s.g = s.f;
  s.f = s.e;
  s.e = fadd(s.d, t1);
  s.d = s.c;
  s.c = s.b;
  s.b = s.a;
  s.a = t1 + S0 + maj;
}

// One round; kw is K[t] + W[t]. h + kw is off the critical path (h is the
// state's g of the round before) and goes to the FMA pipe.
__host__ __device__ __forceinline__ void sha_round(State& s, uint32_t kw) {
  round_from(s, fadd(s.h, kw));
}

// One round whose K[t] + W[t] is w + k, w varying per lane: the add goes
// to the FMA pipe.
__host__ __device__ __forceinline__ void sha_round(State& s, uint32_t w,
                                                   uint32_t k) {
  sha_round(s, fadd(w, k));
}

__host__ __device__ __forceinline__ uint32_t ssig0(uint32_t x) {
  return rotr(x, 7) ^ rotr(x, 18) ^ fshr<3>(x);
}

__host__ __device__ __forceinline__ uint32_t ssig1(uint32_t x) {
  return rotr(x, 17) ^ rotr(x, 19) ^ fshr<10>(x);
}

// Schedule word t from w[t-16], w[t-15], w[t-7], w[t-2]: the shifts of
// s0 and s1 and the add of the two plain taps (known a round or more
// early) on the FMA pipe, the rest one 3-input add.
__host__ __device__ __forceinline__ uint32_t sched(uint32_t w16, uint32_t w15,
                                                   uint32_t w7, uint32_t w2) {
  return fadd(w16, w7) + ssig0(w15) + ssig1(w2);
}

// One compression of the 16 words w into the state st (feed-forward added).
__device__ __forceinline__ void compress(uint32_t st[8],
                                                  uint32_t w[16]) {
  State s{st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7]};
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {  // the in-place mod-16 schedule window
      w[t & 15] = sched(w[t & 15], w[(t + 1) & 15], w[(t + 9) & 15],
                        w[(t + 14) & 15]);
    }
    sha_round(s, w[t & 15], kK[t]);
  }
  st[0] += s.a;
  st[1] += s.b;
  st[2] += s.c;
  st[3] += s.d;
  st[4] += s.e;
  st[5] += s.f;
  st[6] += s.g;
  st[7] += s.h;
}

// The k ASCII digits of lane i in bytes s .. s+k-1 of a 12-byte field
// whose three big-endian words are q0, q1, q2 (the rest zero).
__host__ __device__ __forceinline__ void digit_field(uint32_t i, uint32_t k,
                                                     uint32_t s, uint32_t& q0,
                                                     uint32_t& q1,
                                                     uint32_t& q2) {
  q0 = 0u;
  q1 = 0u;
  q2 = 0u;
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
}

// ------------------------------------------------------------ runs of lanes
//
// A thread takes whole runs of kRun lanes, kRun m .. kRun m + kRun - 1,
// which share every digit but the last: the lane body builds the digits
// once per run (digit_field on the run's base, whose last digit is '0'),
// and lane base + d enters with one multiply-add of d times the last
// digit's byte weight into its word (the byte goes from '0' to '9' with no
// carry). Runs are cut to the valid window [first, last] once, so no lane
// tests lo_i or hi_i. A thread's runs ascend and so do the lanes of a run,
// so a strict-less running minimum keeps the earliest nonce of a tie. 10
// rather than 100: in K1's 1-block SASS the run loop outside the lane loop
// is about 380 instructions, 38 a nonce at 10 lanes against a lane loop of
// about 1,500 (NVIDIA H100 80GB HBM3 build, chip_smoke.py). A run of 100
// would save at most 34 of them, 2%, for a second varying digit and one
// more loop level.
constexpr uint32_t kRun = 10u;

// Calls visit(base, dlo, dhi) for the runs of [first, last] that thread t of
// `stride` threads takes (runs t, t + stride, ... counted from the run of
// first), in ascending order, each cut to lanes base + [dlo, dhi]; stops
// when visit returns false. Nothing when first > last.
template <class Visit>
__host__ __device__ __forceinline__ void walk_runs(uint32_t first,
                                                   uint32_t last, uint32_t t,
                                                   uint32_t stride,
                                                   Visit&& visit) {
  if (first > last) return;
  const uint32_t r_last = last / kRun;
  for (uint32_t r = first / kRun + t; r <= r_last; r += stride) {
    const uint32_t base = r * kRun;
    const uint32_t dlo = base < first ? first - base : 0u;
    const uint32_t dhi = last - base < kRun - 1u ? last - base : kRun - 1u;
    if (!visit(base, dlo, dhi)) return;
  }
}

// The plan's valid lanes [first, last] (first > last: none). The launcher
// keeps i0 + n - 1 within 32 bits.
__host__ __device__ __forceinline__ void valid_lanes(const Plan& p,
                                                     uint32_t& first,
                                                     uint32_t& last) {
  first = p.lo_i > p.i0 ? p.lo_i : p.i0;
  last = p.n == 0u ? 0u : p.i0 + p.n - 1u;
  if (p.hi_i < last) last = p.hi_i;
  if (p.n == 0u) first = 1u;
}

// ------------------------------------------------------- the peeled bodies

// The shape of a tail, from rem and k (ops/sha256_torch.py::
// hoist_structure): variant 0 is a 1-block tail, 1 a 2-block tail with
// digits in both blocks, 2 a 2-block tail whose second block holds none.
// In variant 1, and only there, the last digit lies in block 1.
__host__ __device__ constexpr int tail_variant(int rem, int k) {
  return rem + k + 9 <= 64 ? 0 : ((rem + k - 1) >> 2) <= 15 ? 2 : 1;
}

// Digit words of block 0: t* = rem >> 2 up to the last one below 16.
__host__ __device__ constexpr int block0_width(int rem, int k) {
  return (((rem + k - 1) >> 2) < 15 ? ((rem + k - 1) >> 2) : 15) -
         (rem >> 2) + 1;
}

// Whether some (rem, k) of the variant has t* = a and w0 digit words in
// block 0 (w0 = 0: any number of them).
__host__ __device__ constexpr bool shape_occurs(int variant, int a, int w0) {
  for (int s = 0; s < 4; ++s) {
    for (int k = 1; k <= 9; ++k) {
      const int v = tail_variant(4 * a + s, k);
      if (v == variant && (w0 == 0 || block0_width(4 * a + s, k) == w0)) {
        return true;
      }
    }
  }
  return false;
}

// Bit t of the result: schedule word t (0..31) of a block varies per lane,
// its window words first .. first+width-1 carrying the digits
// (hoist_structure's recurrence: a word varies when one of its taps does).
__host__ __device__ constexpr uint32_t varying_words(int first, int width) {
  uint32_t v = 0u;
  for (int t = 0; t < 32; ++t) {
    const bool var =
        t < 16 ? (t >= first && t < first + width)
               : (((v >> (t - 16)) | (v >> (t - 15)) | (v >> (t - 7)) |
                   (v >> (t - 2))) & 1u) != 0u;
    v |= var ? 1u << t : 0u;
  }
  return v;
}

// Words 16..31 of a block's schedule into W from its window x[0..15]. K3
// expands every word (taps on constant words fold at compile time where the
// words are the plan's); K4 starts from the host's constant part cw and
// adds only the taps whose source word varies (mask: varying_words).
template <int BODY, uint32_t MASK>
__host__ __device__ __forceinline__ void expand_16_31(uint32_t (&x)[32],
                                                      const uint32_t* cw,
                                                      uint32_t (&W)[16]) {
#pragma unroll
  for (int t = 16; t < 32; ++t) {
    if constexpr (BODY == 2) {
      uint32_t acc = cw[t - 16];
      if ((MASK >> (t - 16)) & 1u) acc = fadd(acc, x[t - 16]);
      if ((MASK >> (t - 15)) & 1u) acc = fadd(acc, ssig0(x[t - 15]));
      if ((MASK >> (t - 7)) & 1u) acc = fadd(acc, x[t - 7]);
      if ((MASK >> (t - 2)) & 1u) acc = fadd(acc, ssig1(x[t - 2]));
      x[t] = acc;
    } else {
      x[t] = sched(x[t - 16], x[t - 15], x[t - 7], x[t - 2]);
    }
    W[t - 16] = x[t];
  }
}

// Block 0 of lane i for t* = A (and, for K4, W0 digit words in block 0):
// from the entry state (the round state after rounds 0..A-1), rounds
// A..15 with the digit words q0..q2 at A..A+2 (K4: only the W0 that lie in
// block 0) and no schedule math, then words 16..31 of the schedule into W.
template <int BODY, int A, int W0>
__device__ __forceinline__ void block0_head(const Plan& p,
                                                     const uint32_t* entry,
                                                     uint32_t q0, uint32_t q1,
                                                     uint32_t q2, State& st,
                                                     uint32_t (&W)[16]) {
  st = State{entry[0], entry[1], entry[2], entry[3],
             entry[4], entry[5], entry[6], entry[7]};
  constexpr int kLast = W0 > 0 ? A + W0 - 1 : A + 2;  // last digit word
  uint32_t x[32];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const bool digits = j >= A && j <= kLast;
    const uint32_t qj = j == A ? q0 : j == A + 1 ? q1 : q2;
    x[j] = digits ? (p.tmpl[j] | qj) : p.tmpl[j];
    if (j >= A) {
#if DBMT_BODY == 2
      if (digits) {
        sha_round(st, qj, p.kw[j]);
      } else {
        sha_round(st, p.kw[j]);
      }
#else
      sha_round(st, x[j], kK[j]);
#endif
    }
  }
#if DBMT_BODY == 2
  expand_16_31<BODY, varying_words(A, W0)>(x, p.cw, W);
#else
  expand_16_31<BODY, 0u>(x, nullptr, W);
#endif
}

// Rounds 16..63 of a block whose schedule words 16..31 are W (the window
// then rolls in place, mod 16).
__device__ __forceinline__ void rounds_16_63(State& st,
                                                      uint32_t (&W)[16]) {
#pragma unroll
  for (int t = 16; t < 32; ++t) sha_round(st, W[t - 16], kK[t]);
#pragma unroll
  for (int t = 32; t < 64; ++t) {
    W[t & 15] = sched(W[t & 15], W[(t + 1) & 15], W[(t + 9) & 15],
                      W[(t + 14) & 15]);
    sha_round(st, W[t & 15], kK[t]);
  }
}

#define DBMT_FOR_EACH_T(X, W0) \
  X(0, W0) X(1, W0) X(2, W0) X(3, W0) X(4, W0) X(5, W0) X(6, W0) X(7, W0) \
  X(8, W0) X(9, W0) X(10, W0) X(11, W0) X(12, W0) X(13, W0) X(14, W0)    \
  X(15, W0)

// Block 0 through round 31's schedule word, by shape: `shape` is 4 t* + w0
// for K4, 4 t* for K3 (a warp-uniform value), one copy per shape of the
// variant.
template <int VARIANT>
__device__ __forceinline__ void block0(const Plan& p,
                                                const uint32_t* entry,
                                                int shape, uint32_t q0,
                                                uint32_t q1, uint32_t q2,
                                                State& st,
                                                uint32_t (&W)[16]) {
  switch (shape) {
#define DBMT_SHAPE(A, W0)                                             \
  case 4 * A + W0:                                                    \
    if constexpr ((DBMT_BODY == 2) == (W0 > 0) &&                     \
                  shape_occurs(VARIANT, A, W0)) {                     \
      block0_head<DBMT_BODY, A, W0>(p, entry, q0, q1, q2, st, W);     \
    }                                                                 \
    break;
#if DBMT_BODY == 2
    DBMT_FOR_EACH_T(DBMT_SHAPE, 1)
    DBMT_FOR_EACH_T(DBMT_SHAPE, 2)
    DBMT_FOR_EACH_T(DBMT_SHAPE, 3)
#else
    DBMT_FOR_EACH_T(DBMT_SHAPE, 0)
#endif
#undef DBMT_SHAPE
    default:
      break;
  }
}

#if DBMT_BODY == 2
// K4's second block when it holds digits (variant 1; t* = A is 14 or 15):
// field word r (q_r) sits at tail word A + r, so block 1's word m gets
// field word 16 + m - A; its W1 digit words are 0 .. W1-1. Rounds 0..15
// off the host's K + W, words 16..31 off the host's cw.
template <int A, int W1>
__device__ __forceinline__ void block1_head(const Plan& p,
                                                     uint32_t q1, uint32_t q2,
                                                     State& st,
                                                     uint32_t (&W)[16]) {
  uint32_t x[32];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const bool digits = j < W1;   // field word 16 + j - A: 1 or 2
    const uint32_t qj = 16 + j - A == 1 ? q1 : q2;
    x[j] = digits ? (p.tmpl[16 + j] | qj) : p.tmpl[16 + j];
    if (digits) {
      sha_round(st, qj, p.kw[16 + j]);
    } else {
      sha_round(st, p.kw[16 + j]);
    }
  }
  expand_16_31<2, varying_words(0, W1)>(x, p.cw + 16, W);
}
#endif

// A lane body under the library's body for the variant's tail shape. The
// per-thread part (the shape, the last digit's word and weight, and K3's
// head rounds) is computed once, before the walk, by the constructor; the
// digits once per run (run); the rest per lane. In variant 1 the last
// digit lies in block 1, so the whole of block 0 is the same for every
// lane of a run, and run computes it once; in variant 2 a lane compresses
// its block 0 and then the digit-free block 1. Each variant is its own
// instantiation, so a kernel holds one of these paths and the registers
// it needs.
template <int VARIANT>
struct LaneBody {
  uint32_t s;    // rem & 3: the first digit's byte in its word
  int a;         // t* = rem >> 2
  int shape;     // block 0's shape (see block0)
  int shape1;    // K4, variant 1: block 1's spill shape
  uint32_t lw;   // the tail word of the last digit
  uint32_t inc;  // the last digit's byte weight in that word
#if DBMT_BODY == 1
  uint32_t entry[8];   // the state after block 0's rounds 0..t*-1
#endif

  __device__ __forceinline__ explicit LaneBody(const Plan& p)
      : s(p.rem & 3u),
        a(static_cast<int>((p.rem >> 2) & 15u)),
        lw((p.rem + p.k - 1u) >> 2),
        inc(1u << ((3u - ((p.rem + p.k - 1u) & 3u)) * 8u)) {
    const int rem = static_cast<int>(p.rem), k = static_cast<int>(p.k);
    shape = 4 * a + (DBMT_BODY == 2 ? block0_width(rem, k) : 0);
    shape1 = 2 * (a - 14) + ((rem + k - 1) >> 2) - 16;
#ifdef DBMT_FIXED_SHAPE
    // For reading the SASS only: with the shapes (and the last digit's
    // word) fixed at compile time a kernel's run and lane loops are the one
    // path that those shapes run.
    shape = DBMT_FIXED_SHAPE;
    shape1 = DBMT_FIXED_SHAPE1;
    lw = DBMT_FIXED_LW;
#endif
#if DBMT_BODY == 1
    State st{p.mid[0], p.mid[1], p.mid[2], p.mid[3],
             p.mid[4], p.mid[5], p.mid[6], p.mid[7]};
#pragma unroll 1
    for (int j = 0; j < a; ++j) sha_round(st, kK[j] + p.tmpl[j]);
    entry[0] = st.a;
    entry[1] = st.b;
    entry[2] = st.c;
    entry[3] = st.d;
    entry[4] = st.e;
    entry[5] = st.f;
    entry[6] = st.g;
    entry[7] = st.h;
#endif
  }

  // The lanes base + dlo .. base + dhi (dhi < kRun, in ascending order):
  // visit(key) for each, stopping after the first for which it returns
  // true.
  template <class Visit>
  __device__ __forceinline__ void run(const Plan& p, uint32_t base,
                                               uint32_t dlo, uint32_t dhi,
                                               Visit&& visit) const {
    uint32_t q[3];
    digit_field(base, p.k, s, q[0], q[1], q[2]);
#if DBMT_BODY == 0
    // The tail words that can hold a digit (t* <= 15), with the run's
    // digits, and the weight of lane d's last digit in each.
    constexpr int kWords = VARIANT == 1 ? 18 : 16;
    uint32_t wb[kWords], e[kWords];
#pragma unroll
    for (int m = 0; m < kWords; ++m) {
      const int off = m - a;
      wb[m] = p.tmpl[m] | (off == 0 ? q[0] : off == 1 ? q[1]
                                           : off == 2 ? q[2] : 0u);
      e[m] = static_cast<uint32_t>(m) == lw ? inc : 0u;
    }
    if constexpr (VARIANT == 1) {
      uint32_t st0[8], w0[16];
#pragma unroll
      for (int r = 0; r < 8; ++r) st0[r] = p.mid[r];
#pragma unroll
      for (int m = 0; m < 16; ++m) w0[m] = wb[m];
      compress(st0, w0);
#pragma unroll 1
      for (uint32_t d = dlo; d <= dhi; ++d) {
        uint32_t st[8], w[16];
#pragma unroll
        for (int r = 0; r < 8; ++r) st[r] = st0[r];
        w[0] = fmad(d, e[16], wb[16]);
        w[1] = fmad(d, e[17], wb[17]);
#pragma unroll
        for (int m = 2; m < 16; ++m) w[m] = p.tmpl[16 + m];
        compress(st, w);
        if (visit(Key{st[0], st[1], base + d})) return;
      }
      return;
    }
#pragma unroll 1
    for (uint32_t d = dlo; d <= dhi; ++d) {
      uint32_t st[8], w[16];
#pragma unroll
      for (int r = 0; r < 8; ++r) st[r] = p.mid[r];
#pragma unroll
      for (int m = 0; m < 16; ++m) w[m] = fmad(d, e[m], wb[m]);
      compress(st, w);
      if constexpr (VARIANT != 0) {  // a second block without digits
#pragma unroll
        for (int m = 0; m < 16; ++m) w[m] = p.tmpl[16 + m];
        compress(st, w);
      }
      if (visit(Key{st[0], st[1], base + d})) return;
    }
#else
    // The field word that holds the last digit gets d times its weight.
    uint32_t e[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      e[r] = static_cast<uint32_t>(a + r) == lw ? inc : 0u;
    }
#if DBMT_BODY == 1
    const uint32_t* entry0 = entry;
#else
    const uint32_t* entry0 = p.deep;
#endif
    if constexpr (VARIANT == 1) {
      // Block 0 holds field words 0 and, at t* = 14, 1: none varies.
      State st;
      uint32_t W[16];
      block0<VARIANT>(p, entry0, shape, q[0], q[1], q[2], st, W);
      rounds_16_63(st, W);
      const uint32_t out0[8] = {p.mid[0] + st.a, p.mid[1] + st.b,
                                p.mid[2] + st.c, p.mid[3] + st.d,
                                p.mid[4] + st.e, p.mid[5] + st.f,
                                p.mid[6] + st.g, p.mid[7] + st.h};
#pragma unroll 1
      for (uint32_t d = dlo; d <= dhi; ++d) {
        const uint32_t q1 = fmad(d, e[1], q[1]), q2 = fmad(d, e[2], q[2]);
#if DBMT_BODY == 1
        // Block 1 in full; the digit field spills into its words 0 and 1
        // when t* is 15 (q1, q2) or 14 (q2).
        uint32_t w[16];
#pragma unroll
        for (int m = 0; m < 16; ++m) w[m] = p.tmpl[16 + m];
        w[0] |= a == 15 ? q1 : q2;
        w[1] |= a == 15 ? q2 : 0u;
        uint32_t s8[8] = {out0[0], out0[1], out0[2], out0[3],
                          out0[4], out0[5], out0[6], out0[7]};
        compress(s8, w);
        if (visit(Key{s8[0], s8[1], base + d})) return;
#else
        State s1{out0[0], out0[1], out0[2], out0[3],
                 out0[4], out0[5], out0[6], out0[7]};
        switch (shape1) {
          case 0:
            block1_head<14, 1>(p, q1, q2, s1, W);
            break;
          case 2:
            block1_head<15, 1>(p, q1, q2, s1, W);
            break;
          case 3:
            block1_head<15, 2>(p, q1, q2, s1, W);
            break;
          default:
            break;
        }
        rounds_16_63(s1, W);
        if (visit(Key{out0[0] + s1.a, out0[1] + s1.b, base + d})) return;
#endif
      }
      return;
    }
#pragma unroll 1
    for (uint32_t d = dlo; d <= dhi; ++d) {
      const uint32_t q0 = fmad(d, e[0], q[0]), q1 = fmad(d, e[1], q[1]),
                     q2 = fmad(d, e[2], q[2]);
      State st;
      uint32_t W[16];
      block0<VARIANT>(p, entry0, shape, q0, q1, q2, st, W);
      rounds_16_63(st, W);
      if constexpr (VARIANT == 0) {
        if (visit(Key{p.mid[0] + st.a, p.mid[1] + st.b, base + d})) return;
      } else {  // a second block without digits
        const uint32_t out0[8] = {p.mid[0] + st.a, p.mid[1] + st.b,
                                  p.mid[2] + st.c, p.mid[3] + st.d,
                                  p.mid[4] + st.e, p.mid[5] + st.f,
                                  p.mid[6] + st.g, p.mid[7] + st.h};
#if DBMT_BODY == 1
        uint32_t w[16];
#pragma unroll
        for (int m = 0; m < 16; ++m) w[m] = p.tmpl[16 + m];
        uint32_t s8[8] = {out0[0], out0[1], out0[2], out0[3],
                          out0[4], out0[5], out0[6], out0[7]};
        compress(s8, w);
        if (visit(Key{s8[0], s8[1], base + d})) return;
#else
        st = State{out0[0], out0[1], out0[2], out0[3],
                   out0[4], out0[5], out0[6], out0[7]};
#pragma unroll
        for (int t = 0; t < 64; ++t) sha_round(st, p.ckw[t]);
        if (visit(Key{out0[0] + st.a, out0[1] + st.b, base + d})) return;
#endif
      }
    }
#endif
  }
};

// K2's work on one run of a thread's walk, given the lowest hit the thread
// has read (all-ones: none): none when the run starts above it (so do all
// the thread's later runs: returns false, the walk stops); else the run,
// cut at that hit, each lane's key into best and, at the run's first lane
// below the target, hit(lane), and the run and the walk stop there. Only
// lanes above a found hit are skipped, so the lowest qualifying lane is
// never passed over.
template <class Body, class Hit>
__device__ __forceinline__ bool until_run(const Body& body, const Plan& p,
                                          uint32_t base, uint32_t dlo,
                                          uint32_t dhi, uint32_t lowest,
                                          Key& best, Hit&& hit) {
  if (base + dlo > lowest) return false;
  if (lowest - base < dhi) dhi = lowest - base;
  bool found = false;
  body.run(p, base, dlo, dhi, [&](const Key& cand) {
    if (key_less(cand, best)) best = cand;
    found = cand.hi < p.t_hi || (cand.hi == p.t_hi && cand.lo < p.t_lo);
    if (found) hit(cand.idx);
    return found;
  });
  return !found;
}

// ------------------------------------------------------------- K2's walk
//
// K2's threads take their runs (counted from the run of the window's first
// lane) from a device counter, a warp at a time, in grabs of 32 x G runs:
// in step j of a grab that starts at run c, lane l of the warp works run
// c + 32 j + l. The warp's leader takes the next grab before the warp
// works the current one, so the counter's answer arrives during the lane
// work; and each lane reads the lowest hit one run ahead (see "K2's early
// exit" above). A larger G takes fewer atomics, but spreads a warp's runs
// further apart and leaves each lane more runs to check against the
// lowest hit. Over a 10^9 block and to a hit past its lane 10^8, G = 2, 4
// and 8 ran within 0.5% of each other and G = 1 up to 1.6% slower
// (NVIDIA H100 80GB HBM3 at 700 W, builds of this source with each G timed
// in turns).
constexpr uint32_t kGrab = 4;

// One warp's share of K2's walk over the runs of [first, last], for L of
// its lanes: on the card a thread holds its own lane (L = 1) and the warp
// meets in a shuffle and a vote; the CPU tests hold all 32 lanes of a warp
// in one object (L = 32) and step the warps in turn. `Warp` gives the
// lane's index in the warp, the leader's take of a grab (its first run;
// one atomic), its broadcast to the warp, the warp's vote, the relaxed
// load of the lowest hit and the report of a hit.
template <uint32_t G, int L>
struct UntilWalk {
  uint32_t first, last;
  uint32_t nruns;        // runs of [first, last]
  uint32_t cur;          // the first run of the grab the warp works next
  uint32_t lowest[L];    // each lane's lowest hit, as read a run ago
  bool live[L];          // whether the lane may still have work
  Key best[L];           // each lane's running minimum

  template <class Warp>
  __device__ __forceinline__ UntilWalk(uint32_t first_, uint32_t last_,
                                       Warp& warp)
      : first(first_), last(last_),
        nruns(last_ / kRun - first_ / kRun + 1u) {
    cur = warp.broadcast(warp.take(32u * G));
    for (int l = 0; l < L; ++l) {
      lowest[l] = warp.lowest();
      live[l] = true;
      best[l] = sentinel();
    }
  }

  // Lane l's runs of the grab at cur, ascending: false once the lane is
  // done (a run started above the lowest hit, the lane hit, or its runs
  // passed the window's end).
  template <class Body, class Warp>
  __device__ __forceinline__ bool work(const Body& body, const Plan& p, int l,
                                       Warp& warp) {
#pragma unroll 1
    for (uint32_t j = 0; j < G; ++j) {
      const uint32_t r = cur + 32u * j + warp.lane(l);
      if (r >= nruns) return false;
      const uint32_t base = (first / kRun + r) * kRun;
      const uint32_t dlo = base < first ? first - base : 0u;
      const uint32_t dhi = last - base < kRun - 1u ? last - base : kRun - 1u;
      const uint32_t seen = lowest[l];
      lowest[l] = warp.lowest();   // for the lane's next run
      if (!until_run(body, p, base, dlo, dhi, seen, best[l],
                     [&](uint32_t i) { warp.hit(i); })) {
        return false;
      }
    }
    return true;
  }

  // One grab: the next one taken, this one worked, the next one made
  // current. False when the warp is done: no run is left, or every lane
  // is done.
  template <class Body, class Warp>
  __device__ __forceinline__ bool step(const Body& body, const Plan& p,
                                       Warp& warp) {
    if (cur >= nruns) return false;
    const uint32_t next = warp.take(32u * G);
    bool any = false;
    for (int l = 0; l < L; ++l) {
      if (live[l]) live[l] = work(body, p, l, warp);
      any = any || live[l];
    }
    cur = warp.broadcast(next);
    return warp.vote(any);
  }
};

// Whether the lowest hit already lies below `first` (the leader's read
// stands for the warp, so the answer is warp-uniform): a mesh until
// shard whose window lies above a hit an earlier shard stored then starts
// no walk, so it takes no run (its counter says none were handed out) and
// hashes no lane. Checked before the walk, not in it: a read ahead of the
// first grab inside UntilWalk cost the shard's walk about 0.5% (NVIDIA
// H100 80GB HBM3 at 700 W, chip_smoke.py --against a build with it).
template <class Warp>
__device__ __forceinline__ bool starts_above_hit(uint32_t first,
                                                 Warp& warp) {
  return warp.broadcast(warp.lowest()) < first;
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

// ------------------------------------------------------------ carry folds
//
// Host and device code: the CPU tests compile this section with a host
// C++ compiler.

// Strict lexicographic a < b over n words (element 0 most significant).
__host__ __device__ __forceinline__ bool words_less(const uint32_t* a,
                                                    const uint32_t* b, int n) {
  for (int w = 0; w < n; ++w) {
    if (a[w] != b[w]) return a[w] < b[w];
  }
  return false;
}

// searchop.fold_argmin on the 5-word carry c = [hash_hi, hash_lo,
// nonce_hi, nonce_lo, seen]; the nonce is base + m.idx in 64 bits.
__host__ __device__ __forceinline__ void fold_argmin_words(uint32_t* c,
                                                           const Key& m,
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
__host__ __device__ __forceinline__ void fold_until_words(uint32_t* c,
                                                          uint32_t f_idx,
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

// K6's mesh bodies: the merge of the shards' results, the counterpart of the
// three staged pmins of the JAX package's parallel/mesh_search.py (and, in
// until mode, the pmin of f_idx). rows holds n rows of `width` words, one per
// shard in shard order: 3 (hi, lo, idx) in the arg-min chain, 5 (found,
// f_idx, hi, lo, idx) in the until chain, where f_idx alone says whether
// the shard hit. The shards' windows are disjoint and ascend with the row,
// so the lowest idx of a hash tie and the lowest f_idx are the earliest
// nonces; an empty shard's row is all-ones (found 0), which never wins.
// Returns the exact lexicographic (hi, lo, idx) minimum and, when f_min is
// given, the lowest f_idx.
__host__ __device__ __forceinline__ Key rows_min(const uint32_t* rows, int n,
                                                 int width, uint32_t* f_min) {
  Key best = sentinel();
  uint32_t f = ~0u;
  for (int r = 0; r < n; ++r) {
    const uint32_t* row = rows + width * r;
    const Key c{row[width - 3], row[width - 2], row[width - 1]};
    if (key_less(c, best)) best = c;
    if (width == 5 && row[1] < f) f = row[1];
  }
  if (f_min != nullptr) *f_min = f;
  return best;
}

// The arg-min chain's mesh fold: the n rows' minimum into the 5-word carry.
__host__ __device__ __forceinline__ void mesh_fold_argmin_words(
    uint32_t* c, const uint32_t* rows, int n, uint32_t base_hi,
    uint32_t base_lo) {
  fold_argmin_words(c, rows_min(rows, n, 3, nullptr), base_hi, base_lo);
}

// The until chain's mesh fold into the 8-word carry. Once c[0] says an
// earlier block hit, the shards did no lane work and the carry stays as it
// is (the single-device chain's rule).
__host__ __device__ __forceinline__ void mesh_fold_until_words(
    uint32_t* c, const uint32_t* rows, int n, uint32_t base_hi,
    uint32_t base_lo) {
  if (c[0] != 0u) return;
  uint32_t f_idx;
  const Key m = rows_min(rows, n, 5, &f_idx);
  fold_until_words(c, f_idx, m, base_hi, base_lo);
}

// ------------------------------------------------------------ K5's table
//
// Host and device code: the CPU tests read a table the wrapper built
// through it.

// K5's table, one buffer of int32 words, in this order: the nrows plans of
// kPlanWords words each; pstart[nrows] and pcount[nrows], each row's
// partial slots; seg_rows[nsegs + 1], where each segment's rows begin;
// then for each group g = 0, 1, 2 (the rows of variant g) its rows[n[g]]
// and its block prefix blk[n[g] + 1] (blk[n[g]] blocks in all). Group g's
// partial slots follow group g - 1's.
struct SegminTable {
  const uint32_t* plans;
  const int* pstart;
  const int* pcount;
  const int* seg_rows;
  const int* rows[3];
  const int* blk[3];

  __host__ __device__ SegminTable(const int* table, int nrows, int nsegs,
                                  const int* n)
      : plans(reinterpret_cast<const uint32_t*>(table)),
        pstart(table + kPlanWords * nrows),
        pcount(pstart + nrows),
        seg_rows(pcount + nrows) {
    const int* at = seg_rows + nsegs + 1;
    for (int g = 0; g < 3; ++g) {
      rows[g] = at;
      blk[g] = at + n[g];
      at = blk[g] + n[g] + 1;
    }
  }
};

// ------------------------------------------------------------ kernels

template <int VARIANT>
__global__ void __launch_bounds__(kThreads)
    sha256_argmin_kernel(const Plan p, uint32_t* __restrict__ partials) {
  const LaneBody<VARIANT> body(p);
  uint32_t first, last;
  valid_lanes(p, first, last);
  Key best = sentinel();
  walk_runs(first, last, blockIdx.x * blockDim.x + threadIdx.x,
            gridDim.x * blockDim.x,
            [&](uint32_t base, uint32_t dlo, uint32_t dhi) {
              body.run(p, base, dlo, dhi, [&](const Key& cand) {
                if (key_less(cand, best)) best = cand;
                return false;
              });
              return true;
            });
  write_partial(best, partials);
}

// The lowest-hit words of a mesh's other cards, where a mesh until shard's
// hits also go. Peer pointers under unified virtual addressing, to memory
// this card was given access to (dbmt_enable_peer_access). A box holds at
// most 8 cards.
constexpr int kMaxPeers = 7;

struct Peers {
  uint32_t* word[kMaxPeers];
  int n;
};

// Peers from a host array of n device pointers (false when n is out of
// range).
bool read_peers(uint32_t* const* words, int n, Peers& out) {
  out = Peers{};
  if (n < 0 || n > kMaxPeers || (n > 0 && words == nullptr)) return false;
  for (int j = 0; j < n; ++j) out.word[j] = words[j];
  out.n = n;
  return true;
}

// K2's warp on the card (see UntilWalk): a thread holds its own lane.
// f_min[0] is the lowest qualifying lane found so far (all-ones: none),
// f_min[1] the complement of the runs handed out (all-ones: none yet).
// SHARED (the chained launches: K6's chain and the mesh's until shards):
// the lowest hit may also be written by other cards, so it is read and
// written at system scope, and a hit also goes to every peer's word.
template <bool SHARED>
struct CardWarp {
  uint32_t* f_min;
  const Peers& peers;

  __device__ __forceinline__ uint32_t lane(int) const {
    return threadIdx.x & 31u;
  }
  // The leader's atomic; the other lanes' value is never read.
  __device__ __forceinline__ uint32_t take(uint32_t runs) const {
    return lane(0) == 0u ? ~atomicSub(f_min + 1, runs) : 0u;
  }
  __device__ __forceinline__ uint32_t broadcast(uint32_t v) const {
    return __shfl_sync(0xFFFFFFFFu, v, 0);
  }
  __device__ __forceinline__ bool vote(bool any) const {
    return __any_sync(0xFFFFFFFFu, any);
  }
  __device__ __forceinline__ uint32_t lowest() const {
    uint32_t v;
    if constexpr (SHARED) {
      asm volatile("ld.relaxed.sys.global.u32 %0, [%1];"
                   : "=r"(v)
                   : "l"(f_min));
    } else {
      asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
                   : "=r"(v)
                   : "l"(f_min));
    }
    return v;
  }
  __device__ __forceinline__ void hit(uint32_t i) const {
    if constexpr (SHARED) {
      atomicMin_system(f_min, i);
#pragma unroll
      for (int j = 0; j < kMaxPeers; ++j) {
        if (j < peers.n) atomicMin_system(peers.word[j], i);
      }
    } else {
      atomicMin(f_min, i);
    }
  }
};

// K2's floor of resident blocks a SM (as K5's below). At 2 its 1-block
// instantiation takes 119 registers and a 10^9 block took 76.7 ms, against
// 78.5 at 3 (80 registers) and 83.6 with no floor (64, 4 blocks a SM), and
// K1's 78.7 (NVIDIA H100 80GB HBM3 at 700 W, builds of this source with
// each floor timed in turns).
constexpr int kUntilMinBlocks = 2;

// K2's search; with CHAINED, one launch of K6's until chain or one mesh
// until shard, which does nothing once an earlier launch of the chain has
// hit (carry[0] != 0; no thread of this launch writes the carry, so every
// thread sees one value), and whose hits also go to `peers` (K2 gets
// none). A warp walks its grabs together (UntilWalk::step is
// warp-uniform), and every thread reaches write_partial's barrier.
template <int VARIANT, bool CHAINED>
__global__ void __launch_bounds__(kThreads, kUntilMinBlocks)
    sha256_until_kernel(const Plan p, const uint32_t* __restrict__ carry,
                        uint32_t* f_min,
                        const __grid_constant__ Peers peers,
                        uint32_t* __restrict__ partials) {
  if (CHAINED && carry[0] != 0u) return;
  const LaneBody<VARIANT> body(p);
  uint32_t first, last;
  valid_lanes(p, first, last);
  Key best = sentinel();
  CardWarp<CHAINED> warp{f_min, peers};
  if (first <= last && !(CHAINED && starts_above_hit(first, warp))) {
    UntilWalk<kGrab, 1> walk(first, last, warp);
    while (walk.step(body, p, warp)) {
    }
    best = walk.best[0];
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

// The lowest hit as the chained launches read it (CardWarp<true>): other
// cards may write it.
__device__ __forceinline__ uint32_t load_sys(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// K2's reduce: (found, f_idx, best_hi, best_lo, best_idx). With a carry,
// the reduce of a mesh until shard (K6's mesh until body), whose search ran
// chained: once carry[0] says an earlier block hit, that search wrote no
// partials, and the shard's row gets (0, all-ones x 4), which the mesh fold
// never takes. A shard's found and f_idx come from its card's lowest-hit
// word, which the block's earlier shards there (and, across cards, every
// shard) share, so they may name an earlier shard's hit; best_* is then
// not read (a row's found only goes from 0 to 1 as the word falls, so a
// row with found 0 scanned every lane of its window). No thread writes the
// carry here.
__global__ void __launch_bounds__(1024)
    reduce_until_kernel(const uint32_t* __restrict__ partials, int count,
                        const uint32_t* f_min,
                        const uint32_t* __restrict__ carry,
                        uint32_t* __restrict__ out) {
  if (carry != nullptr && carry[0] != 0u) {
    if (threadIdx.x < 5) out[threadIdx.x] = threadIdx.x == 0 ? 0u : ~0u;
    return;
  }
  const Key best = block_min(partials_min(partials, count));
  if (threadIdx.x == 0) {
    const uint32_t f = carry != nullptr ? load_sys(f_min) : *f_min;
    out[0] = f != ~0u ? 1u : 0u;
    out[1] = f;
    out[2] = best.hi;
    out[3] = best.lo;
    out[4] = best.idx;
  }
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

// K6's mesh folds (see rows_min): one thread merges the n shard rows and
// folds the result into the carry in place. A fold reads n x 12 or n x 20
// bytes and writes at most 32, so launch latency bounds it.
__global__ void __launch_bounds__(1)
    mesh_fold_argmin_kernel(const uint32_t* __restrict__ rows, int n,
                            uint32_t* __restrict__ carry, uint32_t base_hi,
                            uint32_t base_lo) {
  mesh_fold_argmin_words(carry, rows, n, base_hi, base_lo);
}

__global__ void __launch_bounds__(1)
    mesh_fold_until_kernel(const uint32_t* __restrict__ rows, int n,
                           uint32_t* __restrict__ carry, uint32_t base_hi,
                           uint32_t base_lo) {
  mesh_fold_until_words(carry, rows, n, base_hi, base_lo);
}

// K5's search over the valid lanes [first, last] of one row, as block
// `local` of `nblk` blocks of that row.
template <int VARIANT>
__device__ __forceinline__ Key segmin_lanes(const Plan& sp, uint32_t first,
                                            uint32_t last, int local,
                                            int nblk) {
  const LaneBody<VARIANT> body(sp);
  Key best = sentinel();
  walk_runs(first, last, static_cast<uint32_t>(local) * blockDim.x +
                             threadIdx.x,
            static_cast<uint32_t>(nblk) * blockDim.x,
            [&](uint32_t base, uint32_t dlo, uint32_t dhi) {
              body.run(sp, base, dlo, dhi, [&](const Key& cand) {
                if (key_less(cand, best)) best = cand;
                return false;
              });
              return true;
            });
  return best;
}

// Resident blocks a K5 search kernel asks ptxas to fit on an SM
// (__launch_bounds__' second argument): its registers are capped so that
// they leave room for that many blocks. At
// 2 the three instantiations take 111 to 128 registers; at 3 ptxas holds
// them to 80 and the digit-free one spills 248 bytes; left alone it sizes
// them from 63 to 149 (4 blocks a SM down to 1). On the eight mice's 56
// rows the launches took 0.88 ms at 2, 0.91 at 3 and 0.98 with none, and
// on eight 10^8-lane digit-free rows 128.8, 136.0 and 132.9 ms (NVIDIA
// H100 80GB HBM3 at 700 W, builds of this source with each floor timed in
// turns): here fewer warps with room for their registers beat more warps
// held short of them.
constexpr int kSegminMinBlocks = 2;

// K5's search: the blocks of one group, the rows of one tail shape (the
// variant). Block b serves row group_rows[g] for the g with group_blk[g]
// <= b < group_blk[g + 1] (group_blk ascends strictly: a row without a
// block is not in the group), as block b - group_blk[g] of that row's
// group_blk[g + 1] - group_blk[g], and writes its partial at slot
// part_base + b.
template <int VARIANT>
__global__ void __launch_bounds__(kThreads, kSegminMinBlocks)
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
  const uint32_t* src = plans + kPlanWords * s_row;
  uint32_t* dst = reinterpret_cast<uint32_t*>(&sp);
  for (int w = threadIdx.x; w < kPlanWords; w += blockDim.x) dst[w] = src[w];
  __syncthreads();
  uint32_t first, last;
  valid_lanes(sp, first, last);
  Key best = sentinel();
  if (first <= last) {
    best = segmin_lanes<VARIANT>(sp, first, last, s_local, s_nblk);
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
  const bool ok = grid > 0 && grid <= (1 << 20) && p.n <= (1u << 31) &&
                  (p.nblocks == 1u || p.nblocks == 2u) && p.k >= 1u &&
                  p.k <= 9u && p.rem <= 63u;
  // Every body picks its code by the tail's shape, which the block count
  // must match.
  return ok && (tail_variant(static_cast<int>(p.rem),
                             static_cast<int>(p.k)) == 0) ==
                   (p.nblocks == 1u);
}

Plan read_plan(const uint32_t* plan_words) {
  Plan p;
  std::memcpy(&p, plan_words, sizeof(Plan));
  return p;
}

// The search kernels' variant for plan p (tail_variant): 0 for a 1-block
// tail, 1 for a 2-block one whose last digit lies in block 1, 2 for a
// 2-block one whose second block holds no digit.
int plan_variant(const Plan& p) {
  if (p.nblocks == 1u) return 0;
  return tail_variant(static_cast<int>(p.rem), static_cast<int>(p.k)) == 2
             ? 2
             : 1;
}

// Launch K1's search kernel (K3's or K4's under the peeled bodies);
// returns cudaGetLastError() after it.
int launch_argmin_search(const Plan& p, uint32_t* partials, int grid,
                         cudaStream_t s) {
  switch (plan_variant(p)) {
    case 0:
      sha256_argmin_kernel<0><<<grid, kThreads, 0, s>>>(p, partials);
      break;
    case 1:
      sha256_argmin_kernel<1><<<grid, kThreads, 0, s>>>(p, partials);
      break;
    case 2:
      sha256_argmin_kernel<2><<<grid, kThreads, 0, s>>>(p, partials);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Reset f_min[1] (the complement of the runs handed out) and, with
// reset_hit, f_min[0] (the lowest hit) to all-ones on the stream, one
// memset for both, then launch K2's search kernel (CHAINED: the until
// chain's, or a mesh until shard's, whose hits also go to `peers`);
// returns the first error seen.
template <bool CHAINED>
int launch_until_search(const Plan& p, const uint32_t* carry, uint32_t* f_min,
                        bool reset_hit, const Peers& peers,
                        uint32_t* partials, int grid, cudaStream_t s) {
  const cudaError_t err =
      cudaMemsetAsync(f_min + (reset_hit ? 0 : 1), 0xFF,
                      (reset_hit ? 2 : 1) * sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (plan_variant(p)) {
    case 0:
      sha256_until_kernel<0, CHAINED><<<grid, kThreads, 0, s>>>(
          p, carry, f_min, peers, partials);
      break;
    case 1:
      sha256_until_kernel<1, CHAINED><<<grid, kThreads, 0, s>>>(
          p, carry, f_min, peers, partials);
      break;
    case 2:
      sha256_until_kernel<2, CHAINED><<<grid, kThreads, 0, s>>>(
          p, carry, f_min, peers, partials);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch K5's search kernel for the group of variant g on stream gs;
// returns cudaGetLastError() after it.
int launch_segmin_search(int g, const SegminTable& t, int n, int grid,
                         int part_base, uint32_t* partials, cudaStream_t gs) {
  switch (g) {
    case 0:
      sha256_segmin_kernel<0><<<grid, kThreads, 0, gs>>>(
          t.plans, t.rows[0], t.blk[0], n, part_base, partials);
      break;
    case 1:
      sha256_segmin_kernel<1><<<grid, kThreads, 0, gs>>>(
          t.plans, t.rows[1], t.blk[1], n, part_base, partials);
      break;
    case 2:
      sha256_segmin_kernel<2><<<grid, kThreads, 0, gs>>>(
          t.plans, t.rows[2], t.blk[2], n, part_base, partials);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5's groups on side streams (with every group on the caller's stream,
// one after another, the launches on the eight mice's 56 rows took 0.98 ms
// against 0.88, NVIDIA H100 80GB HBM3 at 700 W, timed in turns). Each
// device gets two side streams, made at its first batch with more than one
// group, and the events that fork them from the caller's stream and join
// them back.
constexpr int kMaxDevices = 64;

struct SideStreams {
  cudaStream_t stream[2];
  cudaEvent_t fork, join[2];
};

std::mutex side_lock;
SideStreams* side_pool[kMaxDevices];

// The current device's side streams into *out, made at the first call;
// side_lock must be held. Returns the first error.
int side_streams(SideStreams** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (side_pool[dev] == nullptr) {
    SideStreams ss;
    err = cudaEventCreateWithFlags(&ss.fork, cudaEventDisableTiming);
    for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
      err = cudaStreamCreateWithFlags(&ss.stream[i], cudaStreamNonBlocking);
      if (err == cudaSuccess) {
        err = cudaEventCreateWithFlags(&ss.join[i], cudaEventDisableTiming);
      }
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    side_pool[dev] = new SideStreams(ss);
  }
  *out = side_pool[dev];
  return 0;
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

// The lane body this library was built with (0 rolled, 1 peel, 2 peel fed
// by the host hoist) and its plan's length in words.
int dbmt_sha256_body() { return DBMT_BODY; }

int dbmt_sha256_plan_words() { return kPlanWords; }

// Threads per block of the search kernels.
int dbmt_sha256_argmin_threads() { return kThreads; }

// Lanes per run: a search thread's unit of work (kRun).
int dbmt_sha256_run_lanes() { return static_cast<int>(kRun); }

// Resident search blocks per SM (0 on error) of the entry's kernel
// (0: arg-min, 1: until, 2: K5's segment-min) for the variant (0: 1-block
// tail, 1: 2-block with the last digit in block 1, 2: 2-block with a
// digit-free second block).
int dbmt_sha256_blocks_per_sm(int entry, int variant) {
  if (variant < 0 || variant > 2) return 0;
  switch (3 * entry + variant) {
    case 0:
      return blocks_per_sm(sha256_argmin_kernel<0>);
    case 1:
      return blocks_per_sm(sha256_argmin_kernel<1>);
    case 2:
      return blocks_per_sm(sha256_argmin_kernel<2>);
    case 3:
      return blocks_per_sm(sha256_until_kernel<0, false>);
    case 4:
      return blocks_per_sm(sha256_until_kernel<1, false>);
    case 5:
      return blocks_per_sm(sha256_until_kernel<2, false>);
    case 6:
      return blocks_per_sm(sha256_segmin_kernel<0>);
    case 7:
      return blocks_per_sm(sha256_segmin_kernel<1>);
    case 8:
      return blocks_per_sm(sha256_segmin_kernel<2>);
    default:
      return 0;
  }
}

// K5: `table` is one device buffer of int32 words laid out as SegminTable
// reads it, with n0, n1, n2 rows in the groups of variants 0, 1, 2 and
// grid0, grid1, grid2 blocks; partials: 3 * (grid0 + grid1 + grid2) device
// words, group 0's slots first; out: 3 * nsegs device words. Enqueues the
// search launch of each non-empty group (when more than one, all but the
// first on side streams forked from `stream` and joined back to it) and
// the reduce on `stream`; returns the first error
// that is not 0.
int dbmt_sha256_segmin(const int* table, int nrows, int nsegs, int n0,
                       int grid0, int n1, int grid1, int n2, int grid2,
                       uint32_t* partials, uint32_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n[3] = {n0, n1, n2}, grids[3] = {grid0, grid1, grid2};
  if (nrows <= 0 || nsegs <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int groups[3], ngroups = 0, part_base[3], slots = 0;
  for (int g = 0; g < 3; ++g) {
    if (n[g] < 0 || grids[g] < 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    part_base[g] = slots;
    slots += grids[g];
    if (n[g] > 0 && grids[g] > 0) groups[ngroups++] = g;
  }
  if (slots > (1 << 21)) return static_cast<int>(cudaErrorInvalidValue);
  const SegminTable t(table, nrows, nsegs, n);
  // The events are shared by the device's calls: hold the lock from the
  // fork's record to the last join's wait.
  std::unique_lock<std::mutex> hold(side_lock, std::defer_lock);
  SideStreams* side = nullptr;
  int err = 0;
  if (ngroups > 1) {
    hold.lock();
    err = side_streams(&side);
    if (err == 0) err = static_cast<int>(cudaEventRecord(side->fork, s));
    if (err != 0) return err;
  }
  for (int i = 0; i < ngroups; ++i) {
    const int g = groups[i];
    cudaStream_t gs = side != nullptr && i > 0 ? side->stream[i - 1] : s;
    if (gs != s) err = static_cast<int>(cudaStreamWaitEvent(gs, side->fork, 0));
    if (err == 0) {
      err = launch_segmin_search(g, t, n[g], grids[g], part_base[g], partials,
                                 gs);
    }
    if (err == 0 && gs != s) {
      err = static_cast<int>(cudaEventRecord(side->join[i - 1], gs));
      if (err == 0) {
        err = static_cast<int>(cudaStreamWaitEvent(s, side->join[i - 1], 0));
      }
    }
    if (err != 0) return err;
  }
  segmin_reduce_kernel<<<nsegs, kThreads, 0, s>>>(t.seg_rows, t.pstart,
                                                  t.pcount, partials, nsegs,
                                                  out);
  return static_cast<int>(cudaGetLastError());
}

// Every entry below takes plan_words, dbmt_sha256_plan_words() host
// uint32 words (the Plan layout), enqueues on `stream` without
// synchronising, and returns the cudaGetLastError() seen right after its
// launches (0 when all were accepted). partials: 3 * grid device words of
// scratch.

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

// K2: f_min is two device words of scratch (the lowest hit and the run
// counter); out: 5 device words (found,
// f_idx, best_hi, best_lo, best_idx).
int dbmt_sha256_until(const uint32_t* plan_words, uint32_t* partials,
                      uint32_t* f_min, uint32_t* out, int grid, void* stream) {
  const Plan p = read_plan(plan_words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!plan_ok(p, grid)) return static_cast<int>(cudaErrorInvalidValue);
  const int err =
      launch_until_search<false>(p, nullptr, f_min, true, Peers{}, partials,
                                 grid, s);
  if (err != 0) return err;
  reduce_until_kernel<<<1, 1024, 0, s>>>(partials, grid, f_min, nullptr,
                                         out);
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
  const int err =
      launch_until_search<true>(p, carry, f_min, true, Peers{}, partials,
                                grid, s);
  if (err != 0) return err;
  reduce_until_fold_kernel<<<1, 1024, 0, s>>>(partials, grid, f_min, carry,
                                              base_hi, base_lo);
  return static_cast<int>(cudaGetLastError());
}

// K6's fold alone: the reduce-and-fold kernel of dbmt_sha256_argmin_fold
// (f_min null) or dbmt_sha256_until_fold (f_min: the launch's lowest hit)
// over `count` partials already in device memory, folded into the carry.
// Nothing of the chain calls it: it times that kernel by itself.
int dbmt_k6_fold(const uint32_t* partials, int count, const uint32_t* f_min,
                 uint32_t* carry, uint32_t base_hi, uint32_t base_lo,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (count < 1 || count > (1 << 20)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (f_min == nullptr) {
    reduce_argmin_fold_kernel<<<1, 1024, 0, s>>>(partials, count, carry,
                                                 base_hi, base_lo);
  } else {
    reduce_until_fold_kernel<<<1, 1024, 0, s>>>(partials, count, f_min,
                                                carry, base_hi, base_lo);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6's mesh until shard: K2's chained search over the shard's window (no
// lane work once carry[0] != 0; carry is this device's copy of the chain's
// 8-word carry), then its reduce into out, the shard's 5 device words
// (found, f_idx, best_hi, best_lo, best_idx). f_min is this card's two
// words of the block: the lowest hit, shared by the block's shards here,
// and the run counter of this launch. The counter is reset on the stream
// before the search, and with first (the block's first shard on this
// card) the lowest hit too. peers: npeers device pointers, the lowest-hit
// words of the mesh's other cards, which each hit also lowers.
int dbmt_sha256_until_shard(const uint32_t* plan_words, uint32_t* partials,
                            uint32_t* f_min, int first,
                            uint32_t* const* peers, int npeers,
                            const uint32_t* carry, uint32_t* out, int grid,
                            void* stream) {
  const Plan p = read_plan(plan_words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Peers pw;
  if (!plan_ok(p, grid) || !read_peers(peers, npeers, pw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = launch_until_search<true>(p, carry, f_min, first != 0, pw,
                                            partials, grid, s);
  if (err != 0) return err;
  reduce_until_kernel<<<1, 1024, 0, s>>>(partials, grid, f_min, carry, out);
  return static_cast<int>(cudaGetLastError());
}

// Lets kernels on `device` read and write the memory of `peer` under
// unified virtual addressing (the mesh until shards' hits go to every
// card's lowest-hit word). Access already enabled is not an error, and
// the error it leaves is cleared. The current device is kept.
int dbmt_enable_peer_access(int device, int peer) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      (void)cudaGetLastError();
      err = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(current);
  return static_cast<int>(err != cudaSuccess ? err : back);
}

// K6's mesh folds: rows are the n shards' device rows, 3 words each
// (arg-min) or 5 (until), in shard order, merged and folded into the device
// carry (5 or 8 words) in place; the nonces are base + idx in 64 bits.
int dbmt_mesh_fold_argmin(const uint32_t* rows, int n, uint32_t* carry,
                          uint32_t base_hi, uint32_t base_lo, void* stream) {
  if (n < 1 || n > kMeshRowsMax) return static_cast<int>(cudaErrorInvalidValue);
  mesh_fold_argmin_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, n, carry, base_hi, base_lo);
  return static_cast<int>(cudaGetLastError());
}

int dbmt_mesh_fold_until(const uint32_t* rows, int n, uint32_t* carry,
                         uint32_t base_hi, uint32_t base_lo, void* stream) {
  if (n < 1 || n > kMeshRowsMax) return static_cast<int>(cudaErrorInvalidValue);
  mesh_fold_until_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, n, carry, base_hi, base_lo);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
