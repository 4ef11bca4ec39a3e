// Native host-side SHA-256 arg-min scan.
//
// The CPU analog of the reference miner's hot loop (ref:
// bitcoin/miner/miner.go:52-59 calling bitcoin/hash.go:13-17, which leans on
// Go's assembly-accelerated crypto/sha256): hash "<data> <nonce>" for every
// nonce in [lower, upper], tracking the minimum of the big-endian uint64
// prefix with strict '<' (earliest nonce wins ties).
//
// The port's host compute tier (DBMT_COMPUTE=host, apps/miner.py
// HostSearcher): miner processes that run without a card. Built with g++ at
// first use by ops/sha256_native.py; there is no pure-Python fallback.
//
// The prefix midstate ("<data> " absorbed once) plus an incremental decimal
// counter in the tail block avoid re-hashing the prefix and re-formatting
// the nonce per iteration.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__SHA__) && defined(__SSE4_1__)
#include <immintrin.h>
#endif

namespace {

constexpr uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

constexpr uint32_t H0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                            0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};

inline uint32_t rotr(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

void compress_portable(uint32_t state[8], const uint8_t block[64]) {
  uint32_t w[64];
  for (int t = 0; t < 16; ++t) {
    w[t] = (uint32_t(block[t * 4]) << 24) | (uint32_t(block[t * 4 + 1]) << 16) |
           (uint32_t(block[t * 4 + 2]) << 8) | uint32_t(block[t * 4 + 3]);
  }
  for (int t = 16; t < 64; ++t) {
    uint32_t s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3);
    uint32_t s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10);
    w[t] = w[t - 16] + s0 + w[t - 7] + s1;
  }
  uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
  uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
  for (int t = 0; t < 64; ++t) {
    uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + s1 + ch + K[t] + w[t];
    uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = s0 + maj;
    h = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;
  }
  state[0] += a; state[1] += b; state[2] += c; state[3] += d;
  state[4] += e; state[5] += f; state[6] += g; state[7] += h;
}

#if defined(__SHA__) && defined(__SSE4_1__)
// x86 SHA-NI one-block compression (the standard Intel intrinsic sequence);
// ~10x the portable loop. Selected at build time by -march=native.
void compress_ni(uint32_t state[8], const uint8_t block[64]) {
  const __m128i SHUF = _mm_set_epi64x(0x0c0d0e0f08090a0bULL,
                                      0x0405060700010203ULL);
  __m128i TMP = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&state[0]));
  __m128i S1 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&state[4]));
  TMP = _mm_shuffle_epi32(TMP, 0xB1);        // CDAB
  S1 = _mm_shuffle_epi32(S1, 0x1B);          // EFGH
  __m128i S0 = _mm_alignr_epi8(TMP, S1, 8);  // ABEF
  S1 = _mm_blend_epi16(S1, TMP, 0xF0);       // CDGH
  const __m128i ABEF_SAVE = S0, CDGH_SAVE = S1;

  __m128i M0 = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(block + 0)), SHUF);
  __m128i M1 = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(block + 16)), SHUF);
  __m128i M2 = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(block + 32)), SHUF);
  __m128i M3 = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(block + 48)), SHUF);
  __m128i MSG;

#define QROUND(Mc, Mp, Mn, g, do_msg2, do_msg1)                          \
  MSG = _mm_add_epi32(                                                   \
      Mc, _mm_set_epi64x(                                                \
              (uint64_t(K[4 * (g) + 3]) << 32) | K[4 * (g) + 2],         \
              (uint64_t(K[4 * (g) + 1]) << 32) | K[4 * (g)]));           \
  S1 = _mm_sha256rnds2_epu32(S1, S0, MSG);                               \
  MSG = _mm_shuffle_epi32(MSG, 0x0E);                                    \
  S0 = _mm_sha256rnds2_epu32(S0, S1, MSG);                               \
  if (do_msg2) {                                                         \
    Mn = _mm_add_epi32(Mn, _mm_alignr_epi8(Mc, Mp, 4));                  \
    Mn = _mm_sha256msg2_epu32(Mn, Mc);                                   \
  }                                                                      \
  if (do_msg1) Mp = _mm_sha256msg1_epu32(Mp, Mc);

  // msg2 (with the alignr add) produces W[16..63] at groups 3-14; msg1
  // pre-mixes the operand msg2 consumes two groups later, so it runs at
  // groups 1-12. The alignr must read Mp before msg1 rewrites it.
  QROUND(M0, M3, M1, 0, 0, 0)
  QROUND(M1, M0, M2, 1, 0, 1)
  QROUND(M2, M1, M3, 2, 0, 1)
  QROUND(M3, M2, M0, 3, 1, 1)
  QROUND(M0, M3, M1, 4, 1, 1)
  QROUND(M1, M0, M2, 5, 1, 1)
  QROUND(M2, M1, M3, 6, 1, 1)
  QROUND(M3, M2, M0, 7, 1, 1)
  QROUND(M0, M3, M1, 8, 1, 1)
  QROUND(M1, M0, M2, 9, 1, 1)
  QROUND(M2, M1, M3, 10, 1, 1)
  QROUND(M3, M2, M0, 11, 1, 1)
  QROUND(M0, M3, M1, 12, 1, 1)
  QROUND(M1, M0, M2, 13, 1, 0)
  QROUND(M2, M1, M3, 14, 1, 0)
  QROUND(M3, M2, M0, 15, 0, 0)
#undef QROUND

  S0 = _mm_add_epi32(S0, ABEF_SAVE);
  S1 = _mm_add_epi32(S1, CDGH_SAVE);
  TMP = _mm_shuffle_epi32(S0, 0x1B);         // FEBA
  S1 = _mm_shuffle_epi32(S1, 0xB1);          // DCHG
  S0 = _mm_blend_epi16(TMP, S1, 0xF0);       // DCBA
  S1 = _mm_alignr_epi8(S1, TMP, 8);          // HGFE
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&state[0]), S0);
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&state[4]), S1);
}

// Two-message interleaved compression: the sha256rnds2 dependency chain
// (latency ~4 cycles, throughput ~1/cycle) leaves the unit mostly idle on
// a single chain; alternating rounds of two INDEPENDENT messages nearly
// doubles throughput. Register budget: ~8 xmm per chain = the full
// 16-register file, which is why this stops at 2-way. Wider interleaves
// were measured and rejected: 3-way/4-way prototypes benched
// 24.6-25.8 / 25.8-28.1 M hash/s vs 23.4-24.7 for 2-way on one host —
// <= 10%, within run noise, because past two chains the spilled message
// tiles give back most of the latency hiding; not worth the triple/quad
// scan-loop boundary handling.
void compress2_ni(uint32_t state_a[8], const uint8_t block_a[64],
                  uint32_t state_b[8], const uint8_t block_b[64]) {
  const __m128i SHUF = _mm_set_epi64x(0x0c0d0e0f08090a0bULL,
                                      0x0405060700010203ULL);
#define LOAD_STATE(st, S0, S1, SAVE0, SAVE1)                              \
  __m128i TMP##S0 = _mm_loadu_si128(                                      \
      reinterpret_cast<const __m128i*>(&(st)[0]));                        \
  __m128i S1 = _mm_loadu_si128(                                           \
      reinterpret_cast<const __m128i*>(&(st)[4]));                        \
  TMP##S0 = _mm_shuffle_epi32(TMP##S0, 0xB1);                             \
  S1 = _mm_shuffle_epi32(S1, 0x1B);                                       \
  __m128i S0 = _mm_alignr_epi8(TMP##S0, S1, 8);                           \
  S1 = _mm_blend_epi16(S1, TMP##S0, 0xF0);                                \
  const __m128i SAVE0 = S0, SAVE1 = S1;
  LOAD_STATE(state_a, A0, A1, ASAVE0, ASAVE1)
  LOAD_STATE(state_b, B0, B1, BSAVE0, BSAVE1)
#undef LOAD_STATE

#define LOAD_MSG(block, M0, M1, M2, M3)                                   \
  __m128i M0 = _mm_shuffle_epi8(_mm_loadu_si128(                          \
      reinterpret_cast<const __m128i*>((block) + 0)), SHUF);              \
  __m128i M1 = _mm_shuffle_epi8(_mm_loadu_si128(                          \
      reinterpret_cast<const __m128i*>((block) + 16)), SHUF);             \
  __m128i M2 = _mm_shuffle_epi8(_mm_loadu_si128(                          \
      reinterpret_cast<const __m128i*>((block) + 32)), SHUF);             \
  __m128i M3 = _mm_shuffle_epi8(_mm_loadu_si128(                          \
      reinterpret_cast<const __m128i*>((block) + 48)), SHUF);
  LOAD_MSG(block_a, MA0, MA1, MA2, MA3)
  LOAD_MSG(block_b, MB0, MB1, MB2, MB3)
#undef LOAD_MSG
  __m128i MSG;

  // Same group schedule as compress_ni's QROUND, issued for chain A then
  // chain B each group so the two rnds2 chains overlap in the pipeline.
#define QROUND2(S0, S1, Mc, Mp, Mn, g, do_msg2, do_msg1)                  \
  MSG = _mm_add_epi32(                                                    \
      Mc, _mm_set_epi64x(                                                 \
              (uint64_t(K[4 * (g) + 3]) << 32) | K[4 * (g) + 2],          \
              (uint64_t(K[4 * (g) + 1]) << 32) | K[4 * (g)]));            \
  S1 = _mm_sha256rnds2_epu32(S1, S0, MSG);                                \
  MSG = _mm_shuffle_epi32(MSG, 0x0E);                                     \
  S0 = _mm_sha256rnds2_epu32(S0, S1, MSG);                                \
  if (do_msg2) {                                                          \
    Mn = _mm_add_epi32(Mn, _mm_alignr_epi8(Mc, Mp, 4));                   \
    Mn = _mm_sha256msg2_epu32(Mn, Mc);                                    \
  }                                                                       \
  if (do_msg1) Mp = _mm_sha256msg1_epu32(Mp, Mc);

#define GROUP2(ca, pa, na, cb, pb, nb, g, do2, do1)                       \
  QROUND2(A0, A1, ca, pa, na, g, do2, do1)                                \
  QROUND2(B0, B1, cb, pb, nb, g, do2, do1)

  GROUP2(MA0, MA3, MA1, MB0, MB3, MB1, 0, 0, 0)
  GROUP2(MA1, MA0, MA2, MB1, MB0, MB2, 1, 0, 1)
  GROUP2(MA2, MA1, MA3, MB2, MB1, MB3, 2, 0, 1)
  GROUP2(MA3, MA2, MA0, MB3, MB2, MB0, 3, 1, 1)
  GROUP2(MA0, MA3, MA1, MB0, MB3, MB1, 4, 1, 1)
  GROUP2(MA1, MA0, MA2, MB1, MB0, MB2, 5, 1, 1)
  GROUP2(MA2, MA1, MA3, MB2, MB1, MB3, 6, 1, 1)
  GROUP2(MA3, MA2, MA0, MB3, MB2, MB0, 7, 1, 1)
  GROUP2(MA0, MA3, MA1, MB0, MB3, MB1, 8, 1, 1)
  GROUP2(MA1, MA0, MA2, MB1, MB0, MB2, 9, 1, 1)
  GROUP2(MA2, MA1, MA3, MB2, MB1, MB3, 10, 1, 1)
  GROUP2(MA3, MA2, MA0, MB3, MB2, MB0, 11, 1, 1)
  GROUP2(MA0, MA3, MA1, MB0, MB3, MB1, 12, 1, 1)
  GROUP2(MA1, MA0, MA2, MB1, MB0, MB2, 13, 1, 0)
  GROUP2(MA2, MA1, MA3, MB2, MB1, MB3, 14, 1, 0)
  GROUP2(MA3, MA2, MA0, MB3, MB2, MB0, 15, 0, 0)
#undef GROUP2
#undef QROUND2

#define STORE_STATE(st, S0, S1, SAVE0, SAVE1)                             \
  S0 = _mm_add_epi32(S0, SAVE0);                                          \
  S1 = _mm_add_epi32(S1, SAVE1);                                          \
  {                                                                       \
    __m128i T = _mm_shuffle_epi32(S0, 0x1B);                              \
    S1 = _mm_shuffle_epi32(S1, 0xB1);                                     \
    S0 = _mm_blend_epi16(T, S1, 0xF0);                                    \
    S1 = _mm_alignr_epi8(S1, T, 8);                                       \
  }                                                                       \
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&(st)[0]), S0);             \
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&(st)[4]), S1);
  STORE_STATE(state_a, A0, A1, ASAVE0, ASAVE1)
  STORE_STATE(state_b, B0, B1, BSAVE0, BSAVE1)
#undef STORE_STATE
}

inline void compress(uint32_t state[8], const uint8_t block[64]) {
  compress_ni(state, block);
}
inline void compress2(uint32_t sa[8], const uint8_t ba[64],
                      uint32_t sb[8], const uint8_t bb[64]) {
  compress2_ni(sa, ba, sb, bb);
}
#else
inline void compress(uint32_t state[8], const uint8_t block[64]) {
  compress_portable(state, block);
}
inline void compress2(uint32_t sa[8], const uint8_t ba[64],
                      uint32_t sb[8], const uint8_t bb[64]) {
  compress_portable(sa, ba);
  compress_portable(sb, bb);
}
#endif

// Build the padded tail block(s) (1 or 2 x 64 bytes); returns nblocks.
int pad_tail(uint8_t buf[128], const uint8_t* tail, int tail_len,
             uint64_t total_len) {
  std::memcpy(buf, tail, tail_len);
  buf[tail_len] = 0x80;
  int nblocks = (tail_len + 1 + 8 <= 64) ? 1 : 2;
  int padded = nblocks * 64;
  std::memset(buf + tail_len + 1, 0, padded - tail_len - 1 - 8);
  uint64_t bits = total_len * 8;
  for (int j = 0; j < 8; ++j)
    buf[padded - 1 - j] = uint8_t(bits >> (8 * j));
  return nblocks;
}

// Hash prefix-midstate + tail (tail_len < 64 + up to 20 digit bytes), return
// big-endian uint64 of digest[0:8]. total_len in bytes.
uint64_t finish(const uint32_t mid[8], const uint8_t* tail, int tail_len,
                uint64_t total_len) {
  uint32_t st[8];
  std::memcpy(st, mid, sizeof(st));
  uint8_t buf[128];
  int nblocks = pad_tail(buf, tail, tail_len, total_len);
  compress(st, buf);
  if (nblocks == 2) compress(st, buf + 64);
  return (uint64_t(st[0]) << 32) | uint64_t(st[1]);
}

// Two tails from the SAME midstate, hashed as interleaved chains (the
// scan's hot pair path). Tail lengths may differ (digit rollover inside a
// pair); unequal BLOCK counts (one message crossing the 64-byte pad
// boundary the other doesn't) fall back to two scalar finishes.
void finish2(const uint32_t mid[8],
             const uint8_t* tail_a, int len_a, uint64_t total_a,
             const uint8_t* tail_b, int len_b, uint64_t total_b,
             uint64_t* out_a, uint64_t* out_b) {
  uint8_t buf_a[128], buf_b[128];
  int na = pad_tail(buf_a, tail_a, len_a, total_a);
  int nb = pad_tail(buf_b, tail_b, len_b, total_b);
  if (na != nb) {
    *out_a = finish(mid, tail_a, len_a, total_a);
    *out_b = finish(mid, tail_b, len_b, total_b);
    return;
  }
  uint32_t sa[8], sb[8];
  std::memcpy(sa, mid, sizeof(sa));
  std::memcpy(sb, mid, sizeof(sb));
  for (int j = 0; j < na; ++j)
    compress2(sa, buf_a + 64 * j, sb, buf_b + 64 * j);
  *out_a = (uint64_t(sa[0]) << 32) | uint64_t(sa[1]);
  *out_b = (uint64_t(sb[0]) << 32) | uint64_t(sb[1]);
}

// The one scan loop behind every extern entry point. Ascending over
// [lower, upper]; stops at the FIRST nonce whose hash < target
// (*out_found = 1); otherwise tracks the exact arg-min (*out_found = 0)
// with strict-'<' earliest-nonce ties. target = 0 can never hit (no
// uint64 is < 0), so the arg-min scan is the target-0 special case.
//
// Cooperative MT abort: when min_found_shard is non-null the loop checks
// it every 4096 nonces and bails (returns 1, outputs = partial arg-min)
// once a LOWER-indexed shard has a hit — anything this shard could still
// find is beaten by that hit. Lower shards are never stopped by higher
// ones (the global first-qualifying nonce may sit late in an early
// shard). Returns 0 = completed, 1 = aborted, -1 = empty range.
int scan_until_core(const char* data, uint64_t data_len, uint64_t lower,
                    uint64_t upper, uint64_t target,
                    const std::atomic<uint64_t>* min_found_shard,
                    uint64_t my_shard, uint64_t* out_hash,
                    uint64_t* out_nonce, int* out_found) {
  if (lower > upper) return -1;

  // Absorb all complete 64-byte blocks of "<data> " once.
  uint32_t mid[8];
  std::memcpy(mid, H0, sizeof(mid));
  uint64_t prefix_len = data_len + 1;
  uint8_t block[64];
  uint64_t full = prefix_len - (prefix_len % 64);
  for (uint64_t off = 0; off < full; off += 64) {
    for (int j = 0; j < 64; ++j)
      block[j] = uint8_t(off + j < data_len ? data[off + j] : ' ');
    compress(mid, block);
  }
  int rem = int(prefix_len - full);
  uint8_t tail[64 + 24];
  for (int j = 0; j < rem; ++j)
    tail[j] = uint8_t(full + j < data_len ? data[full + j] : ' ');
  uint8_t tail2[64 + 24];
  std::memcpy(tail2, tail, rem);

  // Incremental ASCII decimal counter for the nonce digits.
  uint8_t digits[24];
  int nd = 0;
  uint64_t v = lower;
  do {
    digits[nd++] = uint8_t('0' + v % 10);
    v /= 10;
  } while (v);
  for (int i = 0; i < nd / 2; ++i) {
    uint8_t t = digits[i]; digits[i] = digits[nd - 1 - i]; digits[nd - 1 - i] = t;
  }
  // ++counter with decimal carry.
  auto incr = [&digits, &nd]() {
    int i = nd - 1;
    while (i >= 0 && digits[i] == '9') digits[i--] = '0';
    if (i < 0) {
      std::memmove(digits + 1, digits, nd);
      digits[0] = '1';
      ++nd;
    } else {
      ++digits[i];
    }
  };

  // Nonce PAIRS through the interleaved two-chain compression (finish2):
  // one sha256rnds2 chain leaves the SHA unit mostly idle on its ~4-cycle
  // latency, so two independent chains nearly double throughput. The
  // target check stays in ascending order — a hit on the first of a pair
  // returns before the second is examined — so first-qualifying and
  // earliest-tie semantics are byte-identical to the scalar loop.
  uint64_t best_hash = ~uint64_t(0);
  uint64_t best_nonce = lower;
  uint64_t n = lower, iter = 0;
  while (true) {
    if (min_found_shard && (iter++ & 2047) == 0 &&
        min_found_shard->load(std::memory_order_relaxed) < my_shard) {
      *out_hash = best_hash;
      *out_nonce = best_nonce;
      *out_found = 0;
      return 1;
    }
    std::memcpy(tail + rem, digits, nd);
    int len_a = rem + nd;
    uint64_t tot_a = prefix_len + nd;
    if (n == upper) {  // odd tail of the range: one scalar hash
      uint64_t h = finish(mid, tail, len_a, tot_a);
      if (h < target) {
        *out_hash = h;
        *out_nonce = n;
        *out_found = 1;
        return 0;
      }
      if (h < best_hash) {
        best_hash = h;
        best_nonce = n;
      }
      break;
    }
    incr();
    std::memcpy(tail2 + rem, digits, nd);
    uint64_t ha, hb;
    finish2(mid, tail, len_a, tot_a,
            tail2, rem + nd, prefix_len + nd, &ha, &hb);
    if (ha < target) {
      *out_hash = ha;
      *out_nonce = n;
      *out_found = 1;
      return 0;
    }
    if (ha < best_hash) {
      best_hash = ha;
      best_nonce = n;
    }
    if (hb < target) {
      *out_hash = hb;
      *out_nonce = n + 1;
      *out_found = 1;
      return 0;
    }
    if (hb < best_hash) {
      best_hash = hb;
      best_nonce = n + 1;
    }
    if (n + 1 == upper) break;
    incr();
    n += 2;
  }
  *out_hash = best_hash;
  *out_nonce = best_nonce;
  *out_found = 0;
  return 0;
}

}  // namespace

extern "C" {

// Difficulty scan (BASELINE config 5), single-threaded. Returns 0, or -1
// for an empty range (outputs untouched).
int dbmt_scan_until(const char* data, uint64_t data_len, uint64_t lower,
                   uint64_t upper, uint64_t target, uint64_t* out_hash,
                   uint64_t* out_nonce, int* out_found) {
  return scan_until_core(data, data_len, lower, upper, target, nullptr, 0,
                         out_hash, out_nonce, out_found);
}

// Scan [lower, upper] inclusive; writes (min_hash, argmin_nonce). Returns 0,
// or -1 for an empty range (outputs untouched).
int dbmt_scan_min(const char* data, uint64_t data_len, uint64_t lower,
                 uint64_t upper, uint64_t* out_hash, uint64_t* out_nonce) {
  int found;
  return scan_until_core(data, data_len, lower, upper, 0, nullptr, 0,
                         out_hash, out_nonce, &found);
}

// Multi-threaded difficulty scan: contiguous ascending shards, one per
// thread; each stops at its own first hit and publishes its shard index,
// which cooperatively aborts all HIGHER shards (scan_until_core). The
// lowest hitting shard's first hit is the globally first qualifying nonce
// (lower shards always run to completion or their own earlier hit); with
// no hit anywhere, shards merge to the exact arg-min in index order, same
// tie rule as dbmt_scan_min_mt. nthreads <= 0 means hardware_concurrency.
int dbmt_scan_until_mt(const char* data, uint64_t data_len, uint64_t lower,
                      uint64_t upper, uint64_t target, int nthreads,
                      uint64_t* out_hash, uint64_t* out_nonce,
                      int* out_found) {
  if (lower > upper) return -1;
  uint64_t total = upper - lower + 1;
  unsigned hw = std::thread::hardware_concurrency();
  uint64_t want = nthreads > 0 ? uint64_t(nthreads) : (hw ? hw : 1);
  if (want > total) want = total;
  if (want <= 1)
    return dbmt_scan_until(data, data_len, lower, upper, target, out_hash,
                          out_nonce, out_found);

  std::vector<uint64_t> los(want), his(want);
  uint64_t per = total / want, extra = total % want, start = lower;
  for (uint64_t t = 0; t < want; ++t) {
    uint64_t len = per + (t < extra ? 1 : 0);
    los[t] = start;
    his[t] = start + len - 1;
    start += len;
  }
  std::atomic<uint64_t> min_found{~uint64_t(0)};
  std::vector<uint64_t> hashes(want), nonces(want);
  auto run_shard = [&](uint64_t t, uint64_t lo, uint64_t hi) {
    int f = 0;
    scan_until_core(data, data_len, lo, hi, target, &min_found, t,
                    &hashes[t], &nonces[t], &f);
    if (f) {
      uint64_t cur = min_found.load(std::memory_order_relaxed);
      while (t < cur &&
             !min_found.compare_exchange_weak(cur, t,
                                              std::memory_order_relaxed)) {
      }
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(want);
  uint64_t spawned = 0;
  try {
    for (uint64_t t = 0; t < want; ++t) {
      threads.emplace_back(run_shard, t, los[t], his[t]);
      ++spawned;
    }
  } catch (...) {
    // Thread spawn failed (e.g. EAGAIN under a pid limit): join what
    // started, then cover the tail on this thread as shard `spawned`
    // (same recovery as dbmt_scan_min_mt; shard order stays ascending).
  }
  for (auto& th : threads) th.join();
  uint64_t covered = spawned;
  if (covered < want) {
    run_shard(covered, los[covered], upper);
    ++covered;
  }
  uint64_t win = min_found.load(std::memory_order_relaxed);
  if (win != ~uint64_t(0) && win < covered) {
    *out_hash = hashes[win];
    *out_nonce = nonces[win];
    *out_found = 1;
    return 0;
  }
  uint64_t best_hash = hashes[0], best_nonce = nonces[0];
  for (uint64_t t = 1; t < covered; ++t) {
    if (hashes[t] < best_hash) {
      best_hash = hashes[t];
      best_nonce = nonces[t];
    }
  }
  *out_hash = best_hash;
  *out_nonce = best_nonce;
  *out_found = 0;
  return 0;
}

// Single hash op (ref: bitcoin/hash.go:13-17), for spot conformance checks.
uint64_t dbmt_hash(const char* data, uint64_t data_len, uint64_t nonce) {
  uint64_t h, n;
  if (dbmt_scan_min(data, data_len, nonce, nonce, &h, &n) != 0) return 0;
  return h;
}

// Multi-threaded scan: contiguous sub-ranges, one per thread, merged with
// the same strict-'<' / earliest-nonce tie rule (sub-ranges ascend with the
// thread index, so merging in index order preserves first-seen-wins).
// nthreads <= 0 means hardware_concurrency.
int dbmt_scan_min_mt(const char* data, uint64_t data_len, uint64_t lower,
                    uint64_t upper, int nthreads, uint64_t* out_hash,
                    uint64_t* out_nonce) {
  if (lower > upper) return -1;
  uint64_t total = upper - lower + 1;
  unsigned hw = std::thread::hardware_concurrency();
  uint64_t want = nthreads > 0 ? uint64_t(nthreads) : (hw ? hw : 1);
  if (want > total) want = total;
  if (want <= 1) return dbmt_scan_min(data, data_len, lower, upper,
                                     out_hash, out_nonce);

  std::vector<uint64_t> los(want), his(want);
  uint64_t per = total / want, extra = total % want, start = lower;
  for (uint64_t t = 0; t < want; ++t) {
    uint64_t len = per + (t < extra ? 1 : 0);
    los[t] = start;
    his[t] = start + len - 1;
    start += len;
  }
  std::vector<uint64_t> hashes(want), nonces(want);
  std::vector<std::thread> threads;
  threads.reserve(want);
  uint64_t spawned = 0;
  try {
    for (uint64_t t = 0; t < want; ++t) {
      uint64_t lo = los[t], hi = his[t];
      threads.emplace_back([=, &hashes, &nonces] {
        dbmt_scan_min(data, data_len, lo, hi, &hashes[t], &nonces[t]);
      });
      ++spawned;
    }
  } catch (...) {
    // Thread spawn failed (e.g. EAGAIN under a pid limit). Letting the
    // vector destroy joinable threads would std::terminate the whole
    // process; instead join what started and scan the uncovered tail on
    // this thread (sub-ranges stay ascending, so the merge rule holds).
  }
  for (auto& th : threads) th.join();
  uint64_t covered = spawned;
  if (covered < want) {
    dbmt_scan_min(data, data_len, los[covered], upper,
                 &hashes[covered], &nonces[covered]);
    ++covered;
  }
  uint64_t best_hash = hashes[0], best_nonce = nonces[0];
  for (uint64_t t = 1; t < covered; ++t) {
    if (hashes[t] < best_hash) {
      best_hash = hashes[t];
      best_nonce = nonces[t];
    }
  }
  *out_hash = best_hash;
  *out_nonce = best_nonce;
  return 0;
}

}  // extern "C"
