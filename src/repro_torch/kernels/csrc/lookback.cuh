// The decoupled look-back of the segmented folds over sorted streams
// (segment_combine.cu, sort_fold_dense.cu): the monoid, the tiles' status
// words, the look-back and the runner. See segment_combine.cu for the
// design; both kernels run one launch over all P streams in BM-row tiles
// taken by ticket.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {


constexpr int OP_SUM = 0;
constexpr int OP_MIN = 1;
constexpr int OP_MAX = 2;
constexpr int MAX_BM = 512;
constexpr int ROWS = 4;                       // rows a thread
constexpr int MAX_THREADS = MAX_BM / ROWS;    // 128
constexpr int MAX_D = 4;
constexpr int WALK = 128;                     // tiles a look-back step
constexpr int RUN = 128;                      // tiles a runner reads at once
constexpr int RUN_BATCHES = 16;               // a runner's budget, x RUN
constexpr int SEG_PAD = 0x7fffffff;   // int32 max: invalid rows and pads
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned PARTIAL = 1u;      // status, low 2 bits of the tag
constexpr unsigned INCLUSIVE = 2u;
constexpr long long TIMEOUT = 1LL << 35;      // cycles, ~20 s

template <int OP>
__device__ __forceinline__ float ident() {
  if (OP == OP_SUM) return 0.0f;
  if (OP == OP_MIN) return INFINITY;
  return -INFINITY;
}

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  if (OP == OP_SUM) return __fadd_rn(a, b);
  if (a != a) return a;
  if (b != b) return b;
  if (OP == OP_MIN) return b < a ? b : a;
  return b > a ? b : a;
}

__device__ __forceinline__ unsigned long long ld_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_bits(unsigned long long* p,
                                        unsigned tag_status, unsigned lo) {
  const unsigned long long v = ((unsigned long long)tag_status << 32) | lo;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void st_word(unsigned long long* p,
                                        unsigned tag_status, float x) {
  st_bits(p, tag_status, __float_as_uint(x));
}

__device__ __forceinline__ bool tagged(unsigned long long v, unsigned tag) {
  return ((unsigned)(v >> 32) & ~3u) == tag;
}

__device__ __forceinline__ unsigned status(unsigned long long v) {
  return (unsigned)(v >> 32) & 3u;
}

__device__ __forceinline__ float value(unsigned long long v) {
  return __uint_as_float((unsigned)v);
}

// The word of a tile once it has published in this launch (tag = epoch
// << 2), given a first read v. Its block has started and publishes
// without waiting, so the wait is short; a wait that never ends traps
// instead of hanging the card.
__device__ __forceinline__ unsigned long long wait_word(
    const unsigned long long* w, unsigned long long v, unsigned tag) {
  if (tagged(v, tag)) return v;
  const long long t0 = clock64();
  for (;;) {
    __nanosleep(32);
    v = ld_word(w);
    if (tagged(v, tag)) return v;
    if (clock64() - t0 > TIMEOUT) __trap();
  }
}

// A tile's carry out, once its word is INCLUSIVE.
__device__ __forceinline__ float wait_inclusive(
    const unsigned long long* w, unsigned tag) {
  unsigned long long v = ld_word(w);
  const long long t0 = clock64();
  while (!(tagged(v, tag) && status(v) == INCLUSIVE)) {
    if (clock64() - t0 > TIMEOUT) __trap();
    __nanosleep(64);
    v = ld_word(w);
  }
  return value(v);
}

// Fold one chunk of up to 32 tile words (lane j holds tile k0 + j's word,
// cnt of them real) into c, oldest first: a PARTIAL word adds its last
// value, an INCLUSIVE one is the carry itself. Publishes the carry out of
// every PARTIAL tile folded (all lanes of the warp take part; wk is the
// lane's own tile word).
template <int OP>
__device__ __forceinline__ float fold_chunk(float c, unsigned long long cur,
                                            int cnt, unsigned long long* wk,
                                            unsigned tag) {
  const int lane = threadIdx.x & 31;
  const unsigned h_cur = (unsigned)(cur >> 32);
  const float v_cur = value(cur);
  float done = 0.0f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const unsigned h = __shfl_sync(FULL, h_cur, j);
    const float v = __shfl_sync(FULL, v_cur, j);
    if (j < cnt) c = (h & 3u) == INCLUSIVE ? v : combine<OP>(c, v);
    if (lane == j) done = c;
  }
  if (lane < cnt && (h_cur & 3u) == PARTIAL)
    st_word(wk, tag | INCLUSIVE, done);
  return c;
}

// X_{t-1}, the carry out of tile t - 1 in one payload column (all lanes
// of warp 0 take part; every lane returns it). w holds the partition's
// words of this column, tile k's at w[k * D]. X_{-1} is the identity.
template <int OP>
__device__ float look_back(long long t, unsigned long long* w, int D,
                           unsigned tag, unsigned long long* s_win) {
  const int lane = threadIdx.x & 31;
  long long stop = -1;
  float c = ident<OP>();
  const long long t0 = clock64();
  for (;;) {
    unsigned long long wd[WALK / 32];
#pragma unroll
    for (int u = 0; u < WALK / 32; ++u) {
      const long long k = t - 1 - 32 * u - lane;
      wd[u] = k >= 0 ? ld_word(w + k * D) : 0ULL;
    }
    bool found = false;
#pragma unroll
    for (int u = 0; u < WALK / 32; ++u) {
      const long long k = t - 1 - 32 * u - lane;
      if (k >= 0) {
        wd[u] = wait_word(w + k * D, wd[u], tag);
        s_win[32 * u + lane] = wd[u];         // tile t - 1 - (32u + lane)
      }
      const unsigned m = __ballot_sync(FULL, k < 0 ||
                                             status(wd[u]) == INCLUSIVE);
      if (m) {
        const int src = __ffs(m) - 1;
        stop = t - 1 - 32 * u - src;
        const float xs = __shfl_sync(FULL, value(wd[u]), src);
        c = stop < 0 ? ident<OP>() : xs;
        found = true;
        break;
      }
    }
    if (found) break;
    // the chain runs further back: wait for a runner to come nearer
    if (clock64() - t0 > TIMEOUT) __trap();
    __nanosleep(256);
  }
  __syncwarp();
  for (long long k0 = stop + 1; k0 < t; k0 += 32) {
    const long long k = k0 + lane;
    const unsigned long long cur = k < t ? s_win[t - 1 - k] : 0ULL;
    const int cnt = (int)(t - k0 < 32 ? t - k0 : 32);
    c = fold_chunk<OP>(c, cur, cnt, w + (k < t ? k : 0) * D, tag);
  }
  __syncwarp();
  return c;
}

// The runner: with X_t = c known, fold on through the PARTIAL tiles
// t + 1, t + 2, ... of this partition that have published, publishing
// their carries out; stop at a tile that has not published or is
// INCLUSIVE already, or at the budget. Words are read RUN / 32 chunks
// at a time, the next batch while the current one is folded.
template <int OP>
__device__ void run_on(long long t, long long n_tiles, float c,
                       unsigned long long* w, int D, unsigned tag) {
  constexpr int U = RUN / 32;
  const int lane = threadIdx.x & 31;
  long long k0 = t + 1;
  unsigned long long next[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long k = k0 + 32 * u + lane;
    next[u] = k < n_tiles ? ld_word(w + k * D) : 0ULL;
  }
  for (int n = 0; n < RUN_BATCHES && k0 < n_tiles; ++n, k0 += RUN) {
    unsigned long long cur[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cur[u] = next[u];
      const long long k = k0 + RUN + 32 * u + lane;
      next[u] = k < n_tiles ? ld_word(w + k * D) : 0ULL;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long k = k0 + 32 * u + lane;
      // the leading run of published PARTIAL words
      const bool go = k < n_tiles && tagged(cur[u], tag) &&
                      status(cur[u]) == PARTIAL;
      const unsigned stopped = __ballot_sync(FULL, !go);
      const int cnt = stopped ? __ffs(stopped) - 1 : 32;
      if (cnt == 0) return;
      c = fold_chunk<OP>(c, cur[u], cnt, w + (k < n_tiles ? k : 0) * D,
                         tag);
      if (cnt < 32) return;
    }
  }
}

struct Stream {          // one partition's rows
  const int* keys;
  const float* pay;
  const unsigned char* valid;
  long long M;
};

// The masked id of row r (int32 max where invalid or past the end).
__device__ __forceinline__ int masked_key(const Stream& s, long long r) {
  return (r < s.M && s.valid[r]) ? s.keys[r] : SEG_PAD;
}

}  // namespace
