// Segmented combine (the D7 sender fold) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/segment_combine/segment_combine.py,
// segment_combine_pallas (body _kernel, in-tile network
// _segmented_scan_tile). It computes the inclusive segmented fold (sum,
// min or max) of (M, D) float32 rows whose int32 segment ids are sorted,
// in BM-row tiles, and must give the same bits as the reference's
// blocked schedule (segment_combine_blocked) for float sums too.
//
// What bounds it: bytes. Each row is read once (4 B id + 4D B payload)
// and written once (4D B), about 12 B a row at D = 1, with one add a row.
// The TPU kernel carried (last id, running value) from one grid step to
// the next in scratch memory; on this card blocks run in no order, so
// that carry cannot live inside one kernel without re-bracketing sums.
//
// Design, three launches on one stream:
//   1. tile_scan: one block per BM-row tile runs the reference's
//      Hillis-Steele shift network in shared memory (the same shifts in
//      the same order, so the same brackets) and writes the local fold
//      plus a tile summary: first id, last id, length of the first
//      segment, last local value.
//   2. tile_carry: one warp per payload column walks the tiles in order,
//      32 summaries per coalesced load, handed lane to lane by shuffles.
//      carry(t+1) = combine(carry(t), last(t)) when tile t is one segment
//      that continues the carried id, else last(t) — the reference's
//      sequential carry, add for add.
//   3. tile_fixup: rows of each tile's first segment whose id equals the
//      carried id become combine(carry, v), as the reference splices it.
// The carry pass is sequential across tiles; a decoupled look-back that
// keeps the same bracketing is later work.
//
// Arithmetic: __fadd_rn for sums (no contraction can arise: there is no
// multiply); min/max written out so that NaN propagates as jnp.minimum /
// jnp.maximum do (fminf/fmaxf would drop it). Built without fast math.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int OP_SUM = 0;
constexpr int OP_MIN = 1;
constexpr int OP_MAX = 2;
constexpr int MAX_BM = 512;
constexpr int SEG_PAD = 0x7fffffff;   // int32 max: invalid rows and pads

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

template <int OP>
__global__ void tile_scan(const int* __restrict__ seg,
                          const float* __restrict__ pay, long long M, int D,
                          int BM, int steps, float* __restrict__ out,
                          int* __restrict__ seg_first,
                          int* __restrict__ seg_last,
                          int* __restrict__ first_len,
                          float* __restrict__ last_val) {
  __shared__ float sv[MAX_BM];
  __shared__ unsigned char sf[MAX_BM];
  __shared__ int sseg[MAX_BM];
  __shared__ int s_first_len;
  const long long t = blockIdx.x;
  const int i = threadIdx.x;
  const long long row = t * BM + i;
  const bool in_tile = i < BM;
  const bool real = in_tile && row < M;
  // rows past M in a ragged last tile are pads (SEG_PAD, identity), as
  // the reference pads them; the network is causal, so they never reach
  // a real row
  const int s = real ? seg[row] : SEG_PAD;
  sseg[i] = s;
  if (i == 0) s_first_len = BM;
  __syncthreads();
  const bool boundary = (i == 0) || (s != sseg[i - 1]);
  if (in_tile && i > 0 && boundary) atomicMin(&s_first_len, i);
  __syncthreads();
  if (i == 0) {
    seg_first[t] = s;
    first_len[t] = s_first_len;
  }
  if (i == BM - 1) seg_last[t] = s;
  for (int d = 0; d < D; ++d) {
    float x = real ? pay[row * D + d] : ident<OP>();
    bool f = boundary;
    for (int k = 0; k < steps; ++k) {
      const int sh = 1 << k;
      sv[i] = x;
      sf[i] = f;
      __syncthreads();
      const float pv = i >= sh ? sv[i - sh] : ident<OP>();
      const bool pf = i >= sh ? (sf[i - sh] != 0) : true;
      __syncthreads();
      if (!f) x = combine<OP>(pv, x);
      f = f || pf;
    }
    if (real) out[row * D + d] = x;
    if (i == BM - 1) last_val[t * D + d] = x;
  }
}

template <int OP>
__global__ void tile_carry(const int* __restrict__ seg_last,
                           const int* __restrict__ first_len,
                           const float* __restrict__ last_val,
                           long long n_tiles, int D, int BM,
                           int* __restrict__ carry_seg,
                           float* __restrict__ carry_val) {
  const int lane = threadIdx.x;
  const int d = blockIdx.x;
  float c = ident<OP>();
  int cs = -2;
  for (long long base = 0; base < n_tiles; base += 32) {
    const long long t = base + lane;
    int sl = 0, one = 0;
    float L = 0.0f;
    if (t < n_tiles) {
      sl = seg_last[t];
      one = first_len[t] == BM;
      L = last_val[t * D + d];
    }
    const int cnt = (int)(n_tiles - base < 32 ? n_tiles - base : 32);
    for (int j = 0; j < cnt; ++j) {
      const int slj = __shfl_sync(0xffffffffu, sl, j);
      const int onej = __shfl_sync(0xffffffffu, one, j);
      const float Lj = __shfl_sync(0xffffffffu, L, j);
      if (lane == j) {            // the carry INTO tile base + j
        if (d == 0) carry_seg[t] = cs;
        carry_val[t * D + d] = c;
      }
      c = (onej && slj == cs) ? combine<OP>(c, Lj) : Lj;
      cs = slj;
    }
  }
}

template <int OP>
__global__ void tile_fixup(const int* __restrict__ seg_first,
                           const int* __restrict__ first_len,
                           const int* __restrict__ carry_seg,
                           const float* __restrict__ carry_val, long long M,
                           int D, int BM, float* __restrict__ out) {
  const long long t = blockIdx.x;
  const int i = threadIdx.x;
  if (seg_first[t] != carry_seg[t] || i >= first_len[t]) return;
  const long long row = t * BM + i;
  if (row >= M) return;
  for (int d = 0; d < D; ++d)
    out[row * D + d] = combine<OP>(carry_val[t * D + d], out[row * D + d]);
}

template <int OP>
int launch(const int* seg, const float* pay, long long M, int D, int BM,
           float* out, int* seg_first, int* seg_last, int* first_len,
           float* last_val, int* carry_seg, float* carry_val,
           cudaStream_t stream) {
  const long long n_tiles = (M + BM - 1) / BM;
  const int threads = ((BM + 31) / 32) * 32;
  int steps = 0;
  while ((1 << steps) < (BM > 2 ? BM : 2)) ++steps;   // ceil(log2(max(BM,2)))
  tile_scan<OP><<<(unsigned)n_tiles, threads, 0, stream>>>(
      seg, pay, M, D, BM, steps, out, seg_first, seg_last, first_len,
      last_val);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_carry<OP><<<D, 32, 0, stream>>>(seg_last, first_len, last_val,
                                       n_tiles, D, BM, carry_seg, carry_val);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_fixup<OP><<<(unsigned)n_tiles, threads, 0, stream>>>(
      seg_first, first_len, carry_seg, carry_val, M, D, BM, out);
  return (int)cudaGetLastError();
}

}  // namespace

// seg: (M,) int32, invalid rows already SEG_PAD; pay: (M, D) float32,
// invalid rows already the identity; out: (M, D). Scratch, all of
// n_tiles = ceil(M / BM) rows: seg_first, seg_last, first_len, carry_seg
// (int32) and last_val, carry_val (n_tiles, D) float32. 1 <= BM <= 512.
extern "C" int segment_combine_launch(
    const void* seg, const void* pay, long long M, int D, int BM, int op,
    void* out, void* seg_first, void* seg_last, void* first_len,
    void* last_val, void* carry_seg, void* carry_val, void* stream) {
  if (M <= 0 || D <= 0 || BM <= 0 || BM > MAX_BM)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* sg = static_cast<const int*>(seg);
  auto* py = static_cast<const float*>(pay);
  auto* o = static_cast<float*>(out);
  auto* sf = static_cast<int*>(seg_first);
  auto* sl = static_cast<int*>(seg_last);
  auto* fl = static_cast<int*>(first_len);
  auto* lv = static_cast<float*>(last_val);
  auto* cs = static_cast<int*>(carry_seg);
  auto* cv = static_cast<float*>(carry_val);
  switch (op) {
    case OP_SUM:
      return launch<OP_SUM>(sg, py, M, D, BM, o, sf, sl, fl, lv, cs, cv, s);
    case OP_MIN:
      return launch<OP_MIN>(sg, py, M, D, BM, o, sf, sl, fl, lv, cs, cv, s);
    case OP_MAX:
      return launch<OP_MAX>(sg, py, M, D, BM, o, sf, sl, fl, lv, cs, cv, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
