// Sorted-run fold into dense slots (the D1 sort group-by) for Hopper, sm_90a.
//
// Replaces: src/repro/core/groupby.py, sort_combine_dense, which the JAX
// package leaves to XLA (a segmented associative_scan over the sorted
// inbox, then a scatter with mode="drop"); it has no Pallas kernel. The
// port's plain chain (core/groupby.py: a Hillis-Steele network of 26
// whole-inbox passes at 34 M rows, then two scatters through a sink slot)
// allocated and copied the inbox in every pass. For each of P streams of
// (M, D) float32 rows sorted by int32 slot, invalid rows keyed int32 max
// at the stream's tail (groupby._sort_rows), it computes
//   dense[p, s] = fn over the valid rows of stream p with slot s, the
//                 identity (0, +inf, -inf) where none;
//   has[p, s]   = some valid row of stream p has slot s;
// a row whose slot lies outside [0, Np) is dropped. The fold keeps the
// brackets of the blocked schedule (segment_combine_blocked in 512-row
// tiles), so the result is deterministic and a float sum equals
// kernels/sort_fold_dense/ref.py bit for bit.
//
// What bounds it: bytes. A kept row is read once (4 B id, 4D B payload,
// 1 B valid); of the dropped tail only one id a tile is read; dense and
// has are written once each by the fill (4D B and 1 B a slot), and a
// slot that receives a run once more by the run's last row.
//
// Design: two launches on the caller's stream.
//   - fill_dense writes the identity into dense and 0 into has, in
//     16-byte stores.
//   - fold_runs_dense is segment_combine.cu's fold_tiles with a dense
//     epilogue: its in-tile network, and from lookback.cuh its tickets,
//     PARTIAL / INCLUSIVE words, oldest-first look-back and runner.
//     A block takes its tile by ticket and first reads the tile's first
//     id (the id of the tile it would get in launch order is read while
//     the ticket is on its way). Ids ascend, so a tile whose first id is
//     Np or more holds no kept row: it returns at once, never publishes,
//     and no tile looks back into it (the tiles before a live tile are
//     live). A live tile folds its rows, looks back only where its
//     first run continues a kept slot, and the last row of each run
//     whose slot lies in [0, Np) stores the folded row into dense[p,
//     slot] and 1 into has[p, slot]. Slots ascend along the rows, so a
//     warp's stores land on few lines. Nothing else is written: no
//     per-row output, no sink slot, no tail word.
//   - Ids that do not ascend break the contract and trap (the launch
//     fails), as a valid row after an invalid one does in fold_tiles.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int FILL_THREADS = 256;

// dense (n floats) = ident, has (n_has bytes) = 0.
__global__ void __launch_bounds__(FILL_THREADS)
fill_dense(float* __restrict__ dense, long long n, float id,
           unsigned char* __restrict__ has, long long n_has) {
  const long long stride = (long long)gridDim.x * FILL_THREADS;
  const long long i0 = (long long)blockIdx.x * FILL_THREADS + threadIdx.x;
  const float4 id4 = make_float4(id, id, id, id);
  float4* d4 = reinterpret_cast<float4*>(dense);
  for (long long i = i0; i < n / 4; i += stride) d4[i] = id4;
  for (long long i = (n / 4) * 4 + i0; i < n; i += stride) dense[i] = id;
  uint4* h4 = reinterpret_cast<uint4*>(has);
  for (long long i = i0; i < n_has / 16; i += stride)
    h4[i] = make_uint4(0u, 0u, 0u, 0u);
  for (long long i = (n_has / 16) * 16 + i0; i < n_has; i += stride)
    has[i] = 0;
}

// The in-tile network over one tile's BM rows, ROWS a thread, one payload
// column at a time: fold_tiles' own, the reference's shifts 1, 2, ...,
// 2**(steps - 1) in that order (_segmented_scan_tile), so the same
// brackets. Shifts 1 and 2 read the thread's own rows and its left
// neighbour's; from 4 on a row reads the same row of the thread shift / 4
// to the left. Each shift is one ping-pong shared-memory exchange and one
// barrier (every thread of the block takes part); kk counts the exchanges
// so that the buffers alternate across columns too. fb holds the thread's
// run starts, a bit a row. fold_tiles keeps the same lines inline: called
// from there as a function they compile to other SASS (the same
// instructions, scheduled otherwise), and the D7 fold's code stays as it
// was.
template <int OP, int D>
__device__ __forceinline__ void tile_network(
    float (&x)[D][ROWS], unsigned fb, int steps,
    float4 (&s_x)[2][MAX_THREADS], unsigned char (&s_f)[2][MAX_THREADS]) {
  const int j = threadIdx.x;
  int kk = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float* v = x[d];
    unsigned f = fb;
    for (int k = 0; k < steps; ++k, ++kk) {
      const int sh = 1 << k, b = kk & 1;
      s_x[b][j] = make_float4(v[0], v[1], v[2], v[3]);
      s_f[b][j] = (unsigned char)f;
      __syncthreads();
      const float id = ident<OP>();
      float pv[ROWS];
      unsigned pf;
      if (sh >= ROWS) {                   // the same row, sh / 4 threads left
        const int js = j - (sh >> 2);
        const float4 q = js >= 0 ? s_x[b][js] : make_float4(id, id, id, id);
        pf = js >= 0 ? s_f[b][js] : 0xfu;
        pv[0] = q.x; pv[1] = q.y; pv[2] = q.z; pv[3] = q.w;
      } else {                            // own rows and the left neighbour's
        const float4 q = j > 0 ? s_x[b][j - 1] : make_float4(id, id, id, id);
        const unsigned qf = j > 0 ? s_f[b][j - 1] : 0xfu;
        const float both[2 * ROWS] = {q.x, q.y, q.z, q.w,
                                      v[0], v[1], v[2], v[3]};
        pf = ((qf | (f << ROWS)) >> (ROWS - sh)) & 0xfu;
#pragma unroll
        for (int m = 0; m < ROWS; ++m)
          pv[m] = sh == 1 ? both[ROWS + m - 1] : both[ROWS + m - 2];
      }
#pragma unroll
      for (int m = 0; m < ROWS; ++m)
        if (!((f >> m) & 1u)) v[m] = combine<OP>(pv[m], v[m]);
      f |= pf;
    }
  }
}

// a slot that dense holds
__device__ __forceinline__ bool kept(int k, int Np) {
  return (unsigned)k < (unsigned)Np;
}

template <int OP, int D>
__global__ void __launch_bounds__(MAX_THREADS, 8)
fold_runs_dense(const int* __restrict__ keys, const float* __restrict__ pay,
                const unsigned char* __restrict__ valid, long long P,
                long long M, int BM, int steps, long long n_tiles, int Np,
                unsigned long long* ticket, unsigned long long ticket_base,
                unsigned tag, unsigned long long* words,
                float* __restrict__ dense, unsigned char* __restrict__ has) {
  __shared__ long long s_tile;
  __shared__ int s_live;
  __shared__ unsigned s_first_len;
  __shared__ float4 s_x[2][MAX_THREADS];
  __shared__ unsigned char s_f[2][MAX_THREADS];
  __shared__ float s_last[D];
  __shared__ float s_carry[D];
  __shared__ int s_cont_in, s_runs;
  __shared__ unsigned long long s_win[WALK];
  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5;

  if (j == 0) {
    // tickets run tile-major over the partitions, as in fold_tiles
    const long long gs = blockIdx.x, ts = gs / P, ps = gs - ts * P;
    const long long es = ps * M + ts * BM;
    const int kg = keys[es];
    const unsigned char vg = valid[es];
    const long long g = (long long)(atomicAdd(ticket, 1ULL) - ticket_base);
    int k0 = vg ? kg : SEG_PAD;
    if (g != gs) {
      const long long tg = g / P, pg = g - tg * P;
      const long long e = pg * M + tg * BM;
      k0 = valid[e] ? keys[e] : SEG_PAD;
    }
    s_tile = g;
    s_live = k0 < Np;
    s_first_len = BM;
  }
  __syncthreads();
  if (!s_live) return;                // the dropped tail: nothing to write
  const long long g = s_tile;
  const long long t = g / P, p = g - t * P;
  const Stream s{keys + p * M, pay + p * M * D, valid + p * M, M};
  const long long r0 = t * BM;
  const int i0 = j * ROWS;                    // this thread's first row
  const long long rr = r0 + i0;

  // load 4 rows, invalid ones masked (int32 max, identity); rows past BM
  // or M are pads
  int key[ROWS];
  float x[D][ROWS];
  const bool vec = D == 1 && i0 + ROWS <= BM && rr + ROWS <= M &&
                   ((reinterpret_cast<uintptr_t>(s.keys + rr) |
                     reinterpret_cast<uintptr_t>(s.pay + rr)) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(s.valid + rr) & 3) == 0;
  if (vec) {
    const int4 k4 = *reinterpret_cast<const int4*>(s.keys + rr);
    const uchar4 v4 = *reinterpret_cast<const uchar4*>(s.valid + rr);
    const float4 x4 = *reinterpret_cast<const float4*>(s.pay + rr);
    const int kk[ROWS] = {k4.x, k4.y, k4.z, k4.w};
    const bool vv[ROWS] = {v4.x != 0, v4.y != 0, v4.z != 0, v4.w != 0};
    const float xx[ROWS] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      key[m] = vv[m] ? kk[m] : SEG_PAD;
      x[0][m] = vv[m] ? xx[m] : ident<OP>();
    }
  } else {
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      const long long r = rr + m;
      const bool v = i0 + m < BM && r < M && s.valid[r];
      key[m] = v ? s.keys[r] : SEG_PAD;
#pragma unroll
      for (int d = 0; d < D; ++d) x[d][m] = v ? s.pay[r * D + d] : ident<OP>();
    }
  }
  // the ids before this thread's first row and after its last one (every
  // lane takes part in every shuffle; the choice comes after)
  const int k_left = __shfl_up_sync(FULL, key[ROWS - 1], 1);
  const int k_right = __shfl_down_sync(FULL, key[0], 1);
  const int k_before = lane > 0 ? k_left
                                : (i0 > 0 ? masked_key(s, rr - 1) : 0);
  const int k_after = lane < 31 ? k_right : masked_key(s, rr + ROWS);
  // the id of the row before the tile (-2 before the first), for warp 0
  const int prev = warp == 0 ? (t > 0 ? masked_key(s, r0 - 1) : -2) : 0;

  // run starts; row 0 of the tile always starts one
  unsigned fb = 0, first = BM;
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    const int i = i0 + m;
    const int kp = m == 0 ? k_before : key[m - 1];
    if (i > 0 && key[m] < kp) __trap();       // ids must ascend
    if (i == 0 || key[m] != kp) {
      fb |= 1u << m;
      if (i > 0 && i < BM && first == (unsigned)BM) first = i;
    }
  }
  first = __reduce_min_sync(FULL, first);
  if (lane == 0 && first < (unsigned)BM) atomicMin(&s_first_len, first);

  tile_network<OP, D>(x, fb, steps, s_x, s_f);
  const int ml = (BM - 1) % ROWS;             // the tile's last row here
  if (j == (BM - 1) / ROWS) {
#pragma unroll
    for (int d = 0; d < D; ++d) s_last[d] = x[d][ml];
    // does the last run, of a kept slot, run into the next tile?
    const int kn = ml + 1 < ROWS ? key[ml + 1 < ROWS ? ml + 1 : 0]
                                 : k_after;
    s_runs = r0 + BM < M && key[ml] == kn && kept(key[ml], Np);
  }
  __syncthreads();

  // publish, and take the carry in where the first run continues a kept
  // slot (a dropped run's carry is never read)
  const int first_len = (int)s_first_len;
  float X[D];
  unsigned long long* w = words + p * n_tiles * D;
  if (warp == 0) {
    const int k0 = __shfl_sync(FULL, key[0], 0);
    if (t > 0 && k0 < prev) __trap();         // ids must ascend
    const bool cont_in = k0 == prev && kept(k0, Np);
    const bool cont_out = cont_in && first_len == BM;
    if (lane < D)
      st_word(w + t * D + lane, tag | (cont_out ? PARTIAL : INCLUSIVE),
              s_last[lane]);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      X[d] = s_last[d];
      if (cont_in) {
        const float c = look_back<OP>(t, w + d, D, tag, s_win);
        if (lane == 0) s_carry[d] = c;
        if (cont_out) {
          X[d] = combine<OP>(c, s_last[d]);
          if (lane == 0) st_word(w + t * D + d, tag | INCLUSIVE, X[d]);
        }
      }
    }
    if (lane == 0) s_cont_in = cont_in;
  }
  __syncthreads();

  // splice the carry; the last row of each run of a kept slot stores it
  const bool cin = s_cont_in;
  float* dense_p = dense + p * (long long)Np * D;
  unsigned char* has_p = has + p * (long long)Np;
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    const int i = i0 + m;
    if (cin && i < first_len) {
#pragma unroll
      for (int d = 0; d < D; ++d) x[d][m] = combine<OP>(s_carry[d], x[d][m]);
    }
    const int kn = m + 1 < ROWS ? key[m + 1 < ROWS ? m + 1 : 0] : k_after;
    if (kept(key[m], Np) && key[m] != kn) {
#pragma unroll
      for (int d = 0; d < D; ++d)
        dense_p[(long long)key[m] * D + d] = x[d][m];
      has_p[key[m]] = 1;
    }
  }

  // a tile whose last run runs into the next tile runs on
  if (warp == 0 && s_runs) {
#pragma unroll
    for (int d = 0; d < D; ++d) run_on<OP>(t, n_tiles, X[d], w + d, D, tag);
  }
}

template <int OP, int D>
int launch(const int* keys, const float* pay, const unsigned char* valid,
           long long P, long long M, int BM, int Np, void* ticket,
           unsigned long long ticket_base, unsigned tag, void* words,
           float* dense, unsigned char* has, cudaStream_t stream) {
  const long long n_tiles = (M + BM - 1) / BM;
  const int threads = ((BM + ROWS * 32 - 1) / (ROWS * 32)) * 32;
  int steps = 0;
  while ((1 << steps) < (BM > 2 ? BM : 2)) ++steps;   // ceil(log2(max(BM,2)))
  fold_runs_dense<OP, D><<<(unsigned)(P * n_tiles), threads, 0, stream>>>(
      keys, pay, valid, P, M, BM, steps, n_tiles, Np,
      static_cast<unsigned long long*>(ticket), ticket_base, tag,
      static_cast<unsigned long long*>(words), dense, has);
  return (int)cudaGetLastError();
}

template <int OP>
int launch_d(int D, const int* k, const float* py, const unsigned char* v,
             long long P, long long M, int BM, int Np, void* tk,
             unsigned long long tb, unsigned tag, void* w, float* dn,
             unsigned char* h, cudaStream_t s) {
  switch (D) {
    case 1: return launch<OP, 1>(k, py, v, P, M, BM, Np, tk, tb, tag, w, dn,
                                 h, s);
    case 2: return launch<OP, 2>(k, py, v, P, M, BM, Np, tk, tb, tag, w, dn,
                                 h, s);
    case 3: return launch<OP, 3>(k, py, v, P, M, BM, Np, tk, tb, tag, w, dn,
                                 h, s);
    case 4: return launch<OP, 4>(k, py, v, P, M, BM, Np, tk, tb, tag, w, dn,
                                 h, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// keys: (P, M) int32, each stream ascending with its invalid rows keyed
// int32 max at its tail; pay: (P, M, D) float32; valid: (P, M) bool (one
// byte each); dense: (P, Np, D) float32 and has: (P, Np) bool, both
// written whole (dense 16-byte aligned, as the caching allocator gives).
// Scratch kept by the caller for the stream, as segment_combine_launch
// takes it: ticket, one uint64 that every launch adds P * n_tiles to
// (ticket_base is its value before this launch); words, at least P *
// n_tiles * D zeroed uint64 tile words. epoch in [1, 2**30) is new to the
// scratch at each launch. 1 <= BM <= 512, 1 <= D <= 4, 0 <= Np < 2**31 - 1,
// n_tiles = ceil(M / BM). op: 0 sum, 1 min, 2 max. Ids that do not ascend
// along a stream trap (the launch fails). Returns the first launch error,
// or 0.
extern "C" int sort_fold_dense_launch(
    const void* keys, const void* pay, const void* valid, long long P,
    long long M, int D, int BM, int Np, int op, void* dense, void* has,
    void* ticket, unsigned long long ticket_base, unsigned epoch,
    void* words, void* stream) {
  if (P < 0 || M < 0 || D <= 0 || D > MAX_D || BM <= 0 || BM > MAX_BM ||
      Np < 0 || Np == SEG_PAD || op < OP_SUM || op > OP_MAX ||
      epoch == 0 || epoch >= (1u << 30) ||
      P * ((M + BM - 1) / BM) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* dn = static_cast<float*>(dense);
  auto* h = static_cast<unsigned char*>(has);
  const long long n = P * Np * D;
  if (n > 0) {
    const float id = op == OP_SUM ? 0.0f : op == OP_MIN ? INFINITY : -INFINITY;
    // a grid-stride loop: up to 16 blocks an SM, one float4 a thread
    long long blocks = (n / 4 + FILL_THREADS - 1) / FILL_THREADS;
    if (blocks < 1) blocks = 1;
    if (blocks > 132 * 16) blocks = 132 * 16;
    fill_dense<<<(unsigned)blocks, FILL_THREADS, 0, s>>>(dn, n, id, h, P * Np);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (n == 0 || M == 0) return 0;
  auto* k = static_cast<const int*>(keys);
  auto* py = static_cast<const float*>(pay);
  auto* v = static_cast<const unsigned char*>(valid);
  const unsigned tag = epoch << 2;
  switch (op) {
    case OP_SUM:
      return launch_d<OP_SUM>(D, k, py, v, P, M, BM, Np, ticket, ticket_base,
                              tag, words, dn, h, s);
    case OP_MIN:
      return launch_d<OP_MIN>(D, k, py, v, P, M, BM, Np, ticket, ticket_base,
                              tag, words, dn, h, s);
    default:
      return launch_d<OP_MAX>(D, k, py, v, P, M, BM, Np, ticket, ticket_base,
                              tag, words, dn, h, s);
  }
}
