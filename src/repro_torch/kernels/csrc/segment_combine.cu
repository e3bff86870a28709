// Segmented combine (the D7 sender fold) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/segment_combine/segment_combine.py,
// segment_combine_pallas (body _kernel, in-tile network
// _segmented_scan_tile). It computes the inclusive segmented fold (sum,
// min or max) of (P, M, D) float32 rows whose int32 segment ids are
// sorted within each of the P partition streams, in BM-row tiles, and
// must give the same bits as the reference's blocked schedule
// (segment_combine_blocked, one call per partition) for float sums too.
//
// What bounds it: bytes. Each row is read once (4 B id, 4D B payload,
// 1 B valid) and written once (4D B folded, 1 B is_last): 14 B a row at
// D = 1, with a few adds a row. The TPU kernel carried (last id, running
// value) from one grid step to the next in scratch memory; on this card
// blocks run in no order.
//
// Design: one launch over all P streams, one pass over the data.
//   - A block of BM / 4 threads takes its tile from an atomic ticket, so
//     every tile it may wait on belongs to a block that has already
//     started; tickets run tile-major over the partitions. While the
//     ticket is on its way the block prefetches the rows of the tile it
//     would get in launch order. Each thread holds 4 consecutive rows
//     (16-byte loads and stores where aligned); at 64 registers a thread
//     8 tiles share an SM (a tighter cap spills and runs slower).
//   - The valid mask (int32 max, identity) is applied in registers, and
//     a ragged last tile is padded the same way.
//   - In-tile network: the reference's shifts 1, 2, ..., 256 in that
//     order, so the same brackets. Shifts 1 and 2 read the thread's own
//     rows and its left neighbour's; from 4 on a row reads the same row
//     of the thread shift / 4 to the left. Each shift is one ping-pong
//     shared-memory exchange and one barrier.
//   - Decoupled look-back in place of the sequential carry. The carry
//     out of tile t is its own last value unless the whole tile is one
//     segment that continues row t*BM - 1's id; the tile reads that id
//     directly and publishes at once what it knows: INCLUSIVE (the
//     carry out) or PARTIAL (its last value). A tile whose first segment
//     continues the previous tile walks back, 128 tiles a step, to the
//     newest INCLUSIVE predecessor, and folds the PARTIAL values after
//     it forward, oldest first:
//       carry = fn(...fn(fn(X_k, last_k+1), last_k+2)..., last_t-1),
//     the sequential carry's brackets add for add (a newest-first fold,
//     as CUB does, would bracket float sums differently).
//   - Long segments (a hub vertex, a stream's invalid tail) make chains
//     of PARTIAL tiles. A tile that finds no INCLUSIVE word within 128
//     tiles waits and looks again instead of folding a long window, and
//     a tile whose last segment runs into the next tile runs on once it
//     knows its carry out: it folds the PARTIAL tiles behind it that
//     have published, oldest first, and publishes their carries out (the
//     same bits their own look-back gives), so a chain advances at the
//     speed of one warp's adds.
//   - A stream's invalid tail is one long segment of identities (the
//     engine pads every partition to the largest one). fn(x, identity)
//     is idempotent bit for bit, so every tile past the tail's first
//     tile a has carry in X_a: the tile holding the step from valid to
//     invalid publishes a, and the tail's tiles read X_a directly.
//   - The carry is spliced into the tile's first segment in the same
//     block, and is_last reads one id past each row; past a ragged
//     stream's last row it reads the pad's int32 max.
// The tile words live in scratch that the caller keeps for the stream:
// one 64-bit word a tile and payload column, (epoch << 2 | status) in
// the high half and the value in the low half, so a status and its
// value are read and written as one (aligned 64-bit accesses are
// single-copy atomic) and the scratch is never cleared between launches.
//
// Arithmetic: __fadd_rn for sums (no contraction can arise: there is no
// multiply); min/max written out so that NaN propagates as jnp.minimum /
// jnp.maximum do (fminf/fmaxf would drop it). Built without fast math.
//
// The monoid, the tile words, the look-back and the runner live in
// lookback.cuh, which sort_fold_dense.cu shares.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

template <int OP, int D>
__global__ void __launch_bounds__(MAX_THREADS, 8)
fold_tiles(const int* __restrict__ keys, const float* __restrict__ pay,
           const unsigned char* __restrict__ valid, long long P, long long M,
           int BM, int steps, long long n_tiles,
           unsigned long long* ticket, unsigned long long ticket_base,
           unsigned tag, unsigned long long* words,
           unsigned long long* tail, float* __restrict__ out,
           unsigned char* __restrict__ is_last) {
  __shared__ long long s_tile;
  __shared__ unsigned s_first_len;
  __shared__ float4 s_x[2][MAX_THREADS];
  __shared__ unsigned char s_f[2][MAX_THREADS];
  __shared__ float s_last[D];
  __shared__ float s_carry[D];
  __shared__ int s_cont_in, s_runs;
  __shared__ unsigned s_tail;
  __shared__ unsigned long long s_win[WALK];
  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5;

  if (j == 0) {
    s_tile = (long long)(atomicAdd(ticket, 1ULL) - ticket_base);
    s_first_len = BM;
  }
  {
    // While the ticket is on its way, pull into L1 the rows of the tile
    // that blocks are launched in order for; the ticket nearly always
    // names it, and a wrong guess costs nothing but the prefetch.
    const long long gs = blockIdx.x, ts = gs / P, ps = gs - ts * P;
    const long long r = ts * BM + j * ROWS;
    if (j * ROWS < BM && r < M) {
      const long long e = ps * M + r;
      asm volatile("prefetch.global.L1 [%0];" :: "l"(keys + e));
      asm volatile("prefetch.global.L1 [%0];" :: "l"(pay + e * D));
      asm volatile("prefetch.global.L1 [%0];" :: "l"(valid + e));
    }
  }
  __syncthreads();
  // tickets run tile-major over the partitions, so that the chains of
  // several streams (each one's invalid tail is one) advance together;
  // a tile's predecessor in its stream still has a smaller ticket
  const long long g = s_tile;
  const long long t = g / P, p = g - t * P;
  const Stream s{keys + p * M, pay + p * M * D, valid + p * M, M};
  const long long r0 = t * BM;
  const int i0 = j * ROWS;                    // this thread's first row
  const long long rr = r0 + i0;

  // load 4 rows; rows past BM or M are pads (int32 max, identity)
  int key[ROWS];
  bool val[ROWS];
  float x[D][ROWS];
  const bool full = i0 + ROWS <= BM && rr + ROWS <= M;
  const bool vec = full && D == 1 &&
                   ((reinterpret_cast<uintptr_t>(s.keys + rr) |
                     reinterpret_cast<uintptr_t>(s.pay + rr) |
                     reinterpret_cast<uintptr_t>(out + p * M + rr)) & 15) ==
                       0 &&
                   ((reinterpret_cast<uintptr_t>(s.valid + rr) |
                     reinterpret_cast<uintptr_t>(is_last + p * M + rr)) &
                    3) == 0;
  if (vec) {
    const int4 k4 = *reinterpret_cast<const int4*>(s.keys + rr);
    const uchar4 v4 = *reinterpret_cast<const uchar4*>(s.valid + rr);
    const float4 x4 = *reinterpret_cast<const float4*>(s.pay + rr);
    key[0] = k4.x; key[1] = k4.y; key[2] = k4.z; key[3] = k4.w;
    val[0] = v4.x; val[1] = v4.y; val[2] = v4.z; val[3] = v4.w;
    x[0][0] = x4.x; x[0][1] = x4.y; x[0][2] = x4.z; x[0][3] = x4.w;
  } else {
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      const long long r = rr + m;
      const bool in = i0 + m < BM && r < M;
      key[m] = in ? s.keys[r] : SEG_PAD;
      val[m] = in && s.valid[r];
#pragma unroll
      for (int d = 0; d < D; ++d) x[d][m] = in ? s.pay[r * D + d] : 0.0f;
    }
  }
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    if (!val[m]) key[m] = SEG_PAD;
#pragma unroll
    for (int d = 0; d < D; ++d) if (!val[m]) x[d][m] = ident<OP>();
  }
  // the ids before this thread's first row and after its last one (every
  // lane takes part in every shuffle; the choice comes after). Rows of
  // the tile past BM are past M too, so masked_key pads them.
  const int k_left = __shfl_up_sync(FULL, key[ROWS - 1], 1);
  const int k_right = __shfl_down_sync(FULL, key[0], 1);
  const int k_before = lane > 0 ? k_left
                                : (i0 > 0 ? masked_key(s, rr - 1) : 0);
  const int k_after = lane < 31 ? k_right : masked_key(s, rr + ROWS);
  // the id of the row before the tile (-2 before the first), for warp 0
  const int prev = warp == 0 ? (t > 0 ? masked_key(s, r0 - 1) : -2) : 0;

  // The stream's invalid rows are sorted to its tail. The tile holding
  // the step from valid to invalid (row 0 counts as after a valid row)
  // publishes the first tile a wholly in the tail; a step back from
  // invalid to valid breaks the contract and traps.
  const int v_up = __shfl_up_sync(FULL, (int)val[ROWS - 1], 1);
  bool v_prev = lane > 0 ? v_up != 0
                         : (rr == 0 || (rr - 1 < M && s.valid[rr - 1]));
  bool any_valid = false;
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    const long long r = rr + m;
    if (r >= M) break;
    if (v_prev && !val[m])
      st_bits(tail + p, tag | INCLUSIVE, (unsigned)((r + BM - 1) / BM));
    if (!v_prev && val[m]) __trap();
    v_prev = val[m];
    any_valid = any_valid || val[m];
  }

  // segment starts; row 0 of the tile always starts one
  unsigned fb = 0, first = BM;
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    const int i = i0 + m;
    const int kp = m == 0 ? k_before : key[m - 1];
    if (i == 0 || key[m] != kp) {
      fb |= 1u << m;
      if (i > 0 && i < BM && first == (unsigned)BM) first = i;
    }
  }
  first = __reduce_min_sync(FULL, first);
  if (lane == 0 && first < (unsigned)BM) atomicMin(&s_first_len, first);

  // the network, one payload column at a time; kk counts the exchanges
  // so that the ping-pong buffers alternate across columns too
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
  const int ml = (BM - 1) % ROWS;             // the tile's last row here
  if (j == (BM - 1) / ROWS) {
#pragma unroll
    for (int d = 0; d < D; ++d) s_last[d] = x[d][ml];
    // does the last segment run into the next tile?
    const int kn = ml + 1 < ROWS ? key[ml + 1 < ROWS ? ml + 1 : 0]
                                 : k_after;
    s_runs = r0 + BM < M && key[ml] == kn;
  }
  // a tile with no valid row lies in the stream's invalid tail
  const bool in_tail = !__syncthreads_or(any_valid);

  // publish, and take the carry in where the first segment continues
  const int first_len = (int)s_first_len;
  float X[D];
  unsigned long long* w = words + p * n_tiles * D;
  if (warp == 0) {
    const int k0 = __shfl_sync(FULL, key[0], 0);
    const bool cont_in = k0 == prev;
    const bool cont_out = cont_in && first_len == BM;
    if (lane < D)
      st_word(w + t * D + lane, tag | (cont_out ? PARTIAL : INCLUSIVE),
              s_last[lane]);
    // Past the tail's first tile a, every carry in is X_a: the tail adds
    // only identities, and fn(fn(x, id), id) == fn(x, id) bit for bit.
    long long a = t;
    if (in_tail && cont_in)
      a = (unsigned)wait_word(tail + p, ld_word(tail + p), tag);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      X[d] = s_last[d];
      if (cont_in) {
        const float c = a < t ? wait_inclusive(w + a * D + d, tag)
                              : look_back<OP>(t, w + d, D, tag, s_win);
        if (lane == 0) s_carry[d] = c;
        if (cont_out) {
          X[d] = combine<OP>(c, s_last[d]);
          if (lane == 0) st_word(w + t * D + d, tag | INCLUSIVE, X[d]);
        }
      }
    }
    if (lane == 0) {
      s_cont_in = cont_in;
      s_tail = a < t;
    }
  }
  __syncthreads();

  // splice the carry, store the rows and is_last
  const bool cin = s_cont_in;
  unsigned char lst[ROWS];
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    const int i = i0 + m;
    if (cin && i < first_len) {
#pragma unroll
      for (int d = 0; d < D; ++d) x[d][m] = combine<OP>(s_carry[d], x[d][m]);
    }
    const int kn = m + 1 < ROWS ? key[m + 1 < ROWS ? m + 1 : 0] : k_after;
    // a stream's last row: a ragged stream is padded to a tile multiple
    // with int32-max keys, as the reference pads it, so a last row keyed
    // int32 max there continues into the pad
    lst[m] = val[m] && (rr + m + 1 == M ? (M % BM == 0 || key[m] != SEG_PAD)
                                        : key[m] != kn);
  }
  if (vec) {
    *reinterpret_cast<float4*>(out + p * M + rr) =
        make_float4(x[0][0], x[0][1], x[0][2], x[0][3]);
    *reinterpret_cast<uchar4*>(is_last + p * M + rr) =
        make_uchar4(lst[0], lst[1], lst[2], lst[3]);
  } else {
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      const long long r = rr + m;
      if (i0 + m < BM && r < M) {
#pragma unroll
        for (int d = 0; d < D; ++d) out[(p * M + r) * D + d] = x[d][m];
        is_last[p * M + r] = lst[m];
      }
    }
  }

  // a tile whose last segment runs into the next tile runs on (not in the
  // tail, whose tiles take X_a)
  if (warp == 0 && s_runs && !s_tail) {
#pragma unroll
    for (int d = 0; d < D; ++d) run_on<OP>(t, n_tiles, X[d], w + d, D, tag);
  }
}

template <int OP, int D>
int launch(const int* keys, const float* pay, const unsigned char* valid,
           long long P, long long M, int BM, void* ticket,
           unsigned long long ticket_base, unsigned tag, void* words,
           float* out, unsigned char* is_last, cudaStream_t stream) {
  const long long n_tiles = (M + BM - 1) / BM;
  const int threads = ((BM + ROWS * 32 - 1) / (ROWS * 32)) * 32;
  int steps = 0;
  while ((1 << steps) < (BM > 2 ? BM : 2)) ++steps;   // ceil(log2(max(BM,2)))
  fold_tiles<OP, D><<<(unsigned)(P * n_tiles), threads, 0, stream>>>(
      keys, pay, valid, P, M, BM, steps, n_tiles,
      static_cast<unsigned long long*>(ticket), ticket_base, tag,
      static_cast<unsigned long long*>(words),
      static_cast<unsigned long long*>(words) + P * n_tiles * D, out,
      is_last);
  return (int)cudaGetLastError();
}

template <int OP>
int launch_d(int D, const int* k, const float* py,
             const unsigned char* v, long long P, long long M, int BM,
             void* tk, unsigned long long tb, unsigned tag, void* w,
             float* o, unsigned char* il, cudaStream_t s) {
  switch (D) {
    case 1: return launch<OP, 1>(k, py, v, P, M, BM, tk, tb, tag, w, o, il,
                                 s);
    case 2: return launch<OP, 2>(k, py, v, P, M, BM, tk, tb, tag, w, o, il,
                                 s);
    case 3: return launch<OP, 3>(k, py, v, P, M, BM, tk, tb, tag, w, o, il,
                                 s);
    case 4: return launch<OP, 4>(k, py, v, P, M, BM, tk, tb, tag, w, o, il,
                                 s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// keys: (P, M) int32; pay: (P, M, D) float32; valid: (P, M) bool (one
// byte each); out: (P, M, D) float32; is_last: (P, M) bool. Scratch kept
// by the caller for the stream, zeroed once when allocated: ticket, one
// uint64 that every launch adds P * n_tiles to (ticket_base is its value
// before this launch); words, P * n_tiles * D uint64 tile words and then
// P tail words. epoch in [1, 2**30) is new to the scratch at each
// launch. 1 <= BM <= 512, 1 <= D <= 4, n_tiles = ceil(M / BM). Each
// stream's invalid rows must lie at its tail: a valid row after an
// invalid one traps (the launch fails).
extern "C" int segment_combine_launch(
    const void* keys, const void* pay, const void* valid, long long P,
    long long M, int D, int BM, int op, void* out, void* is_last,
    void* ticket, unsigned long long ticket_base, unsigned epoch,
    void* words, void* stream) {
  if (P <= 0 || M <= 0 || D <= 0 || D > MAX_D || BM <= 0 || BM > MAX_BM ||
      epoch == 0 || epoch >= (1u << 30) ||
      P * ((M + BM - 1) / BM) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* k = static_cast<const int*>(keys);
  auto* py = static_cast<const float*>(pay);
  auto* v = static_cast<const unsigned char*>(valid);
  auto* o = static_cast<float*>(out);
  auto* il = static_cast<unsigned char*>(is_last);
  const unsigned tag = epoch << 2;
  switch (op) {
    case OP_SUM:
      return launch_d<OP_SUM>(D, k, py, v, P, M, BM, ticket, ticket_base,
                              tag, words, o, il, s);
    case OP_MIN:
      return launch_d<OP_MIN>(D, k, py, v, P, M, BM, ticket, ticket_base,
                              tag, words, o, il, s);
    case OP_MAX:
      return launch_d<OP_MAX>(D, k, py, v, P, M, BM, ticket, ticket_base,
                              tag, words, o, il, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
