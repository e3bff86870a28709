// Expert-grouped matmul (the MoE sort dispatch's grouped GEMM) for
// Hopper, sm_90a.
//
// Replaces: src/repro/kernels/moe_gmm/moe_gmm.py, grouped_matmul_pallas
// (body _kernel), with the group padding of moe_gmm/ops.py:_group_pad
// and its gather back folded into an in-kernel tile schedule.
//   out[t] = tokens[t] @ w[expert_of(t)]   (float32 accumulate, out in
//   the tokens' type), tokens sorted by expert.
//
// What bounds it on an H100: operations at prefill (T = 65,536 routed
// rows, d 2048 -> f 1408 and back: 2 T d f = 3.78e11 FLOP, 0.38 ms at
// 989 TFLOP/s, against ~0.9 GB of tokens, out and weights); bytes at
// decode (T = 32 rows: the weights of the ~29 experts they touch, 5.8 MB
// each in bf16, 0.05 ms at 3.35 TB/s).
//
// Design. The TPU kernel needed every token tile to belong to one expert,
// so its wrapper scattered the tokens into a padded copy, one BM-aligned
// slab per expert, and gathered the result back. Here the kernel takes
// the (E,) group sizes itself: one warp of each block turns them into row
// ranges and tile counts in shared memory (the assignment of
// kernels/moe_gmm/ops.py:tile_map: rows past sum(sizes) go to expert
// E - 1, sizes past T are cut, empty experts get no tile), and the block
// reads and writes the unpadded sorted rows directly. A launch is this
// one kernel and no other op.
// - bfloat16: a persistent, warp-specialised GEMM. One block per SM walks
//   the flat list of work tiles (expert, 128-row tile, BN-column tile)
//   with a stride of the grid. A producer warp issues TMA loads into a
//   ring of stages (192 KB in all), each guarded by a full and an empty
//   mbarrier: the token tile (128 rows x 64 of d) from a 2-D map over the
//   sorted tokens, at any row (a tile that runs into the next expert's
//   rows loads them harmlessly; rows past T read as zeros), and the
//   weight tile (64 of d x BN) from a 3-D map over w (E, d, f), read
//   MN-major by the wgmma descriptor, so nothing is transposed by hand.
//   Two consumer warpgroups each run wgmma m64nBNk16 on 64 rows of the
//   tile, keeping one k-step in flight, and release a stage as soon as
//   the wgmma that read it is done. Both always multiply, even rows past
//   the tile's count: a branch on the count makes the compiler serialise
//   every wgmma. The epilogue casts to bf16 and stores row by row, masked
//   to the tile's row count and to f: a TMA store of the whole box would
//   overwrite the next expert's rows. The producer runs ahead into the
//   next tile while the consumers store. BN is 256 where it divides f
//   (w_down, f 2048) and 128 otherwise (f 1408 = 11 x 128); measured on
//   the card, BN 64 was slower at every shape, decode included. Needs d
//   and f multiples of 8 (16-byte rows for TMA).
// - float32: a plain 64 x 64 FMA tile, 4 x 4 outputs a thread, for the
//   reduced models and the tests' float32 shapes; one block per (row
//   tile, column tile), over the same in-kernel schedule.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_E = 256;   // groups the schedule holds

// Group e's rows are [start[e], start[e] + size[e]) of the sorted tokens;
// tile_end[e] counts the bm-row tiles of groups 0 .. e.
struct Groups {
  int start[MAX_E];
  int size[MAX_E];
  int tile_end[MAX_E];
};

// One warp: an inclusive scan of the sizes over chunks of 32 groups.
__device__ void schedule_groups(Groups& g, const void* sizes, int sizes64,
                                int E, int T, int bm) {
  const int lane = threadIdx.x & 31;
  long long row_carry = 0;
  int tile_carry = 0;
  for (int base = 0; base < E; base += 32) {
    const int e = base + lane;
    long long x = 0;
    if (e < E)
      x = sizes64 ? static_cast<const long long*>(sizes)[e]
                  : static_cast<const int*>(sizes)[e];
    long long incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    incl += row_carry;
    const int start = (int)min(incl - x, (long long)T);
    const int end = e == E - 1 ? T : (int)min(incl, (long long)T);
    const int size = e < E ? end - start : 0;
    int tiles = (size + bm - 1) / bm;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, tiles, o);
      if (lane >= o) tiles += y;
    }
    tiles += tile_carry;
    if (e < E) {
      g.start[e] = start;
      g.size[e] = size;
      g.tile_end[e] = tiles;
    }
    row_carry = __shfl_sync(0xffffffffu, incl, 31);
    tile_carry = __shfl_sync(0xffffffffu, tiles, 31);
  }
}

struct Tile {
  int e, r0, rows, n0;
};

// Work tile w: row tile w / n_col (of expert e, the first whose tile_end
// exceeds it), column tile w % n_col.
__device__ __forceinline__ Tile work_tile(const Groups& g, int E, int n_col,
                                          int bm, int bn, int w) {
  const int rt = w / n_col;
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (g.tile_end[mid] > rt) hi = mid;
    else lo = mid + 1;
  }
  const int j = rt - (g.tile_end[lo] - (g.size[lo] + bm - 1) / bm);
  Tile t;
  t.e = lo;
  t.r0 = g.start[lo] + j * bm;
  t.rows = min(bm, g.size[lo] - j * bm);
  t.n0 = (w - rt * n_col) * bn;
  return t;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// ------------------------------------------------------------ bfloat16

constexpr int BM = 128;       // rows a tile: two consumer warpgroups of 64
constexpr int BK = 64;        // d a stage: 64 bf16 = the 128-byte swizzle
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int A_BYTES = BM * BK * 2;            // token tile, 16 KB
constexpr int PANEL_BYTES = BK * 64 * 2;        // BK rows of 64 columns
constexpr int RING_BYTES = 192 * 1024;          // the stages together

// BN columns a tile, BN / 64 panels of w a stage
template <int BN>
struct Ring {
  static constexpr int STAGE_BYTES = A_BYTES + (BN / 64) * PANEL_BYTES;
  static constexpr int STAGES = RING_BYTES / STAGE_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;
};

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
gmm_bf16(const __grid_constant__ CUtensorMap tm_x,
         const __grid_constant__ CUtensorMap tm_w,
         const void* __restrict__ sizes, int sizes64, int E, int T, int d,
         int f, __nv_bfloat16* __restrict__ out) {
  using namespace hopper;
  constexpr int STAGES = Ring<BN>::STAGES, STAGE_BYTES = Ring<BN>::STAGE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ Groups g;
  uint8_t* smem = align_1024(smem_raw);
  if (threadIdx.x < 32) {
    schedule_groups(g, sizes, sizes64, E, T, BM);
  } else if (threadIdx.x == 32) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int n_col = (f + BN - 1) / BN;
  const int n_work = g.tile_end[E - 1] * n_col;
  const int nk = (d + BK - 1) / BK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (tid == 0) {
      tma_prefetch_map(&tm_x);
      tma_prefetch_map(&tm_w);
      int stage = 0;
      uint32_t phase = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
        const Tile t = work_tile(g, E, n_col, BM, BN, w);
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* a = smem + stage * STAGE_BYTES;
          mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);
          tma_load_2d(a, &tm_x, &full[stage], kb * BK, t.r0);
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            tma_load_3d(a + A_BYTES + p * PANEL_BYTES, &tm_w, &full[stage],
                        t.n0 + 64 * p, kb * BK, t.e);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: rows 64 c .. 64 c + 63 of every tile. Both always
    // run the wgmma, even on rows past the tile's count: a branch on the
    // count would make the compiler serialise every wgmma.
    setmaxnreg_inc<232>();
    const int c = wg - 1, warp = tid / 32, lane = tid % 32;
    int stage = 0;
    uint32_t phase = 0;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      const Tile t = work_tile(g, E, n_col, BM, BN, w);
      int prev = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint32_t a = smem_u32(smem + stage * STAGE_BYTES) + c * 64 * 128;
        const uint32_t b = smem_u32(smem + stage * STAGE_BYTES + A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < BK / 16; ++s)
          Wgmma<BN>::template ss<1>(
              acc, desc_k_major<128>(a + 32 * s),
              desc_mn_major<128>(b + 16 * 128 * s, PANEL_BYTES),
              (kb | s) != 0);
        wgmma_commit();
        wgmma_wait<1>();       // the k-step before this one is done
        if (kb > 0 && tid == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (tid == 0) mbar_arrive(&empty[prev]);
      // f is a multiple of 8, so a column pair (2i, 2i + 1) is in or out
      const int r = 64 * c + 16 * warp + lane / 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = t.n0 + 8 * j + 2 * (lane % 4);
        if (col >= f) continue;
        if (r < t.rows)
          *reinterpret_cast<uint32_t*>(
              out + (long long)(t.r0 + r) * f + col) =
              pack(acc[4 * j], acc[4 * j + 1]);
        if (r + 8 < t.rows)
          *reinterpret_cast<uint32_t*>(
              out + (long long)(t.r0 + r + 8) * f + col) =
              pack(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

template <int BN>
int launch_bf16(const void* tokens, const void* w, const void* sizes,
                int sizes64, int E, int T, int d, int f, void* out,
                cudaStream_t s) {
  CUtensorMap tm_x, tm_w;
  const cuuint64_t x_dims[2] = {(cuuint64_t)d, (cuuint64_t)T};
  const cuuint64_t x_strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t x_box[2] = {BK, BM};
  int rc = hopper::encode_bf16_map(&tm_x, tokens, 2, x_dims, x_strides,
                                   x_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  const cuuint64_t w_dims[3] = {(cuuint64_t)f, (cuuint64_t)d, (cuuint64_t)E};
  const cuuint64_t w_strides[2] = {(cuuint64_t)f * 2, (cuuint64_t)f * d * 2};
  const cuuint32_t w_box[3] = {64, BK, 1};
  rc = hopper::encode_bf16_map(&tm_w, w, 3, w_dims, w_strides, w_box,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        gmm_bf16<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Ring<BN>::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  static const int sms = hopper::sm_count();
  const long long n_col = (f + BN - 1) / BN;
  const long long most = ((T + BM - 1) / BM + E) * n_col;  // work tiles
  const int grid = (int)(most < sms ? most : sms);
  gmm_bf16<BN><<<grid, THREADS, Ring<BN>::SMEM_BYTES, s>>>(
      tm_x, tm_w, sizes, sizes64, E, T, d, f,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ float32

constexpr int FB = 64;       // float32 tile: FB x FB outputs
constexpr int FBK = 16;
constexpr int FTHREADS = 256;  // 16 x 16, 4 x 4 outputs each

__global__ void __launch_bounds__(FTHREADS)
gmm_f32(const float* __restrict__ tokens, const float* __restrict__ w,
        const void* __restrict__ sizes, int sizes64, int E, int T, int d,
        int f, float* __restrict__ out) {
  __shared__ Groups g;
  __shared__ float As[FBK][FB + 1];
  __shared__ float Bs[FBK][FB];
  if (threadIdx.x < 32) schedule_groups(g, sizes, sizes64, E, T, FB);
  __syncthreads();
  if ((int)blockIdx.x >= g.tile_end[E - 1]) return;
  const Tile t = work_tile(g, E, gridDim.y, FB, FB,
                           blockIdx.x * gridDim.y + blockIdx.y);
  const int rows = t.rows, n0 = t.n0;
  const float* W = w + (long long)t.e * d * f;
  const float* X = tokens + (long long)t.r0 * d;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += FBK) {
    for (int c = tid; c < FB * FBK; c += FTHREADS) {
      const int r = c / FBK, kk = c % FBK;
      As[kk][r] = (r < rows && k0 + kk < d) ? X[(long long)r * d + k0 + kk]
                                             : 0.f;
      const int kr = c / FB, n = c % FB;
      Bs[kr][n] = (k0 + kr < d && n0 + n < f)
                      ? W[(long long)(k0 + kr) * f + n0 + n]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < f) out[(long long)(t.r0 + r) * f + col] = acc[i][j];
    }
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. tokens: (T, d), w: (E, d, f), out: (T,
// f), all contiguous, sorted by expert; sizes: (E,) group sizes, int64 if
// sizes64 else int32, on the card. E <= 256. bf16 needs d % 8 == 0, f % 8
// == 0 and 16-byte aligned tokens and w. Returns a cudaError_t, or
// hopper::TMAP_ERROR + a CUresult when a tensor map is refused.
extern "C" int grouped_matmul_launch(int dtype, const void* tokens,
                                     const void* w, const void* sizes,
                                     int sizes64, int E, long long T, int d,
                                     int f, void* out, void* stream) {
  if (T <= 0) return 0;
  if (d <= 0 || f <= 0 || E <= 0 || E > MAX_E || T > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (d % 8 != 0 || f % 8 != 0) return (int)cudaErrorInvalidValue;
    return f % 256 == 0
               ? launch_bf16<256>(tokens, w, sizes, sizes64, E, (int)T, d, f,
                                  out, s)
               : launch_bf16<128>(tokens, w, sizes, sizes64, E, (int)T, d, f,
                                  out, s);
  } else if (dtype == 0) {
    const long long rows = (T + FB - 1) / FB + E;
    if ((f + FB - 1) / FB > 65535 || rows > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    gmm_f32<<<dim3((unsigned)rows, (f + FB - 1) / FB), FTHREADS, 0, s>>>(
        static_cast<const float*>(tokens), static_cast<const float*>(w),
        sizes, sizes64, E, (int)T, d, f, static_cast<float*>(out));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
