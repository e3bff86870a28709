// Expert-grouped matmul (the MoE sort dispatch's grouped GEMM) for
// Hopper, sm_90a.
//
// Replaces: src/repro/kernels/moe_gmm/moe_gmm.py, grouped_matmul_pallas
// (body _kernel), with the group padding of moe_gmm/ops.py:_group_pad
// and its gather back folded into the tile map.
//   out[t] = tokens[t] @ w[expert_of(t)]   (float32 accumulate, out in
//   the tokens' type), tokens sorted by expert.
//
// What bounds it: operations at prefill (T = 65,536 routed rows, d =
// 2048, f = 1408: 2 T d f ~ 3.78e11 FLOP against ~0.9 GB of tokens,
// out and weights), bytes at decode (T = 32 rows: the weights of the
// experts they touch, 5.8 MB each in bf16, dominate).
//
// Design. The TPU kernel needed every token tile to belong to one expert,
// so ops.py scattered the tokens into a padded copy, one BM-aligned slab
// per expert, and gathered the result back. Here a block reads its own
// tile's entry of a tile map (expert, first row, row count), built on the
// card by kernels/moe_gmm/ops.py, and reads and writes the unpadded
// sorted rows directly: no padded copy, no gather back. The map has a
// static length (ceil(T / BM) + E, the most tiles the groups can need);
// entries past the last tile have a row count of 0 and return at once,
// as do experts without tokens (the pad experts are never routed). A
// block computes a BM x BN tile of out, looping over d in BK steps.
// - bfloat16: 4 warps in 2 x 2, each 32 x 64, mma.sync m16n8k16 (bf16
//   in, float32 accumulate). The token tile is staged row-major and the
//   weight tile transposed (n-major) in shared memory, rows padded so
//   the fragment loads do not conflict on banks. Needs d and f to be
//   multiples of 8 (16-byte rows).
// - float32: a plain 64 x 64 FMA tile, 4 x 4 outputs a thread, for the
//   reduced models and the tests' float32 shapes.
// No software pipelining yet; cp.async / TMA and wgmma are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 128;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

__global__ void __launch_bounds__(THREADS)
gmm_bf16(const __nv_bfloat16* __restrict__ tokens,
         const __nv_bfloat16* __restrict__ w, const int* __restrict__ tiles,
         int d, int f, __nv_bfloat16* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][BK + 8];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][BK + 8];
  const int e = tiles[3 * blockIdx.x], r0 = tiles[3 * blockIdx.x + 1];
  const int rows = tiles[3 * blockIdx.x + 2];
  if (rows <= 0) return;
  const int n0 = blockIdx.y * BN;
  const __nv_bfloat16* W = w + (long long)e * d * f;
  const __nv_bfloat16* X = tokens + (long long)r0 * d;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int g = lane >> 2, t = lane & 3;
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    // token tile: BM rows x BK, 16-byte chunks; rows past the tile's
    // count and columns past d load as zeros
    for (int c = tid; c < BM * BK / 8; c += THREADS) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && k0 + kc < d)
        x = *reinterpret_cast<const uint4*>(X + (long long)r * d + k0 + kc);
      *reinterpret_cast<uint4*>(&As[r][kc]) = x;
    }
    // weight tile: BK rows of w[e] x BN, stored transposed Bs[n][k];
    // the k index runs fastest over a warp so the 2-byte stores spread
    for (int c = tid; c < BK * BN / 8; c += THREADS) {
      const int kr = c % BK, nc = (c / BK) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + kr < d && n0 + nc < f)
        x = *reinterpret_cast<const uint4*>(W + (long long)(k0 + kr) * f +
                                            n0 + nc);
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i) Bs[nc + i][kr] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* p = &As[wm + i * 16 + g][kk + 2 * t];
        a[i][0] = ld32(p);
        a[i][1] = ld32(p + 8 * (BK + 8));
        a[i][2] = ld32(p + 8);
        a[i][3] = ld32(p + 8 * (BK + 8) + 8);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* p = &Bs[wn + j * 8 + g][kk + 2 * t];
        const uint32_t b0 = ld32(p), b1 = ld32(p + 8);
        mma_bf16(acc[0][j], a[0], b0, b1);
        mma_bf16(acc[1][j], a[1], b0, b1);
      }
    }
    __syncthreads();
  }
  // f is a multiple of 8, so a column pair (2t, 2t+1) is in or out whole
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int ra = wm + i * 16 + g, rb = ra + 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
      if (col >= f) continue;
      if (ra < rows)
        *reinterpret_cast<uint32_t*>(out + (long long)(r0 + ra) * f + col) =
            pack(acc[i][j][0], acc[i][j][1]);
      if (rb < rows)
        *reinterpret_cast<uint32_t*>(out + (long long)(r0 + rb) * f + col) =
            pack(acc[i][j][2], acc[i][j][3]);
    }
  }
}

constexpr int FB = 64;       // float32 tile: FB x FB outputs
constexpr int FBK = 16;
constexpr int FTHREADS = 256;  // 16 x 16, 4 x 4 outputs each

__global__ void __launch_bounds__(FTHREADS)
gmm_f32(const float* __restrict__ tokens, const float* __restrict__ w,
        const int* __restrict__ tiles, int d, int f,
        float* __restrict__ out) {
  __shared__ float As[FBK][FB + 1];
  __shared__ float Bs[FBK][FB];
  const int e = tiles[3 * blockIdx.x], r0 = tiles[3 * blockIdx.x + 1];
  const int rows = tiles[3 * blockIdx.x + 2];
  if (rows <= 0) return;
  const int n0 = blockIdx.y * FB;
  const float* W = w + (long long)e * d * f;
  const float* X = tokens + (long long)r0 * d;
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
      if (col < f) out[(long long)(r0 + r) * f + col] = acc[i][j];
    }
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. tokens: (T, d), w: (E, d, f), out: (T,
// f), all contiguous; tiles: (n_tiles, 3) int32 rows of (expert, first
// row, row count), row count <= 64. bf16 needs d % 8 == 0 and f % 8 == 0.
extern "C" int grouped_matmul_launch(int dtype, const void* tokens,
                                     const void* w, const void* tiles,
                                     long long n_tiles, int d, int f,
                                     void* out, void* stream) {
  if (n_tiles <= 0) return 0;
  if (d <= 0 || f <= 0 || n_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (d % 8 != 0 || f % 8 != 0 || (f + BN - 1) / BN > 65535)
      return (int)cudaErrorInvalidValue;
    gmm_bf16<<<dim3((unsigned)n_tiles, (f + BN - 1) / BN), THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(tokens),
        static_cast<const __nv_bfloat16*>(w), static_cast<const int*>(tiles),
        d, f, static_cast<__nv_bfloat16*>(out));
  } else if (dtype == 0) {
    if ((f + FB - 1) / FB > 65535) return (int)cudaErrorInvalidValue;
    gmm_f32<<<dim3((unsigned)n_tiles, (f + FB - 1) / FB), FTHREADS, 0, s>>>(
        static_cast<const float*>(tokens), static_cast<const float*>(w),
        static_cast<const int*>(tiles), d, f, static_cast<float*>(out));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
