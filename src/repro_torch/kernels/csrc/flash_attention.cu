// Flash attention forward (online softmax) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
// flash_attention_pallas (body _kernel). Same function:
//   s = (q . k) * hd**-0.5, in float32;
//   causal: key j is visible to query i iff j <= i + (Sk - Sq), the
//     queries being the LAST Sq positions of the keys; hidden scores are
//     the finite -1e30, as in the reference, not -inf;
//   out = (sum_j p_j v_j) / max(sum_j p_j, 1e-30), p = exp(s - running max),
//     cast to the input type.
// q, k and v are read as float32 values (bf16 converts exactly).
//
// What bounds it: operations. At the serving path's prefill (B*H = 128,
// S = 2048, hd = 128, causal) the two products are 2 * 2 * S * S * hd *
// B*H / 2 ~ 1.37e11 FLOP against ~0.27 GB of q, k, v and out.
//
// Design. The TPU kernel kept (m, l, acc) in VMEM across a sequential
// grid axis over K tiles; CUDA blocks run in no order, so here one block
// owns a tile of queries of one (batch, head) and loops over the K tiles
// itself, keeping the softmax state in registers. K tiles that lie wholly
// above the diagonal are never loaded. The ragged edges of Sq and Sk are
// masked (keys past Sk load as zeros and score -1e30; rows past Sq are
// not written). GQA: query head h reads KV head h / G by index, without
// repeating K and V. The kernel reads strided (batch, seq, head) layouts,
// so the (B, S, H, hd) tensors of the model need no transpose.
//
// - bfloat16: 4 warps, 16 query rows each (64 a block), 64-key tiles.
//   Both products run on the tensor cores with mma.sync m16n8k16 (bf16
//   in, float32 accumulate). QK^T is exact in the inputs. The reference
//   multiplies the float32 probabilities by V; rounding p to bf16 would
//   lose 8 bits, so p is split into hi = bf16(p) and lo = bf16(p - hi)
//   and both are multiplied (p carried to ~16 bits, at 2x the PV work).
//   Q fragments stay in registers; K is staged row-major and V
//   transposed in shared memory, rows padded so fragment loads do not
//   conflict on banks.
// - float32: a plain FMA kernel (16 query rows, 32-key tiles, 8 threads a
//   row), for the reduced models and the tests' float32 shapes.
// wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

// ------------------------------------------------------------ bfloat16

constexpr int BQ = 64;       // query rows a block (16 a warp)
constexpr int BK = 64;       // keys a tile
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

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo,
                                         __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// p = hi + lo with hi = bf16(p), lo = bf16(p - hi), two values a register
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
  hi = pack(h0, h1);
  lo = pack(__float2bfloat16(x0 - __bfloat162float(h0)),
            __float2bfloat16(x1 - __bfloat162float(h1)));
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bf16(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           __nv_bfloat16* __restrict__ o, int G, int Sq, int Sk,
           Strides st, int causal, float scale) {
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
  __shared__ __align__(16) __nv_bfloat16 Ks[BK][HD + 8];
  __shared__ __align__(16) __nv_bfloat16 Vt[HD][BK + 8];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rA = q0 + warp * 16 + g, rB = rA + 8;
  const int off = Sk - Sq;
  const __nv_bfloat16* qb = q + b * st.q_b + h * st.q_h;
  const __nv_bfloat16* kb = k + b * st.k_b + hk * st.k_h;
  const __nv_bfloat16* vb = v + b * st.v_b + hk * st.v_h;

  // Q fragments (A operand, row-major 16 x 16 per k step), rows past Sq 0
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    qa[ks][0] = rA < Sq ? ld32(qb + rA * st.q_s + c) : 0u;
    qa[ks][1] = rB < Sq ? ld32(qb + rB * st.q_s + c) : 0u;
    qa[ks][2] = rA < Sq ? ld32(qb + rA * st.q_s + c + 8) : 0u;
    qa[ks][3] = rB < Sq ? ld32(qb + rB * st.q_s + c + 8) : 0u;
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const int last_key = causal ? min(Sk - 1, q0 + BQ - 1 + off) : Sk - 1;
  const int n_tiles = last_key / BK + 1;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    // K: row-major, 16-byte chunks, chunk index fastest along hd
    for (int c = tid; c < BK * HD / 8; c += THREADS) {
      const int r = c / (HD / 8), d = (c % (HD / 8)) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Sk)
        x = *reinterpret_cast<const uint4*>(kb + (k0 + r) * st.k_s + d);
      *reinterpret_cast<uint4*>(&Ks[r][d]) = x;
    }
    // V: transposed to Vt[d][key], key fastest so the stores spread
    for (int c = tid; c < BK * HD / 8; c += THREADS) {
      const int r = c % BK, d = (c / BK) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Sk)
        x = *reinterpret_cast<const uint4*>(vb + (k0 + r) * st.v_s + d);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[d + i][r] = e[i];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const __nv_bfloat16* kr = &Ks[n * 8 + g][ks * 16 + 2 * t];
        mma_bf16(s[n], qa[ks], ld32(kr), ld32(kr + 8));
      }
    }
    // scale, mask, running max (rows rA: s[.][0..1], rB: s[.][2..3])
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + n * 8 + 2 * t + (c & 1);
        const int row = c < 2 ? rA : rB;
        float x = s[n][c] * scale;
        if (key >= Sk || (causal && key > row + off)) x = NEG_INF;
        s[n][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[n][c] - m[c >> 1]);
        s[n][c] = p;
        l[c >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // acc += P V, P as hi + lo bf16 A fragments (C layout of S reused)
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t hi[4], lo[4];
      split2(s[2 * j][0], s[2 * j][1], hi[0], lo[0]);
      split2(s[2 * j][2], s[2 * j][3], hi[1], lo[1]);
      split2(s[2 * j + 1][0], s[2 * j + 1][1], hi[2], lo[2]);
      split2(s[2 * j + 1][2], s[2 * j + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const __nv_bfloat16* vr = &Vt[n * 8 + g][j * 16 + 2 * t];
        const uint32_t b0 = ld32(vr), b1 = ld32(vr + 8);
        mma_bf16(acc[n], hi, b0, b1);
        mma_bf16(acc[n], lo, b0, b1);
      }
    }
  }

  // each thread summed its own columns: add the quad's partial sums
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* ob = o + b * st.o_b + h * st.o_h;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (rA < Sq)
      *reinterpret_cast<uint32_t*>(ob + rA * st.o_s + c) =
          pack(__float2bfloat16(acc[n][0] / l[0]),
               __float2bfloat16(acc[n][1] / l[0]));
    if (rB < Sq)
      *reinterpret_cast<uint32_t*>(ob + rB * st.o_s + c) =
          pack(__float2bfloat16(acc[n][2] / l[1]),
               __float2bfloat16(acc[n][3] / l[1]));
  }
}

// ------------------------------------------------------------ float32

constexpr int FQ = 16;       // query rows a block, 8 threads a row
constexpr int FK = 32;       // keys a tile, 4 a thread

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int G, int Sq,
          int Sk, Strides st, int causal, float scale) {
  __shared__ float Qs[FQ][HD + 1];
  __shared__ float Ks[FK][HD + 1];
  __shared__ float Vs[FK][HD];
  __shared__ float Ps[FQ][FK + 1];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FQ;
  const int hk = h / G;
  const int tid = threadIdx.x, r = tid / 8, c = tid % 8;
  const int row = q0 + r;
  const int off = Sk - Sq;
  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* kb = k + b * st.k_b + hk * st.k_h;
  const float* vb = v + b * st.v_b + hk * st.v_h;
  for (int i = tid; i < FQ * HD; i += THREADS) {
    const int rr = i / HD, d = i % HD;
    Qs[rr][d] = q0 + rr < Sq ? qb[(q0 + rr) * st.q_s + d] : 0.f;
  }
  float acc[HD / 8];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;
  const int last_key = causal ? min(Sk - 1, q0 + FQ - 1 + off) : Sk - 1;
  const int n_tiles = last_key / FK + 1;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * FK;
    __syncthreads();
    for (int i = tid; i < FK * HD; i += THREADS) {
      const int rr = i / HD, d = i % HD;
      const bool in = k0 + rr < Sk;
      Ks[rr][d] = in ? kb[(k0 + rr) * st.k_s + d] : 0.f;
      Vs[rr][d] = in ? vb[(k0 + rr) * st.v_s + d] : 0.f;
    }
    __syncthreads();
    float s[FK / 8];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < FK / 8; ++j) {
      const int kk = c + 8 * j;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot = fmaf(Qs[r][d], Ks[kk][d], dot);
      float x = dot * scale;
      const int key = k0 + kk;
      if (key >= Sk || (causal && key > row + off)) x = NEG_INF;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    // the 8 threads of a row are 8 neighbouring lanes
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int j = 0; j < FK / 8; ++j) {
      const float p = expf(s[j] - m);
      l += p;
      Ps[r][c + 8 * j] = p;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      float x = acc[i] * alpha;
      for (int kk = 0; kk < FK; ++kk) x = fmaf(Ps[r][kk], Vs[kk][c + 8 * i], x);
      acc[i] = x;
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  l += __shfl_xor_sync(0xffffffffu, l, 4);
  l = fmaxf(l, 1e-30f);
  if (row < Sq) {
    float* ob = o + b * st.o_b + h * st.o_h + row * st.o_s;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) ob[c + 8 * i] = acc[i] / l;
  }
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, dim3 grid_bf16, dim3 grid_f32, int G, int Sq,
                   int Sk, const Strides& st, int causal, float scale,
                   cudaStream_t stream) {
  if (dtype == 1) {
    flash_bf16<HD><<<grid_bf16, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), G, Sq, Sk, st, causal, scale);
  } else {
    flash_f32<HD><<<grid_f32, THREADS, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), G, Sq, Sk,
        st, causal, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. q: (B, Sq, H, hd) and o alike, k/v: (B,
// Sk, H / G, hd), each through its (batch, seq, head) strides in
// elements, hd contiguous. strides: 12 values, q_b q_s q_h k_b k_s k_h
// v_b v_s v_h o_b o_s o_h. bf16 needs 16-byte aligned rows (strides a
// multiple of 8). hd in {32, 64, 128}; 1 <= Sq <= Sk; B, H <= 65535.
extern "C" int flash_attention_launch(int dtype, const void* q,
                                      const void* k, const void* v, void* o,
                                      int B, int H, int G, int Sq, int Sk,
                                      int hd, const long long* strides,
                                      int causal, float scale,
                                      void* stream) {
  if ((dtype != 0 && dtype != 1) || B <= 0 || H <= 0 || G <= 0 ||
      H % G != 0 || Sq <= 0 || Sk < Sq || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides st = {strides[0], strides[1], strides[2],  strides[3],
                      strides[4], strides[5], strides[6],  strides[7],
                      strides[8], strides[9], strides[10], strides[11]};
  const dim3 gb((Sq + BQ - 1) / BQ, H, B), gf((Sq + FQ - 1) / FQ, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return (int)launch<32>(dtype, q, k, v, o, gb, gf, G, Sq, Sk, st, causal, scale, s);
    case 64: return (int)launch<64>(dtype, q, k, v, o, gb, gf, G, Sq, Sk, st, causal, scale, s);
    case 128: return (int)launch<128>(dtype, q, k, v, o, gb, gf, G, Sq, Sk, st, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
