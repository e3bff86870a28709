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
// Head dims: any hd with hd % 8 == 0 (TMA's 16-byte strides) up to 256.
// The kernel is built for HD in {32, 64, 128, 256} and runs an hd at the
// next of these: the tensor maps span the true hd, so TMA fills the
// columns past it with zeros in shared memory. Zero columns add nothing to
// q . k and give zero output columns, which are not stored. So gemma3's
// hd 240 runs at HD 256 (6.7 % of the products on zeros), h2o-danube's
// 120 at 128, stablelm's 160 at 256.
//
// What bounds it on an H100: operations. At the serving path's prefill
// (B*H = 128, S = 2048, hd = 128, causal) the two products are 2 * 2 *
// hd * S (S + 1) / 2 * B*H = 1.37e11 FLOP, 0.139 ms at 989 TFLOP/s,
// against ~0.27 GB of q, k, v and out. The PV product runs twice (p split
// in two, below), so 1.5x the products' work: at best ~67 % of that
// bound.
//
// Design. The TPU kernel kept (m, l, acc) in VMEM across a sequential
// grid axis over K tiles; CUDA blocks run in no order, so here one block
// owns BQ = 128 queries of one (batch, head) and loops over the K tiles
// itself, keeping the softmax state in registers. Within each (batch,
// head) the query tiles launch heaviest first (those nearest the end see
// the most keys), so the last wave is not the longest, while the blocks
// that run together still share a few heads' K and V in L2 (a wave
// across all heads' last tiles would stream K and V from memory once per
// query tile). K tiles that lie wholly above the block's diagonal are
// never loaded. GQA: query head h reads KV head h / G by coordinate,
// without repeating K and V. TMA reads the strided (batch, seq, head, hd)
// layouts through 4-D tensor maps, so the model's (B, S, H, hd) tensors
// need no transpose.
// - bfloat16: warp-specialised. A producer warp loads Q once and K and V
//   tiles of 64 keys into a ring of shared-memory stages, each guarded by
//   a full and an empty mbarrier; the 128-byte swizzle spans 64 bf16, so
//   an HD-128 row is two boxes, HD 256 four (HD 32: the 64-byte swizzle,
//   one box). The ring holds 4 stages up to HD 128 and 2 at HD 256 (Q 64
//   KB + 2 x 64 KB of K and V, inside the 227 KB a block may have). At HD
//   256 a consumer's fragments (O 128, S 32, P hi and lo 32 floats) pass
//   the 168 registers ptxas gives a 384-thread block, and it spills
//   (ptxas's report, printed by chip_smoke.py; times in PERF.md).
//   Keys past Sk come in as zeros and still score -1e30. Two consumer
//   warpgroups each own 64 query rows: S = Q K^T is a wgmma with Q and K
//   from shared memory (both K-major); P V is a wgmma with P from
//   registers (the S accumulator, re-packed as bf16 fragments) and V read
//   MN-major by its descriptor, so V is never transposed by hand. The
//   reference multiplies the float32 probabilities by V; rounding p to
//   bf16 would lose 8 bits, so p is split into hi = bf16(p) and lo =
//   bf16(p - hi) and both are multiplied (p carried to ~16 bits). Each
//   warpgroup is software-pipelined: S of tile j and P V of tile j - 1
//   are issued together, and the softmax of tile j runs while P V is in
//   flight. The two warpgroups take turns to issue (named barriers), so
//   one's softmax also runs under the other's products. The softmax runs
//   in base 2 (s scaled by hd**-0.5 * log2(e), p = exp2(s - max), the same
//   function) on ex2.approx. Registers move from the producer to the
//   consumers (setmaxnreg). 64-key tiles, not 128: at 128 the pipelined
//   S, P (hi and lo) and O fragments outgrow the registers the compiler
//   gives a 384-thread block and it serialises the wgmma (measured on the
//   card, PERF.md).
// - float32: a plain FMA kernel (16 query rows, 32-key tiles, 8 threads a
//   row), for the reduced models and the tests' float32 shapes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

// ------------------------------------------------------------ bfloat16

constexpr int CONSUMERS = 2;  // warpgroups of 64 query rows
constexpr int BQ = 64 * CONSUMERS;  // query rows a block
constexpr int BKV = 64;      // keys a tile
constexpr int THREADS = 128 * (1 + CONSUMERS);
// registers a thread after the hand-over: 32 x 128 + 232 x 256 <= 64 K
constexpr int PRODUCER_REGS = 32, CONSUMER_REGS = 232;
// at least half an SM's shared memory, so one block holds an SM and the
// consumers' setmaxnreg always finds the producer's registers
constexpr int SMEM_FLOOR = 116 * 1024;

template <int HD>
struct Cfg {
  static constexpr int SW = HD >= 64 ? 128 : 2 * HD;  // swizzle span, bytes
  static constexpr int PW = SW / 2;                   // bf16 a panel row
  static constexpr int PANELS = HD / PW;
  static constexpr int STAGES = HD > 128 ? 2 : 4;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BKV * HD * 2;       // K or V, one tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int NEED = Q_BYTES + STAGES * STAGE_BYTES + 1024;
  static constexpr int SMEM_BYTES = NEED > SMEM_FLOOR ? NEED : SMEM_FLOOR;
};

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo,
                                         __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// 2**x on the special-function unit, one instruction; a result below
// 2**-126 flushes to 0 (a term that small is lost in the row sum anyway)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p = hi + lo with hi = bf16(p), lo = bf16(p - hi), two values a register
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bf16(const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v,
           __nv_bfloat16* __restrict__ o, int G, int Sq, int Sk, int hd,
           long long o_b, long long o_s, long long o_h, int causal,
           float scale_log2) {
  using namespace hopper;
  using C = Cfg<HD>;
  constexpr int SW = C::SW, PW = C::PW, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[STAGES], empty[STAGES];
  uint8_t* sq = align_1024(smem_raw);
  uint8_t* skv = sq + C::Q_BYTES;         // stage s: K, then V
  // heaviest first within each (batch, head): the blocks that run
  // together share a few heads' K and V, which stay in L2
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int off = Sk - Sq;
  const int last_key = causal ? min(Sk - 1, q0 + BQ - 1 + off) : Sk - 1;
  const int n_tiles = last_key / BKV + 1;
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (wg == 0) {
    // ---- producer: Q once, then K and V tiles through the ring
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) {
      const int hk = h / G;
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      mbar_arrive_expect_tx(&q_full, C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < C::PANELS; ++p)
        tma_load_4d(sq + p * BQ * SW, &tm_q, &q_full, p * PW, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_tiles; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* kv = skv + stage * C::STAGE_BYTES;
        mbar_arrive_expect_tx(&full[stage], C::STAGE_BYTES);
#pragma unroll
        for (int p = 0; p < C::PANELS; ++p) {
          tma_load_4d(kv + p * BKV * SW, &tm_k, &full[stage], p * PW, hk,
                      kt * BKV, b);
          tma_load_4d(kv + C::KV_BYTES + p * BKV * SW, &tm_v, &full[stage],
                      p * PW, hk, kt * BKV, b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: query rows row0 .. row0 + 63. Software-pipelined:
    // S of tile j and P V of tile j - 1 are issued together, and the
    // softmax of tile j runs while the P V product is in flight.
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1, warp = tid / 32, lane = tid % 32;
    const int row0 = q0 + 64 * c;
    const int ra = row0 + 16 * warp + lane / 4, rb = ra + 8;
    // the two warpgroups take turns to issue their products (named
    // barriers 1 and 2), so one's softmax runs under the other's wgmma.
    // Both walk all of the block's tiles (a tile wholly above a
    // warpgroup's diagonal is masked to zeros), so their turns pair up.
    auto turn_begin = [&]() { named_bar_sync(1 + c, 256); };
    auto turn_end = [&]() { named_bar_arrive(1 + (c + 1) % CONSUMERS, 256); };
    const uint32_t q_addr = smem_u32(sq) + 64 * c * SW;
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
    float s[BKV / 2];                           // S, then P, of one tile
    uint32_t hi[BKV / 16][4], lo[BKV / 16][4];  // P as bf16 A fragments

    // S = Q K^T of the tile in `stage`: 64 rows x BKV keys, K-major both
    auto issue_qk = [&](int stage) {
      const uint32_t k_addr = smem_u32(skv + stage * C::STAGE_BYTES);
#pragma unroll
      for (int st = 0; st < HD / 16; ++st) {
        const int p = st / (PW / 16), in = 32 * (st % (PW / 16));
        Wgmma<BKV>::template ss<0>(
            s, desc_k_major<SW>(q_addr + p * BQ * SW + in),
            desc_k_major<SW>(k_addr + p * BKV * SW + in), st != 0);
      }
    };
    // acc += P V of the tile in `stage`, P as hi + lo (k16 step j holds
    // the keys of 8-column blocks 2j and 2j + 1)
    auto issue_pv = [&](int stage) {
      const uint32_t v_addr =
          smem_u32(skv + stage * C::STAGE_BYTES + C::KV_BYTES);
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) {
        const uint64_t dv = desc_mn_major<SW>(v_addr + 16 * SW * j, BKV * SW);
        Wgmma<HD>::template rs<1>(acc, hi[j], dv, 1);
        Wgmma<HD>::template rs<1>(acc, lo[j], dv, 1);
      }
    };
    // on S of the tile at key k0: mask where it crosses the diagonal or
    // Sk, new running max (raw scores; row ra: s[4j], s[4j + 1], row rb:
    // s[4j + 2, 3]), alpha, p = exp2(s * c - m * c) in place, row sums
    auto softmax = [&](int k0) {
      if (k0 + BKV > Sk || (causal && k0 + BKV - 1 > row0 + off)) {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
          const int row = (i & 2) ? rb : ra;
          if (key >= Sk || (causal && key > row + off)) s[i] = NEG_INF;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2((m[r] - mx[r]) * scale_log2);
        m[r] = mx[r];
        mc[r] = mx[r] * scale_log2;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = ex2(fmaf(s[i], scale_log2, -mc[r]));
        l[r] += s[i];
      }
    };
    auto split = [&]() {
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) {
        split2(s[8 * j], s[8 * j + 1], hi[j][0], lo[j][0]);
        split2(s[8 * j + 2], s[8 * j + 3], hi[j][1], lo[j][1]);
        split2(s[8 * j + 4], s[8 * j + 5], hi[j][2], lo[j][2]);
        split2(s[8 * j + 6], s[8 * j + 7], hi[j][3], lo[j][3]);
      }
    };
    auto fence_p = [&]() {
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) {
        fence_regs(hi[j]);
        fence_regs(lo[j]);
      }
    };

    // consumer 0 takes the first turn
    if (c == CONSUMERS - 1) named_bar_arrive(1, 256);
    mbar_wait(&q_full, 0);
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    auto advance = [&]() {
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    // tile 0
    mbar_wait(&full[stage], phase);
    turn_begin();
    wgmma_fence();
    issue_qk(stage);
    wgmma_commit();
    turn_end();
    wgmma_wait<0>();
    fence_regs(s);
    softmax(0);
    split();
    prev = stage;
    advance();
    for (int kt = 1; kt < n_tiles; ++kt) {
      mbar_wait(&full[stage], phase);
      turn_begin();
      wgmma_fence();
      issue_qk(stage);
      wgmma_commit();
      issue_pv(prev);
      wgmma_commit();
      turn_end();
      wgmma_wait<1>();              // S of tile kt is in
      fence_regs(s);
      softmax(kt * BKV);
      wgmma_wait<0>();              // P V of tile kt - 1 is done
      fence_regs(acc);
      fence_p();
      if (tid == 0) mbar_arrive(&empty[prev]);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      split();
      prev = stage;
      advance();
    }
    turn_begin();
    wgmma_fence();
    issue_pv(prev);
    wgmma_commit();
    turn_end();
    if (c == 0) named_bar_sync(1, 256);   // the last consumer's last turn
    wgmma_wait<0>();
    fence_regs(acc);
    fence_p();
    if (tid == 0) mbar_arrive(&empty[prev]);
    // each thread summed its own columns: add the quad's partial sums
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* ob = o + b * o_b + h * o_h;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (8 * j >= hd) continue;  // the zero columns past the true hd
      if (ra < Sq)
        *reinterpret_cast<uint32_t*>(ob + ra * o_s + col) =
            pack(__float2bfloat16(acc[4 * j] / l[0]),
                 __float2bfloat16(acc[4 * j + 1] / l[0]));
      if (rb < Sq)
        *reinterpret_cast<uint32_t*>(ob + rb * o_s + col) =
            pack(__float2bfloat16(acc[4 * j + 2] / l[1]),
                 __float2bfloat16(acc[4 * j + 3] / l[1]));
    }
  }
}

// ------------------------------------------------------------ float32

constexpr int FQ = 16;       // query rows a block, 8 threads a row
constexpr int FK = 32;       // keys a tile, 4 a thread
constexpr int FTHREADS = 128;

// Q, K, V and P tiles, in dynamic shared memory (84 KB at HD 256)
template <int HD>
constexpr int f32_smem_bytes() {
  return (FQ * (HD + 1) + FK * (HD + 1) + FK * HD + FQ * (FK + 1)) * 4;
}

// columns d >= hd of Q, K and V read as zeros, as in the bf16 kernel
template <int HD>
__global__ void __launch_bounds__(FTHREADS)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int G, int Sq,
          int Sk, int hd, Strides st, int causal, float scale) {
  extern __shared__ float fsm[];
  float(*Qs)[HD + 1] = reinterpret_cast<float(*)[HD + 1]>(fsm);
  float(*Ks)[HD + 1] = reinterpret_cast<float(*)[HD + 1]>(fsm + FQ * (HD + 1));
  float(*Vs)[HD] = reinterpret_cast<float(*)[HD]>(fsm + (FQ + FK) * (HD + 1));
  float(*Ps)[FK + 1] = reinterpret_cast<float(*)[FK + 1]>(
      fsm + (FQ + FK) * (HD + 1) + FK * HD);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FQ;
  const int hk = h / G;
  const int tid = threadIdx.x, r = tid / 8, c = tid % 8;
  const int row = q0 + r;
  const int off = Sk - Sq;
  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* kb = k + b * st.k_b + hk * st.k_h;
  const float* vb = v + b * st.v_b + hk * st.v_h;
  for (int i = tid; i < FQ * HD; i += FTHREADS) {
    const int rr = i / HD, d = i % HD;
    Qs[rr][d] = q0 + rr < Sq && d < hd ? qb[(q0 + rr) * st.q_s + d] : 0.f;
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
    for (int i = tid; i < FK * HD; i += FTHREADS) {
      const int rr = i / HD, d = i % HD;
      const bool in = k0 + rr < Sk && d < hd;
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
    for (int i = 0; i < HD / 8; ++i)
      if (c + 8 * i < hd) ob[c + 8 * i] = acc[i] / l;
  }
}
// q, k, v: (B, S, heads, hd) through element strides -> a 4-D map of
// dims (hd, heads, S, B), box (one swizzle span of HD, 1, rows, 1); the
// box's columns past hd come in as zeros
template <int HD>
int seq_map(CUtensorMap* map, const void* base, int B, int S, int heads,
            int hd, long long s_b, long long s_s, long long s_h, int rows) {
  using C = Cfg<HD>;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_h * 2, (cuuint64_t)s_s * 2,
                                 (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::PW, 1, (cuuint32_t)rows, 1};
  return hopper::encode_bf16_map(map, base, 4, dims, strides, box,
                                 hopper::Swizzle<C::SW>::tma);
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int B, int H, int G, int Sq, int Sk, int hd, const Strides& st,
           int causal, float scale, cudaStream_t stream) {
  if (dtype == 0) {
    static bool f32_smem_set = false;
    if (!f32_smem_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          flash_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          f32_smem_bytes<HD>());
      if (e != cudaSuccess) return (int)e;
      f32_smem_set = true;
    }
    flash_f32<HD><<<dim3((Sq + FQ - 1) / FQ, H, B), FTHREADS,
                    f32_smem_bytes<HD>(), stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), G, Sq, Sk, hd,
        st, causal, scale);
    return (int)cudaGetLastError();
  }
  CUtensorMap tm_q, tm_k, tm_v;
  const int KV = H / G;
  int rc = seq_map<HD>(&tm_q, q, B, Sq, H, hd, st.q_b, st.q_s, st.q_h, BQ);
  if (!rc)
    rc = seq_map<HD>(&tm_k, k, B, Sk, KV, hd, st.k_b, st.k_s, st.k_h, BKV);
  if (!rc)
    rc = seq_map<HD>(&tm_v, v, B, Sk, KV, hd, st.v_b, st.v_s, st.v_h, BKV);
  if (rc) return rc;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Cfg<HD>::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const float log2e = 1.4426950408889634f;
  flash_bf16<HD><<<dim3((Sq + BQ - 1) / BQ, H, B), THREADS,
                   Cfg<HD>::SMEM_BYTES, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), G, Sq, Sk, hd,
      st.o_b, st.o_s, st.o_h, causal, scale * log2e);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. q: (B, Sq, H, hd) and o alike, k/v: (B,
// Sk, H / G, hd), each through its (batch, seq, head) strides in
// elements, hd contiguous. strides: 12 values, q_b q_s q_h k_b k_s k_h
// v_b v_s v_h o_b o_s o_h. bf16 needs 16-byte aligned q, k, v and
// strides a multiple of 8 (TMA). hd % 8 == 0 and 8 <= hd <= 256 (run at
// HD 32, 64, 128 or 256); 1 <= Sq <= Sk; B, H <= 65535. Returns a
// cudaError_t, or hopper::TMAP_ERROR + a CUresult when a tensor map is
// refused.
extern "C" int flash_attention_launch(int dtype, const void* q,
                                      const void* k, const void* v, void* o,
                                      int B, int H, int G, int Sq, int Sk,
                                      int hd, const long long* strides,
                                      int causal, float scale,
                                      void* stream) {
  if ((dtype != 0 && dtype != 1) || B <= 0 || H <= 0 || G <= 0 ||
      H % G != 0 || Sq <= 0 || Sk < Sq || B > 65535 || H > 65535 ||
      hd % 8 != 0 || hd < 8 || hd > 256)
    return (int)cudaErrorInvalidValue;
  const Strides st = {strides[0], strides[1], strides[2],  strides[3],
                      strides[4], strides[5], strides[6],  strides[7],
                      strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 32)
    return launch<32>(dtype, q, k, v, o, B, H, G, Sq, Sk, hd, st, causal, scale, s);
  if (hd <= 64)
    return launch<64>(dtype, q, k, v, o, B, H, G, Sq, Sk, hd, st, causal, scale, s);
  if (hd <= 128)
    return launch<128>(dtype, q, k, v, o, B, H, G, Sq, Sk, hd, st, causal, scale, s);
  return launch<256>(dtype, q, k, v, o, B, H, G, Sq, Sk, hd, st, causal, scale, s);
}
