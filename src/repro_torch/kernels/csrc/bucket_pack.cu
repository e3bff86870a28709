// Stable bucket pack (the connector's route into owner buckets) for
// Hopper, sm_90a.
//
// Replaces no Pallas kernel: src/repro/core/connector.py bucket_by_owner
// leaves this to XLA (a stable argsort by owner, gathers by that order, a
// searchsorted, and scatters with mode="drop"). The port's plain version
// is that chain in torch, kernels/bucket_pack/ref.py, which routes the
// dropped rows through one extra sink slot a source. Per source row s of
// an (S, K) stream, with owner(dst) = dst mod P (hash) or
// min(dst div capacity, P - 1) (range):
//   a valid row's position is its rank among the valid rows of s with
//   the same owner, in input order; a row whose position is below C is
//   written to (s, owner, position) of the (S, P, C) buckets (its dst,
//   its payload and True); other valid rows count in overflow[s];
//   a bucket's slots past its count hold dst -1, payload 0 and False.
// That is the plain chain's result bit for bit: valid rows form a prefix
// of every bucket, in input order, which run_host's regrow relies on.
//
// What bounds it: bytes. A row needs its valid byte; a valid row its dst
// and payload read once and its slot written once; every other slot is
// written once, by its row or by the fill: S K + valid (4 + 4D) B read
// and S P C (4 + 4D + 1) B written. The genome cell's sending superstep
// (S = 4, K = 22.9 M, 45.8 M valid, C = 8.59 M, D = 1) needs 1.69 GB,
// 0.51 ms at 3.35 TB/s; a superstep that sends nothing 1.33 GB, 0.40 ms.
// The plain chain sorts all S K rows (int32 keys, int64 order), gathers
// four times and scatters three times through the sink, valid or not:
// 30-50x that. Here the valid bytes and the valid rows' dst are read
// twice (count and write pass), and where valid rows are spread thinly
// (every other row in the genome's stream) whole lines of dst and
// payload are fetched for them; the slots are written once each.
//
// Design: four launches on the caller's stream, no atomics that decide
// an order (the integer atomics below only sum counts).
//   - count_tiles: a block of 256 threads takes a tile of 2048 rows of
//     one source (blockIdx.y); each warp walks 256 consecutive rows in 8
//     steps of 32: it reads the valid bytes, then the dst of the valid
//     rows (a thread's loads all in flight at once); in a step with a
//     valid row __match_any_sync groups the lanes of one owner, and the
//     group's first lane adds its size to the tile's count in shared
//     memory. A step with no valid row reads only its flags. Counts land
//     at counts[s][owner][tile].
//   - scan_counts: one block per (source, owner) turns its tiles' counts
//     into exclusive offsets in place, keeps min(count, C) as the
//     bucket's fill start and adds the excess over C to overflow[s].
//   - fill_tail: dst -1, payload 0 and valid 0 into each bucket's slots
//     from its fill start to C, in 16-byte stores; nothing else.
//   - write_rows: the same tiles and walk as count_tiles, and a tile with
//     no valid row stops after its flags. A warp keeps a running count
//     per owner in shared memory, so a row's position in its warp is the
//     count before its step plus its rank among its group's lanes; after
//     the walk the warps' counts are scanned per owner from the tile's
//     offset, and each kept row writes its dst, its payload and True.
//     Rows of one owner in a step take consecutive slots, so a warp's
//     stores fall in at most P runs.
// The tile is the same in the first and last launch, so the offsets that
// the scan gives a tile are the counts of the tiles before it. Measured
// variants (H100): 16 rows a thread ran the write pass 25 % slower (106
// registers), 4 rows no faster; a ballot an owner in place of the match
// (P <= 8) slower in both passes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STEPS = 8;                       // rows a thread
constexpr int WARP_ROWS = 32 * STEPS;          // 256
constexpr int TILE = THREADS * STEPS;          // 2048 rows a tile
constexpr int SCAN_THREADS = 1024;
constexpr int FILL_THREADS = 256;
constexpr int FILL_SLOTS = 8192;               // slots a fill block
constexpr int MAX_P = 4096;
constexpr unsigned FULL = 0xffffffffu;

struct Route {
  int P;
  int range;          // 0: dst mod P; 1: min(dst div capacity, P - 1)
  int capacity;
};

// The owner of a valid row, as the plain chain computes it (torch's %
// and // round towards minus infinity). A valid row with a negative dst
// under range partitioning, which the plain chain cannot take, lands in
// bucket 0.
__device__ __forceinline__ int owner_of(int d, const Route& r) {
  if (r.range) {
    int o = d / r.capacity;
    if (d < 0 && o * r.capacity != d) --o;
    return o < 0 ? 0 : (o > r.P - 1 ? r.P - 1 : o);
  }
  const int o = d % r.P;
  return o < 0 ? o + r.P : o;
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The valid bytes of a thread's STEPS rows: row k0 + 32 j for step j.
__device__ __forceinline__ void load_flags(const unsigned char* valid,
                                           long long k0, long long K,
                                           bool (&v)[STEPS]) {
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    const long long k = k0 + 32 * j;
    v[j] = k < K && valid[k] != 0;
  }
}

// The dst of the valid ones among them, all loads in flight at once.
__device__ __forceinline__ void load_dst(const int* dst_s, long long k0,
                                         const bool (&v)[STEPS],
                                         int (&d)[STEPS]) {
#pragma unroll
  for (int j = 0; j < STEPS; ++j) d[j] = v[j] ? dst_s[k0 + 32 * j] : 0;
}

__global__ void __launch_bounds__(THREADS)
count_tiles(const int* __restrict__ dst,
            const unsigned char* __restrict__ valid, long long K, int T,
            Route r, int* __restrict__ counts) {
  extern __shared__ int hist[];                // P counts
  const int t = blockIdx.x;
  const long long s = blockIdx.y;
  for (int o = threadIdx.x; o < r.P; o += THREADS) hist[o] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* dst_s = dst + s * K;
  const long long k0 = (long long)t * TILE + warp * WARP_ROWS + lane;
  bool v[STEPS];
  int d[STEPS];
  load_flags(valid + s * K, k0, K, v);
  load_dst(dst_s, k0, v, d);
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    if (!__ballot_sync(FULL, v[j])) continue;     // uniform in the warp
    const int o = v[j] ? owner_of(d[j], r) : -1;
    const unsigned peers = __match_any_sync(FULL, o);
    if (v[j] && !(peers & lanes_below()))
      atomicAdd(&hist[o], __popc(peers));
  }
  __syncthreads();
  for (int o = threadIdx.x; o < r.P; o += THREADS)
    counts[(s * r.P + o) * T + t] = hist[o];
}

// Exclusive scan of one (source, owner)'s T tile counts, in place.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_counts(int* __restrict__ counts, int T, int P, int C,
            int* __restrict__ fill_from, int* __restrict__ overflow) {
  __shared__ int warp_sum[SCAN_THREADS / 32];
  const long long b = blockIdx.x;              // s * P + owner
  int* c = counts + b * T;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (int i0 = 0; i0 < T; i0 += SCAN_THREADS) {
    const int i = i0 + threadIdx.x;
    const int x = i < T ? c[i] : 0;
    int incl = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, w, d);
        if (lane >= d) w += y;
      }
      warp_sum[lane] = w;                       // inclusive over warps
    }
    __syncthreads();
    const int before = warp ? warp_sum[warp - 1] : 0;
    if (i < T) c[i] = carry + before + incl - x;
    carry += warp_sum[SCAN_THREADS / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    fill_from[b] = carry < C ? carry : C;
    if (carry > C) atomicAdd(&overflow[b / P], carry - C);
  }
}

// p[lo, hi) = x for 4-byte words, p 16-byte aligned.
__device__ __forceinline__ void fill_words(uint32_t* p, long long lo,
                                           long long hi, uint32_t x) {
  const long long a = ((lo + 3) & ~3LL) < hi ? ((lo + 3) & ~3LL) : hi;
  const long long e = (hi & ~3LL) > a ? (hi & ~3LL) : a;
  for (long long i = lo + threadIdx.x; i < a; i += FILL_THREADS) p[i] = x;
  const uint4 x4 = make_uint4(x, x, x, x);
  uint4* p4 = reinterpret_cast<uint4*>(p);
  for (long long i = a / 4 + threadIdx.x; i < e / 4; i += FILL_THREADS)
    p4[i] = x4;
  for (long long i = e + threadIdx.x; i < hi; i += FILL_THREADS) p[i] = x;
}

// p[lo, hi) = 0 for bytes, p 16-byte aligned.
__device__ __forceinline__ void zero_bytes(unsigned char* p, long long lo,
                                           long long hi) {
  const long long a = ((lo + 15) & ~15LL) < hi ? ((lo + 15) & ~15LL) : hi;
  const long long e = (hi & ~15LL) > a ? (hi & ~15LL) : a;
  for (long long i = lo + threadIdx.x; i < a; i += FILL_THREADS) p[i] = 0;
  uint4* p4 = reinterpret_cast<uint4*>(p);
  for (long long i = a / 16 + threadIdx.x; i < e / 16; i += FILL_THREADS)
    p4[i] = make_uint4(0u, 0u, 0u, 0u);
  for (long long i = e + threadIdx.x; i < hi; i += FILL_THREADS) p[i] = 0;
}

// A block fills slots [c0, c0 + FILL_SLOTS) of one bucket past its count.
__global__ void __launch_bounds__(FILL_THREADS)
fill_tail(const int* __restrict__ fill_from, int C, int W, long long chunks,
          int* __restrict__ b_dst, uint32_t* __restrict__ b_pay,
          unsigned char* __restrict__ b_val) {
  const long long u = blockIdx.x;
  const long long b = u / chunks;
  const long long c0 = (u - b * chunks) * FILL_SLOTS;
  const long long c1 = c0 + FILL_SLOTS < C ? c0 + FILL_SLOTS : C;
  const long long lo = c0 > fill_from[b] ? c0 : fill_from[b];
  if (lo >= c1) return;
  const long long at = b * C;
  fill_words(reinterpret_cast<uint32_t*>(b_dst), at + lo, at + c1,
             0xffffffffu);
  fill_words(b_pay, (at + lo) * W, (at + c1) * W, 0u);
  zero_bytes(b_val, at + lo, at + c1);
}

// WT: payload words a row, 0 when given at run time as W.
template <int WT>
__global__ void __launch_bounds__(THREADS)
write_rows(const int* __restrict__ dst, const uint32_t* __restrict__ pay,
           const unsigned char* __restrict__ valid, long long K, int T,
           Route r, int C, int W, const int* __restrict__ offsets,
           int* __restrict__ b_dst, uint32_t* __restrict__ b_pay,
           unsigned char* __restrict__ b_val) {
  extern __shared__ int hist[];                // [WARPS][P] running counts
  const int w_row = WT > 0 ? WT : W;
  const int t = blockIdx.x;
  const long long s = blockIdx.y;
  const int P = r.P;
  for (int i = threadIdx.x; i < WARPS * P; i += THREADS) hist[i] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* dst_s = dst + s * K;
  const long long k0 = (long long)t * TILE + warp * WARP_ROWS + lane;
  int* mine = hist + warp * P;
  bool v[STEPS];
  int dv[STEPS];
  load_flags(valid + s * K, k0, K, v);
  bool any = false;
#pragma unroll
  for (int j = 0; j < STEPS; ++j) any |= v[j];
  if (!__syncthreads_or(any)) return;            // a tile with no valid row
  load_dst(dst_s, k0, v, dv);
  int own[STEPS], pos[STEPS];
  const unsigned below = lanes_below();
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    own[j] = -1;
    if (!__ballot_sync(FULL, v[j])) continue;     // uniform in the warp
    const int o = v[j] ? owner_of(dv[j], r) : -1;
    const unsigned peers = __match_any_sync(FULL, o);
    const int lead = __ffs(peers) - 1;
    const bool leads = v[j] && lane == lead;
    const int base = __shfl_sync(FULL, leads ? mine[o] : 0, lead);
    if (leads) mine[o] = base + __popc(peers);
    __syncwarp();
    if (v[j]) {
      own[j] = o;
      pos[j] = base + __popc(peers & below);
    }
  }
  __syncthreads();
  // each warp's start per owner: the tile's offset plus earlier warps'
  for (int o = threadIdx.x; o < P; o += THREADS) {
    int run = offsets[(s * P + o) * T + t];
    for (int w = 0; w < WARPS; ++w) {
      const int c = hist[w * P + o];
      hist[w * P + o] = run;
      run += c;
    }
  }
  __syncthreads();
  const uint32_t* pay_s = pay + s * K * w_row;
  // a kept row's slot (-1: none), then its payload, all loads at once
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    const int p = own[j] < 0 ? C : mine[own[j]] + pos[j];
    pos[j] = p < C ? p : -1;                     // past C: overflow, counted
  }
  constexpr int WR = WT > 0 ? WT : 1;
  uint32_t pv[STEPS][WR];
  if (WT > 0) {
#pragma unroll
    for (int j = 0; j < STEPS; ++j)
#pragma unroll
      for (int w = 0; w < WR; ++w)
        pv[j][w] = pos[j] >= 0 ? pay_s[(k0 + 32 * j) * WR + w] : 0u;
  }
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    if (pos[j] < 0) continue;
    const long long slot = (s * P + own[j]) * C + pos[j];
    b_dst[slot] = dv[j];
    b_val[slot] = 1;
    if (WT > 0) {
#pragma unroll
      for (int w = 0; w < WR; ++w) b_pay[slot * WR + w] = pv[j][w];
    } else {
      const long long k = k0 + 32 * j;
      for (int w = 0; w < w_row; ++w)
        b_pay[slot * w_row + w] = pay_s[k * w_row + w];
    }
  }
}

cudaError_t launch_write(int W, dim3 grid, size_t smem, cudaStream_t st,
                         const int* dst, const uint32_t* pay,
                         const unsigned char* valid, long long K, int T,
                         Route r, int C, const int* offsets, int* b_dst,
                         uint32_t* b_pay, unsigned char* b_val) {
  auto kernel = W == 1 ? write_rows<1> : W == 2 ? write_rows<2>
                : write_rows<0>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, THREADS, smem, st>>>(dst, pay, valid, K, T, r, C, W,
                                      offsets, b_dst, b_pay, b_val);
  return cudaGetLastError();
}

}  // namespace

// dst: (S, K) int32; pay: (S, K, W) 4-byte words (the payload's D
// columns as bits); valid: (S, K) bool (one byte a row); b_dst (S, P, C)
// int32, b_pay (S, P, C, W) and b_val (S, P, C) bool, written whole and
// 16-byte aligned (as the caching allocator gives); overflow (S,) int32;
// counts: (S, P, ceil(K / 2048)) int32 scratch; fill_from (S, P) int32
// scratch. range: 0 hash, 1 range (capacity > 0). 1 <= P <= 4096, S <=
// 65535, W >= 0. Returns the first launch error, or 0.
extern "C" int bucket_pack_launch(const void* dst, const void* pay,
                                  const void* valid, int S, long long K,
                                  int W, int P, int C, int range,
                                  int capacity, void* b_dst, void* b_pay,
                                  void* b_val, void* overflow, void* counts,
                                  void* fill_from, void* stream) {
  if (S < 0 || S > 65535 || K < 0 || W < 0 || P < 1 || P > MAX_P ||
      C < 0 || (range && capacity < 1))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (S == 0) return 0;
  cudaError_t e = cudaMemsetAsync(overflow, 0, sizeof(int) * (size_t)S, st);
  if (e != cudaSuccess) return (int)e;
  const Route r{P, range, capacity};
  const long long T = (K + TILE - 1) / TILE;
  if (T > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)T, (unsigned)S);
  auto* cnt = static_cast<int*>(counts);
  auto* from = static_cast<int*>(fill_from);
  if (T > 0) {
    count_tiles<<<grid, THREADS, sizeof(int) * (size_t)P, st>>>(
        static_cast<const int*>(dst), static_cast<const unsigned char*>(valid),
        K, (int)T, r, cnt);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  scan_counts<<<(unsigned)(S * P), SCAN_THREADS, 0, st>>>(
      cnt, (int)T, P, C, from, static_cast<int*>(overflow));
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (C > 0) {
    const long long chunks = ((long long)C + FILL_SLOTS - 1) / FILL_SLOTS;
    if ((long long)S * P * chunks > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    fill_tail<<<(unsigned)((long long)S * P * chunks), FILL_THREADS, 0, st>>>(
        from, C, W, chunks, static_cast<int*>(b_dst),
        static_cast<uint32_t*>(b_pay), static_cast<unsigned char*>(b_val));
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (T > 0 && C > 0) {
    e = launch_write(W, grid, sizeof(int) * (size_t)WARPS * P, st,
                     static_cast<const int*>(dst),
                     static_cast<const uint32_t*>(pay),
                     static_cast<const unsigned char*>(valid), K, (int)T, r,
                     C, cnt, static_cast<int*>(b_dst),
                     static_cast<uint32_t*>(b_pay),
                     static_cast<unsigned char*>(b_val));
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
