// Scatter group-by (the D1 receiver combine) for Hopper, sm_90a.
//
// Replaces: src/repro/core/groupby.py, scatter_combine_dense, which the
// JAX package leaves to XLA's scatter (dense.at[tgt].add / min / max with
// mode="drop"); it has no Pallas kernel. The port's plain version is the
// torch scatter chain in kernels/scatter_combine/ref.py. For each of P
// partitions it folds (M, D) float32 payload rows into (Np, D) dense
// slots by each row's int32 slot:
//   dense[p, s] = fn over the valid rows of partition p with slot s, the
//                 identity (0, +inf, -inf) where none;
//   has[p, s]   = some valid row of partition p has slot s.
// A row whose valid byte is 0, or whose slot lies outside [0, Np), is
// dropped (the reference's mode="drop"). The plain chain routes such rows
// to a sink slot Np and folds them there, so an inbox that is mostly
// empty (the first superstep's is all empty) pays one contended atomic a
// row at P addresses; here an invalid row is read and writes nothing.
//
// What bounds it: bytes. A row needs its valid byte, and a valid row its
// slot and its payload (9 B at D = 1); a slot is written once by the
// fill (4D B of dense, 1 B of has). The folds are atomics in L2: under a
// sender combine each run of the inbox holds distinct ascending slots,
// so one warp's atomics fall on neighbouring addresses and a slot takes
// at most one row a run.
//
// Design: two launches on the caller's stream.
//   - fill_slots writes the identity into dense (16-byte stores) and 0
//     into has, in one pass.
//   - fold_rows: a block of 256 threads takes 1024 rows of one partition
//     (blockIdx.y), four steps of 256 consecutive rows, so a warp reads
//     32 consecutive valid bytes and, where they are valid, 32
//     consecutive slots and payload rows (streaming loads: the row
//     stream is read once and should not push dense out of L2), and its
//     atomics land on the slots of 32 neighbouring rows.
//   - sum: atomicAdd, which compiles to a reduction without a return
//     (RED.ADD.F32; like every float atomic add it flushes subnormals to
//     zero, as torch's scatter_add on the card does). The order of the
//     adds changes from run to run, so a sum agrees with the plain chain
//     to rounding.
//   - min / max: exact, by the integer order of the bits. A float with
//     its sign bit clear orders as its bits read as a signed int; one
//     with the sign bit set orders backwards as its bits read unsigned.
//     So min takes atomicMin on the signed bits for a non-negative value
//     and atomicMax on the unsigned bits for a negative one (max the
//     mirror), whatever the slot holds. A NaN is stored as the bits that
//     win every later comparison (0xffffffff for min, 0x7fffffff for
//     max), so it stays, as jnp.minimum / jnp.maximum propagate it.
//     -0.0 and +0.0 come out as -0.0 for min and +0.0 for max.
//   - has: a plain byte store of 1; rows that race on it store the same.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int OP_SUM = 0;
constexpr int OP_MIN = 1;
constexpr int OP_MAX = 2;
constexpr int THREADS = 256;
constexpr int STEPS = 4;                      // rows a thread
constexpr int ROWS_PER_BLOCK = THREADS * STEPS;
constexpr int MAX_D = 4;
constexpr int FILL_THREADS = 256;

__device__ __forceinline__ bool is_nan(unsigned bits) {
  return (bits & 0x7fffffffu) > 0x7f800000u;
}

__device__ __forceinline__ void atomic_min_f32(float* a, float v) {
  const unsigned bits = __float_as_uint(v);
  if (is_nan(bits)) {
    atomicMax(reinterpret_cast<unsigned*>(a), 0xffffffffu);
  } else if (!(bits >> 31)) {
    atomicMin(reinterpret_cast<int*>(a), (int)bits);
  } else {
    atomicMax(reinterpret_cast<unsigned*>(a), bits);
  }
}

__device__ __forceinline__ void atomic_max_f32(float* a, float v) {
  const unsigned bits = __float_as_uint(v);
  if (is_nan(bits)) {
    atomicMax(reinterpret_cast<int*>(a), 0x7fffffff);
  } else if (!(bits >> 31)) {
    atomicMax(reinterpret_cast<int*>(a), (int)bits);
  } else {
    atomicMin(reinterpret_cast<unsigned*>(a), bits);
  }
}

template <int OP>
__device__ __forceinline__ void fold(float* a, float v) {
  if constexpr (OP == OP_SUM) {
    atomicAdd(a, v);
  } else if constexpr (OP == OP_MIN) {
    atomic_min_f32(a, v);
  } else {
    atomic_max_f32(a, v);
  }
}

// dense (n floats) = ident, has (n_has bytes) = 0.
__global__ void __launch_bounds__(FILL_THREADS)
fill_slots(float* __restrict__ dense, long long n, float ident,
           unsigned char* __restrict__ has, long long n_has) {
  const long long stride = (long long)gridDim.x * FILL_THREADS;
  const long long i0 = (long long)blockIdx.x * FILL_THREADS + threadIdx.x;
  const float4 id4 = make_float4(ident, ident, ident, ident);
  float4* d4 = reinterpret_cast<float4*>(dense);
  for (long long i = i0; i < n / 4; i += stride) d4[i] = id4;
  for (long long i = (n / 4) * 4 + i0; i < n; i += stride) dense[i] = ident;
  uint4* h4 = reinterpret_cast<uint4*>(has);
  for (long long i = i0; i < n_has / 16; i += stride)
    h4[i] = make_uint4(0u, 0u, 0u, 0u);
  for (long long i = (n_has / 16) * 16 + i0; i < n_has; i += stride)
    has[i] = 0;
}

template <int OP, int D>
__global__ void __launch_bounds__(THREADS)
fold_rows(const int* __restrict__ slot, const float* __restrict__ payload,
          const unsigned char* __restrict__ valid, long long M, int Np,
          float* __restrict__ dense, unsigned char* __restrict__ has) {
  const long long p = blockIdx.y;
  const long long m0 = (long long)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x;
  float* dense_p = dense + p * Np * D;
  unsigned char* has_p = has + p * Np;
#pragma unroll
  for (int k = 0; k < STEPS; ++k) {
    const long long m = m0 + k * THREADS;
    if (m >= M) return;
    const long long r = p * M + m;
    if (!__ldcs(valid + r)) continue;
    const int s = __ldcs(slot + r);
    if ((unsigned)s >= (unsigned)Np) continue;     // mode="drop"
    float v[D];
#pragma unroll
    for (int d = 0; d < D; ++d) v[d] = __ldcs(payload + r * D + d);
    float* out = dense_p + (long long)s * D;
#pragma unroll
    for (int d = 0; d < D; ++d) fold<OP>(out + d, v[d]);
    has_p[s] = 1;
  }
}

template <int OP>
void launch_fold(int D, dim3 grid, const int* slot, const float* payload,
                 const unsigned char* valid, long long M, int Np,
                 float* dense, unsigned char* has, cudaStream_t s) {
  auto kernel = D == 1 ? fold_rows<OP, 1>
                : D == 2 ? fold_rows<OP, 2>
                : D == 3 ? fold_rows<OP, 3> : fold_rows<OP, 4>;
  kernel<<<grid, THREADS, 0, s>>>(slot, payload, valid, M, Np, dense, has);
}

}  // namespace

// slot: (P, M) int32; payload: (P, M, D) float32, 1 <= D <= 4; valid:
// (P, M) bool (one byte a row); dense: (P, Np, D) float32 and has: (P,
// Np) bool, both written whole (dense 16-byte aligned, as the caching
// allocator gives). op: 0 sum, 1 min, 2 max. P <= 65535, Np < 2**31.
// Returns the first launch error, or 0.
extern "C" int scatter_combine_launch(const void* slot, const void* payload,
                                      const void* valid, int P, long long M,
                                      int D, int Np, int op, void* dense,
                                      void* has, void* stream) {
  if (P < 0 || M < 0 || Np < 0 || D < 1 || D > MAX_D || P > 65535 ||
      op < OP_SUM || op > OP_MAX)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* d = static_cast<float*>(dense);
  auto* h = static_cast<unsigned char*>(has);
  const long long n = (long long)P * Np * D;
  if (n > 0) {
    const float ident = op == OP_SUM ? 0.0f
                        : op == OP_MIN ? INFINITY : -INFINITY;
    // a grid-stride loop: up to 16 blocks an SM, one float4 a thread
    long long blocks = (n / 4 + FILL_THREADS - 1) / FILL_THREADS;
    if (blocks < 1) blocks = 1;
    if (blocks > 132 * 16) blocks = 132 * 16;
    fill_slots<<<(unsigned)blocks, FILL_THREADS, 0, s>>>(
        d, n, ident, h, (long long)P * Np);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (P == 0 || M == 0 || Np == 0) return 0;
  const dim3 grid((unsigned)((M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK),
                  (unsigned)P);
  auto launch = op == OP_SUM ? launch_fold<OP_SUM>
                : op == OP_MIN ? launch_fold<OP_MIN> : launch_fold<OP_MAX>;
  launch(D, grid, static_cast<const int*>(slot),
         static_cast<const float*>(payload),
         static_cast<const unsigned char*>(valid), M, Np, d, h, s);
  return (int)cudaGetLastError();
}
