// Edge-order gather (the D3 send gather) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/csr_spmv/csr_spmv.py, edge_gather_pallas
// (body _kernel), with the permuted loads and the scatter back to edge
// order of csr_spmv/ops.py:edge_gather folded away.
//   out[e] = values[flat_src[e]] * edge_val[e]   (edge_val may be absent;
//   out[e] = 0.0 where flat_src[e] < 0)
//
// What bounds it: bytes. Per edge it reads flat_src (4 B), edge_val when
// given (4 B), and writes out (4V B); the values table is read once. No
// arithmetic beyond one optional multiply.
//
// The TPU kernel turned the gather into a one-hot (BM x BR) @ (BR x V)
// MXU product over a host-planned layout that sorted the edges into row
// blocks, because the TPU has no random access; the product turns inf
// and NaN into NaN (0 * inf), so the reference moved non-finite values
// in a side class channel. This card loads at random, and the values
// table of the main path ((P * Np, V) floats, 43.6 MB at graph500-22)
// sits in the 50 MB L2, so the port walks the edges in their own order:
// no layout, no padding, no pre-zeroed output, and a direct load that is
// exact for every float. The engine stores each partition's edges
// sorted by source slot, so neighbouring edges read neighbouring rows.
//
// Design: each thread takes four consecutive edges: one 16-byte load of
// flat_src (and of edge_val), four row loads through the read-only path
// (8- or 16-byte vectors where V = 2 or 4), and V 16-byte stores of the
// 4V output floats, zeros written where the source is -1. The edge
// stream is loaded and stored with the streaming (evict-first) hint so
// that it does not push the values table out of L2. A tail of E % 4
// edges goes edge by edge in the last thread; V above 4, and pointers not
// aligned for the vectors, take a scalar kernel, one edge a thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int V>
__device__ __forceinline__ void load_row(const float* __restrict__ values,
                                         int src, float* r) {
  if (src < 0) {
#pragma unroll
    for (int d = 0; d < V; ++d) r[d] = 0.0f;
    return;
  }
  const long long b = (long long)src * V;
  if constexpr (V == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(values + b));
    r[0] = x.x;
    r[1] = x.y;
  } else if constexpr (V == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(values + b));
    r[0] = x.x;
    r[1] = x.y;
    r[2] = x.z;
    r[3] = x.w;
  } else {
#pragma unroll
    for (int d = 0; d < V; ++d) r[d] = __ldg(values + b + d);
  }
}

// One edge: the scalar path.
__device__ __forceinline__ void gather_one(const float* __restrict__ values,
                                           int V, int src,
                                           const float* __restrict__ edge_val,
                                           long long e, float* __restrict__ o) {
  if (src < 0) {
    for (int d = 0; d < V; ++d) o[d] = 0.0f;
    return;
  }
  const float* row = values + (long long)src * V;
  if (edge_val != nullptr) {
    const float w = edge_val[e];
    for (int d = 0; d < V; ++d) o[d] = __fmul_rn(__ldg(row + d), w);
  } else {
    for (int d = 0; d < V; ++d) o[d] = __ldg(row + d);
  }
}

// Four edges a thread; the thread past the last full quad takes the
// E % 4 edges left one by one.
template <int V>
__global__ void __launch_bounds__(THREADS)
gather_quads(const float* __restrict__ values,
             const int* __restrict__ flat_src,
             const float* __restrict__ edge_val, long long E,
             float* __restrict__ out) {
  const long long q = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long e0 = q * 4;
  if (e0 >= E) return;
  if (e0 + 4 > E) {
    for (long long e = e0; e < E; ++e)
      gather_one(values, V, flat_src[e], edge_val, e, out + e * V);
    return;
  }
  const int4 s = __ldcs(reinterpret_cast<const int4*>(flat_src) + q);
  const int src[4] = {s.x, s.y, s.z, s.w};
  float r[4 * V];
#pragma unroll
  for (int j = 0; j < 4; ++j) load_row<V>(values, src[j], r + j * V);
  if (edge_val != nullptr) {
    const float4 w4 = __ldcs(reinterpret_cast<const float4*>(edge_val) + q);
    const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (src[j] < 0) continue;
#pragma unroll
      for (int d = 0; d < V; ++d) r[j * V + d] = __fmul_rn(r[j * V + d], w[j]);
    }
  }
  float4* o = reinterpret_cast<float4*>(out + e0 * V);
#pragma unroll
  for (int c = 0; c < V; ++c)
    __stcs(o + c, make_float4(r[4 * c], r[4 * c + 1], r[4 * c + 2],
                              r[4 * c + 3]));
}

// One edge a thread: any V, any alignment.
__global__ void __launch_bounds__(THREADS)
gather_scalar(const float* __restrict__ values, int V,
              const int* __restrict__ flat_src,
              const float* __restrict__ edge_val, long long E,
              float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e < E) gather_one(values, V, flat_src[e], edge_val, e, out + e * V);
}

template <int V>
void launch_quads(const float* values, const int* src, const float* ev,
                  long long E, float* out, cudaStream_t stream) {
  const long long quads = (E + 3) / 4;
  gather_quads<V><<<(unsigned)((quads + THREADS - 1) / THREADS), THREADS,
                    0, stream>>>(values, src, ev, E, out);
}

bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

}  // namespace

// values: (N, V) float32; flat_src: (E,) int32, -1 = invalid, else < N;
// edge_val: (E,) float32 or null; out: (E, V) float32, every row of which
// the kernel writes. One launch: the quad kernel where V <= 4 and the
// pointers are aligned for its vectors, else the scalar kernel.
extern "C" int edge_gather_launch(const void* values, int V,
                                  const void* flat_src, const void* edge_val,
                                  long long E, void* out, void* stream) {
  if (E <= 0) return 0;
  if (V <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* vals = static_cast<const float*>(values);
  auto* src = static_cast<const int*>(flat_src);
  auto* ev = static_cast<const float*>(edge_val);
  auto* o = static_cast<float*>(out);
  const uintptr_t row_align = V == 2 ? 8 : V == 4 ? 16 : 4;
  const bool vec = V <= 4 && aligned(src, 16) && aligned(o, 16) &&
                   (ev == nullptr || aligned(ev, 16)) &&
                   aligned(vals, row_align);
  switch (vec ? V : 0) {
    case 1: launch_quads<1>(vals, src, ev, E, o, s); break;
    case 2: launch_quads<2>(vals, src, ev, E, o, s); break;
    case 3: launch_quads<3>(vals, src, ev, E, o, s); break;
    case 4: launch_quads<4>(vals, src, ev, E, o, s); break;
    default:
      gather_scalar<<<(unsigned)((E + THREADS - 1) / THREADS), THREADS, 0,
                      s>>>(vals, V, src, ev, E, o);
  }
  return (int)cudaGetLastError();
}
