// Row-blocked edge gather (the D3 send gather) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/csr_spmv/csr_spmv.py, edge_gather_pallas
// (body _kernel), with the permuted loads and the scatter back to edge
// order of csr_spmv/ops.py:edge_gather fused in.
//   out[e] = values[flat_src[e]] * edge_val[e]   (edge_val may be absent)
// over the host-planned layout (ops.py plan_layout_fixed): edges sorted
// by source and padded so that each BM-slot tile reads one BR-row block,
// perm[slot] = original edge or -1, tile_row[tile] = its row block.
//
// What bounds it: bytes. Per slot it reads perm (4 B); per edge flat_src
// (4 B), edge_val when given (4 B), and writes out (4V B); the values are
// read once per row block. No arithmetic beyond one optional multiply.
// The TPU kernel turned the gather into a one-hot (BM x BR) @ (BR x V)
// MXU product, which turns inf and NaN into NaN (0 * inf), so the
// reference moved non-finite values in a side class channel of V more
// columns. A direct load is exact on this card for every float, so the
// port gathers V columns and drops the channel: the same function with
// half the value bytes.
//
// Design: one block of BM threads per tile. The block stages its row
// block (BR x V floats, the last block masked at N) in shared memory,
// then each thread takes one slot, reads e = perm[slot] and writes
// out[e] = block[flat_src[e] - r0]. perm is injective over valid slots,
// so no atomics; out is pre-zeroed, so edges never written read 0.0. A
// tile of pure padding returns before staging anything.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void edge_gather_tiles(const float* __restrict__ values,
                                  long long N, int V,
                                  const int* __restrict__ flat_src,
                                  const float* __restrict__ edge_val,
                                  const int* __restrict__ perm,
                                  const int* __restrict__ tile_row, int BM,
                                  int BR, float* __restrict__ out) {
  extern __shared__ float block[];
  const long long t = blockIdx.x;
  const int i = threadIdx.x;
  const int e = perm[t * BM + i];
  if (!__syncthreads_or(e >= 0)) return;   // a tile of pure padding
  const long long r0 = (long long)tile_row[t] * BR;
  const long long base = r0 * V;
  const long long end = N * V;
  for (int k = i; k < BR * V; k += blockDim.x)
    block[k] = base + k < end ? values[base + k] : 0.0f;
  __syncthreads();
  if (e < 0) return;
  const int src = flat_src[e];
  const long long local = (long long)src - r0;
  if (src < 0 || local < 0 || local >= BR) return;
  const float* row = block + local * V;
  float* dst = out + (long long)e * V;
  if (edge_val != nullptr) {
    const float w = edge_val[e];
    for (int d = 0; d < V; ++d) dst[d] = __fmul_rn(row[d], w);
  } else {
    for (int d = 0; d < V; ++d) dst[d] = row[d];
  }
}

}  // namespace

// values: (N, V) float32; flat_src: (E,) int32, -1 = invalid; edge_val:
// (E,) float32 or null; perm: (n_tiles * BM,) int32; tile_row: (n_tiles,)
// int32; out: (E, V) float32, zeroed by the caller. BM <= 1024 threads,
// BR * V * 4 bytes of shared memory <= 48 KiB.
extern "C" int edge_gather_launch(const void* values, long long N, int V,
                                  const void* flat_src, const void* edge_val,
                                  const void* perm, const void* tile_row,
                                  long long n_tiles, int BM, int BR,
                                  void* out, void* stream) {
  if (n_tiles <= 0) return 0;
  if (V <= 0 || BM <= 0 || BM > 1024 || BR <= 0 ||
      (long long)BR * V * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  edge_gather_tiles<<<(unsigned)n_tiles, BM, BR * V * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), N, V,
      static_cast<const int*>(flat_src),
      static_cast<const float*>(edge_val), static_cast<const int*>(perm),
      static_cast<const int*>(tile_row), BM, BR, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
