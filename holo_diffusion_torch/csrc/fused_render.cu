// Trilinear sampling by the floor/fraction corner formulation, forward only
// (sm_90a).
//
// Replaces the TPU kernel holo_diffusion_tpu/ops/pallas/fused_render.py:69
// `_sample_kernel` (K7) -> entry point `trilinear_sample_onehot`.
//
// Semantics (fused_render.py:34-66): index i = x / (extent / D) + (n - 1) / 2
// per axis, base b = floor(i), fraction f = i - b; corner b + d (d in {0, 1})
// has weight f or 1 - f per axis, times 0 when the corner lies outside
// [0, n - 1]. The output equals the hat-weight sampler's (kron_sample.cu,
// K4) up to rounding.
//
// What bounds it on the H100: memory traffic, as K4: 8 multiply-adds per
// output element, the grid in L2, the points read and the samples written
// once. On the TPU this is a second sampling strategy, a one-hot matrix
// (block x D*H*W) multiplied by the grid on the MXU, because a TPU has no
// fast gather. Over 4,096 columns with 8 non-zeros per row that product
// would waste the card, so this kernel gathers the 8 corners on K4's
// layout (`sample_gather::gather`, sample_gather.cuh, G lanes per point
// from `sample_layout`): corners once per lane with 32-bit cells, float4
// units where the rows are aligned, no branch on a corner (an outside one
// reads cell 0 with weight 0, where the TPU kernel reads its clipped cell).
// It keeps its own floor/fraction weights. No backward: the JAX function
// has none.

#include <cuda_runtime.h>

#include "sample_gather.cuh"

namespace {

using namespace sample_gather;

template <int VEC, int BATCH>
__global__ void __launch_bounds__(kThreads)
trilinear_sample_onehot_kernel(const float* __restrict__ points, const float* __restrict__ grid,
                               float* __restrict__ out, const Geometry g) {
  gather<FloorFractionCorners, VEC, BATCH>(points, grid, out, g);
}

template <int VEC>
cudaError_t launch(const float* points, const float* grid, float* out, const Geometry& g,
                   cudaStream_t s) {
  switch (batch(g, VEC)) {
    case 1: trilinear_sample_onehot_kernel<VEC, 1><<<blocks(g), kThreads, 0, s>>>(points, grid, out, g); break;
    case 2: trilinear_sample_onehot_kernel<VEC, 2><<<blocks(g), kThreads, 0, s>>>(points, grid, out, g); break;
    case 4: trilinear_sample_onehot_kernel<VEC, 4><<<blocks(g), kThreads, 0, s>>>(points, grid, out, g); break;
    default: trilinear_sample_onehot_kernel<1, 8><<<blocks(g), kThreads, 0, s>>>(points, grid, out, g);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int trilinear_sample_onehot(const float* points, const float* grid, float* out,
                                       long long n, int D, int H, int W, int C,
                                       int group_log2, float voxel_size, void* stream) {
  const Geometry g = make_geometry(n, D, H, W, C, group_log2, voxel_size);
  if (!valid(g)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec4_rows(C, grid, out) ? launch<4>(points, grid, out, g, s) : launch<1>(points, grid, out, g, s);
}
