// Trilinear sampling by the floor/fraction corner formulation, forward only
// (sm_90a).
//
// Replaces the TPU kernel holo_diffusion_tpu/ops/pallas/fused_render.py:69
// `_sample_kernel` (K7) -> entry point `trilinear_sample_onehot`.
//
// Semantics (fused_render.py:34-66): index i = x / (extent / D) + (n - 1) / 2
// per axis, base b = floor(i), fraction f = i - b; corner b + d (d in {0, 1})
// has weight f or 1 - f per axis, times 0 when the corner lies outside
// [0, n - 1]; its cell index is clipped into the grid. The output equals
// the hat-weight sampler's (kron_sample.cu, K4) up to rounding.
//
// What bounds it on the H100: memory traffic, as K4: 8 multiply-adds per
// output element, the grid in L2, the points read and the samples written
// once. On the TPU this is a second sampling strategy, a one-hot matrix
// (block x D*H*W) multiplied by the grid on the MXU, because a TPU has no
// fast gather. Over 4,096 columns with 8 non-zeros per row that product
// would waste the card, so this kernel gathers the 8 clipped corners: a
// group of G lanes per point (G = the smallest power of two >= C, at most a
// warp), consecutive lanes on consecutive channels, one float per load (any
// C). No backward: the JAX function has none.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
trilinear_sample_onehot_kernel(const float* __restrict__ points, const float* __restrict__ grid,
                               float* __restrict__ out, long long n, int D, int H, int W, int C,
                               int group_log2, float voxel_size) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = t >> group_log2;
  const int lane = static_cast<int>(t & ((1 << group_log2) - 1));
  if (i >= n) return;
  const float ix = points[3 * i + 0] / voxel_size + 0.5f * (W - 1);
  const float iy = points[3 * i + 1] / voxel_size + 0.5f * (H - 1);
  const float iz = points[3 * i + 2] / voxel_size + 0.5f * (D - 1);
  const float x0 = floorf(ix), y0 = floorf(iy), z0 = floorf(iz);
  const float fx = ix - x0, fy = iy - y0, fz = iz - z0;
  long long cell[8];
  float w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k & 1, dy = (k >> 1) & 1, dz = k >> 2;
    const float xi = x0 + dx, yi = y0 + dy, zi = z0 + dz;
    const bool inside = xi >= 0.f && xi <= W - 1 && yi >= 0.f && yi <= H - 1 &&
                        zi >= 0.f && zi <= D - 1;
    const float wk = (dx ? fx : 1.f - fx) * (dy ? fy : 1.f - fy) * (dz ? fz : 1.f - fz);
    w[k] = inside ? wk : 0.f;
    const long long xc = static_cast<long long>(fminf(fmaxf(xi, 0.f), W - 1.f));
    const long long yc = static_cast<long long>(fminf(fmaxf(yi, 0.f), H - 1.f));
    const long long zc = static_cast<long long>(fminf(fmaxf(zi, 0.f), D - 1.f));
    cell[k] = (zc * H + yc) * W + xc;
  }
  for (int c = lane; c < C; c += 1 << group_log2) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = fmaf(w[k], __ldg(grid + cell[k] * C + c), acc);
    out[i * C + c] = acc;
  }
}

}  // namespace

extern "C" int trilinear_sample_onehot(const float* points, const float* grid, float* out,
                                       long long n, int D, int H, int W, int C,
                                       int group_log2, float voxel_size, void* stream) {
  if (n < 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || group_log2 < 0 || group_log2 > 5)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>(((n << group_log2) + kThreads - 1) / kThreads);
  trilinear_sample_onehot_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      points, grid, out, n, D, H, W, C, group_log2, voxel_size);
  return cudaGetLastError();
}
