// Trilinear sampling of a channels-last voxel grid and its two cotangents
// (sm_90a).
//
// Replaces the TPU kernels of holo_diffusion_tpu/ops/pallas/kron_sample.py:
//   * `_fwd_kernel` (:83, K4)      -> entry point `kron_sample_fwd`
//   * `_dgrid_kernel` (:100, K5)   -> entry point `kron_sample_dgrid`
//   * `_dpoints_kernel` (:121, K6) -> entry point `kron_sample_dpoints`
//
// Semantics (kron_sample.py:56-80): index i = x / (extent / D) + (n - 1) / 2
// on every axis (align_corners); the corners q in {floor(i), floor(i) + 1}
// carry hat weights relu(1 - |i - q|) per axis, and a corner outside
// [0, n - 1] contributes nothing (zero padding). The slope of a hat is
// -sign(i - q) inside |i - q| < 1, so a coordinate exactly on a voxel plane
// has slope 0 along that axis (kron_sample.py:136-160). K6 scales by D / extent.
//
// What bounds them on the H100: memory traffic. Each output element takes
// 8 fused multiply-adds; the grid (16^3 x 64 floats = 1 MiB, 4.2 MiB at
// C = 257) stays in the 50 MB L2, so the device-memory bytes are the points,
// the cotangents and the outputs. K5 adds 8 float atomics per (point,
// channel) into the grid: 201 M per training fine pass at C = 64, resolved in
// L2, which is its real limit.
//
// What the design does about it: the TPU kernel is a Kronecker-factored
// matrix product with the grid cotangent accumulated in VMEM across
// sequential grid steps. Hopper has a gather and its blocks run in no order,
// so each point is handled by a group of G lanes (G = the smallest power of
// two >= C, at most a warp) that computes the point's 8 corners once and
// walks the channels with consecutive lanes on consecutive channels of one
// corner: coalesced reads (K4, K6), writes (K4) and atomics (K5), for any C.
// Channels are read one float at a time, so C = 257 needs no alignment. K5
// scatters with atomicAdd into a zeroed grid (the sum order changes from
// run to run: not bit-reproducible). K6 reduces each lane's partial sums
// over the group with warp shuffles. Per-block shared-memory partials of
// the grid cotangent are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Geometry {
  long long n;        // points
  int D, H, W, C;
  int group_log2;     // lanes per point = 1 << group_log2
  float voxel_size;   // extent / D
};

__device__ __forceinline__ float hat(float e) { return fmaxf(0.f, 1.f - fabsf(e)); }

__device__ __forceinline__ float hat_slope(float e) {
  return fabsf(e) < 1.f ? (e > 0.f ? -1.f : (e < 0.f ? 1.f : 0.f)) : 0.f;
}

// The 8 corners of point i in (dz, dy, dx) order: flat cell, hat weight
// (0 outside the grid) and, with SLOPES, the weights of d/dix, d/diy, d/diz.
template <bool SLOPES>
__device__ __forceinline__ void corners(const float* points, long long i,
                                        const Geometry& g, long long* cell,
                                        float* w, float (*gw)[3]) {
  const float ix = points[3 * i + 0] / g.voxel_size + 0.5f * (g.W - 1);
  const float iy = points[3 * i + 1] / g.voxel_size + 0.5f * (g.H - 1);
  const float iz = points[3 * i + 2] / g.voxel_size + 0.5f * (g.D - 1);
  const float x0 = floorf(ix), y0 = floorf(iy), z0 = floorf(iz);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float qx = x0 + (k & 1), qy = y0 + ((k >> 1) & 1), qz = z0 + (k >> 2);
    const bool inside = qx >= 0.f && qx <= g.W - 1 && qy >= 0.f &&
                        qy <= g.H - 1 && qz >= 0.f && qz <= g.D - 1;
    const float ex = ix - qx, ey = iy - qy, ez = iz - qz;
    const float hx = hat(ex), hy = hat(ey), hz = hat(ez);
    w[k] = inside ? hx * hy * hz : 0.f;
    cell[k] = inside ? (static_cast<long long>(qz) * g.H + static_cast<long long>(qy)) * g.W +
                           static_cast<long long>(qx)
                     : 0;
    if (SLOPES) {
      gw[k][0] = inside ? hat_slope(ex) * hy * hz : 0.f;
      gw[k][1] = inside ? hx * hat_slope(ey) * hz : 0.f;
      gw[k][2] = inside ? hx * hy * hat_slope(ez) : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
kron_sample_fwd_kernel(const float* __restrict__ points, const float* __restrict__ grid,
                       float* __restrict__ out, const Geometry g) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = t >> g.group_log2;
  const int lane = static_cast<int>(t & ((1 << g.group_log2) - 1));
  if (i >= g.n) return;
  long long cell[8];
  float w[8];
  corners<false>(points, i, g, cell, w, nullptr);
  for (int c = lane; c < g.C; c += 1 << g.group_log2) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (w[k] != 0.f) acc = fmaf(w[k], __ldg(grid + cell[k] * g.C + c), acc);
    out[i * g.C + c] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
kron_sample_dgrid_kernel(const float* __restrict__ points, const float* __restrict__ cot,
                         float* __restrict__ d_grid, const Geometry g) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = t >> g.group_log2;
  const int lane = static_cast<int>(t & ((1 << g.group_log2) - 1));
  if (i >= g.n) return;
  long long cell[8];
  float w[8];
  corners<false>(points, i, g, cell, w, nullptr);
  for (int c = lane; c < g.C; c += 1 << g.group_log2) {
    const float v = __ldg(cot + i * g.C + c);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (w[k] != 0.f) atomicAdd(d_grid + cell[k] * g.C + c, w[k] * v);
  }
}

// cot == nullptr: the all-ones cotangent (the spatial gradient of the field
// summed over channels). Every thread of the launch reaches the shuffles.
__global__ void __launch_bounds__(kThreads)
kron_sample_dpoints_kernel(const float* __restrict__ points, const float* __restrict__ cot,
                           const float* __restrict__ grid, float* __restrict__ d_points,
                           const Geometry g, const float inv_vs) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = t >> g.group_log2;
  const int lanes = 1 << g.group_log2;
  const int lane = static_cast<int>(t & (lanes - 1));
  const bool valid = i < g.n;
  float ax = 0.f, ay = 0.f, az = 0.f;
  if (valid) {
    long long cell[8];
    float w[8], gw[8][3];
    corners<true>(points, i, g, cell, w, gw);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (gw[k][0] == 0.f && gw[k][1] == 0.f && gw[k][2] == 0.f) continue;
      const float* row = grid + cell[k] * g.C;
      float v = 0.f;
      if (cot == nullptr) {
        for (int c = lane; c < g.C; c += lanes) v += __ldg(row + c);
      } else {
        for (int c = lane; c < g.C; c += lanes)
          v = fmaf(__ldg(cot + i * g.C + c), __ldg(row + c), v);
      }
      ax = fmaf(gw[k][0], v, ax);
      ay = fmaf(gw[k][1], v, ay);
      az = fmaf(gw[k][2], v, az);
    }
  }
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    ax += __shfl_xor_sync(0xffffffffu, ax, off);
    ay += __shfl_xor_sync(0xffffffffu, ay, off);
    az += __shfl_xor_sync(0xffffffffu, az, off);
  }
  if (valid && lane == 0) {
    d_points[3 * i + 0] = ax * inv_vs;
    d_points[3 * i + 1] = ay * inv_vs;
    d_points[3 * i + 2] = az * inv_vs;
  }
}

Geometry make_geometry(long long n, int D, int H, int W, int C, int group_log2,
                       float voxel_size) {
  Geometry g;
  g.n = n; g.D = D; g.H = H; g.W = W; g.C = C; g.group_log2 = group_log2;
  g.voxel_size = voxel_size;
  return g;
}

bool valid(const Geometry& g) {
  return g.n >= 0 && g.D > 0 && g.H > 0 && g.W > 0 && g.C > 0 &&
         g.group_log2 >= 0 && g.group_log2 <= 5;
}

unsigned blocks(const Geometry& g) {
  return static_cast<unsigned>(((g.n << g.group_log2) + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int kron_sample_fwd(const float* points, const float* grid, float* out,
                               long long n, int D, int H, int W, int C,
                               int group_log2, float voxel_size, void* stream) {
  const Geometry g = make_geometry(n, D, H, W, C, group_log2, voxel_size);
  if (!valid(g)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  kron_sample_fwd_kernel<<<blocks(g), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      points, grid, out, g);
  return cudaGetLastError();
}

extern "C" int kron_sample_dgrid(const float* points, const float* cot, float* d_grid,
                                 long long n, int D, int H, int W, int C,
                                 int group_log2, float voxel_size, void* stream) {
  const Geometry g = make_geometry(n, D, H, W, C, group_log2, voxel_size);
  if (!valid(g)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  kron_sample_dgrid_kernel<<<blocks(g), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      points, cot, d_grid, g);
  return cudaGetLastError();
}

extern "C" int kron_sample_dpoints(const float* points, const float* cot, const float* grid,
                                   float* d_points, long long n, int D, int H, int W,
                                   int C, int group_log2, float voxel_size, float inv_vs,
                                   void* stream) {
  const Geometry g = make_geometry(n, D, H, W, C, group_log2, voxel_size);
  if (!valid(g)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  kron_sample_dpoints_kernel<<<blocks(g), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      points, cot, grid, d_points, g, inv_vs);
  return cudaGetLastError();
}
