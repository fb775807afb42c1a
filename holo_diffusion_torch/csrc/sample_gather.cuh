// The gather that the two trilinear samplers share (sm_90a): K4
// (`kron_sample_fwd`, kron_sample.cu) with hat-weight corners and K7
// (`trilinear_sample_onehot`, fused_render.cu) with floor/fraction corners.
// Both give a point G lanes (`sample_layout` in ops/kron_sample.py), which
// compute its 8 corners once with 32-bit cells and walk its channels in
// float4 units where C % 4 == 0 and both the grid's and the output's rows
// lie on 16-byte boundaries, single floats otherwise (C 257). A batch of a
// lane's units keeps its accumulators in registers across the 8 corners;
// there is no branch on a corner: one outside the grid reads the cell its
// policy names (cell 0 here) with weight 0, so all of a batch's loads can
// be in flight together. Lane l owns units l, l + G, ..., so the lanes of a
// point read and write consecutive units of a row.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sample_gather {

constexpr int kThreads = 256;

struct Geometry {
  long long n;        // points
  int D, H, W, C;
  int group_log2;     // lanes per point = 1 << group_log2
  float voxel_size;   // extent / D
};

inline Geometry make_geometry(long long n, int D, int H, int W, int C, int group_log2,
                              float voxel_size) {
  Geometry g;
  g.n = n; g.D = D; g.H = H; g.W = W; g.C = C; g.group_log2 = group_log2;
  g.voxel_size = voxel_size;
  return g;
}

inline bool valid(const Geometry& g) {
  return g.n >= 0 && g.D > 0 && g.H > 0 && g.W > 0 && g.C > 0 &&
         g.group_log2 >= 0 && g.group_log2 <= 5 &&
         // 32-bit cell indices: every flat grid offset fits in an int
         static_cast<long long>(g.D) * g.H * g.W * g.C < (1LL << 31);
}

// blocks of kThreads for G lanes on each of n points
inline unsigned blocks(const Geometry& g) {
  return static_cast<unsigned>(((g.n << g.group_log2) + kThreads - 1) / kThreads);
}

__device__ __forceinline__ float hat(float e) { return fmaxf(0.f, 1.f - fabsf(e)); }

// Corner policies: the 8 corners of point i in (dz, dy, dx) order, as a
// flat cell and a weight; a corner outside [0, n - 1] on some axis gets
// weight 0 and the cell `outside`.
//
// K4, K5 (kron_sample.py:56-80): hat weights relu(1 - |i - q|) per axis at
// q in {floor(i), floor(i) + 1}.
struct HatCorners {
  static __device__ __forceinline__ void corners(const float* points, long long i, const Geometry& g,
                                                 int* cell, float* w, int outside) {
    const float ix = points[3 * i + 0] / g.voxel_size + 0.5f * (g.W - 1);
    const float iy = points[3 * i + 1] / g.voxel_size + 0.5f * (g.H - 1);
    const float iz = points[3 * i + 2] / g.voxel_size + 0.5f * (g.D - 1);
    const float x0 = floorf(ix), y0 = floorf(iy), z0 = floorf(iz);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float qx = x0 + (k & 1), qy = y0 + ((k >> 1) & 1), qz = z0 + (k >> 2);
      const bool inside = qx >= 0.f && qx <= g.W - 1 && qy >= 0.f &&
                          qy <= g.H - 1 && qz >= 0.f && qz <= g.D - 1;
      w[k] = inside ? hat(ix - qx) * hat(iy - qy) * hat(iz - qz) : 0.f;
      cell[k] = inside ? (static_cast<int>(qz) * g.H + static_cast<int>(qy)) * g.W +
                             static_cast<int>(qx)
                       : outside;
    }
  }
};

// K7 (fused_render.py:34-66): base b = floor(i), fraction f = i - b; corner
// b + d (d in {0, 1}) weighs f or 1 - f per axis.
struct FloorFractionCorners {
  static __device__ __forceinline__ void corners(const float* points, long long i, const Geometry& g,
                                                 int* cell, float* w, int outside) {
    const float ix = points[3 * i + 0] / g.voxel_size + 0.5f * (g.W - 1);
    const float iy = points[3 * i + 1] / g.voxel_size + 0.5f * (g.H - 1);
    const float iz = points[3 * i + 2] / g.voxel_size + 0.5f * (g.D - 1);
    const float x0 = floorf(ix), y0 = floorf(iy), z0 = floorf(iz);
    const float fx = ix - x0, fy = iy - y0, fz = iz - z0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int dx = k & 1, dy = (k >> 1) & 1, dz = k >> 2;
      const float xi = x0 + dx, yi = y0 + dy, zi = z0 + dz;
      const bool inside = xi >= 0.f && xi <= g.W - 1 && yi >= 0.f && yi <= g.H - 1 &&
                          zi >= 0.f && zi <= g.D - 1;
      const float wk = (dx ? fx : 1.f - fx) * (dy ? fy : 1.f - fy) * (dz ? fz : 1.f - fz);
      w[k] = inside ? wk : 0.f;
      cell[k] = inside ? (static_cast<int>(zi) * g.H + static_cast<int>(yi)) * g.W +
                             static_cast<int>(xi)
                       : outside;
    }
  }
};

// Channel units: a float4 of channels 4u..4u+3 (VEC 4) or one channel.
template <int VEC>
struct Unit;
template <>
struct Unit<4> {
  using T = float4;
  static __device__ __forceinline__ float dot(const T& a, const T& b) {
    return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
  }
  static __device__ __forceinline__ float sum(const T& a) { return (a.x + a.y) + (a.z + a.w); }
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ T fma(float w, const T& x, const T& acc) {
    return make_float4(fmaf(w, x.x, acc.x), fmaf(w, x.y, acc.y), fmaf(w, x.z, acc.z),
                       fmaf(w, x.w, acc.w));
  }
};
template <>
struct Unit<1> {
  using T = float;
  static __device__ __forceinline__ float dot(const T& a, const T& b) { return a * b; }
  static __device__ __forceinline__ float sum(const T& a) { return a; }
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T fma(float w, const T& x, const T& acc) { return fmaf(w, x, acc); }
};

// float4 units when C % 4 == 0 and both row-major (., C) arrays start on a
// 16-byte boundary
inline bool vec4_rows(int C, const void* a, const void* b) {
  return C % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

// The sample of point t >> group_log2 by lane t & (G - 1): corners once,
// then batches of BATCH units whose accumulators stay in registers across
// the 8 corners, summed in corner order as the plain versions do.
template <class Corners, int VEC, int BATCH>
__device__ __forceinline__ void gather(const float* __restrict__ points, const float* __restrict__ grid,
                                       float* __restrict__ out, const Geometry& g) {
  using U = Unit<VEC>;
  using T = typename U::T;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = t >> g.group_log2;
  const int lanes = 1 << g.group_log2;
  const int lane = static_cast<int>(t & (lanes - 1));
  if (i >= g.n) return;
  int cell[8];
  float w[8];
  Corners::corners(points, i, g, cell, w, 0);
  const int units = g.C / VEC;
  const T* grid_u = reinterpret_cast<const T*>(grid);
  T* out_u = reinterpret_cast<T*>(out) + i * units;
  for (int u0 = lane; u0 < units; u0 += BATCH * lanes) {
    T acc[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) acc[b] = U::zero();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const T* row = grid_u + cell[k] * units;
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int u = u0 + b * lanes;
        if (u < units) acc[b] = U::fma(w[k], __ldg(row + u), acc[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int u = u0 + b * lanes;
      if (u < units) out_u[u] = acc[b];
    }
  }
}

// A lane's batch: the next power of two >= the units it owns, at most 4
// float4 or 8 floats (a batch of 16 floats took 93 registers, 2 blocks per
// SM, and was slower at every G on an H100)
inline int batch(const Geometry& g, int vec) {
  const int lanes = 1 << g.group_log2;
  const int per_lane = (g.C / vec + lanes - 1) / lanes;
  if (per_lane <= 1) return 1;
  if (per_lane <= 2) return 2;
  if (vec == 4 || per_lane <= 4) return 4;
  return 8;
}

}  // namespace sample_gather
