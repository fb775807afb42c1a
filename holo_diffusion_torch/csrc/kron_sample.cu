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
// so each point is handled by a group of lanes that computes the point's 8
// corners and walks its channels.
//   * K5 (and K7 in fused_render.cu): G = the smallest power of two >= C,
//     at most a warp, with consecutive lanes on consecutive channels of one
//     corner: coalesced atomics (K5) for any C, one float at a time. Every
//     lane recomputes the point's three divisions and 8 corners for C / G
//     channels (2 at C 64). K5 scatters with atomicAdd into a zeroed grid
//     (the sum order changes from run to run: not bit-reproducible).
//   * K4 and K6 have fewer lanes with more channels each (K4: at least 8
//     per lane in float4 units, 16 single, `sample_layout`; K6: about 16,
//     `dpoints_layout`, both in ops/kron_sample.py), 32-bit cells, float4 channel units where
//     C % 4 == 0 and both rows lie on 16-byte boundaries, and a scalar loop
//     otherwise (C 257). Each lane computes the corners once and walks its
//     units in register batches over the 8 corners, with no branch on a
//     corner: one outside the grid reads cell 0 with weight 0, so all of a
//     batch's loads can be in flight together. Lane l owns units l, l + G,
//     ..., so the lanes of a point read (K4 also writes) consecutive units
//     of a row. K6 loads its cotangent channels once into registers and
//     reduces its three sums over the group in log2(G) shuffle rounds.

#include <cuda_runtime.h>
#include <stdint.h>

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

// The 8 corners of point i in (dz, dy, dx) order: flat cell (64-bit for K5,
// 32-bit for K4) and hat weight; a corner outside the grid gets cell 0 and
// weight 0.
template <typename Cell>
__device__ __forceinline__ void corners(const float* points, long long i,
                                        const Geometry& g, Cell* cell, float* w) {
  const float ix = points[3 * i + 0] / g.voxel_size + 0.5f * (g.W - 1);
  const float iy = points[3 * i + 1] / g.voxel_size + 0.5f * (g.H - 1);
  const float iz = points[3 * i + 2] / g.voxel_size + 0.5f * (g.D - 1);
  const float x0 = floorf(ix), y0 = floorf(iy), z0 = floorf(iz);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float qx = x0 + (k & 1), qy = y0 + ((k >> 1) & 1), qz = z0 + (k >> 2);
    const bool inside = qx >= 0.f && qx <= g.W - 1 && qy >= 0.f &&
                        qy <= g.H - 1 && qz >= 0.f && qz <= g.D - 1;
    const float hx = hat(ix - qx), hy = hat(iy - qy), hz = hat(iz - qz);
    w[k] = inside ? hx * hy * hz : 0.f;
    cell[k] = inside ? (static_cast<Cell>(qz) * g.H + static_cast<Cell>(qy)) * g.W +
                           static_cast<Cell>(qx)
                     : 0;
  }
}

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

// K4: G = 1 << group_log2 lanes per point (`sample_layout`). Each lane
// computes the point's corners once, then walks its units in batches of
// BATCH (lane l owns units l, l + G, ...): a batch's accumulators stay in
// registers across the 8 corners, summed in corner order as the plain
// version does, and the lanes of a point store consecutive units of its
// row (coalesced).
template <int VEC, int BATCH>
__global__ void __launch_bounds__(kThreads)
kron_sample_fwd_kernel(const float* __restrict__ points, const float* __restrict__ grid,
                       float* __restrict__ out, const Geometry g) {
  using U = Unit<VEC>;
  using T = typename U::T;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = t >> g.group_log2;
  const int lanes = 1 << g.group_log2;
  const int lane = static_cast<int>(t & (lanes - 1));
  if (i >= g.n) return;
  int cell[8];
  float w[8];
  corners(points, i, g, cell, w);
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

__global__ void __launch_bounds__(kThreads)
kron_sample_dgrid_kernel(const float* __restrict__ points, const float* __restrict__ cot,
                         float* __restrict__ d_grid, const Geometry g) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = t >> g.group_log2;
  const int lane = static_cast<int>(t & ((1 << g.group_log2) - 1));
  if (i >= g.n) return;
  long long cell[8];
  float w[8];
  corners(points, i, g, cell, w);
  for (int c = lane; c < g.C; c += 1 << g.group_log2) {
    const float v = __ldg(cot + i * g.C + c);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (w[k] != 0.f) atomicAdd(d_grid + cell[k] * g.C + c, w[k] * v);
  }
}

// K6: a group of G = 1 << group_log2 lanes per point (ops/kron_sample.py
// `dpoints_layout`: about 16 channels per lane, G = 4 at C 64, 1 at C 1). Each
// lane computes the point's corners once, with 32-bit cells, then walks its
// channels in batches of BATCH units: VEC = 4 takes float4 units (unit u is
// channels 4u..4u+3, lane l owns units l, l + G, ...), VEC = 1 single
// channels (any C, e.g. 257). A batch's cotangent units are loaded into
// registers once and used for all 8 corners; BATCH is 1 where a lane owns
// at most one unit (C 1), which keeps the register count, and so the
// blocks resident per SM, of a thread-per-point launch. cot == nullptr: the all-ones
// cotangent (the spatial gradient of the field summed over channels). The
// three sums reduce over the group in log2(G) shuffle rounds; every thread
// of the launch reaches them.
template <int VEC, int BATCH>
__global__ void __launch_bounds__(kThreads)
kron_sample_dpoints_kernel(const float* __restrict__ points, const float* __restrict__ cot,
                           const float* __restrict__ grid, float* __restrict__ d_points,
                           const Geometry g, const float inv_vs) {
  using U = Unit<VEC>;
  using T = typename U::T;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = t >> g.group_log2;
  const int lanes = 1 << g.group_log2;
  const int lane = static_cast<int>(t & (lanes - 1));
  const bool valid = i < g.n;
  float ax = 0.f, ay = 0.f, az = 0.f;
  if (valid) {
    // the point's 8 corners, once per lane: flat cell (32-bit) and the
    // weights of d/dix, d/diy, d/diz (0 outside the grid)
    const float ix = points[3 * i + 0] / g.voxel_size + 0.5f * (g.W - 1);
    const float iy = points[3 * i + 1] / g.voxel_size + 0.5f * (g.H - 1);
    const float iz = points[3 * i + 2] / g.voxel_size + 0.5f * (g.D - 1);
    const float x0 = floorf(ix), y0 = floorf(iy), z0 = floorf(iz);
    int cell[8];
    float gw[8][3];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float qx = x0 + (k & 1), qy = y0 + ((k >> 1) & 1), qz = z0 + (k >> 2);
      const bool inside = qx >= 0.f && qx <= g.W - 1 && qy >= 0.f &&
                          qy <= g.H - 1 && qz >= 0.f && qz <= g.D - 1;
      const float ex = ix - qx, ey = iy - qy, ez = iz - qz;
      const float hx = hat(ex), hy = hat(ey), hz = hat(ez);
      cell[k] = inside ? (static_cast<int>(qz) * g.H + static_cast<int>(qy)) * g.W +
                             static_cast<int>(qx)
                       : 0;
      gw[k][0] = inside ? hat_slope(ex) * hy * hz : 0.f;
      gw[k][1] = inside ? hx * hat_slope(ey) * hz : 0.f;
      gw[k][2] = inside ? hx * hy * hat_slope(ez) : 0.f;
    }
    const int units = g.C / VEC;
    const T* grid_u = reinterpret_cast<const T*>(grid);
    const T* cot_u = cot == nullptr ? nullptr : reinterpret_cast<const T*>(cot) + i * units;
    for (int u0 = lane; u0 < units; u0 += BATCH * lanes) {
      T c[BATCH];  // this batch's cotangent units, read once
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int u = u0 + b * lanes;
        c[b] = (cot != nullptr && u < units) ? __ldg(cot_u + u) : U::zero();
      }
      // no branch on the corner: one outside the grid reads cell 0 with
      // zero slopes, so every corner's loads can be in flight at once
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const T* row = grid_u + cell[k] * units;
        float v = 0.f;
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          const int u = u0 + b * lanes;
          if (u < units) {
            const T x = __ldg(row + u);
            v += cot == nullptr ? U::sum(x) : U::dot(c[b], x);
          }
        }
        ax = fmaf(gw[k][0], v, ax);
        ay = fmaf(gw[k][1], v, ay);
        az = fmaf(gw[k][2], v, az);
      }
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

// K4's batch: a lane's units held in registers at once, the next power of
// two >= the units it owns, at most 4 float4 or 8 floats (a batch of 16
// floats took 93 registers, 2 blocks per SM, and was slower at every G on
// an H100)
template <int VEC>
cudaError_t launch_fwd(const float* points, const float* grid, float* out, const Geometry& g,
                       cudaStream_t s) {
  const int lanes = 1 << g.group_log2;
  const int per_lane = (g.C / VEC + lanes - 1) / lanes;
  if (per_lane <= 1)
    kron_sample_fwd_kernel<VEC, 1><<<blocks(g), kThreads, 0, s>>>(points, grid, out, g);
  else if (per_lane <= 2)
    kron_sample_fwd_kernel<VEC, 2><<<blocks(g), kThreads, 0, s>>>(points, grid, out, g);
  else if (VEC == 4 || per_lane <= 4)
    kron_sample_fwd_kernel<VEC, 4><<<blocks(g), kThreads, 0, s>>>(points, grid, out, g);
  else
    kron_sample_fwd_kernel<1, 8><<<blocks(g), kThreads, 0, s>>>(points, grid, out, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" int kron_sample_fwd(const float* points, const float* grid, float* out,
                               long long n, int D, int H, int W, int C,
                               int group_log2, float voxel_size, void* stream) {
  const Geometry g = make_geometry(n, D, H, W, C, group_log2, voxel_size);
  if (!valid(g)) return cudaErrorInvalidValue;
  // 32-bit cell indices: every flat grid offset fits in an int
  if (static_cast<long long>(D) * H * W * C >= (1LL << 31)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float4 units when every row of the grid and of the output starts on a
  // 16-byte boundary; single channels otherwise
  const bool vec4 = C % 4 == 0 && reinterpret_cast<uintptr_t>(grid) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec4 ? launch_fwd<4>(points, grid, out, g, s) : launch_fwd<1>(points, grid, out, g, s);
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
  // 32-bit cell indices: every flat grid offset fits in an int
  if (static_cast<long long>(D) * H * W * C >= (1LL << 31)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float4 units when every row of the grid and of the cotangent starts on
  // a 16-byte boundary; single channels otherwise
  const bool vec4 = C % 4 == 0 && reinterpret_cast<uintptr_t>(grid) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(cot) % 16 == 0;
  // a batch of 8 channels per lane, or 1 unit where a lane owns no more
  const int units = vec4 ? C / 4 : C;
  const bool one = units <= (1 << group_log2);
  if (vec4 && one)
    kron_sample_dpoints_kernel<4, 1><<<blocks(g), kThreads, 0, s>>>(points, cot, grid, d_points, g, inv_vs);
  else if (vec4)
    kron_sample_dpoints_kernel<4, 2><<<blocks(g), kThreads, 0, s>>>(points, cot, grid, d_points, g, inv_vs);
  else if (one)
    kron_sample_dpoints_kernel<1, 1><<<blocks(g), kThreads, 0, s>>>(points, cot, grid, d_points, g, inv_vs);
  else
    kron_sample_dpoints_kernel<1, 8><<<blocks(g), kThreads, 0, s>>>(points, cot, grid, d_points, g, inv_vs);
  return cudaGetLastError();
}
