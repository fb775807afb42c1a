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
// the cotangents and the outputs. K5 adds into the grid with atomics,
// resolved in L2: one per (point, corner, channel) would be 201 M per
// training fine pass at C = 64, which is its real limit.
//
// What the design does about it: the TPU kernel is a Kronecker-factored
// matrix product with the grid cotangent accumulated in VMEM across
// sequential grid steps. Hopper has a gather and its blocks run in no order.
//   * K4 (and K7 in fused_render.cu) gather: `sample_gather::gather` of
//     sample_gather.cuh, a point's G lanes (`sample_layout`) computing its
//     corners once with 32-bit cells and walking float4 units (single
//     floats where C % 4 != 0 or a row is unaligned, e.g. C 257).
//   * K6 gives a point about 16 channels a lane (`dpoints_layout`), 32-bit
//     cells, the same units and no branch on a corner (an outside one reads
//     cell 0 with weight 0). Lane l owns units l, l + G, ...; it loads its
//     cotangent channels once into registers and reduces its three sums over
//     the group in log2(G) shuffle rounds.
//   * K5 scatters: a block owns a tile of consecutive points
//     (`DGRID_TILE_LOG2`) and stages their 8 corners (32-bit cells, hat
//     weights; cell -1 outside the grid) and their cotangent rows (or a
//     chunk of each row's units, at most 256 floats) in shared memory. Then
//     a thread per (float4 unit, corner, run of consecutive points) walks
//     its run in order, accumulates while the corner's cell stays the same
//     and adds one atomic into d_grid each time the cell changes: on
//     ray-ordered points, as training passes lay them out, neighbours share
//     cells, so the atomics fall by the run's sharing as well as by the x4
//     vector width. Units are single floats with scalar atomics where C % 4
//     != 0 or a row is unaligned (C 257). The wrapper zeroes d_grid, and the
//     atomic sums are taken in no fixed order: the result is not
//     bit-reproducible.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sample_gather.cuh"

namespace {

using namespace sample_gather;

__device__ __forceinline__ float hat_slope(float e) {
  return fabsf(e) < 1.f ? (e > 0.f ? -1.f : (e < 0.f ? 1.f : 0.f)) : 0.f;
}

// K4: the hat-weight gather of sample_gather.cuh
template <int VEC, int BATCH>
__global__ void __launch_bounds__(kThreads)
kron_sample_fwd_kernel(const float* __restrict__ points, const float* __restrict__ grid,
                       float* __restrict__ out, const Geometry g) {
  gather<HatCorners, VEC, BATCH>(points, grid, out, g);
}

// K5's tiles: points per block, points per run (both powers of two, run <=
// tile), and the units of a row that one block stages (blockIdx.y picks
// the chunk)
struct Tiles {
  int tile_log2, run_log2, chunk;
};

template <int VEC>
__global__ void __launch_bounds__(kThreads)
kron_sample_dgrid_kernel(const float* __restrict__ points, const float* __restrict__ cot,
                         float* __restrict__ d_grid, const Geometry g, const Tiles t) {
  using U = Unit<VEC>;
  using T = typename U::T;
  extern __shared__ float4 smem4[];
  const int tile = 1 << t.tile_log2;
  const int units = g.C / VEC;
  const int u0 = blockIdx.y * t.chunk;            // this block's units u0 .. u0 + cu - 1
  const int cu = min(t.chunk, units - u0);
  T* s_cot = reinterpret_cast<T*>(smem4);         // tile x cu cotangent units
  int* s_cell = reinterpret_cast<int*>(s_cot + tile * t.chunk);  // tile x 8
  float* s_w = reinterpret_cast<float*>(s_cell + 8 * tile);      // tile x 8
  const long long base = static_cast<long long>(blockIdx.x) << t.tile_log2;
  const int here = static_cast<int>(min(static_cast<long long>(tile), g.n - base));

  for (int p = threadIdx.x; p < here; p += kThreads)
    HatCorners::corners(points, base + p, g, s_cell + 8 * p, s_w + 8 * p, -1);
  const T* cot_u = reinterpret_cast<const T*>(cot) + base * units + u0;
  for (int e = threadIdx.x; e < here * cu; e += kThreads) {
    const int p = e / cu, q = e - p * cu;
    s_cot[e] = __ldg(cot_u + static_cast<long long>(p) * units + q);
  }
  __syncthreads();

  // item = (run r, corner k, unit q), q fastest: a warp's atomics go to
  // consecutive units of a cell's row
  T* grid_u = reinterpret_cast<T*>(d_grid) + u0;
  const int items = 8 * cu * (tile >> t.run_log2);
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int kr = it / cu, q = it - kr * cu, k = kr & 7, r = kr >> 3;
    const int p_end = min((r + 1) << t.run_log2, here);
    int cur = -1;
    T acc = U::zero();
    for (int p = r << t.run_log2; p < p_end; ++p) {
      const int cell = s_cell[8 * p + k];
      if (cell != cur) {
        if (cur >= 0) atomicAdd(grid_u + cur * units + q, acc);
        cur = cell;
        acc = U::zero();
      }
      acc = U::fma(s_w[8 * p + k], s_cot[p * cu + q], acc);
    }
    if (cur >= 0) atomicAdd(grid_u + cur * units + q, acc);
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

template <int VEC>
cudaError_t launch_fwd(const float* points, const float* grid, float* out, const Geometry& g,
                       cudaStream_t s) {
  switch (batch(g, VEC)) {
    case 1: kron_sample_fwd_kernel<VEC, 1><<<blocks(g), kThreads, 0, s>>>(points, grid, out, g); break;
    case 2: kron_sample_fwd_kernel<VEC, 2><<<blocks(g), kThreads, 0, s>>>(points, grid, out, g); break;
    case 4: kron_sample_fwd_kernel<VEC, 4><<<blocks(g), kThreads, 0, s>>>(points, grid, out, g); break;
    default: kron_sample_fwd_kernel<1, 8><<<blocks(g), kThreads, 0, s>>>(points, grid, out, g);
  }
  return cudaGetLastError();
}

// K5 at float4 units (VEC 4) or single floats: a block stages at most 256
// floats of each of its tile's rows, the units shared evenly by the chunks
template <int VEC>
cudaError_t launch_dgrid(const float* points, const float* cot, float* d_grid, const Geometry& g,
                         int tile_log2, int run_log2, cudaStream_t s) {
  const int units = g.C / VEC;
  const int max_chunk = 256 / VEC;
  const int n_chunks = (units + max_chunk - 1) / max_chunk;
  if (n_chunks > 65535) return cudaErrorInvalidValue;
  Tiles t;
  t.tile_log2 = tile_log2;
  t.run_log2 = run_log2;
  t.chunk = (units + n_chunks - 1) / n_chunks;
  const size_t smem = (static_cast<size_t>(t.chunk) * VEC * 4 + 8 * 8) << tile_log2;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kron_sample_dgrid_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_dims(static_cast<unsigned>(((g.n - 1) >> tile_log2) + 1), n_chunks);
  kron_sample_dgrid_kernel<VEC><<<grid_dims, kThreads, smem, s>>>(points, cot, d_grid, g, t);
  return cudaGetLastError();
}

}  // namespace

extern "C" int kron_sample_fwd(const float* points, const float* grid, float* out,
                               long long n, int D, int H, int W, int C,
                               int group_log2, float voxel_size, void* stream) {
  const Geometry g = make_geometry(n, D, H, W, C, group_log2, voxel_size);
  if (!valid(g)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec4_rows(C, grid, out) ? launch_fwd<4>(points, grid, out, g, s)
                                 : launch_fwd<1>(points, grid, out, g, s);
}

// K5: tiles of 1 << tile_log2 points, runs of 1 << run_log2 (ops/kron_sample.py
// `DGRID_TILE_LOG2`, `DGRID_RUN_LOG2`)
extern "C" int kron_sample_dgrid(const float* points, const float* cot, float* d_grid,
                                 long long n, int D, int H, int W, int C,
                                 int run_log2, float voxel_size, int tile_log2, void* stream) {
  const Geometry g = make_geometry(n, D, H, W, C, 0, voxel_size);
  if (!valid(g) || run_log2 < 0 || run_log2 > tile_log2 || tile_log2 > 10)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec4_rows(C, cot, d_grid) ? launch_dgrid<4>(points, cot, d_grid, g, tile_log2, run_log2, s)
                                   : launch_dgrid<1>(points, cot, d_grid, g, tile_log2, run_log2, s);
}

extern "C" int kron_sample_dpoints(const float* points, const float* cot, const float* grid,
                                   float* d_points, long long n, int D, int H, int W,
                                   int C, int group_log2, float voxel_size, float inv_vs,
                                   void* stream) {
  const Geometry g = make_geometry(n, D, H, W, C, group_log2, voxel_size);
  if (!valid(g)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float4 units when every row of the grid and of the cotangent starts on
  // a 16-byte boundary; single channels otherwise
  const bool vec4 = vec4_rows(C, grid, cot);
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
