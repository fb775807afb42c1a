// Fused trilinear sample + render decode on the tensor cores (sm_90a).
//
// Replaces the TPU kernels of holo_diffusion_tpu/ops/pallas/fused_decode.py:
//   * `_fwd_kernel` (:122, K1)                          -> `fused_decode_fwd`
//   * `_fwd_kernel_normals` (:144, K3; `_normals_block` :74)
//                                                       -> `fused_decode_fwd_normals`
// Both are one template, `fused_decode_kernel<C, NORMALS>`.
//
// Per point, with s the trilinear sample of the (D, H, W, C) grid:
//   pre  = s @ A + c                  A: collapsed density affine (C, hidden+1)
//   h    = leaky_relu_0.2(pre)
//   rgb  = sigmoid(leaky_relu([h[:hidden] | pe_dir] @ Wr + br))
//   out  = [h[hidden] | rgb]          (the density lane IS leaky-relu'd; the
//                                      raymarcher applies its ReLU later)
// K3 appends the analytic spatial gradient of the scalar trilinear field
// g1 = grid @ A[:, -1] at the point, times D / extent (lanes 4:7).
//
// Sampling semantics (holo_diffusion_tpu/ops/pallas/kron_sample.py:56-63):
// index = x / (extent / D) + (n - 1) / 2 on every axis (a true division),
// align_corners, and a corner outside the grid contributes zero (no
// clamping). The derivative of the hat relu(1 - |i - q|) is -sign(i - q) for
// |i - q| < 1 and 0 otherwise, so the gradient along an axis is 0 at an
// exact integer coordinate, as in the TPU kernel (fused_decode.py:85-106).
//
// What bounds it on the H100: the 64 x 257 affine, 32.9 kFLOP of the
// ~35.6 kFLOP per point. On the float32 CUDA cores (67 TFLOP/s) that is
// 0.044 ms per 81,920-point chunk; on the tensor cores in TF32 (495 TFLOP/s)
// the float32-accurate 3-pass split below costs 3 x 32.9 kFLOP per point,
// about 0.020 ms. The grid (1 MiB) stays in L2; each point reads 12 B and
// writes 16 B (K1) or 28 B (K3).
//
// What the design does about it:
//   * A persistent grid of one 512-thread block per SM stages A, c, Wr and
//     br in shared memory once per block (132 times per launch), 16 loads of
//     A in flight per thread, each thread writing whole 16-byte fragment
//     slots (no bank conflicts; `stage_split_a`, tf32_mma.cuh, shared with
//     the backward). Each block takes an even
//     share of the 16-point tiles, so the coarse (40,960-point) and fine
//     (81,920-point) chunks both load every SM.
//   * A warp owns a 16-point tile. Lanes 0-15 each compute one point's 8
//     corners (and K3's g1 gradient); then C/4 lanes per point gather the
//     corners' channels as float4 into the warp's s tile in shared memory,
//     without branches (a corner outside reads cell 0 with weight 0).
//   * The affine runs as mma.sync.m16n8k8 TF32 over (16 points x C) by
//     (C x 8 columns) tiles, with the 3 x TF32 split a_hi b_hi + a_hi b_lo +
//     a_lo b_hi (each part rounded with cvt.rna.tf32.f32) to keep float32
//     accuracy: one TF32 pass keeps ~3 decimal digits. The s tile's hi/lo
//     fragments live in registers for the whole column sweep; A is staged
//     already split, in the mma's B-fragment order (one conflict-free 16-byte
//     load per lane gives b_hi and b_lo). Two column tiles are in flight,
//     each with its large and its small products in separate accumulators.
//   * Epilogue in registers per accumulator fragment: + c, leaky-ReLU, the
//     dot with Wr's rows (a per-column (Wr, is_density) float4 picks the
//     density column without a branch); the pe rows are split over the quad,
//     then each row's sums reduce across its quad with two shuffles.
//   * Shared memory at hydrant scale (C 64, hidden 256): 139 KB of split A,
//     70 KB of s tiles, 6 KB of the rest; 128 registers a thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using tf32x3::mma;
using tf32x3::split;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;           // points per warp tile (the mma's M)
constexpr int kColTile = 16;        // columns padded to two 8-wide mma tiles
constexpr float kNegSlope = 0.2f;   // torch.nn.LeakyReLU(0.2)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float lrelu(float x) {
  return x >= 0.f ? x : kNegSlope * x;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

struct Params {
  const float* points;  // (n, 3) world xyz
  const float* pe;      // (n / points_per_ray, pe_dim) harmonic view dirs
  const float* grid;    // (D, H, W, C)
  const float* A;       // (C, j_pad), columns >= hidden + 1 are zero
  const float* c;       // (j_pad)
  const float* Wr;      // (hidden + pe_dim, 3)
  const float* br;      // (3)
  const float* g1;      // (D, H, W) or nullptr
  float* out;           // (n, 4) or (n, 7)
  long long n;
  int points_per_ray;
  int D, H, W;
  int j_pad, hidden, pe_dim;
  float voxel_size;  // extent / D
  float inv_vs;      // D / extent
};

// Shared memory, in 4-byte words. The columns j < n_cols (hidden + 1 padded
// to a multiple of kColTile) are swept; padded columns have A = c = Wr = 0.
//   sB   (n_cols / 8) x (C / 8) blocks of 32 uint4: A in B-fragment order,
//        split: lane 4 g + t of block (nt, ks) holds (hi, hi, lo, lo) of
//        A[8 ks + t][8 nt + g] and A[8 ks + t + 4][8 nt + g]
//   sc   n_cols          c
//   sW   n_cols x 4      (Wr[j, 0:3], j == hidden)
//   sPe  pe_dim x 4      (Wr[hidden + e, 0:3], 0)
//   sbr  4
//   sS   kWarps x kRows x (C + 4)   each warp's s tile (rows padded by 4
//                                   floats: conflict-free fragment loads)
struct Layout {
  int n_cols, sc, sW, sPe, sbr, sS, total;
  __host__ __device__ Layout(int C, int hidden, int pe_dim) {
    n_cols = (hidden + 1 + kColTile - 1) / kColTile * kColTile;
    sc = 2 * C * n_cols;
    sW = sc + n_cols;
    sPe = sW + 4 * n_cols;
    sbr = sPe + 4 * pe_dim;
    sS = sbr + 4;
    total = sS + kWarps * kRows * (C + 4);
  }
};

template <int C, bool NORMALS>
__global__ void __launch_bounds__(kThreads, 1)
fused_decode_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L(C, p.hidden, p.pe_dim);
  const int n_cols = L.n_cols, n_out = p.hidden + 1;
  uint32_t* sB = reinterpret_cast<uint32_t*>(smem);
  float* sc = smem + L.sc;
  float* sW = smem + L.sW;
  float* sPe = smem + L.sPe;
  float* sbr = smem + L.sbr;

  // ---- stage the weights once per block: A split, in fragment order
  constexpr int kKSteps = C / 8;
  tf32x3::stage_split_a<C, kThreads>(sB, p.A, p.j_pad, n_out, n_cols);
  for (int j = threadIdx.x; j < n_cols; j += kThreads) {
    const bool h = j < p.hidden;
    sc[j] = j < n_out ? p.c[j] : 0.f;
    sW[4 * j + 0] = h ? p.Wr[3 * j + 0] : 0.f;
    sW[4 * j + 1] = h ? p.Wr[3 * j + 1] : 0.f;
    sW[4 * j + 2] = h ? p.Wr[3 * j + 2] : 0.f;
    sW[4 * j + 3] = j == p.hidden ? 1.f : 0.f;
  }
  for (int e = threadIdx.x; e < p.pe_dim; e += kThreads) {
    const float* w = p.Wr + 3 * (p.hidden + e);
    sPe[4 * e + 0] = w[0];
    sPe[4 * e + 1] = w[1];
    sPe[4 * e + 2] = w[2];
    sPe[4 * e + 3] = 0.f;
  }
  if (threadIdx.x < 4) sbr[threadIdx.x] = threadIdx.x < 3 ? p.br[threadIdx.x] : 0.f;
  __syncthreads();

  constexpr int kS = C + 4;
  constexpr int kLanesPerPoint = C / 4;
  constexpr int kPointsPerStep = 32 / kLanesPerPoint;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* sS = smem + L.sS + warp * kRows * kS;
  const float4* grid4 = reinterpret_cast<const float4*>(p.grid);
  constexpr int kLanes = NORMALS ? 7 : 4;

  // this block's even share of the tiles, dealt round-robin to its warps
  const long long n_tiles = (p.n + kRows - 1) / kRows;
  const long long first = n_tiles * blockIdx.x / gridDim.x;
  const long long last = n_tiles * (blockIdx.x + 1) / gridDim.x;
  for (long long tile = first + warp; tile < last; tile += kWarps) {
    const long long base = tile * kRows;

    // ---- corners: lane r < 16 takes point base + r
    int cell[8];
    float w[8];
    float gx = 0.f, gy = 0.f, gz = 0.f;
    {
      const long long i = base + (lane & (kRows - 1));
      const bool live = lane < kRows && i < p.n;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        cell[k] = 0;
        w[k] = 0.f;
      }
      if (live) {
        const float ix = p.points[3 * i + 0] / p.voxel_size + 0.5f * (p.W - 1);
        const float iy = p.points[3 * i + 1] / p.voxel_size + 0.5f * (p.H - 1);
        const float iz = p.points[3 * i + 2] / p.voxel_size + 0.5f * (p.D - 1);
        const float x0 = floorf(ix), y0 = floorf(iy), z0 = floorf(iz);
        const float fx = ix - x0, fy = iy - y0, fz = iz - z0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int dx = k & 1, dy = (k >> 1) & 1, dz = k >> 2;
          const float xf = x0 + dx, yf = y0 + dy, zf = z0 + dz;
          if (!(xf >= 0.f && xf <= p.W - 1 && yf >= 0.f && yf <= p.H - 1 &&
                zf >= 0.f && zf <= p.D - 1))
            continue;
          cell[k] = (static_cast<int>(zf) * p.H + static_cast<int>(yf)) * p.W +
                    static_cast<int>(xf);
          const float wx = dx ? fx : 1.f - fx;
          const float wy = dy ? fy : 1.f - fy;
          const float wz = dz ? fz : 1.f - fz;
          w[k] = wx * wy * wz;
          if (NORMALS) {
            // hat derivative: -1 at the lower corner, +1 at the upper, 0
            // when the coordinate sits exactly on the lower corner's plane
            const float ddx = fx > 0.f ? (dx ? 1.f : -1.f) : 0.f;
            const float ddy = fy > 0.f ? (dy ? 1.f : -1.f) : 0.f;
            const float ddz = fz > 0.f ? (dz ? 1.f : -1.f) : 0.f;
            const float gv = __ldg(p.g1 + cell[k]);
            gx = fmaf(wz * wy * ddx, gv, gx);
            gy = fmaf(wz * ddy * wx, gv, gy);
            gz = fmaf(ddz * wy * wx, gv, gz);
          }
        }
      }
    }

    // ---- gather: C/4 lanes per point, one float4 of channels each
    {
      const int q = lane % kLanesPerPoint, sub = lane / kLanesPerPoint;
#pragma unroll
      for (int r0 = 0; r0 < kRows; r0 += kPointsPerStep) {
        const int r = r0 + sub;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        // no branch: a corner outside the grid reads cell 0 with weight 0,
        // so all eight loads can be in flight at once
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int ck = __shfl_sync(kFull, cell[k], r);
          const float wk = __shfl_sync(kFull, w[k], r);
          const float4 v = __ldg(grid4 + ck * (C / 4) + q);
          acc.x = fmaf(wk, v.x, acc.x);
          acc.y = fmaf(wk, v.y, acc.y);
          acc.z = fmaf(wk, v.z, acc.z);
          acc.w = fmaf(wk, v.w, acc.w);
        }
        *reinterpret_cast<float4*>(sS + r * kS + 4 * q) = acc;
      }
    }
    __syncwarp();

    // ---- the s tile's A fragments, split into TF32 hi and lo
    uint32_t ahi[kKSteps][4], alo[kKSteps][4];
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const float* s0 = sS + g * kS + 8 * ks + t;
      split(s0[0], ahi[ks][0], alo[ks][0]);           // row g,     col t
      split(s0[8 * kS], ahi[ks][1], alo[ks][1]);      // row g + 8, col t
      split(s0[4], ahi[ks][2], alo[ks][2]);           // row g,     col t + 4
      split(s0[8 * kS + 4], ahi[ks][3], alo[ks][3]);  // row g + 8, col t + 4
    }
    __syncwarp();  // the next tile may overwrite sS

    // ---- affine on the tensor cores, epilogue per fragment; rows g and g + 8
    float r_a[3] = {0.f, 0.f, 0.f}, r_b[3] = {0.f, 0.f, 0.f};
    float dens_a = 0.f, dens_b = 0.f;
    const uint4* B4 = reinterpret_cast<const uint4*>(sB);
    for (int nt = 0; nt < n_cols / 8; nt += 2) {
      float big[2][4] = {}, small[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 b = B4[((nt + h) * kKSteps + ks) * 32 + lane];  // (hi0, hi1, lo0, lo1)
          mma(small[h], alo[ks], b.x, b.y);
          mma(small[h], ahi[ks], b.z, b.w);
          mma(big[h], ahi[ks], b.x, b.y);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 8 * (nt + h) + 2 * t;
        const float2 cc = *reinterpret_cast<const float2*>(sc + j);
        const float4 w0 = *reinterpret_cast<const float4*>(sW + 4 * j);
        const float4 w1 = *reinterpret_cast<const float4*>(sW + 4 * j + 4);
        const float ha0 = lrelu(big[h][0] + small[h][0] + cc.x);  // row g,     col j
        const float ha1 = lrelu(big[h][1] + small[h][1] + cc.y);  // row g,     col j + 1
        const float hb0 = lrelu(big[h][2] + small[h][2] + cc.x);  // row g + 8, col j
        const float hb1 = lrelu(big[h][3] + small[h][3] + cc.y);  // row g + 8, col j + 1
        r_a[0] = fmaf(ha1, w1.x, fmaf(ha0, w0.x, r_a[0]));
        r_a[1] = fmaf(ha1, w1.y, fmaf(ha0, w0.y, r_a[1]));
        r_a[2] = fmaf(ha1, w1.z, fmaf(ha0, w0.z, r_a[2]));
        dens_a = fmaf(ha1, w1.w, fmaf(ha0, w0.w, dens_a));
        r_b[0] = fmaf(hb1, w1.x, fmaf(hb0, w0.x, r_b[0]));
        r_b[1] = fmaf(hb1, w1.y, fmaf(hb0, w0.y, r_b[1]));
        r_b[2] = fmaf(hb1, w1.z, fmaf(hb0, w0.z, r_b[2]));
        dens_b = fmaf(hb1, w1.w, fmaf(hb0, w0.w, dens_b));
      }
    }

    // ---- the view-direction rows, split over the quad
    const long long ia = base + g, ib = base + g + 8;
    if (ia < p.n) {
      const float* pe = p.pe + (ia / p.points_per_ray) * p.pe_dim;
      for (int e = t; e < p.pe_dim; e += 4) {
        const float v = __ldg(pe + e);
        r_a[0] = fmaf(v, sPe[4 * e + 0], r_a[0]);
        r_a[1] = fmaf(v, sPe[4 * e + 1], r_a[1]);
        r_a[2] = fmaf(v, sPe[4 * e + 2], r_a[2]);
      }
    }
    if (ib < p.n) {
      const float* pe = p.pe + (ib / p.points_per_ray) * p.pe_dim;
      for (int e = t; e < p.pe_dim; e += 4) {
        const float v = __ldg(pe + e);
        r_b[0] = fmaf(v, sPe[4 * e + 0], r_b[0]);
        r_b[1] = fmaf(v, sPe[4 * e + 1], r_b[1]);
        r_b[2] = fmaf(v, sPe[4 * e + 2], r_b[2]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        r_a[o] += __shfl_xor_sync(kFull, r_a[o], off);
        r_b[o] += __shfl_xor_sync(kFull, r_b[o], off);
      }
      dens_a += __shfl_xor_sync(kFull, dens_a, off);
      dens_b += __shfl_xor_sync(kFull, dens_b, off);
    }
    float na[3], nb[3];
    if (NORMALS) {  // the field gradients of rows g and g + 8 from lanes g, g + 8
      const float gs[3] = {gx, gy, gz};
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        na[o] = __shfl_sync(kFull, gs[o], g);
        nb[o] = __shfl_sync(kFull, gs[o], g + 8);
      }
    }

    if (t == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long i = half ? ib : ia;
        if (i >= p.n) continue;
        const float* r = half ? r_b : r_a;
        float* o = p.out + i * kLanes;
        o[0] = half ? dens_b : dens_a;
        o[1] = sigmoid(lrelu(r[0] + sbr[0]));
        o[2] = sigmoid(lrelu(r[1] + sbr[1]));
        o[3] = sigmoid(lrelu(r[2] + sbr[2]));
        if (NORMALS) {
          const float* nn = half ? nb : na;
          o[4] = nn[0] * p.inv_vs;
          o[5] = nn[1] * p.inv_vs;
          o[6] = nn[2] * p.inv_vs;
        }
      }
    }
  }
}

template <int C, bool NORMALS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Layout(C, p.hidden, p.pe_dim).total;
  cudaError_t err = cudaFuncSetAttribute(
      fused_decode_kernel<C, NORMALS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_decode_kernel<C, NORMALS>, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // persistent: at most as many blocks as are resident at once, and no
  // block with fewer than one tile per warp
  const long long n_tiles = (p.n + kRows - 1) / kRows;
  long long blocks = (n_tiles + kWarps - 1) / kWarps;
  if (blocks > static_cast<long long>(sms) * per_sm) blocks = static_cast<long long>(sms) * per_sm;
  fused_decode_kernel<C, NORMALS>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool NORMALS>
int dispatch(const Params& p, int C, void* stream) {
  if (p.n == 0) return cudaSuccess;
  if (p.j_pad < p.hidden + 1) return cudaErrorInvalidValue;
  // 32-bit cell indices: every flat grid offset fits in an int
  if (static_cast<long long>(p.D) * p.H * p.W * C >= (1LL << 31)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return launch<32, NORMALS>(p, s);
    case 64: return launch<64, NORMALS>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

Params make_params(const float* points, const float* pe, const float* grid,
                   const float* A, const float* c, const float* Wr,
                   const float* br, const float* g1, float* out, long long n,
                   int points_per_ray, int D, int H, int W, int j_pad,
                   int hidden, int pe_dim, float voxel_size, float inv_vs) {
  Params p;
  p.points = points; p.pe = pe; p.grid = grid; p.A = A; p.c = c; p.Wr = Wr;
  p.br = br; p.g1 = g1; p.out = out; p.n = n;
  p.points_per_ray = points_per_ray; p.D = D; p.H = H; p.W = W;
  p.j_pad = j_pad; p.hidden = hidden; p.pe_dim = pe_dim;
  p.voxel_size = voxel_size; p.inv_vs = inv_vs;
  return p;
}

}  // namespace

extern "C" int fused_decode_fwd(
    const float* points, const float* pe, const float* grid, const float* A,
    const float* c, const float* Wr, const float* br, float* out, long long n,
    int points_per_ray, int D, int H, int W, int C, int j_pad, int hidden,
    int pe_dim, float voxel_size, float inv_vs, void* stream) {
  const Params p = make_params(points, pe, grid, A, c, Wr, br, nullptr, out, n,
                               points_per_ray, D, H, W, j_pad, hidden, pe_dim,
                               voxel_size, inv_vs);
  return dispatch<false>(p, C, stream);
}

extern "C" int fused_decode_fwd_normals(
    const float* points, const float* pe, const float* grid, const float* A,
    const float* c, const float* Wr, const float* br, const float* g1,
    float* out, long long n, int points_per_ray, int D, int H, int W, int C,
    int j_pad, int hidden, int pe_dim, float voxel_size, float inv_vs,
    void* stream) {
  const Params p = make_params(points, pe, grid, A, c, Wr, br, g1, out, n,
                               points_per_ray, D, H, W, j_pad, hidden, pe_dim,
                               voxel_size, inv_vs);
  return dispatch<true>(p, C, stream);
}
