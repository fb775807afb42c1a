// The fused trilinear sample + render decode at C = 128 (sm_90a): the
// forward (K1, and K3 with the normals' field gradient) and its backward
// (K2), for the reference model's default grid, 32^3 x 128.
//
// Replaces the TPU kernels of holo_diffusion_tpu/ops/pallas/fused_decode.py
// at 128 channels:
//   * `_fwd_kernel` (:122, K1)            -> `decode_c128_fwd`
//   * `_fwd_kernel_normals` (:144, K3)    -> `decode_c128_fwd_normals`
//   * `_bwd_kernel` (:173, K2)            -> `decode_c128_bwd`
// They compute what csrc/fused_decode.cu and csrc/fused_decode_bwd.cu
// compute (see those files for the functions, the sampling semantics and
// the 3 x TF32 split), with their own shared-memory layout: those files
// stage A split into TF32 hi and lo, 2 C (hidden + 1) words, which at C 128
// and hidden 256 is 278,528 bytes for the forward and 270,336 for the
// backward alone, over the 232,448 one block may opt into.
//
// What the design does about it:
//   * A is staged once per block unsplit, in the mma's B-fragment order
//     (`stage_a`: block (nt, ks) of 32 float2, lane 4 g + t holding
//     A[8 ks + t][8 nt + g] and A[8 ks + t + 4][8 nt + g]), 135-139 KB at
//     hidden 256, and each B fragment is split into hi and lo as it is
//     loaded: two cvt.rna and a subtraction a value, for three products.
//     The backward reads A's transposed fragments (d_s = d_pre A^T) from the
//     same copy, conflict-free: lane 4 g + t's word of block (kc, nc) is
//     2 (4 t + g % 4) + g / 4.
//   * The forward holds 8 warps of 16-point tiles (not 16): their s tiles
//     take 67.6 KB, and the s tile's hi and lo fragments take 128 of a
//     thread's up to 255 registers; a warp's 32 lanes gather one point's
//     128 channels as float4 units.
//   * The backward keeps K2's 16 warps, 32-point tiles and its phases, with
//     the s tile unsplit (split where a fragment is read), one d_s buffer
//     (a warp per 16 points by 16 channels takes every column step: 16
//     warps, 16 such units), and dA's partial sums in mma accumulators
//     across the block's tiles (68 registers a thread at hidden <= 271).
// Shared memory at hidden 256, pe_dim 27: forward 212,736 bytes, backward
// 216,304 (`ops/fused_decode.py` `fwd_smem_bytes`, `bwd_smem_bytes`).
// The backward adds with float atomics, so it is not bit-reproducible.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

using tf32x3::mma;
using tf32x3::split;

// The channel count: 128. kernel_sweep.py's `design` section builds the
// same design at 64 (-DDECODE_C128_CHANNELS=64) to time it against the C-64
// kernels; the port builds and launches it at 128 alone.
#ifndef DECODE_C128_CHANNELS
#define DECODE_C128_CHANNELS 128
#endif
constexpr int C = DECODE_C128_CHANNELS;
constexpr int kKSteps = C / 8;      // k-steps of the affine
constexpr int kS = C + 4;           // an s or d_s row, padded by 4 floats
constexpr int kUnits = 32;          // vector units of a grid cell: a warp's lanes
constexpr int kVec = C / kUnits;    // floats of a unit: 4 at C 128
constexpr int kRows = 16;           // points of an mma row tile
constexpr float kNegSlope = 0.2f;   // torch.nn.LeakyReLU(0.2)
constexpr unsigned kFull = 0xffffffffu;
static_assert(C == 128 || C == 64, "a warp gathers one point's channels as float4 or float2 units");
using Vec = typename std::conditional<kVec == 4, float4, float2>::type;

__device__ __forceinline__ float4 vzero(float4) { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ float2 vzero(float2) { return make_float2(0.f, 0.f); }

// acc += w v, element by element
__device__ __forceinline__ void vfma(float w, const float4& v, float4& acc) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}
__device__ __forceinline__ void vfma(float w, const float2& v, float2& acc) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
}

__device__ __forceinline__ float lrelu(float x) {
  return x >= 0.f ? x : kNegSlope * x;
}

__device__ __forceinline__ float dlrelu(float x) {
  return x >= 0.f ? 1.f : kNegSlope;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Stage the columns j < n_cols (a multiple of 8) of the (C, j_pad) matrix A
// (columns >= n_out read as 0) unsplit in B-fragment order: block
// (nt, ks) = nt * kKSteps + ks of 32 float2, lane 4 g + t holding
// (A[8 ks + t][8 nt + g], A[8 ks + t + 4][8 nt + g]). No barrier.
template <int THREADS>
__device__ __forceinline__ void stage_a(float2* sA, const float* __restrict__ A, int j_pad,
                                        int n_out, int n_cols) {
  const int n_slots = n_cols / 8 * kKSteps * 32;
#pragma unroll 4
  for (int s = threadIdx.x; s < n_slots; s += THREADS) {
    const int blk = s >> 5, ln = s & 31;
    const int j = 8 * (blk / kKSteps) + (ln >> 2), k = 8 * (blk % kKSteps) + (ln & 3);
    const bool live = j < n_out;
    sA[s] = make_float2(live ? __ldg(A + k * j_pad + j) : 0.f,
                        live ? __ldg(A + (k + 4) * j_pad + j) : 0.f);
  }
}

// the 8 corners of point i (cell 0 with weight 0 for a corner outside the
// grid, and `inside` false) and, with NORMALS, the gradient of the scalar
// field g1 at the point; K1/K3's arithmetic
template <bool NORMALS>
__device__ __forceinline__ void corners(const float* __restrict__ points, long long i, float voxel_size,
                                        int D, int H, int W, const float* __restrict__ g1, int (&cell)[8],
                                        float (&w)[8], bool (&inside)[8], float& gx, float& gy, float& gz) {
  const float ix = points[3 * i + 0] / voxel_size + 0.5f * (W - 1);
  const float iy = points[3 * i + 1] / voxel_size + 0.5f * (H - 1);
  const float iz = points[3 * i + 2] / voxel_size + 0.5f * (D - 1);
  const float x0 = floorf(ix), y0 = floorf(iy), z0 = floorf(iz);
  const float fx = ix - x0, fy = iy - y0, fz = iz - z0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k & 1, dy = (k >> 1) & 1, dz = k >> 2;
    const float xf = x0 + dx, yf = y0 + dy, zf = z0 + dz;
    inside[k] = xf >= 0.f && xf <= W - 1 && yf >= 0.f && yf <= H - 1 && zf >= 0.f && zf <= D - 1;
    if (!inside[k]) continue;
    cell[k] = (static_cast<int>(zf) * H + static_cast<int>(yf)) * W + static_cast<int>(xf);
    const float wx = dx ? fx : 1.f - fx;
    const float wy = dy ? fy : 1.f - fy;
    const float wz = dz ? fz : 1.f - fz;
    w[k] = wx * wy * wz;
    if (NORMALS) {
      // hat derivative: -1 at the lower corner, +1 at the upper, 0 when the
      // coordinate sits exactly on the lower corner's plane
      const float ddx = fx > 0.f ? (dx ? 1.f : -1.f) : 0.f;
      const float ddy = fy > 0.f ? (dy ? 1.f : -1.f) : 0.f;
      const float ddz = fz > 0.f ? (dz ? 1.f : -1.f) : 0.f;
      const float gv = __ldg(g1 + cell[k]);
      gx = fmaf(wz * wy * ddx, gv, gx);
      gy = fmaf(wz * ddy * wx, gv, gy);
      gz = fmaf(ddz * wy * wx, gv, gz);
    }
  }
}

// a warp's 32 lanes gather point r's C channels (the corners held by
// lane `src`) into row r of the s tile, one unit a lane
__device__ __forceinline__ void gather_row(const Vec* __restrict__ gridv, const int (&cell)[8],
                                           const float (&w)[8], int src, float* s_row, int lane) {
  Vec acc = vzero(Vec{});
  // no branch: a corner outside the grid reads cell 0 with weight 0
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ck = __shfl_sync(kFull, cell[k], src);
    const float wk = __shfl_sync(kFull, w[k], src);
    vfma(wk, __ldg(gridv + ck * kUnits + lane), acc);
  }
  *reinterpret_cast<Vec*>(s_row + kVec * lane) = acc;
}

// ======================= forward (K1, K3) =======================

constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kColTile = 16;  // columns padded to two 8-wide mma tiles

struct FwdParams {
  const float* points;  // (n, 3) world xyz
  const float* pe;      // (n / points_per_ray, pe_dim)
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

// Shared memory, in 4-byte words; columns j < n_cols (hidden + 1 padded to
// kColTile) are swept, padded columns have A = c = Wr = 0.
//   sA   C x n_cols        A unsplit, in B-fragment order (`stage_a`)
//   sc   n_cols            c
//   sW   n_cols x 4        (Wr[j, 0:3], j == hidden)
//   sPe  pe_dim x 4        (Wr[hidden + e, 0:3], 0)
//   sbr  4
//   sS   kFwdWarps x kRows x kS   each warp's s tile
struct FwdLayout {
  int n_cols, sc, sW, sPe, sbr, sS, total;
  __host__ __device__ FwdLayout(int hidden, int pe_dim) {
    n_cols = (hidden + 1 + kColTile - 1) / kColTile * kColTile;
    sc = C * n_cols;
    sW = sc + n_cols;
    sPe = sW + 4 * n_cols;
    sbr = sPe + 4 * pe_dim;
    sS = sbr + 4;
    total = sS + kFwdWarps * kRows * kS;
  }
};

template <bool NORMALS>
__global__ void __launch_bounds__(kFwdThreads, 1)
decode_c128_fwd_kernel(const FwdParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const FwdLayout L(p.hidden, p.pe_dim);
  const int n_cols = L.n_cols, n_out = p.hidden + 1;
  const float2* sA = reinterpret_cast<const float2*>(smem);
  float* sc = smem + L.sc;
  float* sW = smem + L.sW;
  float* sPe = smem + L.sPe;
  float* sbr = smem + L.sbr;

  stage_a<kFwdThreads>(reinterpret_cast<float2*>(smem), p.A, p.j_pad, n_out, n_cols);
  for (int j = threadIdx.x; j < n_cols; j += kFwdThreads) {
    const bool h = j < p.hidden;
    sc[j] = j < n_out ? p.c[j] : 0.f;
    sW[4 * j + 0] = h ? p.Wr[3 * j + 0] : 0.f;
    sW[4 * j + 1] = h ? p.Wr[3 * j + 1] : 0.f;
    sW[4 * j + 2] = h ? p.Wr[3 * j + 2] : 0.f;
    sW[4 * j + 3] = j == p.hidden ? 1.f : 0.f;
  }
  for (int e = threadIdx.x; e < p.pe_dim; e += kFwdThreads) {
    const float* w = p.Wr + 3 * (p.hidden + e);
    sPe[4 * e + 0] = w[0];
    sPe[4 * e + 1] = w[1];
    sPe[4 * e + 2] = w[2];
    sPe[4 * e + 3] = 0.f;
  }
  if (threadIdx.x < 4) sbr[threadIdx.x] = threadIdx.x < 3 ? p.br[threadIdx.x] : 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* sS = smem + L.sS + warp * kRows * kS;
  const Vec* gridv = reinterpret_cast<const Vec*>(p.grid);
  constexpr int kLanes = NORMALS ? 7 : 4;

  // this block's even share of the tiles, dealt round-robin to its warps
  const long long n_tiles = (p.n + kRows - 1) / kRows;
  const long long first = n_tiles * blockIdx.x / gridDim.x;
  const long long last = n_tiles * (blockIdx.x + 1) / gridDim.x;
  for (long long tile = first + warp; tile < last; tile += kFwdWarps) {
    const long long base = tile * kRows;

    // ---- corners: lane r < 16 takes point base + r; then the gather
    float gx = 0.f, gy = 0.f, gz = 0.f;
    {
      int cell[8];
      float w[8];
      bool inside[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        cell[k] = 0;
        w[k] = 0.f;
      }
      const long long i = base + (lane & (kRows - 1));
      if (lane < kRows && i < p.n)
        corners<NORMALS>(p.points, i, p.voxel_size, p.D, p.H, p.W, p.g1, cell, w, inside, gx, gy, gz);
#pragma unroll 4
      for (int r = 0; r < kRows; ++r) gather_row(gridv, cell, w, r, sS + r * kS, lane);
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
    for (int nt = 0; nt < n_cols / 8; nt += 2) {
      float big[2][4] = {}, small[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 b = sA[((nt + h) * kKSteps + ks) * 32 + lane];
          uint32_t bh0, bl0, bh1, bl1;
          split(b.x, bh0, bl0);
          split(b.y, bh1, bl1);
          mma(small[h], alo[ks], bh0, bh1);
          mma(small[h], ahi[ks], bl0, bl1);
          mma(big[h], ahi[ks], bh0, bh1);
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

template <bool NORMALS>
int launch_fwd(const FwdParams& p, int C_in, void* stream) {
  if (p.n == 0) return cudaSuccess;
  if (C_in != C || p.j_pad < p.hidden + 1) return cudaErrorInvalidValue;
  // 32-bit cell indices: every flat grid offset fits in an int
  if (static_cast<long long>(p.D) * p.H * p.W * C >= (1LL << 31)) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * FwdLayout(p.hidden, p.pe_dim).total;
  cudaError_t err = cudaFuncSetAttribute(decode_c128_fwd_kernel<NORMALS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_c128_fwd_kernel<NORMALS>,
                                                           kFwdThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // persistent: at most as many blocks as are resident at once, and no
  // block with fewer than one tile per warp
  const long long n_tiles = (p.n + kRows - 1) / kRows;
  long long blocks = (n_tiles + kFwdWarps - 1) / kFwdWarps;
  if (blocks > static_cast<long long>(sms) * per_sm) blocks = static_cast<long long>(sms) * per_sm;
  decode_c128_fwd_kernel<NORMALS><<<static_cast<unsigned>(blocks), kFwdThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

FwdParams make_fwd_params(const float* points, const float* pe, const float* grid, const float* A,
                          const float* c, const float* Wr, const float* br, const float* g1, float* out,
                          long long n, int points_per_ray, int D, int H, int W, int j_pad, int hidden,
                          int pe_dim, float voxel_size, float inv_vs) {
  FwdParams p;
  p.points = points; p.pe = pe; p.grid = grid; p.A = A; p.c = c; p.Wr = Wr;
  p.br = br; p.g1 = g1; p.out = out; p.n = n;
  p.points_per_ray = points_per_ray; p.D = D; p.H = H; p.W = W;
  p.j_pad = j_pad; p.hidden = hidden; p.pe_dim = pe_dim;
  p.voxel_size = voxel_size; p.inv_vs = inv_vs;
  return p;
}

// ======================= backward (K2) =======================

constexpr int kBwdWarps = 16;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kTile = 32;           // points per tile: two 16-row mma tiles
constexpr int kMT = kTile / kRows;
static_assert(kTile == 2 * kBwdWarps, "the sample and the radiance head take two points a warp");
constexpr int kDsTiles = C * kMT / (8 * kBwdWarps);  // d_s: 8-channel tiles a warp, 2 at C 128
static_assert(kDsTiles * 8 * kBwdWarps == C * kMT && kDsTiles >= 1, "d_s: a warp per row tile and 8 kDsTiles channels");
constexpr int kMaxCols = 272;       // hidden + 1 padded to 8: the dA accumulators
constexpr int kMC = C / 16;         // dA: 16-channel row tiles
constexpr int kGroups = kBwdWarps / kMC;
constexpr int kDaTiles = (kMaxCols / 8 + kGroups - 1) / kGroups;

struct BwdParams {
  const float* points;  // (n, 3) world xyz
  const float* pe;      // (n / points_per_ray, pe_dim)
  const float* g;       // (n, 4) cotangent [d_density | d_rgb]
  const float* grid;    // (D, H, W, C)
  const float* A;       // (C, j_pad), columns >= hidden + 1 are zero
  const float* c;       // (j_pad)
  const float* Wr;      // (hidden + pe_dim, 3)
  const float* br;      // (3)
  float* d_grid;        // (D, H, W, C), zeroed
  float* dA;            // (C, j_pad), zeroed
  float* dc;            // (j_pad), zeroed
  float* dWr;           // (hidden + pe_dim + 1, 3), zeroed; last row is dbr
  long long n;
  int points_per_ray;
  int D, H, W;
  int j_pad, hidden, pe_dim;
  float voxel_size;  // extent / D
};

// Shared memory, in 4-byte words; columns j < n_cols (hidden + 1 padded to
// 8) are swept, padded columns have A = c = 0.
//   sA    C x n_cols          A unsplit, in B-fragment order (`stage_a`)
//   sc    n_cols              c
//   sWr   3 (n_rin + 1), padded to 4: Wr rows, then br
//   sS    kTile x kS          the s tile
//   sPre  kTile x (n_cols + 4)  pre, then d_pre
//   sDs   kTile x kS          d_s
//   sw, scell  2 x kTile x 8  corner weights and cells (-1 outside), by
//                             tile parity
//   sg, sdrp   kTile x 4      the cotangent and d_rpre
//   sPe   kTile x pe_dim, padded to 4: each point's view-direction row
struct BwdLayout {
  int n_cols, kPS, sc, sWr, sS, sPre, sDs, sw, scell, sg, sdrp, sPe, total;
  __host__ __device__ BwdLayout(int hidden, int pe_dim) {
    n_cols = (hidden + 1 + 7) / 8 * 8;
    kPS = n_cols + 4;
    sc = C * n_cols;
    sWr = sc + n_cols;
    sS = sWr + (3 * (hidden + pe_dim + 1) + 3) / 4 * 4;
    sPre = sS + kTile * kS;
    sDs = sPre + kTile * kPS;
    sw = sDs + kTile * kS;
    scell = sw + 2 * 8 * kTile;
    sg = scell + 2 * 8 * kTile;
    sdrp = sg + 4 * kTile;
    sPe = sdrp + 4 * kTile;
    total = sPe + (kTile * pe_dim + 3) / 4 * 4;
  }
};

__global__ void __launch_bounds__(kBwdThreads, 1)
decode_c128_bwd_kernel(const BwdParams p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const BwdLayout L(p.hidden, p.pe_dim);
  const int n_cols = L.n_cols, kPS = L.kPS, n_nt = L.n_cols / 8;
  const int hidden = p.hidden, pe_dim = p.pe_dim, n_rin = hidden + pe_dim, n_out = hidden + 1;
  const float2* sA = reinterpret_cast<const float2*>(sm);
  const float* sAf = sm;
  float* sc = sm + L.sc;
  float* sWr = sm + L.sWr;  // rows 0..n_rin-1 = Wr, row n_rin = br
  float* sS = sm + L.sS;
  float* sPre = sm + L.sPre;
  float* sDs = sm + L.sDs;
  float* sg = sm + L.sg;
  float* sdrp = sm + L.sdrp;
  float* sPe = sm + L.sPe;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  stage_a<kBwdThreads>(reinterpret_cast<float2*>(sm), p.A, p.j_pad, n_out, n_cols);
  for (int j = tid; j < n_cols; j += kBwdThreads) sc[j] = j < n_out ? p.c[j] : 0.f;
  for (int k = tid; k < 3 * (n_rin + 1); k += kBwdThreads)
    sWr[k] = k < 3 * n_rin ? p.Wr[k] : p.br[k - 3 * n_rin];
  __syncthreads();

  // this thread's share of the block's partial sums, kept across tiles:
  // dA (mma accumulators: channels 16 mc + g (+8) by column tiles grp,
  // grp + kGroups, ...); dc and dWr's hidden rows of column tid; or dWr's
  // pe row tid - n_cols (dbr at tid - n_cols == pe_dim)
  const int mc = warp % kMC, grp = warp / kMC;
  float dacc[kDaTiles][4];
#pragma unroll
  for (int q = 0; q < kDaTiles; ++q) dacc[q][0] = dacc[q][1] = dacc[q][2] = dacc[q][3] = 0.f;
  float dc_acc = 0.f, dwr[3] = {0.f, 0.f, 0.f};

  constexpr int kRuns = kBwdThreads / (8 * kUnits);  // runs of points per tile in the scatter
  constexpr int kRun = kTile / kRuns;
  const Vec* gridv = reinterpret_cast<const Vec*>(p.grid);

  const long long n_tiles = (p.n + kTile - 1) / kTile;
  int parity = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, parity ^= 1) {
    const long long base = tile * kTile;
    float* sw = sm + L.sw + parity * 8 * kTile;
    int* scell = reinterpret_cast<int*>(sm + L.scell) + parity * 8 * kTile;

    // ---- 1. each point's pe row (every thread); warp w's lanes 0, 1 take
    // the corners of points 2 w, 2 w + 1, then the warp gathers both
    for (int e = tid; e < kTile * pe_dim; e += kBwdThreads) {
      const long long i = base + e / pe_dim;
      sPe[e] = i < p.n ? __ldg(p.pe + (i / p.points_per_ray) * pe_dim + e % pe_dim) : 0.f;
    }
    {
      int cell[8];
      float w[8];
      bool inside[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        cell[k] = 0;
        w[k] = 0.f;
        inside[k] = false;
      }
      if (lane < 2) {
        const int r = 2 * warp + lane;
        const long long i = base + r;
        const bool live = i < p.n;
        float gx = 0.f, gy = 0.f, gz = 0.f;
        if (live) corners<false>(p.points, i, p.voxel_size, p.D, p.H, p.W, nullptr, cell, w, inside, gx, gy, gz);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          sw[8 * r + k] = w[k];
          scell[8 * r + k] = inside[k] ? cell[k] : -1;
        }
#pragma unroll
        for (int l = 0; l < 4; ++l) sg[4 * r + l] = live ? p.g[4 * i + l] : 0.f;
      }
#pragma unroll
      for (int sub = 0; sub < 2; ++sub) gather_row(gridv, cell, w, sub, sS + (2 * warp + sub) * kS, lane);
    }
    __syncthreads();

    // ---- 2. pre = s A + c: warp w takes row tile w % kMT and every
    // (kBwdWarps / kMT)-th column tile, kPass at a time sharing each s
    // fragment, with K1/K3's sequence of products per element
    {
      constexpr int kStride = kBwdWarps / kMT;
      constexpr int kPass = 2;
      const int mt = warp % kMT;
      for (int p0 = warp / kMT; p0 < n_nt; p0 += kPass * kStride) {
        float big[kPass][4] = {}, small[kPass][4] = {};
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          // rows g, g + 8 by columns t, t + 4
          const float* s0 = sS + (16 * mt + g) * kS + 8 * ks + t;
          uint32_t ahi[4], alo[4];
          split(s0[0], ahi[0], alo[0]);
          split(s0[8 * kS], ahi[1], alo[1]);
          split(s0[4], ahi[2], alo[2]);
          split(s0[8 * kS + 4], ahi[3], alo[3]);
#pragma unroll
          for (int h = 0; h < kPass; ++h) {
            const int nt = p0 + h * kStride;
            if (nt < n_nt) {
              const float2 b = sA[(nt * kKSteps + ks) * 32 + lane];
              uint32_t bh0, bl0, bh1, bl1;
              split(b.x, bh0, bl0);
              split(b.y, bh1, bl1);
              mma(small[h], alo, bh0, bh1);
              mma(small[h], ahi, bl0, bl1);
              mma(big[h], ahi, bh0, bh1);
            }
          }
        }
#pragma unroll
        for (int h = 0; h < kPass; ++h) {
          const int nt = p0 + h * kStride;
          if (nt < n_nt) {
            const int j = 8 * nt + 2 * t;
            const float2 cc = *reinterpret_cast<const float2*>(sc + j);
            float* o = sPre + (16 * mt + g) * kPS + j;
            *reinterpret_cast<float2*>(o) =
                make_float2(big[h][0] + small[h][0] + cc.x, big[h][1] + small[h][1] + cc.y);
            *reinterpret_cast<float2*>(o + 8 * kPS) =
                make_float2(big[h][2] + small[h][2] + cc.x, big[h][3] + small[h][3] + cc.y);
          }
        }
      }
    }
    __syncthreads();

    // ---- 3. radiance head and d_rpre, one warp per two points
    {
      float r[2][3] = {};
      for (int j = lane; j < n_rin; j += 32) {
        const float w0 = sWr[3 * j + 0], w1 = sWr[3 * j + 1], w2 = sWr[3 * j + 2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pt = warp + h * kBwdWarps;
          const float v = j < hidden ? lrelu(sPre[pt * kPS + j]) : sPe[pt * pe_dim + j - hidden];
          r[h][0] = fmaf(v, w0, r[h][0]);
          r[h][1] = fmaf(v, w1, r[h][1]);
          r[h][2] = fmaf(v, w2, r[h][2]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int o = 0; o < 3; ++o) r[h][o] += __shfl_xor_sync(kFull, r[h][o], off);
      if (lane < 3) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pt = warp + h * kBwdWarps;
          const float rp = (lane == 0 ? r[h][0] : lane == 1 ? r[h][1] : r[h][2]) + sWr[3 * n_rin + lane];
          const float rgb = 1.f / (1.f + expf(-lrelu(rp)));
          sdrp[4 * pt + lane] = sg[4 * pt + 1 + lane] * rgb * (1.f - rgb) * dlrelu(rp);
        }
      }
    }
    __syncthreads();

    // ---- 4. a thread per column j: dWr[j] += h_j d_rpre, d_pre in place of
    // pre, dc[j] += d_pre; a thread per pe row e: dWr[hidden + e] (and dbr)
    if (tid < n_cols) {
      const int j = tid;
      const bool h = j < hidden;
      const float w0 = h ? sWr[3 * j + 0] : 0.f, w1 = h ? sWr[3 * j + 1] : 0.f,
                  w2 = h ? sWr[3 * j + 2] : 0.f;
#pragma unroll 4
      for (int pt = 0; pt < kTile; ++pt) {
        const float pre = sPre[pt * kPS + j];
        const float d0 = sdrp[4 * pt + 0], d1 = sdrp[4 * pt + 1], d2 = sdrp[4 * pt + 2];
        const float hv = lrelu(pre);
        dwr[0] = fmaf(hv, d0, dwr[0]);
        dwr[1] = fmaf(hv, d1, dwr[1]);
        dwr[2] = fmaf(hv, d2, dwr[2]);
        const float dh = h ? d0 * w0 + d1 * w1 + d2 * w2 : (j == hidden ? sg[4 * pt] : 0.f);
        const float dp = dh * dlrelu(pre);
        sPre[pt * kPS + j] = dp;
        dc_acc += dp;
      }
    } else if (tid < n_cols + pe_dim + 1) {
      const int e = tid - n_cols;
#pragma unroll 4
      for (int pt = 0; pt < kTile; ++pt) {
        // a missing point of the last tile has d_rpre 0
        const float v = e < pe_dim ? sPe[pt * pe_dim + e] : 1.f;
        dwr[0] = fmaf(v, sdrp[4 * pt + 0], dwr[0]);
        dwr[1] = fmaf(v, sdrp[4 * pt + 1], dwr[1]);
        dwr[2] = fmaf(v, sdrp[4 * pt + 2], dwr[2]);
      }
    }
    __syncthreads();

    // ---- 5a. dA += s^T d_pre: rows are channels, the k dimension points
#pragma unroll
    for (int kp = 0; kp < kTile / 8; ++kp) {
      // channels g, g + 8 by points t, t + 4
      const int o0 = (8 * kp + t) * kS + 16 * mc + g;
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) split(sS[o0 + (r & 1) * 8 + (r >> 1) * 4 * kS], ahi[r], alo[r]);
#pragma unroll
      for (int q = 0; q < kDaTiles; ++q) {
        const int nt = grp + q * kGroups;
        if (nt < n_nt) {
          const float* d0 = sPre + (8 * kp + t) * kPS + 8 * nt + g;
          uint32_t bh0, bl0, bh1, bl1;
          split(d0[0], bh0, bl0);        // point t,     column g
          split(d0[4 * kPS], bh1, bl1);  // point t + 4, column g
          mma(dacc[q], alo, bh0, bh1);
          mma(dacc[q], ahi, bl0, bl1);
          mma(dacc[q], ahi, bh0, bh1);
        }
      }
    }

    // ---- 5b. d_s = d_pre A^T: warp w takes row tile w % kMT and the
    // kDsTiles channel tiles from kDsTiles (w / kMT) on (16 channels at C
    // 128) over every column step; A's transposed fragments
    // come from the staged copy (word 2 (4 t + g % 4) + g / 4 of block
    // (kc, nc), and 32 words on for columns t + 4)
    {
      const int mt = warp % kMT, np = warp / kMT;
      float acc[kDsTiles][2][4] = {};  // [channel tile][column-step parity]
      const float* a_row = sPre + (16 * mt + g) * kPS + t;
      const float* b_lane = sAf + 2 * (4 * t + (g & 3)) + (g >> 2);
      auto step = [&](int kc, int par) {
        const float* a0 = a_row + 8 * kc;
        uint32_t ahi[4], alo[4];
        split(a0[0], ahi[0], alo[0]);
        split(a0[8 * kPS], ahi[1], alo[1]);
        split(a0[4], ahi[2], alo[2]);
        split(a0[8 * kPS + 4], ahi[3], alo[3]);
#pragma unroll
        for (int h = 0; h < kDsTiles; ++h) {
          const float* b = b_lane + (kc * kKSteps + kDsTiles * np + h) * 64;
          uint32_t bh0, bl0, bh1, bl1;
          split(b[0], bh0, bl0);
          split(b[32], bh1, bl1);
          mma(acc[h][par], alo, bh0, bh1);
          mma(acc[h][par], ahi, bl0, bl1);
          mma(acc[h][par], ahi, bh0, bh1);
        }
      };
      for (int kc = 0; kc < n_nt; kc += 2) {
        step(kc, 0);
        if (kc + 1 < n_nt) step(kc + 1, 1);
      }
#pragma unroll
      for (int h = 0; h < kDsTiles; ++h) {
        float* o = sDs + (16 * mt + g) * kS + 8 * (kDsTiles * np + h) + 2 * t;
        *reinterpret_cast<float2*>(o) = make_float2(acc[h][0][0] + acc[h][1][0], acc[h][0][1] + acc[h][1][1]);
        *reinterpret_cast<float2*>(o + 8 * kS) =
            make_float2(acc[h][0][2] + acc[h][1][2], acc[h][0][3] + acc[h][1][3]);
      }
    }
    __syncthreads();

    // ---- 6. scatter d_s into the grid: a thread per (run of kRun points,
    // corner, unit) adds one atomic per change of its corner's cell
    {
      const int q = tid % kUnits, k = (tid / kUnits) % 8, run = tid / (8 * kUnits);
      int cur = -1;
      Vec acc = vzero(Vec{});
#pragma unroll 4
      for (int pt = run * kRun; pt < (run + 1) * kRun; ++pt) {
        const int cell = scell[8 * pt + k];
        if (cell != cur) {
          if (cur >= 0) atomicAdd(reinterpret_cast<Vec*>(p.d_grid) + cur * kUnits + q, acc);
          cur = cell;
          acc = vzero(Vec{});
        }
        const float wk = sw[8 * pt + k];
        vfma(wk, *reinterpret_cast<const Vec*>(sDs + pt * kS + kVec * q), acc);
      }
      if (cur >= 0) atomicAdd(reinterpret_cast<Vec*>(p.d_grid) + cur * kUnits + q, acc);
    }
    // no barrier: the next tile writes the other parity's corners, and its
    // d_s only after three more barriers
  }

  // ---- the block's partial sums, once per entry
#pragma unroll
  for (int q = 0; q < kDaTiles; ++q) {
    const int nt = grp + q * kGroups;
    if (nt < n_nt) {
      const int row = 16 * mc + g, col = 8 * nt + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + (e >= 2 ? 8 : 0), cl = col + (e & 1);
        if (cl < n_out) atomicAdd(p.dA + r * p.j_pad + cl, dacc[q][e]);
      }
    }
  }
  if (tid < n_out) atomicAdd(p.dc + tid, dc_acc);
  const int wr_row = tid < hidden ? tid : (tid >= n_cols && tid < n_cols + pe_dim + 1 ? hidden + tid - n_cols : -1);
  if (wr_row >= 0) {
#pragma unroll
    for (int o = 0; o < 3; ++o) atomicAdd(p.dWr + 3 * wr_row + o, dwr[o]);
  }
}

int launch_bwd(const BwdParams& p, int C_in, cudaStream_t stream) {
  if (p.n == 0) return cudaSuccess;
  if (C_in != C || p.j_pad % 4 != 0 || p.j_pad < p.hidden + 1) return cudaErrorInvalidValue;
  // 32-bit cell indices: every flat grid offset fits in an int
  if (static_cast<long long>(p.D) * p.H * p.W * C >= (1LL << 31)) return cudaErrorInvalidValue;
  const BwdLayout L(p.hidden, p.pe_dim);
  // the dA accumulators cover kMaxCols columns; a thread each for the
  // columns, the pe rows and dbr
  if (L.n_cols > kMaxCols || L.n_cols + p.pe_dim + 1 > kBwdThreads) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * static_cast<size_t>(L.total);
  cudaError_t err = cudaFuncSetAttribute(decode_c128_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_c128_bwd_kernel, kBwdThreads,
                                                           smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (p.n + kTile - 1) / kTile;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const long long blocks = tiles < resident ? tiles : resident;
  decode_c128_bwd_kernel<<<static_cast<unsigned>(blocks), kBwdThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int decode_c128_fwd(
    const float* points, const float* pe, const float* grid, const float* A,
    const float* c, const float* Wr, const float* br, float* out, long long n,
    int points_per_ray, int D, int H, int W, int C_in, int j_pad, int hidden,
    int pe_dim, float voxel_size, float inv_vs, void* stream) {
  const FwdParams p = make_fwd_params(points, pe, grid, A, c, Wr, br, nullptr, out, n, points_per_ray,
                                      D, H, W, j_pad, hidden, pe_dim, voxel_size, inv_vs);
  return launch_fwd<false>(p, C_in, stream);
}

extern "C" int decode_c128_fwd_normals(
    const float* points, const float* pe, const float* grid, const float* A,
    const float* c, const float* Wr, const float* br, const float* g1,
    float* out, long long n, int points_per_ray, int D, int H, int W, int C_in,
    int j_pad, int hidden, int pe_dim, float voxel_size, float inv_vs,
    void* stream) {
  const FwdParams p = make_fwd_params(points, pe, grid, A, c, Wr, br, g1, out, n, points_per_ray,
                                      D, H, W, j_pad, hidden, pe_dim, voxel_size, inv_vs);
  return launch_fwd<true>(p, C_in, stream);
}

extern "C" int decode_c128_bwd(
    const float* points, const float* pe, const float* g, const float* grid,
    const float* A, const float* c, const float* Wr, const float* br,
    float* d_grid, float* dA, float* dc, float* dWr, long long n,
    int points_per_ray, int D, int H, int W, int C_in, int j_pad, int hidden,
    int pe_dim, float voxel_size, void* stream) {
  BwdParams p;
  p.points = points; p.pe = pe; p.g = g; p.grid = grid; p.A = A; p.c = c;
  p.Wr = Wr; p.br = br; p.d_grid = d_grid; p.dA = dA; p.dc = dc; p.dWr = dWr;
  p.n = n; p.points_per_ray = points_per_ray; p.D = D; p.H = H; p.W = W;
  p.j_pad = j_pad; p.hidden = hidden; p.pe_dim = pe_dim;
  p.voxel_size = voxel_size;
  return launch_bwd(p, C_in, static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory, in bytes, that the last launch of kernel
// `which` (0 K1, 1 K3, 2 K2) set as its maximum (the bytes it asked for);
// -1 if the attribute cannot be read.
extern "C" int decode_c128_smem_bytes(int which) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      which == 0 ? cudaFuncGetAttributes(&attr, decode_c128_fwd_kernel<false>)
      : which == 1 ? cudaFuncGetAttributes(&attr, decode_c128_fwd_kernel<true>)
                   : cudaFuncGetAttributes(&attr, decode_c128_bwd_kernel);
  return err == cudaSuccess ? attr.maxDynamicSharedSizeBytes : -1;
}
