// Backward of the fused trilinear sample + render decode (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` (K2) of
// holo_diffusion_tpu/ops/pallas/fused_decode.py:173 -> entry point
// `fused_decode_bwd`. Given the cotangent g = [d_density | d_rgb] (n, 4) of
// the forward of csrc/fused_decode.cu (the normals lanes carry no gradient),
// it accumulates the five parameter cotangents d_grid, dA, dc, dWr, dbr. It
// computes what the TPU kernel computes, not its Kronecker/one-hot MXU form.
// Per point, with s the trilinear sample of the (D, H, W, C) grid:
//   pre    = s @ A + c,  h = lrelu(pre),  rin = [h[:hidden] | pe]
//   rpre   = rin @ Wr + br,  rgb = sigmoid(lrelu(rpre))
//   d_rpre = d_rgb * rgb * (1 - rgb) * lrelu'(rpre)
//   dWr   += rin (x) d_rpre,  dbr += d_rpre,  d_rin = d_rpre @ Wr^T
//   d_pre  = [d_rin[:hidden] | d_density | 0...] * lrelu'(pre)
//   dA    += s (x) d_pre,  dc += d_pre,  d_s = d_pre @ A^T
//   d_grid[corner k] += w_k * d_s      (in-grid corners only, no clamping)
// lrelu'(x) is 1 for x >= 0 and 0.2 below, as the TPU kernel's `_dlrelu`
// (slope 1 at exactly 0, where torch's leaky_relu backward takes 0.2).
//
// What bounds it on the H100: arithmetic. Per point the recomputed affine,
// dA and d_s are 2 * C * (hidden + 1) FLOP each (3 x 32.9 k at hydrant),
// plus the sample, the radiance head and the scatter: about 106 kFLOP, so a
// hydrant training step's fine pass (393,216 points) is 41.6 GFLOP, 0.62 ms
// at the 67 TFLOP/s float32 peak; with the three products on the tensor
// cores in the float32-accurate 3 x TF32 split (3 x 38.8 GFLOP at 495
// TFLOP/s, the rest at 67) about 0.28 ms. The bytes are few: the grid
// (1 MiB) and d_grid stay in L2, each point reads 12 + 16 B.
//
// What the design does about it: one persistent 512-thread block per SM
// stages A once, split into TF32 hi/lo in the mma's B-fragment order (K1's
// `stage_split_a`, tf32_mma.cuh), and walks tiles of kTile points:
//   1. corners and the sample: a few lanes of a warp compute the points'
//      corners (K1's arithmetic) and C / 4 lanes per point gather float4
//      units into the s tile (no branch: a corner outside reads cell 0 with
//      weight 0);
//   2. pre = s A + c as mma.sync.m16n8k8 TF32 products, 3 x TF32 split, in
//      K1/K3's order per element (the same large and small accumulators
//      over the same k-steps), so a pre-activation near 0 takes the same
//      leaky-ReLU slope here as in the forward; a warp keeps one row tile
//      and takes three column tiles at a time, which share each s fragment;
//   3. the radiance head, one warp per point;
//   4. a thread per column of pre: dWr's hidden rows and dc in registers
//      across the block's tiles, d_pre in place of pre; a thread per pe row
//      (and one for dbr) the rest of dWr;
//   5. dA += s^T d_pre on the tensor cores into mma accumulators that stay
//      in registers across the block's tiles (warp w owns 16 channels by a
//      quarter of the column tiles at C 64), and d_s = d_pre A^T on the
//      tensor cores (A's transposed fragments read from the same staged
//      copy; a warp per 16 points, 16 channels and half of the column
//      steps, so each d_pre fragment is split once for two channel tiles,
//      the halves summed in the scatter), both split 3 x TF32;
//   6. the grid scatter: a thread per (corner, float4 unit, run of points)
//      walks its run in order and adds its partial sum with one float4
//      atomic only when its corner's cell changes, so consecutive points of
//      a ray that share a voxel share their atomics; the corners are double
//      buffered by tile, so a block's next tile needs no barrier first.
// At the end each block adds its partial dA, dc and dWr to the (zeroed)
// outputs with one atomicAdd per entry. Atomic sums are taken in no fixed
// order, so the results are not bit-reproducible.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using tf32x3::mma;
using tf32x3::split;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;           // points per tile: two 16-row mma tiles
constexpr int kMT = kTile / 16;
static_assert(kTile == 2 * kWarps, "the radiance head takes two points a warp");
static_assert(kWarps % kMT == 0, "a warp keeps its row tile in the affine");
constexpr int kMaxCols = 320;       // hidden + 1 padded to 8: the dA accumulators
constexpr float kNegSlope = 0.2f;   // torch.nn.LeakyReLU(0.2)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float lrelu(float x) {
  return x >= 0.f ? x : kNegSlope * x;
}

__device__ __forceinline__ float dlrelu(float x) {
  return x >= 0.f ? 1.f : kNegSlope;
}

struct Params {
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

// Shared memory, in 4-byte words. Columns j < n_cols (hidden + 1 padded to
// a multiple of 8) are swept; padded columns have A = c = 0.
//   sB    2 C n_cols   A split, in B-fragment order (tf32_mma.cuh)
//   sc    n_cols       c
//   sWr   3 (n_rin + 1), padded to 4: Wr rows, then br
//   sS    kTile x (C + 4)        the s tile (rows padded by 4 floats)
//   sPre  kTile x (n_cols + 4)   pre, then d_pre
//   sDs   2 x kTile x (C + 4)    d_s, the partial sums of two halves of
//                                the column steps
//   sw, scell  2 x kTile x 8     corner weights and cells (-1 outside), by
//                                tile parity
//   sg, sdrp   kTile x 4         the cotangent and d_rpre
//   sPe   kTile x pe_dim, padded to 4: each point's view-direction row
struct Layout {
  int n_cols, kPS, sc, sWr, sS, sPre, sDs, sw, scell, sg, sdrp, sPe, total;
  __host__ __device__ Layout(int C, int hidden, int pe_dim) {
    n_cols = (hidden + 1 + 7) / 8 * 8;
    kPS = n_cols + 4;
    sc = 2 * C * n_cols;
    sWr = sc + n_cols;
    sS = sWr + (3 * (hidden + pe_dim + 1) + 3) / 4 * 4;
    sPre = sS + 2 * kTile * (C + 4);  // hi, then lo
    sDs = sPre + kTile * kPS;
    sw = sDs + 2 * kTile * (C + 4);
    scell = sw + 2 * 8 * kTile;
    sg = scell + 2 * 8 * kTile;
    sdrp = sg + 4 * kTile;
    sPe = sdrp + 4 * kTile;
    total = sPe + (kTile * pe_dim + 3) / 4 * 4;
  }
};

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
fused_decode_bwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Layout L(C, p.hidden, p.pe_dim);
  const int n_cols = L.n_cols, kPS = L.kPS, n_nt = L.n_cols / 8;
  const int hidden = p.hidden, pe_dim = p.pe_dim, n_rin = hidden + pe_dim, n_out = hidden + 1;
  uint32_t* sB = reinterpret_cast<uint32_t*>(sm);
  float* sc = sm + L.sc;
  float* sWr = sm + L.sWr;  // rows 0..n_rin-1 = Wr, row n_rin = br
  uint32_t* sShi = reinterpret_cast<uint32_t*>(sm + L.sS);
  uint32_t* sSlo = sShi + kTile * (C + 4);
  float* sPre = sm + L.sPre;
  float* sDs = sm + L.sDs;
  float* sg = sm + L.sg;
  float* sdrp = sm + L.sdrp;
  float* sPe = sm + L.sPe;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  constexpr int kSS = C + 4;
  constexpr int kKSteps = C / 8;

  tf32x3::stage_split_a<C, kThreads>(sB, p.A, p.j_pad, n_out, n_cols);
  for (int j = tid; j < n_cols; j += kThreads) sc[j] = j < n_out ? p.c[j] : 0.f;
  for (int k = tid; k < 3 * (n_rin + 1); k += kThreads)
    sWr[k] = k < 3 * n_rin ? p.Wr[k] : p.br[k - 3 * n_rin];
  __syncthreads();

  // this thread's share of the block's partial sums, kept across tiles:
  // dA (mma accumulators: channels 16 mc + g (+8) by column tiles grp,
  // grp + kGroups, ...); dc and dWr's hidden rows of column tid; or dWr's
  // pe row tid - n_cols (dbr at tid - n_cols == pe_dim)
  constexpr int kMC = C / 16;
  constexpr int kGroups = kWarps / kMC;
  constexpr int kDaTiles = (kMaxCols / 8 + kGroups - 1) / kGroups;
  const int mc = warp % kMC, grp = warp / kMC;
  float dacc[kDaTiles][4];
#pragma unroll
  for (int q = 0; q < kDaTiles; ++q) dacc[q][0] = dacc[q][1] = dacc[q][2] = dacc[q][3] = 0.f;
  float dc_acc = 0.f, dwr[3] = {0.f, 0.f, 0.f};

  constexpr int kUnits = C / 4;                 // float4 units of a row: gathering lanes per point
  constexpr int kPPS = 32 / kUnits;             // points per warp and step
  constexpr int kSampleWarps = kTile / kPPS;
  constexpr int kRuns = kThreads / (8 * kUnits);  // runs of points per tile (4 at C 64)
  constexpr int kRun = kTile / kRuns;
  const float4* grid4 = reinterpret_cast<const float4*>(p.grid);

  const long long n_tiles = (p.n + kTile - 1) / kTile;
  int parity = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, parity ^= 1) {
    const long long base = tile * kTile;
    float* sw = sm + L.sw + parity * 8 * kTile;
    int* scell = reinterpret_cast<int*>(sm + L.scell) + parity * 8 * kTile;

    // ---- 1. each point's pe row (every thread); corners (lanes < kPPS:
    // point r0 + lane), then the sample
    for (int e = tid; e < kTile * pe_dim; e += kThreads) {
      const long long i = base + e / pe_dim;
      sPe[e] = i < p.n ? __ldg(p.pe + (i / p.points_per_ray) * pe_dim + e % pe_dim) : 0.f;
    }
    if (warp < kSampleWarps) {
      const int r0 = warp * kPPS;
      int cell[8];
      float w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        cell[k] = 0;
        w[k] = 0.f;
      }
      if (lane < kPPS) {
        const long long i = base + r0 + lane;
        const bool live = i < p.n;
        int out_cell[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) out_cell[k] = -1;
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
            out_cell[k] = cell[k];
            const float wx = dx ? fx : 1.f - fx;
            const float wy = dy ? fy : 1.f - fy;
            const float wz = dz ? fz : 1.f - fz;
            w[k] = wx * wy * wz;
          }
        }
        const int r = r0 + lane;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          sw[8 * r + k] = w[k];
          scell[8 * r + k] = out_cell[k];
        }
#pragma unroll
        for (int l = 0; l < 4; ++l) sg[4 * r + l] = live ? p.g[4 * i + l] : 0.f;
      }
      const int q = lane % kUnits, sub = lane / kUnits;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int ck = __shfl_sync(kFull, cell[k], sub);
        const float wk = __shfl_sync(kFull, w[k], sub);
        const float4 v = __ldg(grid4 + ck * kUnits + q);
        acc.x = fmaf(wk, v.x, acc.x);
        acc.y = fmaf(wk, v.y, acc.y);
        acc.z = fmaf(wk, v.z, acc.z);
        acc.w = fmaf(wk, v.w, acc.w);
      }
      uint4 hi, lo;
      split(acc.x, hi.x, lo.x);
      split(acc.y, hi.y, lo.y);
      split(acc.z, hi.z, lo.z);
      split(acc.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(sShi + (r0 + sub) * kSS + 4 * q) = hi;
      *reinterpret_cast<uint4*>(sSlo + (r0 + sub) * kSS + 4 * q) = lo;
    }
    __syncthreads();

    // ---- 2. pre = s A + c: warp w takes row tile w % kMT and every
    // (kWarps / kMT)-th column tile, kPass at a time sharing each s
    // fragment, with K1/K3's sequence of products per element
    {
      constexpr int kStride = kWarps / kMT;
      constexpr int kPass = 3;
      const int mt = warp % kMT;
      for (int p0 = warp / kMT; p0 < n_nt; p0 += kPass * kStride) {
        float big[kPass][4] = {}, small[kPass][4] = {};
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          // rows g, g + 8 by columns t, t + 4
          const int o0 = (16 * mt + g) * kSS + 8 * ks + t;
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int o = o0 + (r & 1) * 8 * kSS + (r >> 1) * 4;
            ahi[r] = sShi[o];
            alo[r] = sSlo[o];
          }
#pragma unroll
          for (int h = 0; h < kPass; ++h) {
            const int nt = p0 + h * kStride;
            if (nt < n_nt) {
              const uint4 b = reinterpret_cast<const uint4*>(sB)[(nt * kKSteps + ks) * 32 + lane];  // (hi0, hi1, lo0, lo1)
              mma(small[h], alo, b.x, b.y);
              mma(small[h], ahi, b.z, b.w);
              mma(big[h], ahi, b.x, b.y);
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
          const int pt = warp + h * kWarps;
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
          const int pt = warp + h * kWarps;
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
      const int o0 = (8 * kp + t) * kSS + 16 * mc + g;
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int o = o0 + (r & 1) * 8 + (r >> 1) * 4 * kSS;
        ahi[r] = sShi[o];
        alo[r] = sSlo[o];
      }
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

    // ---- 5b. d_s = d_pre A^T: a warp per (row tile, 16 channels, half of
    // the column steps), each d_pre fragment split once for two channel
    // tiles; the two halves' partial sums in two buffers
    for (int u = warp; u < kMT * (C / 16) * 2; u += kWarps) {
      const int mt = u % kMT, np = (u / kMT) % (C / 16), half = u / (kMT * (C / 16));
      float acc[2][2][4] = {};  // [channel tile][column-step parity]
      const float* a_row = sPre + (16 * mt + g) * kPS + t;
      const uint32_t* b_lane = sB + (2 * np) * 32 * 4 + (4 * t + (g & 3)) * 4 + (g >> 2);
      // column steps half, half + 2, ...: two at a time, one per accumulator
      auto step = [&](int kc, int par) {
        const float* a0 = a_row + 8 * kc;
        uint32_t ahi[4], alo[4];
        split(a0[0], ahi[0], alo[0]);
        split(a0[8 * kPS], ahi[1], alo[1]);
        split(a0[4], ahi[2], alo[2]);
        split(a0[8 * kPS + 4], ahi[3], alo[3]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t* b = b_lane + (kc * kKSteps + h) * 32 * 4;
          const uint32_t bh0 = b[0], bl0 = b[2], bh1 = b[64], bl1 = b[66];
          mma(acc[h][par], alo, bh0, bh1);
          mma(acc[h][par], ahi, bl0, bl1);
          mma(acc[h][par], ahi, bh0, bh1);
        }
      };
      for (int kc = half; kc < n_nt; kc += 4) {
        step(kc, 0);
        if (kc + 2 < n_nt) step(kc + 2, 1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* o = sDs + half * kTile * kSS + (16 * mt + g) * kSS + 8 * (2 * np + h) + 2 * t;
        *reinterpret_cast<float2*>(o) = make_float2(acc[h][0][0] + acc[h][1][0], acc[h][0][1] + acc[h][1][1]);
        *reinterpret_cast<float2*>(o + 8 * kSS) =
            make_float2(acc[h][0][2] + acc[h][1][2], acc[h][0][3] + acc[h][1][3]);
      }
    }
    __syncthreads();

    // ---- 6. scatter d_s into the grid: a thread per (run of kRun points,
    // corner, float4 unit) adds one atomic per change of its corner's cell
    {
      const int q = tid % kUnits, k = (tid / kUnits) % 8, run = tid / (8 * kUnits);
      int cur = -1;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int pt = run * kRun; pt < (run + 1) * kRun; ++pt) {
        const int cell = scell[8 * pt + k];
        if (cell != cur) {
          if (cur >= 0) atomicAdd(reinterpret_cast<float4*>(p.d_grid) + cur * kUnits + q, acc);
          cur = cell;
          acc = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        const float wk = sw[8 * pt + k];
        const float4 d0 = *reinterpret_cast<const float4*>(sDs + pt * kSS + 4 * q);
        const float4 d1 = *reinterpret_cast<const float4*>(sDs + (kTile + pt) * kSS + 4 * q);
        acc.x = fmaf(wk, d0.x + d1.x, acc.x);
        acc.y = fmaf(wk, d0.y + d1.y, acc.y);
        acc.z = fmaf(wk, d0.z + d1.z, acc.z);
        acc.w = fmaf(wk, d0.w + d1.w, acc.w);
      }
      if (cur >= 0) atomicAdd(reinterpret_cast<float4*>(p.d_grid) + cur * kUnits + q, acc);
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

template <int C>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const Layout L(C, p.hidden, p.pe_dim);
  // the dA accumulators cover kMaxCols columns; a thread each for the
  // columns, the pe rows and dbr
  if (L.n_cols > kMaxCols || L.n_cols + p.pe_dim + 1 > kThreads) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * static_cast<size_t>(L.total);
  cudaError_t err = cudaFuncSetAttribute(
      fused_decode_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_decode_bwd_kernel<C>, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (p.n + kTile - 1) / kTile;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const long long blocks = tiles < resident ? tiles : resident;
  fused_decode_bwd_kernel<C>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_decode_bwd(
    const float* points, const float* pe, const float* g, const float* grid,
    const float* A, const float* c, const float* Wr, const float* br,
    float* d_grid, float* dA, float* dc, float* dWr, long long n,
    int points_per_ray, int D, int H, int W, int C, int j_pad, int hidden,
    int pe_dim, float voxel_size, void* stream) {
  if (n == 0) return cudaSuccess;
  if (j_pad % 4 != 0 || j_pad < hidden + 1) return cudaErrorInvalidValue;
  // 32-bit cell indices: every flat grid offset fits in an int
  if (static_cast<long long>(D) * H * W * C >= (1LL << 31)) return cudaErrorInvalidValue;
  Params p;
  p.points = points; p.pe = pe; p.g = g; p.grid = grid; p.A = A; p.c = c;
  p.Wr = Wr; p.br = br; p.d_grid = d_grid; p.dA = dA; p.dc = dc; p.dWr = dWr;
  p.n = n; p.points_per_ray = points_per_ray; p.D = D; p.H = H; p.W = W;
  p.j_pad = j_pad; p.hidden = hidden; p.pe_dim = pe_dim;
  p.voxel_size = voxel_size;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return launch<32>(p, s);
    case 64: return launch<64>(p, s);
    default: return cudaErrorInvalidValue;
  }
}
