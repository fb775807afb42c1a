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
// at the 67 TFLOP/s float32 peak. The bytes are few: the grid (1 MiB) and
// d_grid stay in L2, each point reads 12 + 16 B.
//
// What the simple design does about the reductions over all points: one
// persistent block per SM walks over tiles of kTile points. A tile's samples
// s (C x kTile, transposed) and its pre/d_pre (kTile x j_pad) live in shared
// memory, next to A, Wr and the block's own partial sums of dA, dc, dWr and
// dbr. Each tile adds its s^T d_pre into the partials with each thread
// owning fixed (c, 4 j) entries, so no atomics touch them. At the end every
// block adds its partials to the outputs with one atomicAdd per entry (the
// outputs are zeroed by the caller): 132 blocks x 16.9 k atomics, not one per
// point. The order of those additions varies between runs, so the sums are
// not bit-reproducible. The grid cotangent is scattered with atomicAdd, 8
// corners x C channels per point, consecutive threads on consecutive
// channels of one cell; hydrant's points land in 4,096 voxels, so these
// contend. Tensor cores for s^T d_pre and d_pre A^T, and warp-aggregated
// scatters, are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 32;  // points per tile; a multiple of 4
constexpr float kNegSlope = 0.2f;  // torch.nn.LeakyReLU(0.2)

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

template <int C>
struct Smem {
  // offsets in floats into the dynamic shared buffer (each a multiple of 4)
  int A, dA, c, dc, Wr, dWr, sT, buf, w, cell, g, drp, total;
  __host__ __device__ Smem(int j_pad, int n_rin) {
    const int n_wr = (3 * (n_rin + 1) + 3) / 4 * 4;
    A = 0;
    dA = A + C * j_pad;
    c = dA + C * j_pad;
    dc = c + j_pad;
    Wr = dc + j_pad;
    dWr = Wr + n_wr;
    sT = dWr + n_wr;  // (C, kTile) samples; reused as d_s (kTile, C)
    buf = sT + C * kTile;  // (kTile, j_pad) pre, then d_pre
    w = buf + kTile * j_pad;  // (kTile, 8) corner weights
    cell = w + 8 * kTile;  // (kTile, 8) corner cells (as int), -1 outside
    g = cell + 8 * kTile;  // (kTile, 4) cotangent
    drp = g + 4 * kTile;  // (kTile, 4) d_rpre
    total = drp + 4 * kTile;
  }
};

template <int C>
__global__ void __launch_bounds__(kThreads)
fused_decode_bwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int j_pad = p.j_pad, hidden = p.hidden, pe_dim = p.pe_dim;
  const int n_rin = hidden + pe_dim;
  const Smem<C> L(j_pad, n_rin);
  float* sA = sm + L.A;
  float* sdA = sm + L.dA;
  float* sc = sm + L.c;
  float* sdc = sm + L.dc;
  float* sWr = sm + L.Wr;  // rows 0..n_rin-1 = Wr, row n_rin = br
  float* sdWr = sm + L.dWr;
  float* sT = sm + L.sT;
  float* buf = sm + L.buf;
  float* sw = sm + L.w;
  int* scell = reinterpret_cast<int*>(sm + L.cell);
  float* sg = sm + L.g;
  float* sdrp = sm + L.drp;
  const int tid = threadIdx.x;

  for (int k = tid; k < C * j_pad; k += kThreads) {
    sA[k] = p.A[k];
    sdA[k] = 0.f;
  }
  for (int k = tid; k < j_pad; k += kThreads) {
    sc[k] = p.c[k];
    sdc[k] = 0.f;
  }
  for (int k = tid; k < 3 * (n_rin + 1); k += kThreads) {
    sWr[k] = k < 3 * n_rin ? p.Wr[k] : p.br[k - 3 * n_rin];
    sdWr[k] = 0.f;
  }
  __syncthreads();

  const long long n_tiles = (p.n + kTile - 1) / kTile;
  const int jq = j_pad / 4;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long base = tile * kTile;

    // ---- 1. per point: corner cells and weights, cotangent
    if (tid < kTile) {
      const long long i = base + tid;
      const bool live = i < p.n;
      float ix = 0.f, iy = 0.f, iz = 0.f;
      if (live) {
        ix = p.points[3 * i + 0] / p.voxel_size + 0.5f * (p.W - 1);
        iy = p.points[3 * i + 1] / p.voxel_size + 0.5f * (p.H - 1);
        iz = p.points[3 * i + 2] / p.voxel_size + 0.5f * (p.D - 1);
      }
      const float x0 = floorf(ix), y0 = floorf(iy), z0 = floorf(iz);
      const float fx = ix - x0, fy = iy - y0, fz = iz - z0;
#pragma unroll
      for (int corner = 0; corner < 8; ++corner) {
        const int dx = corner & 1, dy = (corner >> 1) & 1, dz = corner >> 2;
        const float xf = x0 + dx, yf = y0 + dy, zf = z0 + dz;
        const bool inside = live && xf >= 0.f && xf <= p.W - 1 && yf >= 0.f &&
                            yf <= p.H - 1 && zf >= 0.f && zf <= p.D - 1;
        const float wx = dx ? fx : 1.f - fx;
        const float wy = dy ? fy : 1.f - fy;
        const float wz = dz ? fz : 1.f - fz;
        sw[8 * tid + corner] = inside ? wx * wy * wz : 0.f;
        scell[8 * tid + corner] =
            inside ? (static_cast<int>(zf) * p.H + static_cast<int>(yf)) * p.W +
                         static_cast<int>(xf)
                   : -1;
      }
#pragma unroll
      for (int l = 0; l < 4; ++l) sg[4 * tid + l] = live ? p.g[4 * i + l] : 0.f;
    }
    __syncthreads();

    // ---- 2. trilinear sample, stored transposed: sT[k][pt]
    for (int e = tid; e < kTile * C; e += kThreads) {
      const int pt = e / C, k = e % C;
      float acc = 0.f;
#pragma unroll
      for (int corner = 0; corner < 8; ++corner) {
        const int cell = scell[8 * pt + corner];
        if (cell >= 0)
          acc = fmaf(sw[8 * pt + corner],
                     __ldg(p.grid + static_cast<long long>(cell) * C + k), acc);
      }
      sT[k * kTile + pt] = acc;
    }
    __syncthreads();

    // ---- 3. pre = s @ A + c, four points per thread
    for (int e = tid; e < (kTile / 4) * j_pad; e += kThreads) {
      const int pg = e / j_pad, j = e % j_pad;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int k = 0; k < C; ++k) {
        const float a = sA[k * j_pad + j];
        const float4 s = reinterpret_cast<const float4*>(sT + k * kTile)[pg];
        acc.x = fmaf(s.x, a, acc.x);
        acc.y = fmaf(s.y, a, acc.y);
        acc.z = fmaf(s.z, a, acc.z);
        acc.w = fmaf(s.w, a, acc.w);
      }
      const float cj = sc[j];
      buf[(4 * pg + 0) * j_pad + j] = acc.x + cj;
      buf[(4 * pg + 1) * j_pad + j] = acc.y + cj;
      buf[(4 * pg + 2) * j_pad + j] = acc.z + cj;
      buf[(4 * pg + 3) * j_pad + j] = acc.w + cj;
    }
    __syncthreads();

    // ---- 4. radiance head and d_rpre, one warp per point
    const int warp = tid / 32, lane = tid % 32;
    for (int pt = warp; pt < kTile; pt += kThreads / 32) {
      const long long i = base + pt;
      const float* pe = p.pe + (i < p.n ? i / p.points_per_ray : 0) * pe_dim;
      float r0 = 0.f, r1 = 0.f, r2 = 0.f;
      for (int j = lane; j < n_rin; j += 32) {
        const float v = j < hidden ? lrelu(buf[pt * j_pad + j])
                                   : (i < p.n ? __ldg(pe + j - hidden) : 0.f);
        r0 = fmaf(v, sWr[3 * j + 0], r0);
        r1 = fmaf(v, sWr[3 * j + 1], r1);
        r2 = fmaf(v, sWr[3 * j + 2], r2);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        r0 += __shfl_xor_sync(0xffffffffu, r0, off);
        r1 += __shfl_xor_sync(0xffffffffu, r1, off);
        r2 += __shfl_xor_sync(0xffffffffu, r2, off);
      }
      if (lane < 3) {
        const float rp = (lane == 0 ? r0 : lane == 1 ? r1 : r2) + sWr[3 * n_rin + lane];
        const float rgb = 1.f / (1.f + expf(-lrelu(rp)));
        sdrp[4 * pt + lane] = sg[4 * pt + 1 + lane] * rgb * (1.f - rgb) * dlrelu(rp);
      }
    }
    __syncthreads();

    // ---- 5. dWr += rin^T d_rpre, dbr += sum d_rpre (row n_rin, rin = 1)
    for (int e = tid; e < 3 * (n_rin + 1); e += kThreads) {
      const int j = e / 3, o = e % 3;
      float acc = 0.f;
      if (j < hidden) {
        for (int pt = 0; pt < kTile; ++pt)
          acc = fmaf(lrelu(buf[pt * j_pad + j]), sdrp[4 * pt + o], acc);
      } else if (j < n_rin) {
        for (int pt = 0; pt < kTile; ++pt) {
          const long long i = base + pt;
          if (i < p.n)
            acc = fmaf(__ldg(p.pe + (i / p.points_per_ray) * pe_dim + j - hidden),
                       sdrp[4 * pt + o], acc);
        }
      } else {
        for (int pt = 0; pt < kTile; ++pt) acc += sdrp[4 * pt + o];
      }
      sdWr[e] += acc;
    }
    __syncthreads();

    // ---- 6. d_pre = [d_rpre @ Wr[:hidden]^T | d_density | 0] * lrelu'(pre)
    for (int e = tid; e < kTile * j_pad; e += kThreads) {
      const int pt = e / j_pad, j = e % j_pad;
      float dh = 0.f;
      if (j < hidden) {
        dh = sdrp[4 * pt + 0] * sWr[3 * j + 0] + sdrp[4 * pt + 1] * sWr[3 * j + 1] +
             sdrp[4 * pt + 2] * sWr[3 * j + 2];
      } else if (j == hidden) {
        dh = sg[4 * pt];
      }
      buf[e] = dh * dlrelu(buf[e]);
    }
    __syncthreads();

    // ---- 7. dA += s^T d_pre, dc += sum d_pre; thread owns (k, 4 columns)
    for (int e = tid; e < (C + 1) * jq; e += kThreads) {
      const int k = e / jq, q = e % jq;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int pt = 0; pt < kTile; ++pt) {
        const float s = k < C ? sT[k * kTile + pt] : 1.f;  // row C: dc
        const float4 d = reinterpret_cast<const float4*>(buf + pt * j_pad)[q];
        acc.x = fmaf(s, d.x, acc.x);
        acc.y = fmaf(s, d.y, acc.y);
        acc.z = fmaf(s, d.z, acc.z);
        acc.w = fmaf(s, d.w, acc.w);
      }
      float4* dst = reinterpret_cast<float4*>(k < C ? sdA + k * j_pad : sdc) + q;
      float4 cur = *dst;
      cur.x += acc.x;
      cur.y += acc.y;
      cur.z += acc.z;
      cur.w += acc.w;
      *dst = cur;
    }
    __syncthreads();

    // ---- 8. d_s = d_pre @ A^T into the sT space, as (kTile, C)
    float* ds = sT;
    float dsv[(kTile * C + kThreads - 1) / kThreads];
#pragma unroll
    for (int r = 0; r < (kTile * C + kThreads - 1) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      float acc = 0.f;
      if (e < kTile * C) {
        const int pt = e / C, k = e % C;
        const float4* d4 = reinterpret_cast<const float4*>(buf + pt * j_pad);
        const float4* a4 = reinterpret_cast<const float4*>(sA + k * j_pad);
        for (int q = 0; q < jq; ++q) {
          const float4 d = d4[q], a = a4[q];
          acc = fmaf(d.x, a.x, acc);
          acc = fmaf(d.y, a.y, acc);
          acc = fmaf(d.z, a.z, acc);
          acc = fmaf(d.w, a.w, acc);
        }
      }
      dsv[r] = acc;
    }
    __syncthreads();  // every read of sT (step 7) is done before the overwrite
#pragma unroll
    for (int r = 0; r < (kTile * C + kThreads - 1) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      if (e < kTile * C) ds[e] = dsv[r];
    }
    __syncthreads();

    // ---- 9. scatter into the grid: consecutive threads, consecutive channels
    for (int e = tid; e < kTile * C; e += kThreads) {
      const int pt = e / C, k = e % C;
      const float v = ds[e];
#pragma unroll
      for (int corner = 0; corner < 8; ++corner) {
        const int cell = scell[8 * pt + corner];
        if (cell >= 0)
          atomicAdd(p.d_grid + static_cast<long long>(cell) * C + k,
                    sw[8 * pt + corner] * v);
      }
    }
    __syncthreads();
  }

  // ---- the block's partial sums, once per entry
  for (int k = tid; k < C * j_pad; k += kThreads) atomicAdd(p.dA + k, sdA[k]);
  for (int k = tid; k < j_pad; k += kThreads) atomicAdd(p.dc + k, sdc[k]);
  for (int k = tid; k < 3 * (n_rin + 1); k += kThreads) atomicAdd(p.dWr + k, sdWr[k]);
}

template <int C>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const Smem<C> L(p.j_pad, p.hidden + p.pe_dim);
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
