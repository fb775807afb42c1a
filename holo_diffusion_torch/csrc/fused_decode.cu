// Fused trilinear sample + render decode, one thread per point (sm_90a).
//
// Replaces the TPU kernels of holo_diffusion_tpu/ops/pallas/fused_decode.py:
//   * `_fwd_kernel` (K1)          -> entry point `fused_decode_fwd`
//   * `_fwd_kernel_normals` (K3)  -> entry point `fused_decode_fwd_normals`
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
// index = x / (extent / D) + (n - 1) / 2 on every axis, align_corners, and a
// corner outside the grid contributes zero (no clamping). The derivative of
// the hat relu(1 - |i - q|) is -sign(i - q) for |i - q| < 1 and 0 otherwise,
// so the gradient along an axis is 0 at an exact integer coordinate, as in
// the TPU kernel (fused_decode.py:85-106).
//
// What bounds it on the H100: arithmetic. Per point the 64 x 257 affine is
// 32.9 kFLOP of the ~35.6 kFLOP total (sample 1.0k, radiance 1.7k); a
// 512^2 frame at 64 + 128 points per ray is 50.3 M points, 1.79 TFLOP on
// the float32 CUDA cores. The grid (1 MiB) stays in L2, the weights in shared
// memory; each point reads 12 B and writes 16 B (K1) or 28 B (K3).
//
// What the simple design does about it: the 64 sampled channels live in
// registers; A, c, Wr and br are staged once per block in dynamic shared
// memory (71 KB at hydrant scale, above the 48 KB static limit), A with its
// columns zero-padded to a multiple of 4 so one broadcast 16-byte shared load
// feeds four FMAs. The padded columns are never written out. Tensor cores
// (the affine as a GEMM over a block of points) are a later step.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegSlope = 0.2f;  // torch.nn.LeakyReLU(0.2)

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

template <int C, bool NORMALS>
__global__ void __launch_bounds__(kThreads)
fused_decode_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);
  float* sc = sA + C * p.j_pad;
  float* sWr = sc + p.j_pad;
  float* sbr = sWr + 3 * (p.hidden + p.pe_dim);

  for (int k = threadIdx.x; k < C * p.j_pad; k += blockDim.x) sA[k] = p.A[k];
  for (int k = threadIdx.x; k < p.j_pad; k += blockDim.x) sc[k] = p.c[k];
  for (int k = threadIdx.x; k < 3 * (p.hidden + p.pe_dim); k += blockDim.x)
    sWr[k] = p.Wr[k];
  if (threadIdx.x < 3) sbr[threadIdx.x] = p.br[threadIdx.x];
  __syncthreads();

  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.n) return;

  // ---- trilinear sample (and the g1 gradient for K3)
  const float ix = p.points[3 * i + 0] / p.voxel_size + 0.5f * (p.W - 1);
  const float iy = p.points[3 * i + 1] / p.voxel_size + 0.5f * (p.H - 1);
  const float iz = p.points[3 * i + 2] / p.voxel_size + 0.5f * (p.D - 1);
  const float x0 = floorf(ix), y0 = floorf(iy), z0 = floorf(iz);
  const float fx = ix - x0, fy = iy - y0, fz = iz - z0;

  float s[C];
#pragma unroll
  for (int k = 0; k < C; ++k) s[k] = 0.f;
  float gx = 0.f, gy = 0.f, gz = 0.f;

#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int dx = corner & 1, dy = (corner >> 1) & 1, dz = corner >> 2;
    const float xf = x0 + dx, yf = y0 + dy, zf = z0 + dz;
    if (!(xf >= 0.f && xf <= p.W - 1 && yf >= 0.f && yf <= p.H - 1 &&
          zf >= 0.f && zf <= p.D - 1))
      continue;
    const long long cell =
        (static_cast<long long>(zf) * p.H + static_cast<long long>(yf)) * p.W +
        static_cast<long long>(xf);
    const float wx = dx ? fx : 1.f - fx;
    const float wy = dy ? fy : 1.f - fy;
    const float wz = dz ? fz : 1.f - fz;
    const float w = wx * wy * wz;
    const float4* row = reinterpret_cast<const float4*>(p.grid + cell * C);
#pragma unroll
    for (int k = 0; k < C / 4; ++k) {
      const float4 v = __ldg(row + k);
      s[4 * k + 0] = fmaf(w, v.x, s[4 * k + 0]);
      s[4 * k + 1] = fmaf(w, v.y, s[4 * k + 1]);
      s[4 * k + 2] = fmaf(w, v.z, s[4 * k + 2]);
      s[4 * k + 3] = fmaf(w, v.w, s[4 * k + 3]);
    }
    if (NORMALS) {
      // hat derivative: -1 at the lower corner, +1 at the upper, 0 when the
      // coordinate sits exactly on the lower corner's plane
      const float ddx = fx > 0.f ? (dx ? 1.f : -1.f) : 0.f;
      const float ddy = fy > 0.f ? (dy ? 1.f : -1.f) : 0.f;
      const float ddz = fz > 0.f ? (dz ? 1.f : -1.f) : 0.f;
      const float g = __ldg(p.g1 + cell);
      gx = fmaf(wz * wy * ddx, g, gx);
      gy = fmaf(wz * ddy * wx, g, gy);
      gz = fmaf(ddz * wy * wx, g, gz);
    }
  }

  // ---- density affine + radiance head, streamed over the hidden columns
  const float4* A4 = reinterpret_cast<const float4*>(sA);
  const float4* c4 = reinterpret_cast<const float4*>(sc);
  const int jq = p.j_pad / 4;
  float r0 = 0.f, r1 = 0.f, r2 = 0.f, density = 0.f;
  for (int q = 0; q < jq; ++q) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const float4 a = A4[k * jq + q];
      acc.x = fmaf(s[k], a.x, acc.x);
      acc.y = fmaf(s[k], a.y, acc.y);
      acc.z = fmaf(s[k], a.z, acc.z);
      acc.w = fmaf(s[k], a.w, acc.w);
    }
    const float4 cb = c4[q];
    const float pre[4] = {acc.x + cb.x, acc.y + cb.y, acc.z + cb.z, acc.w + cb.w};
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int j = 4 * q + l;
      const float h = lrelu(pre[l]);
      if (j < p.hidden) {
        r0 = fmaf(h, sWr[3 * j + 0], r0);
        r1 = fmaf(h, sWr[3 * j + 1], r1);
        r2 = fmaf(h, sWr[3 * j + 2], r2);
      } else if (j == p.hidden) {
        density = h;
      }
    }
  }
  const float* pe = p.pe + (i / p.points_per_ray) * p.pe_dim;
  for (int e = 0; e < p.pe_dim; ++e) {
    const float v = __ldg(pe + e);
    const float* w = sWr + 3 * (p.hidden + e);
    r0 = fmaf(v, w[0], r0);
    r1 = fmaf(v, w[1], r1);
    r2 = fmaf(v, w[2], r2);
  }

  constexpr int kLanes = NORMALS ? 7 : 4;
  float* o = p.out + i * kLanes;
  o[0] = density;
  o[1] = sigmoid(lrelu(r0 + sbr[0]));
  o[2] = sigmoid(lrelu(r1 + sbr[1]));
  o[3] = sigmoid(lrelu(r2 + sbr[2]));
  if (NORMALS) {
    o[4] = gx * p.inv_vs;
    o[5] = gy * p.inv_vs;
    o[6] = gz * p.inv_vs;
  }
}

template <int C, bool NORMALS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(C + 1) * p.j_pad +
                       3 * (p.hidden + p.pe_dim) + 4);
  cudaError_t err = cudaFuncSetAttribute(
      fused_decode_kernel<C, NORMALS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (p.n + kThreads - 1) / kThreads;
  fused_decode_kernel<C, NORMALS>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool NORMALS>
int dispatch(const Params& p, int C, void* stream) {
  if (p.n == 0) return cudaSuccess;
  if (p.j_pad % 4 != 0 || p.j_pad < p.hidden + 1) return cudaErrorInvalidValue;
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
