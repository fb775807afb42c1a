// The view pooler's sampler (sm_90a): every feature map of every source
// view sampled bilinearly at the points' projections in one launch
// (`view_sample_fwd`), and the maps' gradients gathered back in one more
// (`view_sample_bwd`). K8 of the port.
//
// Replaces no TPU kernel: the JAX package samples with plain gathers, or a
// matmul form for small maps (holo_diffusion_tpu/ops/image.py), left to
// XLA, which fuses them. The port's plain version,
// `view_sample_reference` (ops/view_sample.py), is one
// `bilinear_sample_ndc` call a view and a map: about 90 small launches
// each, 180 calls a hydrant step, and in the backward a sorted index
// scatter for every gather. This kernel does that work in one launch each
// way.
//
// Semantics (ops/image.py `bilinear_sample_ndc`): pytorch3d NDC (+x left,
// +y up) flipped to grid_sample's orientation, then to pixel coordinates
// f = (g + 1) / 2 * n - 0.5 (align_corners: (g + 1) / 2 * (n - 1)); the
// corners floor(f) + d weigh (1 - frac) or frac per axis, and a corner
// outside the map weighs 0 and reads its clamped pixel. Every product and
// sum is rounded as the plain version rounds it (no contraction into fma),
// and the corners are added in its order, (dy, dx) = (0,0), (0,1), (1,0),
// (1,1), so the forward equals the plain version's.
//
// What bounds it on the H100: memory traffic, and little of it: a point
// reads 4 corners x its channels (68 in the release configs) and writes
// one row; the maps (under 40 MB at the release shapes) stay in L2.
//
// Forward: one thread per (view, point) and map (grid.y is the map; the
// table of maps is a `__grid_constant__` parameter, read in place), the
// corners and weights once per map, the channels walked in float4 units
// where the map's and the rows' strides allow it, single floats
// otherwise. The maps are taken with their strides as they come: the
// extractor's maps are NHWC views of NCHW memory, so a unit's 4 channels
// are 4 loads one plane apart, and no copy is made.
//
// Backward: a gather, not a scatter, so that it sums in a fixed order and
// a step reruns bitwise (with atomics the order would change from run to
// run). A block owns a 16 x 16 tile of one map's pixels in one view and
// up to 16 of its channels; it walks the view's points in chunks of 256,
// keeps (in shared memory, in point order) those whose 2 x 2 corners touch
// the tile, with their corner weights and gradient rows, and each thread
// adds to its pixel the shares of the points that have it as a corner.
// Every pixel of the gradient is written once, so no zero fill is needed.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxMaps = 8;
constexpr int kThreads = 256;
// per map: src, grad, h, w, c, offset, 4 strides of src, 4 of grad
constexpr int kDescWords = 14;
// backward: a block's tile of pixels and its channels
constexpr int kTile = 16;
constexpr int kPassChannels = 16;

struct Map {
  const float* src;             // the map (forward)
  float* grad;                  // its gradient (backward)
  long long sv, sr, sc, sch;    // the map's strides: view, row, column, channel (elements)
  long long gv, gr, gc, gch;    // the gradient's
  int h, w, c, offset;          // size, channels, first channel in the rows
  bool units4;                  // c % 4 == 0 and the rows take float4 at offset
  bool vec_src;                 // a unit's 4 channels are one aligned float4
  int tiles_x, passes;          // backward: tiles a row, channel passes
  int first_block;              // backward: the map's first block of a view
};

struct Table {
  Map m[kMaxMaps];
  int n;
};

// xy (S, N, 2) and the rows (S, N, F) the kernel writes or reads; the rows'
// channel stride is 1
struct Points {
  const float* xy;
  long long xv, xn, xk;
  long long S, N;
  long long rv, rn;
  bool align_corners;
};

__device__ __forceinline__ float4 mul4(float4 v, float w) {
  return make_float4(__fmul_rn(v.x, w), __fmul_rn(v.y, w), __fmul_rn(v.z, w), __fmul_rn(v.w, w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 load4(const float* p, long long step, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + step), __ldg(p + 2 * step), __ldg(p + 3 * step));
}

// The 4 corners of (x, y) on an h x w map as `bilinear_sample_ndc` forms
// them: weight (0 outside), clamped pixel; and the unclamped first corner
// (x0, y0), cut to [-2, n] so that it fits an int and still lies off the
// map where it did.
__device__ __forceinline__ void corners(float x, float y, int h, int w, bool align_corners, float* wt,
                                        int* yc, int* xc, int* x0i, int* y0i) {
  const float gx = -x, gy = -y;
  float fx, fy;
  if (align_corners) {
    fx = __fmul_rn(__fmul_rn(__fadd_rn(gx, 1.f), 0.5f), static_cast<float>(w - 1));
    fy = __fmul_rn(__fmul_rn(__fadd_rn(gy, 1.f), 0.5f), static_cast<float>(h - 1));
  } else {
    fx = __fsub_rn(__fmul_rn(__fmul_rn(__fadd_rn(gx, 1.f), 0.5f), static_cast<float>(w)), 0.5f);
    fy = __fsub_rn(__fmul_rn(__fmul_rn(__fadd_rn(gy, 1.f), 0.5f), static_cast<float>(h)), 0.5f);
  }
  const float x0 = floorf(fx), y0 = floorf(fy);
  const float wx = __fsub_rn(fx, x0), wy = __fsub_rn(fy, y0);
  const float xmax = static_cast<float>(w - 1), ymax = static_cast<float>(h - 1);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dy = k >> 1, dx = k & 1;
    const float xi = __fadd_rn(x0, static_cast<float>(dx)), yi = __fadd_rn(y0, static_cast<float>(dy));
    const float wk = __fmul_rn(dx ? wx : __fsub_rn(1.f, wx), dy ? wy : __fsub_rn(1.f, wy));
    const bool in = xi >= 0.f && xi <= xmax && yi >= 0.f && yi <= ymax;
    wt[k] = __fmul_rn(wk, in ? 1.f : 0.f);
    xc[k] = static_cast<int>(fminf(fmaxf(xi, 0.f), xmax));
    yc[k] = static_cast<int>(fminf(fmaxf(yi, 0.f), ymax));
  }
  *x0i = static_cast<int>(fminf(fmaxf(x0, -2.f), static_cast<float>(w)));
  *y0i = static_cast<int>(fminf(fmaxf(y0, -2.f), static_cast<float>(h)));
}

__global__ void __launch_bounds__(kThreads)
view_sample_fwd_kernel(const __grid_constant__ Table t, const Points p, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= p.S * p.N) return;
  const Map& m = t.m[blockIdx.y];
  const long long s = i / p.N, n = i - s * p.N;
  const float* q = p.xy + s * p.xv + n * p.xn;
  float wt[4];
  int yc[4], xc[4], x0, y0;
  corners(q[0], q[p.xk], m.h, m.w, p.align_corners, wt, yc, xc, &x0, &y0);
  const float* src[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) src[k] = m.src + s * m.sv + yc[k] * m.sr + xc[k] * m.sc;
  float* row = out + s * p.rv + n * p.rn + m.offset;
  if (m.units4) {
    for (int u = 0; u < m.c; u += 4) {
      float4 acc = mul4(load4(src[0] + u * m.sch, m.sch, m.vec_src), wt[0]);
#pragma unroll
      for (int k = 1; k < 4; ++k) acc = add4(acc, mul4(load4(src[k] + u * m.sch, m.sch, m.vec_src), wt[k]));
      *reinterpret_cast<float4*>(row + u) = acc;
    }
  } else {
    for (int ch = 0; ch < m.c; ++ch) {
      float acc = __fmul_rn(__ldg(src[0] + ch * m.sch), wt[0]);
#pragma unroll
      for (int k = 1; k < 4; ++k) acc = __fadd_rn(acc, __fmul_rn(__ldg(src[k] + ch * m.sch), wt[k]));
      row[ch] = acc;
    }
  }
}

// grid (blocks of all maps' tiles and passes, S): see the header.
__global__ void __launch_bounds__(kThreads)
view_sample_bwd_kernel(const __grid_constant__ Table t, const Points p, const float* __restrict__ grad_out) {
  __shared__ int s_x0[kThreads], s_y0[kThreads], s_n[kThreads], s_warp[kThreads / 32];
  __shared__ float s_w[kThreads][4];
  __shared__ float s_g[kThreads][kPassChannels];
  int j = 0;
  while (j + 1 < t.n && static_cast<int>(blockIdx.x) >= t.m[j + 1].first_block) ++j;
  const Map& m = t.m[j];
  const int local = blockIdx.x - m.first_block;
  const int pass = local % m.passes, tile = local / m.passes;
  const int ty = (tile / m.tiles_x) * kTile, tx = (tile % m.tiles_x) * kTile;
  const int py = ty + threadIdx.x / kTile, px = tx + threadIdx.x % kTile;
  const bool active = py < m.h && px < m.w;
  const int ch0 = pass * kPassChannels, nch = min(kPassChannels, m.c - ch0);
  const long long s = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[kPassChannels];
#pragma unroll
  for (int cc = 0; cc < kPassChannels; ++cc) acc[cc] = 0.f;

  for (long long base = 0; base < p.N; base += kThreads) {
    // ---- the chunk's points whose corners touch the tile, in point order
    const long long n = base + threadIdx.x;
    float wt[4];
    int x0 = 0, y0 = 0;
    bool touch = false;
    if (n < p.N) {
      const float* q = p.xy + s * p.xv + n * p.xn;
      int yc[4], xc[4];
      corners(q[0], q[p.xk], m.h, m.w, p.align_corners, wt, yc, xc, &x0, &y0);
      touch = x0 + 1 >= tx && x0 < tx + kTile && y0 + 1 >= ty && y0 < ty + kTile;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, touch);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int slot = __popc(ballot & ((1u << lane) - 1u)), total = 0;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) {
      slot += k < warp ? s_warp[k] : 0;
      total += s_warp[k];
    }
    if (touch) {
      s_x0[slot] = x0;
      s_y0[slot] = y0;
      s_n[slot] = static_cast<int>(n - base);
#pragma unroll
      for (int k = 0; k < 4; ++k) s_w[slot][k] = wt[k];
    }
    __syncthreads();
    // ---- their gradient rows, this pass's channels
    for (int e = threadIdx.x; e < total * kPassChannels; e += kThreads) {
      const int i = e / kPassChannels, cc = e % kPassChannels;
      s_g[i][cc] = cc < nch ? grad_out[s * p.rv + (base + s_n[i]) * p.rn + m.offset + ch0 + cc] : 0.f;
    }
    __syncthreads();
    // ---- each pixel adds the shares of the points it is a corner of
    if (active) {
      for (int i = 0; i < total; ++i) {
        const unsigned dx = px - s_x0[i], dy = py - s_y0[i];
        if (dx > 1u || dy > 1u) continue;
        const float w = s_w[i][dy * 2 + dx];
#pragma unroll
        for (int cc = 0; cc < kPassChannels; ++cc) acc[cc] = __fadd_rn(acc[cc], __fmul_rn(s_g[i][cc], w));
      }
    }
    __syncthreads();
  }
  if (active) {
    float* dst = m.grad + s * m.gv + py * m.gr + px * m.gc + ch0 * m.gch;
#pragma unroll
    for (int cc = 0; cc < kPassChannels; ++cc)
      if (cc < nch) dst[cc * m.gch] = acc[cc];
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<unsigned long long>(ptr) % 16 == 0; }

// The table from the wrapper's words; false where a map is malformed.
bool make_table(const long long* desc, int n_maps, const float* rows, long long rv, long long rn,
                bool need_grad, Table* t) {
  if (n_maps < 1 || n_maps > kMaxMaps) return false;
  t->n = n_maps;
  const bool rows4 = aligned16(rows) && rv % 4 == 0 && rn % 4 == 0;
  long long blocks = 0;
  for (int j = 0; j < n_maps; ++j) {
    const long long* d = desc + j * kDescWords;
    Map& m = t->m[j];
    m.src = reinterpret_cast<const float*>(d[0]);
    m.grad = reinterpret_cast<float*>(d[1]);
    m.h = static_cast<int>(d[2]);
    m.w = static_cast<int>(d[3]);
    m.c = static_cast<int>(d[4]);
    m.offset = static_cast<int>(d[5]);
    m.sv = d[6]; m.sr = d[7]; m.sc = d[8]; m.sch = d[9];
    m.gv = d[10]; m.gr = d[11]; m.gc = d[12]; m.gch = d[13];
    if (m.h < 1 || m.w < 1 || m.c < 1 || m.offset < 0) return false;
    if (need_grad ? m.grad == nullptr : m.src == nullptr) return false;
    m.units4 = rows4 && m.c % 4 == 0 && m.offset % 4 == 0;
    // a unit's 4 channels from any multiple of 4 are one aligned float4
    m.vec_src = m.src != nullptr && aligned16(m.src) && m.sch == 1 && m.sv % 4 == 0 && m.sr % 4 == 0 &&
                m.sc % 4 == 0;
    m.tiles_x = (m.w + kTile - 1) / kTile;
    m.passes = (m.c + kPassChannels - 1) / kPassChannels;
    m.first_block = static_cast<int>(blocks);
    blocks += static_cast<long long>(m.tiles_x) * ((m.h + kTile - 1) / kTile) * m.passes;
    if (blocks >= (1LL << 31)) return false;
  }
  return true;
}

int bwd_blocks(const Table& t) {
  const Map& m = t.m[t.n - 1];
  return m.first_block + m.tiles_x * ((m.h + kTile - 1) / kTile) * m.passes;
}

Points make_points(const float* xy, long long xv, long long xn, long long xk, long long S,
                   long long N, long long rv, long long rn, int align_corners) {
  Points p;
  p.xy = xy; p.xv = xv; p.xn = xn; p.xk = xk;
  p.S = S; p.N = N; p.rv = rv; p.rn = rn;
  p.align_corners = align_corners != 0;
  return p;
}

}  // namespace

// out (S, N, F) rows with strides (rv, rn, 1); desc: kDescWords int64 per map.
extern "C" int view_sample_fwd(const long long* desc, int n_maps, const float* xy, long long xv,
                               long long xn, long long xk, long long S, long long N, int align_corners,
                               float* out, long long rv, long long rn, void* stream) {
  Table t;
  if (S < 0 || N < 0 || !make_table(desc, n_maps, out, rv, rn, false, &t)) return cudaErrorInvalidValue;
  if (S * N == 0) return cudaSuccess;
  const Points p = make_points(xy, xv, xn, xk, S, N, rv, rn, align_corners);
  const dim3 grid(static_cast<unsigned>((S * N + kThreads - 1) / kThreads), n_maps);
  view_sample_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, p, out);
  return cudaGetLastError();
}

// Writes every pixel of the gradient each map's entry names; grad_out
// (S, N, F) rows with strides (rv, rn, 1). S at most 65535.
extern "C" int view_sample_bwd(const long long* desc, int n_maps, const float* xy, long long xv,
                               long long xn, long long xk, long long S, long long N, int align_corners,
                               const float* grad_out, long long rv, long long rn, void* stream) {
  Table t;
  if (S < 0 || S > 65535 || N < 0 || !make_table(desc, n_maps, grad_out, rv, rn, true, &t))
    return cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  const Points p = make_points(xy, xv, xn, xk, S, N, rv, rn, align_corners);
  const dim3 grid(static_cast<unsigned>(bwd_blocks(t)), static_cast<unsigned>(S));
  view_sample_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, p, grad_out);
  return cudaGetLastError();
}
