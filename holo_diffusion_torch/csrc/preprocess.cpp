// Host code of the CO3D loader (data/co3d.py, native/__init__.py): crop +
// bilinear resize of uint8 frames, the compact-source composite + resize
// (data/compact.py), the tight mask box, and PNG row unfiltering
// (data/image_io.py).
//
// A copy of holo_diffusion_tpu/native/csrc/preprocess.cpp (the crop/resize,
// compact-source and mask-box functions are unchanged, so both give the same
// bits), plus hd_png_unfilter. Plain C ABI, loaded with
// ctypes; built by ops/_build.py with
//   g++ -O3 -shared -fPIC -std=c++17 -pthread
// ctypes releases the interpreter lock around every call, so the loader's
// decode threads run these in parallel.

#include <algorithm>
#include <cmath>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Bilinear sample with align_corners=false semantics (matches
// ops/image.py::bilinear_sample_ndc and PIL.Image.BILINEAR up to its
// box-filter differences; the reference grid convention).
inline float sample_bilinear(const uint8_t* src, int H, int W, int C,
                             float fy, float fx, int c) {
  int x0 = static_cast<int>(std::floor(fx));
  int y0 = static_cast<int>(std::floor(fy));
  float wx = fx - x0;
  float wy = fy - y0;
  float acc = 0.f;
  for (int dy = 0; dy < 2; ++dy) {
    int yi = y0 + dy;
    if (yi < 0 || yi >= H) continue;
    float wyv = dy ? wy : 1.f - wy;
    for (int dx = 0; dx < 2; ++dx) {
      int xi = x0 + dx;
      if (xi < 0 || xi >= W) continue;
      float wxv = dx ? wx : 1.f - wx;
      acc += wyv * wxv * src[(yi * W + xi) * C + c];
    }
  }
  return acc;
}

void crop_resize_one(const uint8_t* src, int H, int W, int C, int x0, int y0,
                     int x1, int y1, float* dst, int outH, int outW,
                     float scale) {
  const int cw = x1 - x0;
  const int ch = y1 - y0;
  const float sx = static_cast<float>(cw) / outW;
  const float sy = static_cast<float>(ch) / outH;
  for (int oy = 0; oy < outH; ++oy) {
    const float fy = y0 + (oy + 0.5f) * sy - 0.5f;
    for (int ox = 0; ox < outW; ++ox) {
      const float fx = x0 + (ox + 0.5f) * sx - 0.5f;
      for (int c = 0; c < C; ++c) {
        dst[(oy * outW + ox) * C + c] =
            sample_bilinear(src, H, W, C, fy, fx, c) * scale;
      }
    }
  }
}

// Compact-source kernel (data/compact.py): fg-threshold composite onto
// bg_color applied to each of the 4 bilinear corner reads — i.e. EXACTLY
// mask-at-full-res-then-resize (the reference preprocess order,
// holo_diffusion_model preprocessing -> extractor rescale) in ONE pass with
// no full-res intermediate (numpy `where` over 33x800^2x3 costs seconds on a
// 1-core host; this runs in ~60 ms). Outputs uint8 (round-to-nearest).
void compact_source_one(const uint8_t* img, const uint8_t* fg, int H, int W,
                        int C, uint8_t* dimg, uint8_t* dfg, int outH,
                        int outW, float thr255, const float* bg255,
                        int mask_images) {
  const float sx = static_cast<float>(W) / outW;
  const float sy = static_cast<float>(H) / outH;
  for (int oy = 0; oy < outH; ++oy) {
    const float fy = (oy + 0.5f) * sy - 0.5f;
    const int y0 = static_cast<int>(std::floor(fy));
    const float wy = fy - y0;
    for (int ox = 0; ox < outW; ++ox) {
      const float fx = (ox + 0.5f) * sx - 0.5f;
      const int x0 = static_cast<int>(std::floor(fx));
      const float wx = fx - x0;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};  // C <= 4
      float accfg = 0.f;
      for (int dy = 0; dy < 2; ++dy) {
        const int yi = y0 + dy;
        if (yi < 0 || yi >= H) continue;
        const float wyv = dy ? wy : 1.f - wy;
        for (int dx = 0; dx < 2; ++dx) {
          const int xi = x0 + dx;
          if (xi < 0 || xi >= W) continue;
          const float w = wyv * (dx ? wx : 1.f - wx);
          const uint8_t* p = img + (static_cast<size_t>(yi) * W + xi) * C;
          const bool in_fg = !fg || fg[static_cast<size_t>(yi) * W + xi] > thr255;
          if (mask_images && !in_fg) {
            for (int c = 0; c < C; ++c) acc[c] += w * bg255[c];
          } else {
            for (int c = 0; c < C; ++c) acc[c] += w * p[c];
          }
          if (in_fg && fg) accfg += w * 255.f;
        }
      }
      uint8_t* o = dimg + (static_cast<size_t>(oy) * outW + ox) * C;
      for (int c = 0; c < C; ++c)
        o[c] = static_cast<uint8_t>(
            std::min(255.f, std::max(0.f, std::nearbyint(acc[c]))));
      if (dfg)
        dfg[static_cast<size_t>(oy) * outW + ox] = static_cast<uint8_t>(
            std::min(255.f, std::max(0.f, std::nearbyint(accfg))));
    }
  }
}

}  // namespace

extern "C" {

// Crop [x0,y0,x1,y1) from (H, W, C) uint8, bilinear-resize to (outH, outW),
// scale (e.g. 1/255) into float32 dst.
void hd_crop_resize_u8(const uint8_t* src, int H, int W, int C, int x0, int y0,
                       int x1, int y1, float* dst, int outH, int outW,
                       float scale) {
  crop_resize_one(src, H, W, C, x0, y0, x1, y1, dst, outH, outW, scale);
}

// Same crop+resize with uint8 output, BIT-IDENTICAL to quantizing the f32
// path after the fact (data/co3d.py compact cache did
// clip(round(f32 * 255), 0, 255) over the STACKED scene — several seconds of
// pure dtype traffic per cold scene on a 1-core host). The two f32 multiplies
// (acc*scale, then *255) and round-half-to-even (rintf == numpy round) are
// kept in the numpy order so compact == quantize(full) exactly.
void hd_crop_resize_u8_out(const uint8_t* src, int H, int W, int C, int x0,
                           int y0, int x1, int y1, uint8_t* dst, int outH,
                           int outW, float scale) {
  const int cw = x1 - x0;
  const int ch = y1 - y0;
  const float sx = static_cast<float>(cw) / outW;
  const float sy = static_cast<float>(ch) / outH;
  for (int oy = 0; oy < outH; ++oy) {
    const float fy = y0 + (oy + 0.5f) * sy - 0.5f;
    for (int ox = 0; ox < outW; ++ox) {
      const float fx = x0 + (ox + 0.5f) * sx - 0.5f;
      for (int c = 0; c < C; ++c) {
        const float v = sample_bilinear(src, H, W, C, fy, fx, c) * scale;
        float q = std::nearbyintf(v * 255.f);
        q = q < 0.f ? 0.f : (q > 255.f ? 255.f : q);
        dst[(static_cast<size_t>(oy) * outW + ox) * C + c] =
            static_cast<uint8_t>(q);
      }
    }
  }
}

// Batch version over N frames with a thread pool. Arrays are packed:
// srcs: N pointers; boxes: (N, 4) int32; dst: (N, outH, outW, C) float32.
void hd_crop_resize_batch_u8(const uint8_t** srcs, const int* HWs,
                             const int* boxes, int N, int C, float* dst,
                             int outH, int outW, float scale, int n_threads) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= N) break;
      const int H = HWs[2 * i];
      const int W = HWs[2 * i + 1];
      const int* b = boxes + 4 * i;
      crop_resize_one(srcs[i], H, W, C, b[0], b[1], b[2], b[3],
                      dst + static_cast<size_t>(i) * outH * outW * C, outH,
                      outW, scale);
    }
  };
  if (n_threads <= 1 || N == 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  const int nt = std::min(n_threads, N);
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// Batch compact-source preprocess: per-frame composite+resize (see
// compact_source_one). imgs: N pointers to (H, W, C) u8; fgs: N pointers to
// (H, W) u8 masks or nullptr (then no masking and fg_dst untouched).
// img_dst: (N, outH, outW, C) u8; fg_dst: (N, outH, outW) u8 or nullptr.
void hd_compact_source_batch_u8(const uint8_t** imgs, const uint8_t** fgs,
                                const int* HWs, int N, int C,
                                uint8_t* img_dst, uint8_t* fg_dst, int outH,
                                int outW, float thr255, const float* bg255,
                                int mask_images, int n_threads) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= N) break;
      const int H = HWs[2 * i];
      const int W = HWs[2 * i + 1];
      compact_source_one(
          imgs[i], fgs ? fgs[i] : nullptr, H, W, C,
          img_dst + static_cast<size_t>(i) * outH * outW * C,
          fg_dst ? fg_dst + static_cast<size_t>(i) * outH * outW : nullptr,
          outH, outW, thr255, bg255, mask_images);
    }
  };
  if (n_threads <= 1 || N == 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  const int nt = std::min(n_threads, N);
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// Tight bbox around mask > thr, expanded by `context`, clamped; returns
// 1 when nonempty. mask: (H, W) float32.
int hd_mask_bbox(const float* mask, int H, int W, float thr, float context,
                 int* out_box) {
  int x0 = W, y0 = H, x1 = -1, y1 = -1;
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      if (mask[y * W + x] > thr) {
        x0 = std::min(x0, x);
        y0 = std::min(y0, y);
        x1 = std::max(x1, x);
        y1 = std::max(y1, y);
      }
    }
  }
  if (x1 < 0) return 0;
  x1 += 1;
  y1 += 1;
  const int w = x1 - x0, h = y1 - y0;
  // match numpy round-half-to-even used by the python path
  auto round_even = [](float v) {
    return static_cast<int>(std::nearbyint(v));
  };
  const int dx = round_even(w * context);
  const int dy = round_even(h * context);
  out_box[0] = std::max(0, x0 - dx);
  out_box[1] = std::max(0, y0 - dy);
  out_box[2] = std::min(W, x1 + dx);
  out_box[3] = std::min(H, y1 + dy);
  return 1;
}

// Undo the PNG row filters in place (PNG spec, section 9): `data` holds
// `h` rows of 1 filter-type byte then `stride` bytes; `bpp` is the bytes of
// one pixel (1 for 8-bit gray, 2 for 16-bit). The unfiltered rows are
// written to `out` (h x stride). Returns the first row whose filter type is
// not 0-4, or -1.
int hd_png_unfilter(const uint8_t* data, int h, int stride, int bpp,
                    uint8_t* out) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* f = data + static_cast<size_t>(y) * (stride + 1);
    const uint8_t type = f[0];
    const uint8_t* in = f + 1;
    uint8_t* o = out + static_cast<size_t>(y) * stride;
    const uint8_t* up = y ? o - stride : nullptr;
    switch (type) {
      case 0:
        std::memcpy(o, in, stride);
        break;
      case 1:
        for (int i = 0; i < stride; ++i)
          o[i] = in[i] + (i >= bpp ? o[i - bpp] : 0);
        break;
      case 2:
        for (int i = 0; i < stride; ++i) o[i] = in[i] + (up ? up[i] : 0);
        break;
      case 3:
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? o[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          o[i] = in[i] + static_cast<uint8_t>((a + b) >> 1);
        }
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? o[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          o[i] = in[i] + static_cast<uint8_t>(pred);
        }
        break;
      default:
        return y;
    }
  }
  return -1;
}

}  // extern "C"
