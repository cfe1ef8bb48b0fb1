// hostops: the host-side data-path loops of the port's input pipeline,
// C++ with OpenMP behind a plain C interface, loaded with ctypes
// (bigdl_tpu_torch/native/__init__.py).
//
// The port's own copy of bigdl_tpu/native/hostops.cpp (the functions the
// image transformers and the CIFAR-10 reader use), and the PNG decoder's
// scanline unfilter (hostops_png_unfilter, the port's own: byte integer
// arithmetic).  Every function is an element-wise fp32 copy
// or (x - mean) / std, so its output has the bits of the numpy expression
// it replaces; the build passes -ffp-contract=off so that no a * b + c is
// fused into one rounding.
//
// A loop takes an OpenMP team only when its image is large (kParallelMin
// elements), and then at most kMaxThreads threads: a team's threads spin
// between regions, and on a small image (a 28x28 digit) they cost more
// than the copy while taking the cores the training loop runs on.  Below
// kParallelMin the loop runs on the calling thread outside any OpenMP
// region: entering one, even with a team of one, costs more than the
// loop of a small image.
//
// Build (done at first use by the loader):
//   g++ -O3 -fopenmp -ffp-contract=off -shared -fPIC hostops.cpp -o libhostops.so

#include <omp.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t kParallelMin = 1 << 16;
constexpr int kMaxThreads = 4;

// body(i) for i in [0, n) of an image of `elems` elements
template <class Body>
void loop(int64_t n, int64_t elems, const Body& body) {
  if (elems < kParallelMin) {
    for (int64_t i = 0; i < n; ++i) body(i);
    return;
  }
  const int team = std::min(kMaxThreads, omp_get_max_threads());
#pragma omp parallel for num_threads(team)
  for (int64_t i = 0; i < n; ++i) body(i);
}

}  // namespace

extern "C" {

// out[i] = (in[i] - mean[i % c]) / std[i % c]: an HWC (c channels) or HW
// (c = 1) image, pixel by pixel
void hostops_normalize(const float* in, float* out, int64_t n,
                       const float* mean, const float* stddev, int64_t c) {
  if (c == 1) {
    const float m = mean[0], sd = stddev[0];
    loop(n, n, [&](int64_t i) { out[i] = (in[i] - m) / sd; });
    return;
  }
  loop(n / c, n, [&](int64_t p) {
    for (int64_t k = 0; k < c; ++k) {
      out[p * c + k] = (in[p * c + k] - mean[k]) / stddev[k];
    }
  });
}

// u8 -> f32 as in[i] * scale + shift (two roundings, as numpy's)
void hostops_u8_to_f32(const uint8_t* in, float* out, int64_t n,
                       float scale, float shift) {
  loop(n, n, [&](int64_t i) {
    out[i] = static_cast<float>(in[i]) * scale + shift;
  });
}

// HWC crop: src (h, w, c) -> dst (ch, cw, c) from (y0, x0)
void hostops_crop(const float* src, float* dst, int64_t h, int64_t w,
                  int64_t c, int64_t y0, int64_t x0, int64_t ch, int64_t cw) {
  (void)h;
  loop(ch, ch * cw * c, [&](int64_t y) {
    std::memcpy(dst + y * cw * c, src + ((y0 + y) * w + x0) * c,
                sizeof(float) * cw * c);
  });
}

// the columns of an HWC image mirrored (src != dst)
void hostops_hflip(const float* src, float* dst, int64_t h, int64_t w,
                   int64_t c) {
  loop(h, h * w * c, [&](int64_t y) {
    const float* row = src + y * w * c;
    float* to = dst + y * w * c;
    for (int64_t x = 0; x < w; ++x) {
      for (int64_t k = 0; k < c; ++k) to[x * c + k] = row[(w - 1 - x) * c + k];
    }
  });
}

// HWC -> CHW, dst one member of a batch buffer
void hostops_hwc_to_chw(const float* src, float* dst, int64_t h, int64_t w,
                        int64_t c) {
  loop(c, h * w * c, [&](int64_t k) {
    for (int64_t y = 0; y < h; ++y) {
      for (int64_t x = 0; x < w; ++x) {
        dst[(k * h + y) * w + x] = src[(y * w + x) * c + k];
      }
    }
  });
}

// CIFAR-10 binary records, n of (1 label byte + 3072 CHW pixel bytes) ->
// labels f32 (1-based, n) and images f32 HWC (n, 32, 32, 3)
void hostops_cifar_decode(const uint8_t* in, float* labels, float* images,
                          int64_t n) {
  constexpr int64_t kRec = 3073, kPlane = 1024;
  loop(n, n * (kRec - 1), [&](int64_t i) {
    const uint8_t* r = in + i * kRec;
    labels[i] = static_cast<float>(r[0]) + 1.0f;
    float* img = images + i * 3 * kPlane;
    for (int64_t p = 0; p < kPlane; ++p) {
      for (int64_t k = 0; k < 3; ++k) {
        img[p * 3 + k] = static_cast<float>(r[1 + k * kPlane + p]);
      }
    }
  });
}

// PNG scanline filters undone (RFC 2083 section 6): `raw` holds h rows
// of one filter-type byte and `stride` bytes, `out` gets the h rows of
// `stride` bytes, `bpp` the bytes of a pixel (bit depth 8).  The rows run
// in order (each reads the one above it).  Returns 0, or 1 + the index of
// the first row whose filter type is not 0-4 (the rows before it done).
int64_t hostops_png_unfilter(const uint8_t* raw, uint8_t* out, int64_t h,
                             int64_t stride, int64_t bpp) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* in = raw + y * (stride + 1);
    const uint8_t kind = in[0];
    ++in;
    uint8_t* row = out + y * stride;
    const uint8_t* up = y > 0 ? row - stride : nullptr;
    switch (kind) {
      case 0:
        std::memcpy(row, in, stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i) {
          row[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? row[i - bpp] : 0));
        }
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i) {
          row[i] = static_cast<uint8_t>(in[i] + (up ? up[i] : 0));
        }
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          row[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = p > a ? p - a : a - p;
          const int pb = p > b ? p - b : b - p;
          const int pc = p > c ? p - c : c - p;
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          row[i] = static_cast<uint8_t>(in[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

int hostops_version() { return 1; }

}  // extern "C"
