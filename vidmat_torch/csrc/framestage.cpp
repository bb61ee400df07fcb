// framestage: host-side frame staging of the port's video pipeline
// (counterpart of native/framestage.cpp, the JAX package's native tier).
//
// Host code, not a kernel: it sits between the decoder and the H2D copy.
//   vm_pad_into   edge-pads one (h, w, c) uint8 frame (c = 3, or 4 for a
//                 frame carrying its trimap; any row and pixel stride) at
//                 the bottom and right straight into a caller's contiguous
//                 (out_h, out_w, c) buffer, a slot of the pipeline's
//                 pinned host chunk; rows split over up to `threads` OpenMP
//                 threads (0: up to 4).
//   vm_unpack_rgba copies packed RGBA words (R | G<<8 | B<<16 | A<<24, the
//                 composite kernels' output) to interleaved uint8 RGBA: a
//                 byte copy on a little-endian host, split over threads, for
//                 writers that need an owned buffer.
//
// A plain C interface, built with g++ -fopenmp and loaded with ctypes
// (vidmat_torch/io/native.py), which releases the GIL for the call.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>

namespace {

// Rows [y0, y1) of the padded frame.
void pad_rows(const uint8_t* src, int64_t h, int64_t w, int64_t c,
              int64_t stride0, int64_t stride1, uint8_t* dst, int64_t out_w,
              int64_t y0, int64_t y1) {
  const int64_t row_bytes = out_w * c;
  for (int64_t y = y0; y < y1; ++y) {
    // Rows below the frame repeat its last row (edge padding).
    const uint8_t* s = src + std::min(y, h - 1) * stride0;
    uint8_t* d = dst + y * row_bytes;
    if (stride1 == c) {
      std::memcpy(d, s, w * c);
    } else {
      for (int64_t x = 0; x < w; ++x)
        std::memcpy(d + x * c, s + x * stride1, c);
    }
    // Columns right of the frame repeat its last pixel.
    const uint8_t* edge = d + (w - 1) * c;
    for (int64_t x = w; x < out_w; ++x) std::memcpy(d + x * c, edge, c);
  }
}

// Threads a call splits its rows over by default: up to 4, fewer on a
// smaller host.
int default_threads() {
  static const int n = static_cast<int>(
      std::min(4u, std::max(1u, std::thread::hardware_concurrency())));
  return n;
}

// Run fn(lo, hi) over [0, n) split into at most `threads` ranges (0: the
// default) of at least `grain` items, on OpenMP's threads (its runtime
// keeps them across calls).
template <typename F>
void parallel_rows(int64_t n, int64_t grain, int threads, F fn) {
  const int cap = threads > 0 ? threads : default_threads();
  const int parts = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(cap, n / grain)));
  const int64_t step = (n + parts - 1) / parts;
#pragma omp parallel for num_threads(parts) schedule(static, 1)
  for (int part = 0; part < parts; ++part) {
    const int64_t lo = part * step;
    if (lo < n) fn(lo, std::min(lo + step, n));
  }
}

}  // namespace

extern "C" {

// Returns 0, or 1 on shapes it does not take (empty frame, frame larger
// than the buffer, c not 3 or 4). threads: at most that many (0: the
// default).
int vm_pad_into(const uint8_t* src, int64_t h, int64_t w, int64_t c,
                int64_t stride0, int64_t stride1, uint8_t* dst,
                int64_t out_h, int64_t out_w, int threads) {
  if (h <= 0 || w <= 0 || h > out_h || w > out_w || c < 3 || c > 4)
    return 1;
  parallel_rows(out_h, 64, threads,
                [=](int64_t lo, int64_t hi) {
                  pad_rows(src, h, w, c, stride0, stride1, dst, out_w, lo,
                           hi);
                });
  return 0;
}

// n packed words -> 4 n bytes.
int vm_unpack_rgba(const uint32_t* src, int64_t n, uint8_t* dst) {
  const uint8_t* s = reinterpret_cast<const uint8_t*>(src);
  parallel_rows(n, 1 << 18, 0,
                [=](int64_t lo, int64_t hi) {
                  std::memcpy(dst + lo * 4, s + lo * 4, (hi - lo) * 4);
                });
  return 0;
}

}  // extern "C"
