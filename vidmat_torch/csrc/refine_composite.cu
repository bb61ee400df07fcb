// Fused guided refine + composite + RGBA pack at full resolution:
//   A, B   = bilinear (half-pixel, edge-clamped) x pool upsample of the
//            coarse coefficient grids mean_a, mean_b ([alpha, r, g, b])
//   guide  = (0.299 R + 0.587 G + 0.114 B) / 255 of the uint8 frame
//   alpha  = clip(A0 * guide + B0), fgr_c = clip(Ac * guide + Bc)
//   rgb_c  = fgr_c * alpha + bg_c * (1 - alpha), bg_c one of
//              color   a constant
//              image   bg[y, x, c] of an (h, w, 3) float image, unclipped
//              coarse  clip(upsample(bg_lr)[y, x, c]): an (hl, wl, 3) grid
//                      per frame, upsampled exactly as the coefficients
//          | fgr_c * alpha                        (no background)
//   word   = R | G << 8 | B << 16 | A << 24, each round(clip(v) * 255)
//            with round-half-to-even (__float2int_rn, as jnp.round)
//
// Replaces the TPU kernel vidmat/ops/pallas/refine_kernel.py
// fused_refine_composite (_refine_kernel), all four background modes. The
// TPU kernel upsamples with banded matmuls over VMEM-resident coefficient
// grids.
//
// Pool 4 (the main path), w % 4 == 0, aligned pointers: a warp owns a strip
// of 124 output columns and 2 consecutive rows of one frame, and works
// without barriers or shared memory:
//   - lane l (0-30) owns output pixels 4j+2 .. 4j+5, whose taps are the
//     same two coarse columns j and j+1 (weights 1/8, 3/8, 5/8, 7/8 of
//     j+1); it row-lerps column j, all 8 channels, once per row, from 4
//     16-byte loads of the two coarse rows (loaded once for both rows,
//     which share them), and takes column j+1 from lane l+1 by shuffle
//     (lane 31 only row-lerps);
//   - src_index runs once per row (per warp) and once per pixel column
//     (per lane, for both rows), with the pool the constant 4 so the
//     division compiles to a product (the runtime pool's IEEE divisions
//     measured slower: planar_knockouts.py --tail, "divisions");
//   - a lane reads its 12 frame bytes (both rows', first) as four 32-bit
//     words and writes its 4 packed words as two 8-byte stores; an image
//     background is six 8-byte loads;
//   - where a weight is 1/8 its product is exact, so a fused multiply-add
//     gives the two-step value with one instruction fewer;
//   - the frame's first and last two pixels (clamped taps) take the same
//     taps by selection.
// Designs that measured slower on the main path's 4-frame chunk
// (planar_knockouts.py --tail and --parent): 16 x 128 tiles with
// staged coefficients and row lerps in shared memory between block
// barriers (0.051-0.056 ms; the phases barely overlapped), and 4-pixel
// groups aligned to x = 4j, which need columns j-1, j and j+1 and twice
// the shuffles (0.053-0.056 ms).
//
// Other pools, widths and alignments: one thread per output pixel, taps
// read from the grids (through the caches) in the same order.
//
// Bound: bytes. At 1088x1920 from a 272x480 grid, per frame: 6.3 MB of
// frame and 4.2 MB of coefficients read, 8.4 MB of packed words written;
// an image adds 25.1 MB read, a coarse background 1.6 MB. The arithmetic
// (~53 rounded FP32 operations a pixel under --fmad=false, about 0.015 ms
// of a 4-frame chunk's issue) is close behind: byte-to-float conversions
// are byte permutes and the rounding to bytes an add of 1.5 * 2^23
// (refine_common.cuh), so the slow conversion unit is not used.
//
// Arithmetic order is the TPU kernel's and the per-pixel kernel's: the row
// lerp, then the column lerp, each product and sum rounded
// (--fmad=false), so the packed bytes equal that kernel's.

#include "refine_common.cuh"

namespace {

using refine::Bg;
using refine::next_lane;

// The background mode is a template parameter, so each mode carries none
// of the other modes' code or registers.
enum Mode { kNone, kColor, kImage, kCoarse };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPx = 4;              // pixels a lane owns
constexpr int kOwners = 31;         // lanes that own pixels
constexpr int kRows = 2;            // rows a warp owns
constexpr float kPool = 4.0f;       // the strip path's pool, a constant

struct Geom {
  int h, w, hl, wl;
  float pool;
};

struct Args {
  const uint8_t* frame;
  const float4* ma;
  const float4* mb;
  uint32_t* out;
  Bg bg;                    // kColor: the color
  const float* bg_img;      // kImage: (h, w, 3) per frame
  long long bg_img_stride;  // floats between frames' images (0: shared)
  const float* bg_lr;       // kCoarse: (n, hl, wl, 3)
};

// A lerp (1 - f) p + f q, each product and the sum rounded. KIND 1: f is
// 1/8, KIND 2: 1 - f is 1/8. That product is then exact (for normal q or
// p), so one fused multiply-add gives the same value with one
// instruction fewer.
template <int KIND>
__device__ __forceinline__ float lerp1k(float p, float q, float f) {
  const float g = 1.0f - f;
  if constexpr (KIND == 1) return __fmaf_rn(f, q, g * p);
  if constexpr (KIND == 2) return __fmaf_rn(g, p, f * q);
  return g * p + f * q;
}

template <int KIND>
__device__ __forceinline__ float4 lerp4k(float4 p, float4 q, float f) {
  return make_float4(lerp1k<KIND>(p.x, q.x, f), lerp1k<KIND>(p.y, q.y, f),
                     lerp1k<KIND>(p.z, q.z, f), lerp1k<KIND>(p.w, q.w, f));
}

// lerp4k with the kind the weight allows (f is the same across a warp).
__device__ __forceinline__ float4 lerp4_any(float4 p, float4 q, float f) {
  if (f == 0.125f) return lerp4k<1>(p, q, f);
  if (f == 0.875f) return lerp4k<2>(p, q, f);
  return lerp4k<0>(p, q, f);
}

// One packed word from the row-lerped taps of a pixel (lo, hi: the coarse
// columns on both sides, weight f of hi, lerped as KIND allows), its luma
// and its background.
template <int MODE, int KIND>
__device__ __forceinline__ uint32_t shade(float4 alo, float4 ahi,
                                          float4 blo, float4 bhi, float f,
                                          float lum, float3 bgc) {
  const float4 A = lerp4k<KIND>(alo, ahi, f);
  const float4 B = lerp4k<KIND>(blo, bhi, f);
  const float alpha = refine::add_sat(A.x * lum, B.x);
  const float fgr[3] = {refine::add_sat(A.y * lum, B.y),
                        refine::add_sat(A.z * lum, B.z),
                        refine::add_sat(A.w * lum, B.w)};
  const float bgv[3] = {bgc.x, bgc.y, bgc.z};
  uint32_t q[3];
  if constexpr (MODE == kNone) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      q[c] = refine::quant_bits(refine::mul_sat(fgr[c], alpha));
  } else {
    const float om = 1.0f - alpha;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      q[c] = refine::quant_bits(refine::add_sat(fgr[c] * alpha, bgv[c] * om));
  }
  return refine::pack_rgba(q[0], q[1], q[2], refine::quant_bits(alpha));
}

// The clipped column lerp of a coarse background's row-lerped taps.
__device__ __forceinline__ float3 coarse_bg(float4 lo, float4 hi, float f) {
  const float g = 1.0f - f;
  return make_float3(refine::add_sat(g * lo.x, f * hi.x),
                     refine::add_sat(g * lo.y, f * hi.y),
                     refine::add_sat(g * lo.z, f * hi.z));
}

// Column x of row y of a 3-channel coarse grid (wl x 3 floats a row), in
// .x-.z.
__device__ __forceinline__ float4 tap3(const float* __restrict__ grid,
                                       int wl, int y, int x) {
  const float* p = grid + ((long long)y * wl + x) * 3;
  return make_float4(p[0], p[1], p[2], 0.0f);
}

// Pool 4, w % 4 == 0, frame 4-byte and out and bg_img 16-byte aligned.
template <int MODE>
__device__ __forceinline__ void strip_body(const Geom& g, const Args& a) {
  constexpr bool kC = MODE == kCoarse;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.z;
  const int y_first = (blockIdx.y * kWarps + threadIdx.x / 32) * kRows;
  if (y_first >= g.h) return;  // the whole warp
  // Lane l (0-30) owns pixels 4j + 2 .. 4j + 5 of column j = 31 k - 1 + l
  // (strip k); lane 31 only row-lerps column j for lane 30.
  const int j = blockIdx.x * kOwners - 1 + lane;
  const int x = kPx * j + 2;
  const bool full = lane < kOwners && x >= 0 && x + kPx <= g.w;
  const bool some = lane < kOwners && x + kPx > 0 && x < g.w;
  const int col = min(max(j, 0), g.wl - 1);
  const long long plane = (long long)g.h * g.w;

  // Both rows' frame bytes first: the 4 words from byte 3 x - 2 (4-byte
  // aligned, and inside the row: x = 4j + 2 <= w - 6), whose bytes 2-13
  // are the 4 pixels'.
  uint32_t fw[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(
        a.frame + (b * plane + (long long)(y_first + r) * g.w + x) * 3 - 2);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      fw[r][k] = full && y_first + r < g.h ? src[k] : 0u;
  }

  // The taps of the lane's column on the first row's two coarse rows
  // (the rows of a pair at pool 4 share them).
  int y0, y1;
  float fy;
  refine::src_index(y_first, g.hl, kPool, &y0, &y1, &fy);
  const float* cgrid = a.bg_lr + (long long)b * g.hl * g.wl * 3;
  auto taps = [&](int t0, int t1, float4* t) {
    const long long r0 = ((long long)b * g.hl + t0) * g.wl + col;
    const long long r1 = ((long long)b * g.hl + t1) * g.wl + col;
    t[0] = a.ma[r0];
    t[1] = a.ma[r1];
    t[2] = a.mb[r0];
    t[3] = a.mb[r1];
    if constexpr (kC) {
      t[4] = tap3(cgrid, g.wl, t0, col);
      t[5] = tap3(cgrid, g.wl, t1, col);
    }
  };
  float4 t[kC ? 6 : 4];
  taps(y0, y1, t);

  // Interior pixels take columns j and j + 1 with weights 1/8, 3/8, 5/8,
  // 7/8 of j + 1 (pattern); the frame's first two and last two pixels
  // are clamped: both taps on one column (weight 0 on the other).
  int d0[kPx], d1[kPx];
  float fx[kPx];
  bool pat = full;
#pragma unroll
  for (int q = 0; q < kPx; ++q) {
    int x0 = 0, x1 = 0;
    float f = 0.0f;
    if (some && x + q >= 0 && x + q < g.w)
      refine::src_index(x + q, g.wl, kPool, &x0, &x1, &f);
    d0[q] = x0 - j;
    d1[q] = f == 0.0f ? d0[q] : x1 - j;
    fx[q] = f;
    pat = pat && d0[q] == 0 && d1[q] == 1;
  }
  pat = pat && fx[0] == 0.125f && fx[3] == 0.875f;

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = y_first + r;
    if (y >= g.h) break;
    if (r > 0) {
      int r0, r1;
      refine::src_index(y, g.hl, kPool, &r0, &r1, &fy);
      if (r0 != y0 || r1 != y1) {  // never at pool 4; the whole warp
        y0 = r0;
        y1 = r1;
        taps(y0, y1, t);
      }
    }
    const float4 ra = lerp4_any(t[0], t[1], fy);
    const float4 rb = lerp4_any(t[2], t[3], fy);
    const float4 ra_p = next_lane(ra), rb_p = next_lane(rb);
    float4 rc, rc_p;
    if constexpr (kC) {
      rc = lerp4_any(t[4], t[5], fy);
      rc_p = next_lane(rc);
    }
    if (!some) continue;
    const long long prow = b * plane + (long long)y * g.w + x;
    float3 bgc = make_float3(a.bg.rgb[0], a.bg.rgb[1], a.bg.rgb[2]);
    if (pat) {
      float lum[kPx];
#pragma unroll
      for (int q = 0; q < kPx; ++q)
        lum[q] = refine::strip_luma(fw[r], q);
      float im[3 * kPx];
      if constexpr (MODE == kImage) {
        // 8-byte aligned: x = 4 j + 2
        const float2* src = reinterpret_cast<const float2*>(
            a.bg_img + b * a.bg_img_stride + ((long long)y * g.w + x) * 3);
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const float2 v = src[k];
          im[2 * k] = v.x;
          im[2 * k + 1] = v.y;
        }
      }
      // fx = 1/8, 3/8, 5/8, 7/8: pixels 0 and 3 lerp with one
      // multiply-add a channel.
      uint32_t word[kPx];
#pragma unroll
      for (int q = 0; q < kPx; ++q) {
        if constexpr (MODE == kImage)
          bgc = make_float3(im[3 * q], im[3 * q + 1], im[3 * q + 2]);
        if constexpr (kC) bgc = coarse_bg(rc, rc_p, fx[q]);
        word[q] = q == 0   ? shade<MODE, 1>(ra, ra_p, rb, rb_p, fx[q],
                                            lum[q], bgc)
                  : q == 3 ? shade<MODE, 2>(ra, ra_p, rb, rb_p, fx[q],
                                            lum[q], bgc)
                           : shade<MODE, 0>(ra, ra_p, rb, rb_p, fx[q],
                                            lum[q], bgc);
      }
      uint2* o = reinterpret_cast<uint2*>(a.out + prow);  // 8-byte aligned
      o[0] = make_uint2(word[0], word[1]);
      o[1] = make_uint2(word[2], word[3]);
    } else {
#pragma unroll
      for (int q = 0; q < kPx; ++q) {
        if (x + q < 0 || x + q >= g.w) continue;
        if constexpr (MODE == kImage) {
          const float* p = a.bg_img + b * a.bg_img_stride +
                           ((long long)y * g.w + x + q) * 3;
          bgc = make_float3(p[0], p[1], p[2]);
        }
        if constexpr (kC)
          bgc = coarse_bg(d0[q] ? rc_p : rc, d1[q] ? rc_p : rc, fx[q]);
        a.out[prow + q] = shade<MODE, 0>(
            d0[q] ? ra_p : ra, d1[q] ? ra_p : ra, d0[q] ? rb_p : rb,
            d1[q] ? rb_p : rb, fx[q], refine::luma(a.frame + (prow + q) * 3),
            bgc);
      }
    }
  }
}

// Any pool, width and alignment: one thread per output pixel.
template <int MODE>
__device__ __forceinline__ void pixel_body(const Geom& g, const Args& a) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= g.w) return;
  int x0, x1, y0, y1;
  float fx, fy;
  refine::src_index(x, g.wl, g.pool, &x0, &x1, &fx);
  refine::src_index(y, g.hl, g.pool, &y0, &y1, &fy);
  const long long r0 = ((long long)b * g.hl + y0) * g.wl;
  const long long r1 = ((long long)b * g.hl + y1) * g.wl;
  const long long pix = ((long long)b * g.h + y) * g.w + x;
  float3 bgc = make_float3(a.bg.rgb[0], a.bg.rgb[1], a.bg.rgb[2]);
  if constexpr (MODE == kImage) {
    const float* p =
        a.bg_img + b * a.bg_img_stride + ((long long)y * g.w + x) * 3;
    bgc = make_float3(p[0], p[1], p[2]);
  } else if constexpr (MODE == kCoarse) {
    const float* grid = a.bg_lr + (long long)b * g.hl * g.wl * 3;
    bgc = coarse_bg(
        refine::lerp4(tap3(grid, g.wl, y0, x0), tap3(grid, g.wl, y1, x0), fy),
        refine::lerp4(tap3(grid, g.wl, y0, x1), tap3(grid, g.wl, y1, x1), fy),
        fx);
  }
  a.out[pix] = shade<MODE, 0>(refine::lerp4(a.ma[r0 + x0], a.ma[r1 + x0], fy),
                           refine::lerp4(a.ma[r0 + x1], a.ma[r1 + x1], fy),
                           refine::lerp4(a.mb[r0 + x0], a.mb[r1 + x0], fy),
                           refine::lerp4(a.mb[r0 + x1], a.mb[r1 + x1], fy),
                           fx, refine::luma(a.frame + pix * 3), bgc);
}

// At most 80 registers (three blocks an SM): the coarse mode's strip
// body would take more and run slower.
template <int MODE, bool STRIP>
__global__ void __launch_bounds__(kThreads, 3)
    refine_composite_kernel(Geom g, Args a) {
  if constexpr (STRIP)
    strip_body<MODE>(g, a);
  else
    pixel_body<MODE>(g, a);
}

template <int MODE>
cudaError_t launch(bool strip, int n, const Geom& g, const Args& a,
                   cudaStream_t stream) {
  if (strip) {
    const dim3 grid((g.w + 2 + kOwners * kPx - 1) / (kOwners * kPx),
                    (g.h + kWarps * kRows - 1) / (kWarps * kRows), n);
    refine_composite_kernel<MODE, true><<<grid, kThreads, 0, stream>>>(g, a);
  } else {
    const dim3 grid((g.w + kThreads - 1) / kThreads, g.h, n);
    refine_composite_kernel<MODE, false><<<grid, kThreads, 0, stream>>>(g, a);
  }
  return cudaGetLastError();
}

}  // namespace

// frame: (n, h, w, 3) uint8; mean_a, mean_b: (n, h/pool, w/pool, 4) f32;
// out: (n, h, w) uint32. At most one background:
//   bg_color   host array [r, g, b]
//   bg_img     device (h, w, 3) f32 image (bg_img_per_frame 0) or
//              (n, h, w, 3) images (bg_img_per_frame 1)
//   bg_coarse  device (n, h/pool, w/pool, 3) f32
// None: premultiplied output.
extern "C" int vm_refine_composite(const void* frame, const void* mean_a,
                                   const void* mean_b, void* out, int n,
                                   int h, int w, int pool, const float* bg,
                                   const void* bg_img, int bg_img_per_frame,
                                   const void* bg_coarse, void* stream) {
  if (n <= 0 || n > 65535 || h <= 0 || h > 65535 || w <= 0 || pool < 1 ||
      h % pool || w % pool ||
      (bg != nullptr) + (bg_img != nullptr) + (bg_coarse != nullptr) > 1)
    return (int)cudaErrorInvalidValue;
  const Geom g{h, w, h / pool, w / pool, (float)pool};
  Args a;
  a.frame = (const uint8_t*)frame;
  a.ma = (const float4*)mean_a;
  a.mb = (const float4*)mean_b;
  a.out = (uint32_t*)out;
  for (int c = 0; c < 3; ++c) a.bg.rgb[c] = bg ? bg[c] : 0.0f;
  a.bg_img = (const float*)bg_img;
  a.bg_img_stride = bg_img_per_frame ? (long long)h * w * 3 : 0;
  a.bg_lr = (const float*)bg_coarse;
  const bool strip = pool == 4 && w % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(frame) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(bg_img) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (bg_img) return (int)launch<kImage>(strip, n, g, a, s);
  if (bg_coarse) return (int)launch<kCoarse>(strip, n, g, a, s);
  if (bg) return (int)launch<kColor>(strip, n, g, a, s);
  return (int)launch<kNone>(strip, n, g, a, s);
}
