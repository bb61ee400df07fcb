// Composite + quantize + RGBA pack of full-resolution float mattes:
//   rgb_c = f_c * a + bg_c * (1 - a)   (color, shared image, per-frame image)
//         | f_c * a                    (no background: premultiplied)
//   word  = round(clip(rgb_r) * 255) | G << 8 | B << 16
//           | round(clip(a) * 255) << 24
// The RGB term uses alpha as given (unclipped), as the TPU kernel does;
// rounding is half to even (as jnp.round).
//
// Replaces the TPU kernel vidmat/ops/pallas/composite_kernel.py
// composite_rgba_packed (_composite_kernel), all four of its modes. The
// TPU kernel packs with integer shifts on planar (C, th, W) tiles to avoid
// lane padding.
//
// Here the contiguous NHWC inputs are indexed flat: pixel p of the batch
// is one index (a shared image's pixel is p mod h w, a per-frame image's
// p), and a thread owns a group of 4 pixels: one 16-byte load of alpha,
// three of fgr, three of an image, all issued before any arithmetic, and
// one 16-byte store of the 4 words. So a one-frame launch keeps 4-7
// 16-byte loads a thread in flight. The mode is a template parameter, so
// each mode compiles without the others' code and registers. The last
// n h w mod 4 pixels, groups whose shared-image pixels straddle two frames
// (h w mod 4 != 0) and inputs that are not 16-byte aligned take the
// scalar path, one pixel at a time, with the same arithmetic.
//
// Bound: bytes. At 1088x1920 without a background image: 25.1 MB of fgr
// and 8.4 MB of alpha read, 8.4 MB of words written.
//
// Built with --fmad=false: f * a + bg * (1 - a) is four rounded operations,
// as in the plain version. The clip of the rounded sum or product is its
// .sat form, the rounding to a byte an add of 1.5 * 2^23 and the word a
// byte permute (refine_common.cuh: add_sat, mul_sat, quant_bits,
// pack_rgba), each the same byte as clip, __float2int_rn and shifts.

#include "refine_common.cuh"

namespace {

enum Mode { kNone, kColor, kImage, kPerFrame };

constexpr int kThreads = 256;

struct Args {
  const float* fgr;
  const float* alpha;
  const float* bg_img;  // kImage: (h, w, 3); kPerFrame: (n, h, w, 3)
  uint32_t* out;
  float bg[3];          // kColor
  long long total;      // n h w
  long long plane;      // h w
  int mode;
};

// One word from a pixel's fgr, alpha and background.
__device__ __forceinline__ uint32_t word(int mode, float f0, float f1,
                                         float f2, float al, float b0,
                                         float b1, float b2) {
  const float f[3] = {f0, f1, f2};
  const float bg[3] = {b0, b1, b2};
  uint32_t q[3];
  if (mode == kNone) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      q[c] = refine::quant_bits(refine::mul_sat(f[c], al));
  } else {
    const float om = 1.0f - al;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      q[c] = refine::quant_bits(refine::add_sat(f[c] * al, bg[c] * om));
  }
  return refine::pack_rgba(q[0], q[1], q[2],
                           refine::quant_bits(__saturatef(al)));
}

// p mod h w: the shared image's pixel of batch pixel p.
__device__ __forceinline__ long long image_pixel(const Args& a,
                                                 long long p) {
  if (a.total <= 0xFFFFFFFFll)
    return (unsigned)p % (unsigned)a.plane;
  return p % a.plane;
}

// Pixel p on its own (the bg image's pixel at q).
__device__ __forceinline__ void pixel(int mode, const Args& a, long long p,
                                      long long q) {
  const float* f = a.fgr + 3 * p;
  float b0 = a.bg[0], b1 = a.bg[1], b2 = a.bg[2];
  if (mode == kImage || mode == kPerFrame) {
    const float* bp = a.bg_img + 3 * q;
    b0 = bp[0];
    b1 = bp[1];
    b2 = bp[2];
  }
  a.out[p] = word(mode, f[0], f[1], f[2], a.alpha[p], b0, b1, b2);
}

// One group of 4 pixels a thread (a grid-stride loop over 132 x 8 blocks
// measured no faster: planar_knockouts.py --tail).
template <int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads) composite_kernel(Args a) {
  const int mode = MODE;
  const bool image = mode == kImage || mode == kPerFrame;
  const long long gi = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long p = 4 * gi;
  if (p >= a.total) return;
  const long long q = mode == kImage ? image_pixel(a, p) : p;
  const bool vec = VEC && p + 4 <= a.total &&
                   (mode != kImage || (q % 4 == 0 && q + 4 <= a.plane));
  if (!vec) {
    for (int i = 0; i < 4 && p + i < a.total; ++i)
      pixel(mode, a, p + i, mode == kImage ? image_pixel(a, p + i) : p + i);
    return;
  }
  const float4* fv = reinterpret_cast<const float4*>(a.fgr) + 3 * gi;
  const float4 al = reinterpret_cast<const float4*>(a.alpha)[gi];
  const float4 f0 = fv[0], f1 = fv[1], f2 = fv[2];
  float4 b0 = make_float4(a.bg[0], a.bg[1], a.bg[2], a.bg[0]);
  float4 b1 = make_float4(a.bg[1], a.bg[2], a.bg[0], a.bg[1]);
  float4 b2 = make_float4(a.bg[2], a.bg[0], a.bg[1], a.bg[2]);
  if (image) {
    const float4* bv = reinterpret_cast<const float4*>(a.bg_img + 3 * q);
    b0 = bv[0];
    b1 = bv[1];
    b2 = bv[2];
  }
  // fgr and bg hold r0 g0 b0 r1 | g1 b1 r2 g2 | b2 r3 g3 b3.
  reinterpret_cast<uint4*>(a.out)[gi] = make_uint4(
      word(mode, f0.x, f0.y, f0.z, al.x, b0.x, b0.y, b0.z),
      word(mode, f0.w, f1.x, f1.y, al.y, b0.w, b1.x, b1.y),
      word(mode, f1.z, f1.w, f2.x, al.z, b1.z, b1.w, b2.x),
      word(mode, f2.y, f2.z, f2.w, al.w, b2.y, b2.z, b2.w));
}

template <int MODE>
cudaError_t launch(const Args& a, bool vec, cudaStream_t stream) {
  const long long blocks = (a.total + 4LL * kThreads - 1) / (4LL * kThreads);
  if (blocks > 0x7FFFFFFFll) return cudaErrorInvalidValue;
  const int grid = (int)blocks;
  if (vec)
    composite_kernel<MODE, true><<<grid, kThreads, 0, stream>>>(a);
  else
    composite_kernel<MODE, false><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// fgr: (n, h, w, 3) f32; alpha: (n, h, w) f32; out: (n, h, w) uint32.
// bg_color: host [r, g, b] or null; bg_img: device (h, w, 3) f32 image
// (bg_per_frame 0) or (n, h, w, 3) images (bg_per_frame 1), or null.
// Both null: premultiplied output.
extern "C" int vm_composite_rgba_packed(const void* fgr, const void* alpha,
                                        const float* bg_color,
                                        const void* bg_img, int bg_per_frame,
                                        void* out, int n, int h, int w,
                                        void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || (bg_color && bg_img))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.fgr = (const float*)fgr;
  a.alpha = (const float*)alpha;
  a.bg_img = (const float*)bg_img;
  a.out = (uint32_t*)out;
  for (int c = 0; c < 3; ++c) a.bg[c] = bg_color ? bg_color[c] : 0.0f;
  a.plane = (long long)h * w;
  a.total = a.plane * n;
  a.mode = bg_img ? (bg_per_frame ? kPerFrame : kImage)
                  : bg_color ? kColor : kNone;
  const bool vec = aligned16(fgr) && aligned16(alpha) && aligned16(out) &&
                   aligned16(bg_img);
  cudaStream_t s = (cudaStream_t)stream;
  switch (a.mode) {
    case kImage: return (int)launch<kImage>(a, vec, s);
    case kPerFrame: return (int)launch<kPerFrame>(a, vec, s);
    case kColor: return (int)launch<kColor>(a, vec, s);
    default: return (int)launch<kNone>(a, vec, s);
  }
}
