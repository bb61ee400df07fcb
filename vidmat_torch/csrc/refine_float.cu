// Fused guided refine at full resolution emitting float32 planes:
//   A, B   = bilinear (half-pixel, edge-clamped) x pool upsample of the
//            coarse coefficient grids mean_a, mean_b ([alpha, r, g, b])
//   guide  = (0.299 R + 0.587 G + 0.114 B) / 255 of the uint8 frame
//   alpha  = clip(A0 * guide + B0), fgr_c = clip(Ac * guide + Bc)
// No composite, no quantization: alpha (n, h, w, 1) and fgr (n, h, w, 3)
// float32 are written as they are.
//
// Replaces the TPU kernel vidmat/ops/pallas/refine_kernel.py
// fused_refine_float (_refine_float_kernel), the tail of float-output
// serving (the streaming session, raw-foreground output). The TPU kernel
// upsamples with banded matmuls over VMEM-resident coefficient grids and
// writes planar (3, th, wc) tiles.
//
// Pool 4 (the session's 1080p launch), w % 4 == 0, aligned pointers: the
// warp strips of refine_composite.cu, without block barriers:
//   - a warp owns 124 output columns of one row (kRows; rows of a pair
//     would share their coefficient taps, but the second row's registers
//     leave fewer warps in flight, and a one-frame launch needs them:
//     planar_knockouts.py --tail); lane l (0-30) owns pixels 4j+2 ..
//     4j+5, whose taps are coarse columns j and j+1 with weights 1/8,
//     3/8, 5/8, 7/8 of j+1 (the exact value src_index gives them:
//     constants here); it row-lerps column j, all 8 channels, from 4
//     16-byte loads, and takes column j+1 from lane l+1 by shuffle (lane
//     31 only row-lerps);
//   - src_index runs once per row, with the pool the constant 4;
//   - the frame is read as 32-bit words (byte_f);
//   - a warp row's output is contiguous runs of 496 bytes of alpha and
//     1488 of fgr. The lanes put their pixels into a per-warp stage in
//     shared memory, and the warp writes each run from it as 16-byte
//     stores of consecutive lanes (an 8-byte head and tail at the strip's
//     ends), so every store instruction fills whole sectors. Stored from
//     registers, a lane's own 4 pixels (16 bytes of alpha, 48 of fgr,
//     both at an 8-byte offset) fill half of every sector an instruction
//     touches; as 8- or 16-byte stores they measured slower
//     (planar_knockouts.py --parent against edited copies);
//   - the frame's first and last two pixels (clamped taps) take the
//     per-pixel path, as every pixel of the other bodies does.
//
// Other pools (the session at downsample_ratio 0.5 runs pool 2), and
// misaligned frames: one thread per output pixel (guided_apply), taps
// read from the grids through the caches in the same order.
//
// Both bodies compute every value as guided_apply does: the row lerp,
// then the column lerp, each product and sum rounded (--fmad=false), the
// clip as fminf(fmaxf(.)). So the floats equal each other's and the
// earlier per-pixel kernel's.
//
// Bound: bytes. At 1088x1920 from a 272x480 grid: 6.3 MB of frame and
// 4.2 MB of coefficients read, 33.4 MB of float32 written.

#include "refine_common.cuh"

namespace {

using refine::next_lane;

// 4 warps a block: the one-frame launch's 4352 blocks spread more evenly
// over the SMs than 2176 of 8 warps (planar_knockouts.py --tail).
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPx = 4;         // pixels a lane owns
constexpr int kOwners = 31;    // lanes that own pixels
constexpr int kRows = 1;       // rows a warp owns
constexpr float kPool = 4.0f;  // the strip body's pool, a constant
constexpr int kStrip = kOwners * kPx;  // output columns of a strip
// A warp's stage: its row's alpha (kStrip floats) and fgr (3 kStrip), each
// at an offset of 2 floats and padded to 16 bytes.
constexpr int kStageA = (kStrip + 2 + 3) / 4 * 4;
constexpr int kStageF = (3 * kStrip + 2 + 3) / 4 * 4;

struct Geom {
  int h, w, hl, wl;
  float pool;
};

struct Args {
  const uint8_t* frame;
  const float4* ma;
  const float4* mb;
  float* alpha;
  float* fgr;
};

__device__ __forceinline__ float4 apply(float4 A, float4 B, float lum) {
  return make_float4(
      refine::clip01(A.x * lum + B.x), refine::clip01(A.y * lum + B.y),
      refine::clip01(A.z * lum + B.z), refine::clip01(A.w * lum + B.w));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// dst[i] = src[i + 2] for i in [lo, hi) by the whole warp: 16-byte
// stores where i = 2 (mod 4) (dst + 2 and src are 16-byte aligned), the
// floats before the first and after the last such chunk one at a time.
// lo is 0 or 2 (mod 4), hi >= 2.
__device__ __forceinline__ void store_run(float* dst, const float* src,
                                          int lo, int hi, int lane) {
  for (int i = 2 + 4 * lane; i + 4 <= hi; i += 128)
    if (i >= lo)
      *reinterpret_cast<float4*>(dst + i) =
          *reinterpret_cast<const float4*>(src + i + 2);
  if (lo == 0 && lane < 2) dst[lane] = src[lane + 2];
  const int end = 2 + (hi - 2) / 4 * 4;
  if (lane < hi - end && end + lane >= lo)
    dst[end + lane] = src[end + lane + 2];
}

// Pool 4, w % 4 == 0, frame 4-byte and alpha and fgr 16-byte aligned.
__device__ __forceinline__ void strip_body(const Geom& g, const Args& a) {
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.z;
  const int y_first = (blockIdx.y * kWarps + threadIdx.x / 32) * kRows;
  if (y_first >= g.h) return;  // the whole warp
  // Lane l (0-30) owns pixels 4j + 2 .. 4j + 5 of column j = 31 k - 1 + l
  // (strip k); lane 31 only row-lerps column j for lane 30. A full lane's
  // pixels are inside the row with unclamped taps (0 <= j <= wl - 2); an
  // edge lane holds the frame's first or last two pixels.
  const int j = blockIdx.x * kOwners - 1 + lane;
  const int x = kPx * j + 2;
  const bool full = lane < kOwners && x >= 0 && x + kPx <= g.w;
  const bool edge = lane < kOwners && !full && x + kPx > 0 && x < g.w;
  const int col = min(max(j, 0), g.wl - 1);
  const long long plane = (long long)g.h * g.w;
  // The strip's output columns x0 .. x0 + kStrip - 1, those in the frame
  // from x0 + lo to x0 + hi - 1; a lane's pixel x + q is stage pixel
  // 4 lane + q.
  const int x0 = blockIdx.x * kStrip - 2;
  const int lo = max(0, -x0), hi = min(kStrip, g.w - x0);
  __shared__ __align__(16) float stage[kWarps][kStageA + kStageF];
  float* sa = stage[threadIdx.x / 32];
  float* sf = sa + kStageA;

  // The rows' frame bytes first: the 4 words from byte 3 x - 2 (4-byte
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
  float4 t[4];
  auto taps = [&](int t0, int t1) {
    const long long r0 = ((long long)b * g.hl + t0) * g.wl + col;
    const long long r1 = ((long long)b * g.hl + t1) * g.wl + col;
    t[0] = a.ma[r0];
    t[1] = a.ma[r1];
    t[2] = a.mb[r0];
    t[3] = a.mb[r1];
  };
  taps(y0, y1);

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
        taps(y0, y1);
      }
    }
    const float4 ra = refine::lerp4(t[0], t[1], fy);
    const float4 rb = refine::lerp4(t[2], t[3], fy);
    const float4 ra_p = next_lane(ra), rb_p = next_lane(rb);
    // v[q] = [alpha, r, g, b] of pixel x + q.
    float4 v[kPx];
    if (full) {
#pragma unroll
      for (int q = 0; q < kPx; ++q) {
        const float f = 0.125f + 0.25f * q;
        v[q] = apply(refine::lerp4(ra, ra_p, f), refine::lerp4(rb, rb_p, f),
                     refine::strip_luma(fw[r], q));
      }
    } else {
#pragma unroll
      for (int q = 0; q < kPx; ++q)
        v[q] = edge && x + q >= 0 && x + q < g.w
                   ? refine::guided_apply(a.frame, a.ma, a.mb, b, y, x + q,
                                          g.h, g.w, g.hl, g.wl, kPool)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    // Stage pixel r's alpha at sa[r + 2], its fgr at sf[3 r + 2 ..].
    float* la = sa + 4 * lane + 2;
    float* lf = sf + 12 * lane + 2;
    if (full) {
      store2(la, v[0].x, v[1].x);
      store2(la + 2, v[2].x, v[3].x);
      store2(lf, v[0].y, v[0].z);
      store2(lf + 2, v[0].w, v[1].y);
      store2(lf + 4, v[1].z, v[1].w);
      store2(lf + 6, v[2].y, v[2].z);
      store2(lf + 8, v[2].w, v[3].y);
      store2(lf + 10, v[3].z, v[3].w);
    } else if (edge) {
#pragma unroll
      for (int q = 0; q < kPx; ++q) {
        if (x + q < 0 || x + q >= g.w) continue;
        la[q] = v[q].x;
        lf[3 * q] = v[q].y;
        lf[3 * q + 1] = v[q].z;
        lf[3 * q + 2] = v[q].w;
      }
    }
    __syncwarp();
    const long long prow = b * plane + (long long)y * g.w + x0;
    store_run(a.alpha + prow, sa, lo, hi, lane);
    store_run(a.fgr + 3 * prow, sf, 3 * lo, 3 * hi, lane);
    __syncwarp();
  }
}

// Any pool, width and alignment: one thread per output pixel.
__device__ __forceinline__ void pixel_body(const Geom& g, const Args& a) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= g.w) return;
  const float4 v = refine::guided_apply(a.frame, a.ma, a.mb, b, y, x, g.h,
                                        g.w, g.hl, g.wl, g.pool);
  const long long pix = ((long long)b * g.h + y) * g.w + x;
  a.alpha[pix] = v.x;
  float* f = a.fgr + pix * 3;
  f[0] = v.y;
  f[1] = v.z;
  f[2] = v.w;
}

template <bool STRIP>
__global__ void __launch_bounds__(kThreads) refine_float_kernel(Geom g,
                                                                Args a) {
  if constexpr (STRIP)
    strip_body(g, a);
  else
    pixel_body(g, a);
}

}  // namespace

// frame: (n, h, w, 3) uint8; mean_a, mean_b: (n, h/pool, w/pool, 4) f32;
// alpha: (n, h, w) f32; fgr: (n, h, w, 3) f32.
extern "C" int vm_refine_float(const void* frame, const void* mean_a,
                               const void* mean_b, void* alpha, void* fgr,
                               int n, int h, int w, int pool, void* stream) {
  if (n <= 0 || n > 65535 || h <= 0 || h > 65535 || w <= 0 || pool < 1 ||
      h % pool || w % pool)
    return (int)cudaErrorInvalidValue;
  const Geom g{h, w, h / pool, w / pool, (float)pool};
  const Args a{(const uint8_t*)frame, (const float4*)mean_a,
               (const float4*)mean_b, (float*)alpha, (float*)fgr};
  cudaStream_t s = (cudaStream_t)stream;
  if (pool == 4 && w % 4 == 0 &&
      reinterpret_cast<uintptr_t>(frame) % 4 == 0 &&
      reinterpret_cast<uintptr_t>(alpha) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(fgr) % 16 == 0) {
    const dim3 grid((w + 2 + kOwners * kPx - 1) / (kOwners * kPx),
                    (h + kWarps * kRows - 1) / (kWarps * kRows), n);
    refine_float_kernel<true><<<grid, kThreads, 0, s>>>(g, a);
  } else {
    const dim3 grid((w + kThreads - 1) / kThreads, h, n);
    refine_float_kernel<false><<<grid, kThreads, 0, s>>>(g, a);
  }
  return (int)cudaGetLastError();
}
