// int8-stored 3x3 conv probe, 16 -> 16 channels, NCHW:
//   xb    = bf16(bf16(x) * bf16(1 / q))          dequantize each input
//   acc   = sum over (tap, ci) of xb * w         bf16 products, f32 sums
//   out   = clip(round(max(acc, 0) * q), -127, 127) as int8
// with zero padding outside the image and round half to even
// (__float2int_rn, as jnp.round).
//
// Replaces the TPU kernel of tools/bench_int8_planes.py (int8_conv, its
// int8_kernel): a measurement of whether int8-stored activation planes
// would speed up the planar net. The TPU kernel reads pitched (C, TOTAL)
// int8 planes with a zero ring and masks the ring on output; here the
// planes are NCHW and the ring is the zero padding of the staged tile.
//
// Bound: bytes. At the probe's shape (8 x 16 x 144 x 240) 4.4 MB of int8
// read and 4.4 MB written: 2.6 us at 3.35 TB/s; its 1.27 GFLOP is 1.3 us
// of bf16 tensor-core peak, out of reach of the CUDA cores (637 M
// multiply-adds), so the conv is an implicit GEMM on the bf16 tensor
// cores (planar_mma.cuh): M = output pixels in tiles of 16 along a row,
// N = the 16 output channels (two n8 tiles), K = 9 taps x 16 input
// channels, one mma.sync.m16n8k16 per tap. bf16 is the faithful operand
// type: an int8 value is exact in bf16, the dequantized value is the
// bf16 the reference multiplies, and the probe's weights are bf16 (an s8
// mma would need quantized weights, another function).
//
// A block (8 warps) computes one kTileH x kTileW output tile of one image
// (a flat grid over images and tiles):
//   1. B, the packed weights ([n][tap * 16 + ci], ops/planar.py
//      pack_conv_weight, row stride 152: conflict-free ldmatrix), copied
//      once into shared memory as 16-byte vectors; a warp reads one
//      ldmatrix.x4 of it (both n tiles) per tap and row. (Held in 36
//      registers a lane, they cost residency.)
//   2. The tile plus a one-pixel halo of all 16 planes is staged
//      channels-last in shared memory as bf16 (pixel stride 24: conflict-
//      free ldmatrix), dequantized on the way by byte permutes and one
//      bf16x2 FMA a channel pair (deq2: exact, and no quarter-rate
//      conversions). Where W is a multiple of 16 and x is 16-byte aligned
//      (VEC) each lane loads two channels' 16-byte vectors along W and the
//      halo columns' bytes, all issued before the first shared store.
//      Else every staged value is a byte load (ragged W, an offset input).
//   3. A warp takes a whole output row: per tap, for each of the row's
//      kSegs M tiles one ldmatrix.x4 (each lane hands it its own pixel's
//      address, so the im2col costs nothing) and two mma, each from a
//      zero accumulator and added to the f32 running sum with an IEEE add
//      (mma16816), in the reference's tap order (dx outer, dy inner:
//      vidmat/ops/pallas/planar.py _tap_accum); the row's 2 kSegs mma of a
//      tap are independent. Products of bf16 values are exact in f32, so
//      the sum differs from the reference's only by its order.
//   4. The epilogue (ReLU, * q, clamp, round half to even by an add of
//      1.5 * 2^23) writes the C fragments as bytes into a [co][pixel] tile
//      in shared memory; the block then stores each channel plane's row
//      segments, as 16-byte vectors (VEC) or bytes.
// What bounds it on the H100 (PERF.md, PR 9, planar_knockouts.py --tail
// int8:): no single part; removing the loads, the mma or the stores each
// saves a share, because a block's phases (load, stage, mma, store) run
// one after another and the blocks of a launch run them in step.
// Built with --fmad=false.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "planar_mma.cuh"

namespace {

using planar::mma::ldsm_x4;
using planar::mma::mma16816;
using planar::mma::saddr;
using bf16 = __nv_bfloat16;

constexpr int C = 16;                   // input and output channels
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 8;               // output tile rows
constexpr int kTileW = 32;              // output tile columns (16 | kTileW)
constexpr int kRH = kTileH + 2;         // staged region with its halo
constexpr int kRW = kTileW + 2;
constexpr int kPS = planar::mma::pstride(C);  // 24 bf16 a staged pixel
constexpr int kSegs = kTileW / 16;      // 16-pixel segments of a tile row
constexpr int kRowsPerWarp = kTileH / kWarps;  // output rows a warp
static_assert(kTileH % kWarps == 0, "whole rows a warp");
constexpr int kWStride = planar::mma::wstride(C);  // packed row: 152
constexpr int kOutStride = kTileH * kTileW + 16;  // bytes a channel
constexpr size_t kRegionBytes = (size_t)kRH * kRW * kPS * sizeof(bf16);
constexpr size_t kOutBytes = (size_t)C * kOutStride;
constexpr size_t kWBytes = (size_t)C * kWStride * sizeof(bf16);
constexpr size_t kSmem = kRegionBytes + kOutBytes + kWBytes;
static_assert(kTileW % 16 == 0 && kRegionBytes % 16 == 0, "tile");

// The staged A operand: (bf16(bf16(a_j) * s), bf16(bf16(b_j) * s)) for
// byte j of words a and b (int8 values of two channels), as one bf16x2
// word, exactly as the reference rounds it, on full-rate ALUs (no I2F,
// F2FP): m = 128 + (x & 127) is a bf16 integer built from the byte's low
// bits, x = m - 128 - 128 [x < 0], and fma(m, s, -128 s (1 + [x < 0]))
// rounds x s once, with c128 the bits of bf16(-128 s) in both halves (+
// 0x80 doubles a bf16 of normal exponent).
template <int J>
__device__ __forceinline__ uint32_t deq2(uint32_t a, uint32_t b,
                                         __nv_bfloat162 s2, uint32_t c128) {
  constexpr uint32_t kSel = J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12);
  const uint32_t t = __byte_perm(a, b, kSel);
  const uint32_t m = (t & 0x007F007Fu) | 0x43004300u;
  const uint32_t c = c128 + (t & 0x00800080u);
  const __nv_bfloat162 r =
      __hfma2(*reinterpret_cast<const __nv_bfloat162*>(&m), s2,
              *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// clip(round(max(acc, 0) * q), -127, 127) as a byte (the low byte of the
// result): min(v, 127) + 1.5 * 2^23 rounds v in [0, 127] half to even at
// a unit spacing (IEEE add), as __float2int_rn, on the FMA pipe.
__device__ __forceinline__ uint32_t quant(float acc, float q) {
  const float v = fminf(__fmul_rn(fmaxf(acc, 0.0f), q), 127.0f);
  return __float_as_uint(__fadd_rn(v, 12582912.0f));
}

// The global loads of a VEC tile's staged region, all in flight before
// the first shared store: interior item (channel pair cp, row r, segment s),
// cp fastest (8 lanes fill one pixel's 32 bytes; 4 rows of one segment
// cover the 32 banks), two channels' 16-byte vectors; halo item (cp, r,
// side), two bytes.
constexpr int kItems = (C / 2) * kRH * kSegs;
constexpr int kRounds = (kItems + kThreads - 1) / kThreads;
constexpr int kHalo = (C / 2) * kRH * 2;
constexpr int kHRounds = (kHalo + kThreads - 1) / kThreads;
struct Fetch {
  uint4 v[kRounds][2];
  int h[kHRounds][2];
};

struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile tile_of(int t, int tiles_x, int tiles_y) {
  const int per = tiles_x * tiles_y;
  const int b = t / per, r = t - b * per;
  return Tile{b, (r / tiles_x) * kTileH, (r % tiles_x) * kTileW};
}

__device__ __forceinline__ void fetch(Fetch& f, const int8_t* __restrict__ x,
                                      const Tile& tl, int h, int wd,
                                      size_t hw) {
  const int8_t* xb = x + (size_t)tl.b * C * hw;
#pragma unroll
  for (int u = 0; u < kRounds; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int cp = i & 7, r = (i >> 3) % kRH, s = (i >> 3) / kRH;
    const int gy = tl.y0 - 1 + r, gx = tl.x0 + s * 16;
    f.v[u][0] = f.v[u][1] = make_uint4(0u, 0u, 0u, 0u);
    if (i < kItems && gy >= 0 && gy < h && gx < wd) {
      const int8_t* src = xb + 2 * cp * hw + (size_t)gy * wd + gx;
      f.v[u][0] = __ldg(reinterpret_cast<const uint4*>(src));
      f.v[u][1] = __ldg(reinterpret_cast<const uint4*>(src + hw));
    }
  }
#pragma unroll
  for (int u = 0; u < kHRounds; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int cp = i & 7, r = (i >> 3) % kRH, side = (i >> 3) / kRH;
    const int gy = tl.y0 - 1 + r, gx = side ? tl.x0 + kTileW : tl.x0 - 1;
    f.h[u][0] = f.h[u][1] = 0;
    if (i < kHalo && gy >= 0 && gy < h && gx >= 0 && gx < wd) {
      const int8_t* src = xb + 2 * cp * hw + (size_t)gy * wd + gx;
      f.h[u][0] = (uint8_t)__ldg(src);
      f.h[u][1] = (uint8_t)__ldg(src + hw);
    }
  }
}

// Region pixel (r, c) = image (y0 - 1 + r, x0 - 1 + c); rw: its bf16x2
// words, kPW a pixel.
constexpr int kPW = kPS / 2;

__device__ __forceinline__ void stage_fetched(const Fetch& f, uint32_t* rw,
                                              __nv_bfloat162 s2,
                                              uint32_t c128) {
#pragma unroll
  for (int u = 0; u < kRounds; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i >= kItems) continue;
    const int cp = i & 7, r = (i >> 3) % kRH, s = (i >> 3) / kRH;
    uint32_t* dst = rw + (r * kRW + 1 + s * 16) * kPW + cp;
    const uint32_t* a = reinterpret_cast<const uint32_t*>(&f.v[u][0]);
    const uint32_t* b = reinterpret_cast<const uint32_t*>(&f.v[u][1]);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      dst[(4 * w + 0) * kPW] = deq2<0>(a[w], b[w], s2, c128);
      dst[(4 * w + 1) * kPW] = deq2<1>(a[w], b[w], s2, c128);
      dst[(4 * w + 2) * kPW] = deq2<2>(a[w], b[w], s2, c128);
      dst[(4 * w + 3) * kPW] = deq2<3>(a[w], b[w], s2, c128);
    }
  }
#pragma unroll
  for (int u = 0; u < kHRounds; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i >= kHalo) continue;
    const int cp = i & 7, r = (i >> 3) % kRH, side = (i >> 3) / kRH;
    rw[(r * kRW + (side ? kRW - 1 : 0)) * kPW + cp] =
        deq2<0>((uint32_t)f.h[u][0], (uint32_t)f.h[u][1], s2, c128);
  }
}

// Every staged value a byte load (ragged W, a misaligned input): item
// (cp, pixel of the region).
__device__ __forceinline__ void stage_bytes(const int8_t* __restrict__ x,
                                            const Tile& tl, int h, int wd,
                                            size_t hw, uint32_t* rw,
                                            __nv_bfloat162 s2,
                                            uint32_t c128) {
  const int8_t* xb = x + (size_t)tl.b * C * hw;
  constexpr int kAll = (C / 2) * kRH * kRW;
  constexpr int kU = 4;
  for (int base = threadIdx.x; base < kAll; base += kThreads * kU) {
    uint32_t lo[kU], hi[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = base + u * kThreads;
      const int cp = i & 7, p = i >> 3;
      const int gy = tl.y0 - 1 + p / kRW, gx = tl.x0 - 1 + p % kRW;
      lo[u] = hi[u] = 0u;
      if (i < kAll && gy >= 0 && gy < h && gx >= 0 && gx < wd) {
        const int8_t* src = xb + 2 * cp * hw + (size_t)gy * wd + gx;
        lo[u] = (uint8_t)__ldg(src);
        hi[u] = (uint8_t)__ldg(src + hw);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = base + u * kThreads;
      if (i < kAll) rw[(i >> 3) * kPW + (i & 7)] = deq2<0>(lo[u], hi[u], s2,
                                                           c128);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const int8_t* __restrict__ x,
                     const bf16* __restrict__ wp, int8_t* __restrict__ out,
                     int h, int wd, int tiles_x, int tiles_y, float scale,
                     float q) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* region = reinterpret_cast<bf16*>(smem);
  uint8_t* otile = smem + kRegionBytes;
  uint4* wsm = reinterpret_cast<uint4*>(otile + kOutBytes);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t hw = (size_t)h * wd;
  const Tile tl = tile_of(blockIdx.x, tiles_x, tiles_y);

  // Every load of the block is issued before the first shared store: the
  // packed weights as 16-byte vectors, the region's vectors (VEC).
  constexpr int kWVec = (int)(kWBytes / 16);
  constexpr int kWRounds = (kWVec + kThreads - 1) / kThreads;
  uint4 wv[kWRounds];
#pragma unroll
  for (int u = 0; u < kWRounds; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < kWVec) wv[u] = __ldg(reinterpret_cast<const uint4*>(wp) + i);
  }
  [[maybe_unused]] Fetch f;
  if constexpr (VEC) fetch(f, x, tl, h, wd, hw);
#pragma unroll
  for (int u = 0; u < kWRounds; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < kWVec) wsm[i] = wv[u];
  }
  const __nv_bfloat162 s2 = __float2bfloat162_rn(scale);
  const uint32_t c128 =
      (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(-128.0f * scale)) *
      0x00010001u;
  uint32_t* rw = reinterpret_cast<uint32_t*>(smem);
  if constexpr (VEC) {
    stage_fetched(f, rw, s2, c128);
  } else {
    stage_bytes(x, tl, h, wd, hw, rw, s2, c128);
  }
  __syncthreads();

  // A warp's rows: per tap, one ldmatrix of B (both n tiles, rows n of
  // the packed weights) and, for each of the row's kSegs M tiles, one
  // ldmatrix of A and two mma: 2 kSegs independent mma in flight. Columns
  // past the image are computed from the zero padding and not stored.
  const uint32_t b0 = saddr(reinterpret_cast<const bf16*>(wsm) +
                            (((lane >> 4) << 3) + (lane & 7)) * kWStride +
                            ((lane >> 3) & 1) * 8);
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int oy = warp * kRowsPerWarp + rr;
    if (tl.y0 + oy >= h) break;  // warp-uniform
    const uint32_t a0 =
        saddr(region + (oy * kRW + (lane & 15)) * kPS + (lane >> 4) * 8);
    float acc[kSegs][2][4];
#pragma unroll
    for (int m = 0; m < kSegs; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0f;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const int tap = ky * 3 + kx;
        uint32_t b[4];
        ldsm_x4(b, b0 + (uint32_t)(tap * C * 2));
#pragma unroll
        for (int m = 0; m < kSegs; ++m) {
          uint32_t a[4];
          ldsm_x4(a, a0 + (uint32_t)(((ky * kRW + kx + 16 * m) * kPS) * 2));
          mma16816(acc[m][0], a, b[0], b[1]);
          mma16816(acc[m][1], a, b[2], b[3]);
        }
      }
    // C fragment: c0, c1 at (pixel lane / 4, channels 2 (lane % 4) +
    // {0, 1}) of each n tile, c2, c3 eight pixels on.
#pragma unroll
    for (int m = 0; m < kSegs; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint8_t* o = otile + (j * 8 + 2 * (lane & 3)) * kOutStride +
                     oy * kTileW + 16 * m + (lane >> 2);
        o[0] = (uint8_t)quant(acc[m][j][0], q);
        o[kOutStride] = (uint8_t)quant(acc[m][j][1], q);
        o[8] = (uint8_t)quant(acc[m][j][2], q);
        o[kOutStride + 8] = (uint8_t)quant(acc[m][j][3], q);
      }
  }
  __syncthreads();

  int8_t* ob = out + (size_t)tl.b * C * hw;
  if constexpr (VEC) {
    // Item (segment, row, channel), segment fastest: a plane's tile row is
    // kSegs contiguous 16-byte stores.
    constexpr int kOut = C * kTileH * kSegs;
    for (int i = threadIdx.x; i < kOut; i += kThreads) {
      const int s = i % kSegs, r = (i / kSegs) % kTileH,
                co = i / (kSegs * kTileH);
      const int gy = tl.y0 + r, gx = tl.x0 + s * 16;
      if (gy >= h || gx >= wd) continue;
      *reinterpret_cast<uint4*>(ob + co * hw + (size_t)gy * wd + gx) =
          *reinterpret_cast<const uint4*>(otile + co * kOutStride +
                                          r * kTileW + s * 16);
    }
  } else {
    constexpr int kOut = C * kTileH * kTileW;
    for (int i = threadIdx.x; i < kOut; i += kThreads) {
      const int c = i % kTileW, r = (i / kTileW) % kTileH,
                co = i / (kTileW * kTileH);
      const int gy = tl.y0 + r, gx = tl.x0 + c;
      if (gy < h && gx < wd)
        ob[co * hw + (size_t)gy * wd + gx] =
            (int8_t)otile[co * kOutStride + r * kTileW + c];
    }
  }
}

template <bool VEC>
int launch(const int8_t* x, const bf16* wp, int8_t* out, int n, int h,
           int wd, float scale, float q, cudaStream_t stream) {
  const int tiles_x = (wd + kTileW - 1) / kTileW;
  const int tiles_y = (h + kTileH - 1) / kTileH;
  const long long tiles = (long long)n * tiles_x * tiles_y;
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if constexpr (kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_conv_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem);
    if (e != cudaSuccess) return (int)e;
  }
  int8_conv_kernel<VEC><<<(unsigned)tiles, kThreads, kSmem, stream>>>(
      x, wp, out, h, wd, tiles_x, tiles_y, scale, q);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (n, 16, h, w) int8, contiguous; wp: the weights (16, 16, 3, 3)
// bf16 packed by pack_conv_weight, (16, 152), 16-byte aligned; scale: the
// bf16 value of 1 / q (the dequantization factor); q: the requantization
// factor.
extern "C" int vm_int8_conv(const void* x, const void* wp, void* out, int n,
                            int h, int wd, float scale, float q,
                            void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || (reinterpret_cast<uintptr_t>(wp) & 15))
    return (int)cudaErrorInvalidValue;
  const bool vec = wd % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  return vec ? launch<true>((const int8_t*)x, (const bf16*)wp,
                            (int8_t*)out, n, h, wd, scale, q,
                            (cudaStream_t)stream)
             : launch<false>((const int8_t*)x, (const bf16*)wp,
                             (int8_t*)out, n, h, wd, scale, q,
                             (cudaStream_t)stream);
}
