// Tensor-core building blocks of the bf16 planar kernels (planar_conv.cu,
// planar_conv2.cu, planar_gru.cu): a 3x3 or 1x1 conv stage as an implicit
// GEMM on mma.sync.m16n8k16 (bf16 in, f32 accumulate) over regions staged
// in shared memory channels-last.
//
// A conv stage computes out[m][n] = sum over (tap, k) of
//   region[pixel(m) + tap][k] * w[n][tap][k]
// for the pixels m of a rows x cols output region (M, raster order), the
// output channels n (N, in tiles of 8) and K = taps (9 or 1) x the input
// channels padded to 16. One K step is one tap's 16 channels of one pixel,
// 32 contiguous bytes; each lane hands ldmatrix its own pixel's address,
// so the im2col gather costs nothing and an M tile of 16 pixels may cross
// region rows.
//
// Layouts (bf16):
//   region   [pixel][channel], pixel stride ps = up(c, 16) + 8: the 8
//            extra channels put the 16-byte rows of 8 neighbouring pixels
//            in distinct bank groups (conflict-free ldmatrix);
//   weights  [n][tap][k], row stride taps * kp + 8 for the same reason,
//            rows padded to a multiple of 8 with zeros, k the staged
//            channel (zero where no input channel maps). planar_conv2 and
//            planar_gru reorder (cout, cin, 3, 3) tensors into it in each
//            block (stage_w); planar_conv's weights come packed so once
//            (vidmat_torch/ops/planar.py pack_conv_weight).
// Padding channels are zero in both, so they add exact zeros.
//
// Work split: a warp owns one M tile (16 pixels) and a group of up to
// kNTMax N tiles, whose accumulators stay in registers; the A fragment is
// loaded once per K step and reused across the group. The group size is
// chosen per stage so that the 8 warps have work (stage_groups).
//
// Numerics: products of bf16 values are exact in f32; each K step's 16
// products are summed by the tensor cores and added to the f32 running sum
// with IEEE adds (mma16816). That is as accurate as the CUDA-core loop's
// sequential FMA chain, but in another order, and where a result lies
// next to a bf16 rounding midpoint (or next to relu's zero) the two orders
// can round an intermediate (mid, b, r * h) to neighbouring bf16 values,
// which the next conv carries into its outputs and the recurrence into
// later frames. So the block also sums S = sum |x * w| per output (a
// second mma on sign-masked fragments), and every epilogue checks the
// value it is about to round against the two orders' error scale carried
// through its arithmetic (near_tie). The scale (err_scale) is
// u (K P + 4 S) (u = 2^-24), P the larger of |acc| and the largest K
// step's mass (the sum of its 16 |x * w|). K P bounds what either order
// can lose while its partial sums stay below P: each of the K adds rounds
// by at most u times its partial sum, and the sequential order drops every
// term under half a unit of its running sum. So tiny terms of one sign
// over K products move the two orders apart linearly in K (the card test
// test_planar_kernels_round_same_sign_tiny_terms_as_sequential_order; a
// scale of 2 sqrt(K) |acc|, the spread of random roundings, missed it),
// and so do big terms that cancel after many tiny ones: the sequential
// order drops the tiny terms while a big one holds its running sum up,
// the tensor-core order keeps those it adds while its sum is small (the
// card test test_planar_kernels_round_cancelling_sums_as_sequential_order;
// u (K |acc| + 4 S), a scale that saw only the final sum, missed it). A
// big term makes the mass of the K step that holds it big. 4 S covers the
// rest as a spread (many medium terms that cancel across K steps); the
// bound of a K-term sum is K u S, which would send about a third of all
// values to the slow order. Where the value lies that close
// to a midpoint or to zero (a few percent of values) its (m, n) is queued
// and recomputed in the CUDA-core order (seq_sum: input channel, then ky,
// then kx, FMA from 0, over the operands already in shared memory), one
// queued value per lane. Each bf16 value is then the one the sequential
// kernel gives. The epilogue arithmetic is unchanged.

#pragma once

#include "planar_common.cuh"

namespace planar {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kWarps = kThreads / 32;
constexpr int kNTMax = 4;  // N tiles (of 8 channels) a warp accumulates
// Unit roundoff of f32.
constexpr float kU = 1.0f / 16777216.0f;  // 2^-24

// The error scale of a sum acc of k products with S = sabs (see Numerics):
// u (k P + 4 S), P = max(|acc|, big), big the largest K step mass; kf = k.
__device__ __forceinline__ float err_scale(float acc, float sabs, float big,
                                           float kf) {
  return kU * (kf * fmaxf(fabsf(acc), big) + 4.0f * sabs);
}

__host__ __device__ constexpr int up(int x, int m) {
  return (x + m - 1) / m * m;
}
// Pixel stride of a channels-last region of c channels.
__host__ __device__ constexpr int pstride(int c) { return up(c, 16) + 8; }
// Row stride of staged weights with kp channels per tap.
__host__ __device__ constexpr int wstride(int kp, int taps = 9) {
  return taps * kp + 8;
}
// Elements of staged weights for cout outputs and kp channels per tap.
__host__ __device__ constexpr size_t welems(int cout, int kp, int taps = 9) {
  return (size_t)up(cout, 8) * wstride(kp, taps);
}

// N tiles per warp task for a stage of mt M tiles and nt N tiles: the
// group size minimizing the busiest warp's K-step cost, one A load (worth
// two B loads) plus one B load and mma per tile of the group. Returns that
// cost per K step; *gs receives the group size.
__host__ __device__ inline int stage_groups(int mt, int nt, int* gs) {
  int best = 0;
  for (int g = nt < kNTMax ? nt : kNTMax; g >= 1; --g) {
    const int groups = (nt + g - 1) / g;
    const int rounds = (mt * groups + kWarps - 1) / kWarps;
    const int cost = rounds * (g + 2);
    if (best == 0 || cost < best) {
      best = cost;
      *gs = g;
    }
  }
  return best;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// acc += A * B for one K step of 16. The tensor cores sum the 16 exact
// products of a step with their own alignment and truncation, which is
// coarser than IEEE f32 once a long running sum is fed back in; so each
// step starts from zero and its sum is added to acc with IEEE f32 adds
// (the CUDA-core loop's accuracy, within the bf16 bars).
__device__ __forceinline__ void mma16816(float (&acc)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  float d0, d1, d2, d3;
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
  acc[0] = __fadd_rn(acc[0], d0);
  acc[1] = __fadd_rn(acc[1], d1);
  acc[2] = __fadd_rn(acc[2], d2);
  acc[3] = __fadd_rn(acc[3], d3);
}

// s += |A| * |B| for one K step (sign bits cleared), summed loosely: S
// only sizes the error of the sum. big = max(big, the step's masses of the
// four values): a lane's four values share one big (a wider scale only
// queues more values).
__device__ __forceinline__ void mma_abs(float (&s)[4], float& big,
                                        const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  constexpr uint32_t kMag = 0x7FFF7FFFu;
  const uint32_t aa[4] = {a[0] & kMag, a[1] & kMag, a[2] & kMag,
                          a[3] & kMag};
  float d0, d1, d2, d3;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
      : "r"(aa[0]), "r"(aa[1]), "r"(aa[2]), "r"(aa[3]), "r"(b0 & kMag),
        "r"(b1 & kMag), "f"(0.0f));
  s[0] += d0;
  s[1] += d1;
  s[2] += d2;
  s[3] += d3;
  big = fmaxf(big, fmaxf(fmaxf(d0, d1), fmaxf(d2, d3)));
}

// Channel k of image b of the concatenation `in` (k < in.total): its plane.
__device__ __forceinline__ const bf16* plane(const Planes& in, int b, int k,
                                             int hw) {
  if (k < in.c[0])
    return (const bf16*)in.p[0] + ((long long)b * in.c[0] + k) * hw;
  k -= in.c[0];
  if (k < in.c[1])
    return (const bf16*)in.p[1] + ((long long)b * in.c[1] + k) * hw;
  k -= in.c[1];
  return (const bf16*)in.p[2] + ((long long)b * in.c[2] + k) * hw;
}

// Fills channels [c0, c1) of every pixel of the rows x cols region whose
// top-left pixel is (y0, x0) of image b: channel c0 + k is channel k of
// the concatenated inputs (k < in.total; zero outside the image), the
// rest are zero. Pixels fastest, so a warp reads along image rows; each
// thread keeps kU loads in flight.
__device__ void stage_cl(const Planes& in, int b, int hh, int ww, int y0,
                         int x0, int rows, int cols, bf16* dst, int ps,
                         int c0, int c1) {
  constexpr int kU = 8;
  const int npix = rows * cols, total = (c1 - c0) * npix, hw = hh * ww;
  for (int base = threadIdx.x; base < total; base += kThreads * kU) {
    bf16 v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = base + u * kThreads;
      v[u] = __float2bfloat16_rn(0.0f);
      if (i < total) {
        const int k = i / npix, p = i - k * npix;
        const int r = p / cols, c = p - r * cols;
        const int gy = y0 + r, gx = x0 + c;
        if (k < in.total && gy >= 0 && gy < hh && gx >= 0 && gx < ww)
          v[u] = __ldg(plane(in, b, k, hw) + gy * ww + gx);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = base + u * kThreads;
      if (i < total) {
        const int k = i / npix, p = i - k * npix;
        dst[(size_t)p * ps + c0 + k] = v[u];
      }
    }
  }
}

// Zeroes channels [c0, c1) of every pixel of an npix-pixel region.
__device__ void zero_cl(bf16* dst, int npix, int ps, int c0, int c1) {
  const int nc = c1 - c0, total = npix * nc;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int p = i / nc;
    dst[(size_t)p * ps + c0 + i - p * nc] = __float2bfloat16_rn(0.0f);
  }
}

// Stages conv weights w (cout, cin, 3, 3) into dst [n][tap][k] (row stride
// wstride(kp)): input channel ci lands at k = ci for ci < split, else at
// ci - split + koff2 (the second operand of a concatenation that starts on
// its own 16-channel boundary); every other k of rows < up(cout, 8) is
// zero. Reads w in 16-byte vectors where it is 16-byte aligned.
__device__ void stage_w(const bf16* __restrict__ w, int cout, int cin,
                        int kp, int split, int koff2, bf16* dst) {
  const int ws = wstride(kp), per_n = cin * 9, total = cout * per_n;
  auto put = [&](int e, bf16 v) {
    const int n = e / per_n, r = e - n * per_n;
    const int ci = r / 9, tap = r - ci * 9;
    const int k = ci < split ? ci : ci - split + koff2;
    dst[(size_t)n * ws + tap * kp + k] = v;
  };
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(w) & 15) == 0) {
    constexpr int kU = 4;
    const int nv = total / 8;
    const uint4* wv = reinterpret_cast<const uint4*>(w);
    for (int base = threadIdx.x; base < nv; base += kThreads * kU) {
      uint4 q[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (base + u * kThreads < nv) q[u] = __ldg(wv + base + u * kThreads);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = base + u * kThreads;
        if (i >= nv) continue;
        const bf16* e = reinterpret_cast<const bf16*>(&q[u]);
#pragma unroll
        for (int j = 0; j < 8; ++j) put(i * 8 + j, e[j]);
      }
    }
    done = nv * 8;
  }
  for (int i = done + threadIdx.x; i < total; i += kThreads) put(i, w[i]);

  // Zeros: the k no channel maps to, [split, koff2) and [hi0, kp), in the
  // rows of real outputs; then whole padding rows.
  const bf16 z = __float2bfloat16_rn(0.0f);
  const int h1 = koff2 - split, hi0 = koff2 + cin - split;
  const int nh = h1 + kp - hi0;
  const int holes = cout * 9 * nh;
  for (int i = threadIdx.x; i < holes; i += kThreads) {
    const int n = i / (9 * nh), r = i - n * 9 * nh;
    const int tap = r / nh, j = r - tap * nh;
    dst[(size_t)n * ws + tap * kp + (j < h1 ? split + j : hi0 + j - h1)] = z;
  }
  const int pad = (up(cout, 8) - cout) * 9 * kp;
  for (int i = threadIdx.x; i < pad; i += kThreads) {
    const int n = cout + i / (9 * kp);
    dst[(size_t)n * ws + i % (9 * kp)] = z;
  }
}

// One K segment of a conv stage: a channels-last region and where the
// stage's KS x KS taps read it. Output pixel (oy, ox), tap (ky, kx) reads
// region pixel (stride * oy + ky + shift, stride * ox + kx + shift), channels
// [0, 16 * chunks), against staged weight k in [koff, koff + 16 * chunks);
// its first nch channels are the conv's inputs (seq_sum reads those).
struct Seg {
  const bf16* base;
  int cols, ps, shift, chunks, koff, nch;
};

// True when v, about to be rounded to bf16 (after a relu, if any), may
// round otherwise in the CUDA-core order: it lies closer than dv (its
// error scale) to a bf16 rounding midpoint, or to zero. The nearest
// midpoint is v with its low 16 bits set to 0x8000. A value with no error
// (dv = 0, such as r * h where h is 0) is never flagged.
__device__ __forceinline__ bool near_tie(float v, float dv) {
  const float mid = __uint_as_float((__float_as_uint(v) & 0xFFFF0000u) |
                                    0x8000u);
  return fabsf(__fsub_rn(v, mid)) < dv || fabsf(v) < dv;
}

// *out = act(acc * scale + bias) as planar::affine (e: acc's error
// scale), unless the result may round otherwise in the CUDA-core order:
// then false, and the caller recomputes acc with seq_sum.
__device__ __forceinline__ bool affine_checked(float acc, float e,
                                               float scale, float bias,
                                               int relu, float* out) {
  const float v = __fadd_rn(__fmul_rn(acc, scale), bias);
  const float dv = fabsf(scale) * e;
  if (!(relu && v < -dv) && near_tie(v, dv)) return false;
  *out = relu ? fmaxf(v, 0.0f) : v;
  return true;
}

// The sum of output pixel m (of an output region `cols` wide), channel n,
// in the CUDA-core loop's order: over the segments in turn, input channel
// by input channel, taps ky then kx, FMA from 0 (products of bf16 values
// are exact, so each step is one rounding, as there). KS: the conv's edge
// (3 or 1).
template <int KS = 3, int NSEG>
__device__ __noinline__ float seq_sum(const Seg (&segs)[NSEG], int stride,
                                      int cols, int m, const bf16* w,
                                      int kp, int n) {
  constexpr int kTaps = KS * KS;
  const int oy = m / cols, ox = m - oy * cols;
  const bf16* wr = w + (size_t)n * wstride(kp, kTaps);
  float acc = 0.0f;
  for (int s = 0; s < NSEG; ++s) {
    const Seg& sg = segs[s];
    const bf16* a = sg.base + ((size_t)(stride * oy + sg.shift) * sg.cols +
                               stride * ox + sg.shift) * sg.ps;
    const bf16* wt = wr + sg.koff;
    int off[kTaps];
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap)
      off[tap] = ((tap / KS) * sg.cols + tap % KS) * sg.ps;
    // The 2 * taps loads of a channel go out together; the FMA chain keeps
    // the order.
#pragma unroll 2
    for (int ci = 0; ci < sg.nch; ++ci) {
      float x[kTaps], v[kTaps];
#pragma unroll
      for (int tap = 0; tap < kTaps; ++tap) {
        x[tap] = __bfloat162float(a[off[tap] + ci]);
        v[tap] = __bfloat162float(wt[tap * kp + ci]);
      }
#pragma unroll
      for (int tap = 0; tap < kTaps; ++tap)
        acc = __fmaf_rn(x[tap], v[tap], acc);
    }
  }
  return acc;
}

// Entries of a warp's queue of values to recompute in the CUDA-core order.
constexpr int kQueue = 32;
// Shared memory of the queues of a block, in bytes.
constexpr size_t kQueueBytes = (size_t)kWarps * kQueue * sizeof(unsigned);

// The stage over the rows x cols output region (npix = rows * cols
// pixels) and n_out output channels: for every pixel m and channel n <
// up(n_out, 8), epi(m, n, acc, e) with the f32 sum and its error scale
// (err_scale; the caller drops n >= n_out). Where epi returns false (the
// value may round otherwise in the CUDA-core order) the warp queues (m, n)
// in `queue` (kQueue entries per warp) and later calls exact(m, n), one
// entry per lane, so the serial recomputations run side by side. w: staged
// weights with kp channels per tap. KS: the conv's edge (3 or 1). Every
// warp of the block must call it; it does not synchronize.
template <int KS = 3, int NSEG, typename Epi, typename Exact>
__device__ __forceinline__ void conv_stage(const Seg (&segs)[NSEG],
                                           int stride, int rows, int cols,
                                           const bf16* w, int kp, int n_out,
                                           unsigned* queue, Epi&& epi,
                                           Exact&& exact) {
  constexpr int kTaps = KS * KS;
  const int npix = rows * cols;
  const int mt = (npix + 15) / 16, nt = (n_out + 7) / 8;
  int gs = 1;
  stage_groups(mt, nt, &gs);
  const int groups = (nt + gs - 1) / gs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ws = wstride(kp, kTaps);
  int k = 0;
#pragma unroll
  for (int s = 0; s < NSEG; ++s) k += kTaps * segs[s].nch;
  const float kf = (float)k;
  // ldmatrix roles: A rows are pixels (lanes 0-15 at k 0, 16-31 at k 8);
  // B rows are output channels (lanes 0-7 at k 0, 8-15 at k 8, then the
  // next N tile for x4).
  const int a_half = (lane >> 4) * 8;
  const int b_row = ((lane >> 4) << 3) + (lane & 7);
  const int b_half = ((lane >> 3) & 1) * 8;

  for (int task = warp; task < mt * groups; task += kWarps) {
    const int m_tile = task / groups, g = task - m_tile * groups;
    const int n0 = g * gs;
    const int ng = nt - n0 < gs ? nt - n0 : gs;
    int m = m_tile * 16 + (lane & 15);
    if (m >= npix) m = 0;  // a real pixel; its row is dropped below
    const int oy = m / cols, ox = m - (m / cols) * cols;

    float acc[kNTMax][4], sab[kNTMax][4], big[kNTMax];
#pragma unroll
    for (int j = 0; j < kNTMax; ++j) {
      big[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = sab[j][i] = 0.0f;
    }

#pragma unroll
    for (int s = 0; s < NSEG; ++s) {
      const Seg& sg = segs[s];
      const uint32_t a0 = saddr(
          sg.base +
          ((size_t)(stride * oy + sg.shift) * sg.cols + stride * ox +
           sg.shift) * sg.ps + a_half);
      const uint32_t b0 =
          saddr(w + (size_t)(n0 * 8 + b_row) * ws + sg.koff + b_half);
#pragma unroll
      for (int tap = 0; tap < kTaps; ++tap) {
        const int ky = tap / KS, kx = tap % KS;
        const uint32_t at = a0 + (uint32_t)((ky * sg.cols + kx) * sg.ps) * 2;
        const uint32_t bt = b0 + (uint32_t)(tap * kp) * 2;
        for (int kc = 0; kc < sg.chunks; ++kc) {
          uint32_t a[4];
          ldsm_x4(a, at + kc * 32);
#pragma unroll
          for (int j = 0; j < kNTMax; j += 2) {
            if (j >= ng) break;
            const uint32_t bj = bt + (uint32_t)(j * 8 * ws) * 2 + kc * 32;
            if (j + 1 < ng) {
              uint32_t b[4];
              ldsm_x4(b, bj);
              mma16816(acc[j], a, b[0], b[1]);
              mma16816(acc[j + 1], a, b[2], b[3]);
              mma_abs(sab[j], big[j], a, b[0], b[1]);
              mma_abs(sab[j + 1], big[j + 1], a, b[2], b[3]);
            } else {
              uint32_t b0r, b1r;
              ldsm_x2(b0r, b1r, bj);
              mma16816(acc[j], a, b0r, b1r);
              mma_abs(sab[j], big[j], a, b0r, b1r);
            }
          }
        }
      }
    }

    // C fragment: c0, c1 at (row lane/4, cols 2*(lane%4) + {0, 1}), c2, c3
    // eight rows below.
    const int r0 = m_tile * 16 + (lane >> 2), r1 = r0 + 8;
    const int cq = 2 * (lane & 3);
    unsigned* q = queue + warp * kQueue;
    int qn = 0;  // the same in every lane
    auto flush = [&]() {
      __syncwarp();
      for (int i = lane; i < qn; i += 32)
        exact((int)(q[i] >> 16), (int)(q[i] & 0xFFFFu));
      __syncwarp();
      qn = 0;
    };
    auto put = [&](int r, int n, float v, float sv, float bg) {
      const bool need = r < npix && !epi(r, n, v, err_scale(v, sv, bg, kf));
      const unsigned mask = __ballot_sync(0xFFFFFFFFu, need);
      if (mask == 0) return;
      if (qn + __popc(mask) > kQueue) flush();
      if (need)
        q[qn + __popc(mask & ((1u << lane) - 1))] =
            ((unsigned)r << 16) | (unsigned)n;
      qn += __popc(mask);
    };
#pragma unroll
    for (int j = 0; j < kNTMax; ++j) {
      if (j >= ng) break;
      const int n = (n0 + j) * 8 + cq;
      put(r0, n, acc[j][0], sab[j][0], big[j]);
      put(r0, n + 1, acc[j][1], sab[j][1], big[j]);
      put(r1, n, acc[j][2], sab[j][2], big[j]);
      put(r1, n + 1, acc[j][3], sab[j][3], big[j]);
    }
    flush();
  }
}

// Launch planning: output tile edge and blocks per launch.
struct Plan {
  int tile, blocks;
  size_t smem;
};

// The tile edge in {16, 8, 4} of least estimated time whose shared memory
// (smem_of(t)) fits: waves of blocks (132 SMs, one block each: the
// kernels take 125-205 registers a thread, so a second block of 256
// threads does not fit) times one block's critical path work_of(t). The
// halo a small tile recomputes and the idle SMs a large one leaves are
// both in the estimate. tile 0 if none fits.
template <typename S, typename W>
inline Plan plan_tile(int n, int oh, int ow, S smem_of, W work_of) {
  Plan best{0, 0, 0};
  double best_cost = 0.0;
  const int edges[3] = {16, 8, 4};
  for (int i = 0; i < 3; ++i) {
    const int t = edges[i];
    const size_t sm = smem_of(t);
    if (sm > kMaxSmem) continue;
    const long long blocks =
        (long long)n * ((oh + t - 1) / t) * ((ow + t - 1) / t);
    const long long waves = (blocks + 131) / 132;
    const double cost = (double)waves * work_of(t);
    if (best.tile == 0 || cost < best_cost) {
      best = Plan{t, (int)blocks, sm};
      best_cost = cost;
    }
  }
  return best;
}

// Critical-path estimate of one conv stage (per warp): K steps times the
// busiest warp's cost per step.
inline double stage_work(int npix, int n_out, int kp, int taps = 9) {
  int gs = 1;
  return (double)stage_groups((npix + 15) / 16, (n_out + 7) / 8, &gs) *
         taps * (kp / 16);
}

// Estimate of staging `elems` elements from device memory, in the units of
// stage_work (a K step of one warp is about 4 loads of a block's threads).
inline double staging_work(double elems) { return elems / kThreads / 2; }

}  // namespace mma
}  // namespace planar
