// ConvGRU step, standalone and fused behind its decoder conv:
//
//   vm_planar_gru:      h' = GRU(x, h)
//   vm_planar_conv_gru: mid = relu(conv3x3(concat(xs), w) * scale + bias),
//                       cast to T; a = mid[:C]; h' = GRU(mid[C:], h)
//
//   GRU(x, h):  r, z = sigmoid(conv3x3([x, h], wg) + bg)      f32
//               rh   = T(r * h)
//               c    = tanh(conv3x3([x, rh], wc) + bc)         f32
//               h'   = T((1 - z) * h + z * c)
//
// Replaces the TPU kernels vidmat/ops/pallas/planar.py planar_gru
// (_gru_kernel) and planar_conv_gru (_conv_gru_kernel), keeping their cast
// points (planar.py:418-450). The TPU kernels chain halos along a lane
// chunk; here a block owns a t x t output tile and chains them in shared
// memory:
//   conv (fused only): the input region of edge t+6 (origin -3) is staged;
//       b = mid[C:] is computed on the t+4 region (origin -2) and a =
//       mid[:C] on the tile itself, straight to device memory;
//   gates: r, z on the t+2 region (origin -1) from [b|x, h] on the t+4
//       region; rh is kept on the t+2 region, z on the tile;
//   candidate and update on the tile.
// b, h and rh are zero outside the image (the JAX kernel's interior mask:
// conv over zero padding would give relu(bias) != 0 for b there).
//
// Shared memory at the widest main-path site, d1 at 72x120 with 48 inputs,
// t = 16, bf16: 48*22^2*2 (inputs) + 24*20^2*2 (b, h) + 12*18^2*2 (rh) +
// 12*16^2*4 (z) = 46 + 19 + 8 + 12 KB.
//
// Main-path sites (1080p, s2d 2, once per frame): d3 [64, 40] -> 48,
// h 24 at 18x30; d2 [24, 24, 24] -> 32, h 16 at 36x60; d1 [16, 16, 16]
// -> 24, h 12 at 72x120. The standalone step runs on the unfused path
// (fuse_pairs=False). Bound: bytes on this card (d1 moves 1.2 MB and does
// 0.2 G multiply-adds); this CUDA-core kernel is limited by its
// shared-memory and weight loads and by the halo recompute.

#include "planar_common.cuh"

namespace {

using namespace planar;

struct Args {
  Planes in;  // fused: the conv's inputs; standalone: in.p[0] = x
  const void* w;
  const float* scale;
  const float* bias;
  const void* h;
  const void* wg;
  const float* bg;
  const void* wc;
  const float* bc;
  void* a;
  void* h_new;
  int hh, ww, c, tile;
};

template <typename T>
struct Smem {
  float* z;   // [c][t*t]
  T* bh;      // [2c][t+4][t+4]: b (or x), then h
  T* rh;      // [c][t+2][t+2]
  T* in;      // [cin][t+6][t+6] (fused only)

  __host__ __device__ static size_t bytes(int c, int cin, int t, bool fused) {
    const size_t e2 = t + 4, e1 = t + 2, e3 = t + 6;
    return (size_t)c * t * t * sizeof(float) +
           (2 * c * e2 * e2 + c * e1 * e1 + (fused ? cin * e3 * e3 : 0)) *
               sizeof(T);
  }
  __device__ Smem(unsigned char* raw, int c, int t) {
    z = (float*)raw;
    bh = (T*)(z + (size_t)c * t * t);
    rh = bh + (size_t)2 * c * (t + 4) * (t + 4);
    in = rh + (size_t)c * (t + 2) * (t + 2);
  }
};

// The decoder conv (fused path): b on the t+4 region into sm.bh[0:c), a on
// the tile to device memory.
template <typename T>
__device__ void conv_stage(const Args& a, Smem<T>& sm, int b, int oy0,
                           int ox0) {
  const int t = a.tile, c = a.c, feats = 2 * c, cin = a.in.total;
  const int e3 = t + 6, e2 = t + 4;
  const T* w = (const T*)a.w;
  const int groups = (c + CG - 1) / CG;
  const int p2 = e2 * e2;
  for (int item = threadIdx.x; item < p2 * groups; item += blockDim.x) {
    const int g = item / p2, p = item - g * p2;
    const int ly = p / e2, lx = p - ly * e2;
    const int y = oy0 - 2 + ly, x = ox0 - 2 + lx;
    const bool inside = y >= 0 && y < a.hh && x >= 0 && x < a.ww;
    float acc[CG];
#pragma unroll
    for (int j = 0; j < CG; ++j) acc[j] = 0.0f;
    if (inside)
      accum<T, 3>(acc, sm.in, cin, e3, e3, ly, lx, w, cin, 0, c + g * CG,
                  feats);
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      const int ch = g * CG + j;
      if (ch < c)
        sm.bh[ch * p2 + p] =
            inside ? from_f<T>(affine(acc[j], a.scale[c + ch],
                                      a.bias[c + ch], 1))
                   : zero<T>();
    }
  }
  T* out_a = (T*)a.a + (long long)b * c * a.hh * a.ww;
  const int p0 = t * t;
  for (int item = threadIdx.x; item < p0 * groups; item += blockDim.x) {
    const int g = item / p0, p = item - g * p0;
    const int ly = p / t, lx = p - ly * t;
    const int y = oy0 + ly, x = ox0 + lx;
    if (y >= a.hh || x >= a.ww) continue;
    float acc[CG];
#pragma unroll
    for (int j = 0; j < CG; ++j) acc[j] = 0.0f;
    accum<T, 3>(acc, sm.in, cin, e3, e3, ly + 2, lx + 2, w, cin, 0, g * CG,
                c);
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      const int ch = g * CG + j;
      if (ch < c)
        out_a[((long long)ch * a.hh + y) * a.ww + x] =
            from_f<T>(affine(acc[j], a.scale[ch], a.bias[ch], 1));
    }
  }
}

// Gates, candidate and update on sm.bh = [x | h] (t+4 region).
template <typename T>
__device__ void gru_stage(const Args& a, Smem<T>& sm, int b, int oy0,
                          int ox0) {
  const int t = a.tile, c = a.c;
  const int e2 = t + 4, e1 = t + 2;
  const int p2 = e2 * e2, p1 = e1 * e1, p0 = t * t;

  // r, z on the t+2 region (origin -1).
  const T* wg = (const T*)a.wg;
  const int ggroups = (2 * c + CG - 1) / CG;
  for (int item = threadIdx.x; item < p1 * ggroups; item += blockDim.x) {
    const int g = item / p1, p = item - g * p1;
    const int ly = p / e1, lx = p - ly * e1;
    const int y = oy0 - 1 + ly, x = ox0 - 1 + lx;
    const bool inside = y >= 0 && y < a.hh && x >= 0 && x < a.ww;
    const bool center = ly >= 1 && ly <= t && lx >= 1 && lx <= t;
    float acc[CG];
#pragma unroll
    for (int j = 0; j < CG; ++j) acc[j] = 0.0f;
    if (inside)
      accum<T, 3>(acc, sm.bh, 2 * c, e2, e2, ly, lx, wg, 2 * c, 0, g * CG,
                  2 * c);
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      const int ch = g * CG + j;
      if (ch < c) {
        float v = 0.0f;  // h is zero outside the image, so r * h is too
        if (inside) {
          const float r = sigmoid(__fadd_rn(acc[j], a.bg[ch]));
          v = __fmul_rn(r, to_f(sm.bh[(c + ch) * p2 + (ly + 1) * e2 + lx +
                                      1]));
        }
        sm.rh[ch * p1 + p] = from_f<T>(v);
      } else if (ch < 2 * c && center && inside) {
        sm.z[(ch - c) * p0 + (ly - 1) * t + lx - 1] =
            sigmoid(__fadd_rn(acc[j], a.bg[ch]));
      }
    }
  }
  __syncthreads();

  // Candidate and update on the tile.
  const T* wc = (const T*)a.wc;
  T* out = (T*)a.h_new + (long long)b * c * a.hh * a.ww;
  const int groups = (c + CG - 1) / CG;
  for (int item = threadIdx.x; item < p0 * groups; item += blockDim.x) {
    const int g = item / p0, p = item - g * p0;
    const int ly = p / t, lx = p - ly * t;
    const int y = oy0 + ly, x = ox0 + lx;
    if (y >= a.hh || x >= a.ww) continue;
    float acc[CG];
#pragma unroll
    for (int j = 0; j < CG; ++j) acc[j] = 0.0f;
    accum<T, 3>(acc, sm.bh, c, e2, e2, ly + 1, lx + 1, wc, 2 * c, 0, g * CG,
                c);
    accum<T, 3>(acc, sm.rh, c, e1, e1, ly, lx, wc, 2 * c, c, g * CG, c);
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      const int ch = g * CG + j;
      if (ch >= c) continue;
      const float cand = tanhf(__fadd_rn(acc[j], a.bc[ch]));
      const float hc = to_f(sm.bh[(c + ch) * p2 + (ly + 2) * e2 + lx + 2]);
      const float z = sm.z[ch * p0 + p];
      const float hn = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, z), hc),
                                 __fmul_rn(z, cand));
      out[((long long)ch * a.hh + y) * a.ww + x] = from_f<T>(hn);
    }
  }
}

template <typename T, bool FUSED>
__global__ void __launch_bounds__(kThreads) planar_gru_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = a.tile, c = a.c, b = blockIdx.z;
  const int oy0 = blockIdx.y * t, ox0 = blockIdx.x * t;
  const int e2 = t + 4;
  Smem<T> sm(smem_raw, c, t);
  const long long img = (long long)b * c * a.hh * a.ww;
  stage((const T*)a.h + img, c, a.hh, a.ww, oy0 - 2, ox0 - 2, e2, e2,
        sm.bh + (size_t)c * e2 * e2);
  if (FUSED) {
    stage_planes(a.in, b, a.hh, a.ww, oy0 - 3, ox0 - 3, t + 6, t + 6, sm.in);
    __syncthreads();
    conv_stage(a, sm, b, oy0, ox0);
  } else {
    stage((const T*)a.in.p[0] + img, c, a.hh, a.ww, oy0 - 2, ox0 - 2, e2, e2,
          sm.bh);
  }
  __syncthreads();
  gru_stage(a, sm, b, oy0, ox0);
}

template <typename T, bool FUSED>
cudaError_t launch(Args a, int n, cudaStream_t stream) {
  const int cin = a.in.total;
  auto smem_of = [&](int t) { return Smem<T>::bytes(a.c, cin, t, FUSED); };
  a.tile = pick_tile(n, a.hh, a.ww, smem_of);
  if (!grid_ok(n, a.hh, a.ww, a.tile)) return cudaErrorInvalidValue;
  const size_t smem = smem_of(a.tile);
  cudaError_t err =
      set_smem((const void*)planar_gru_kernel<T, FUSED>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.ww + a.tile - 1) / a.tile, (a.hh + a.tile - 1) / a.tile,
                  n);
  planar_gru_kernel<T, FUSED><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(const Args& a, int n, int f32, bool fused,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (f32)
    return fused ? launch<float, true>(a, n, s)
                 : launch<float, false>(a, n, s);
  return fused ? launch<__nv_bfloat16, true>(a, n, s)
               : launch<__nv_bfloat16, false>(a, n, s);
}

}  // namespace

// x, h, h_new: (n, c, hh, ww); wg: (2c, 2c, 3, 3); wc: (c, 2c, 3, 3) in
// the plane dtype; bg (2c,), bc (c,) f32. Planes are bf16 (f32 = 0) or
// f32.
extern "C" int vm_planar_gru(const void* x, const void* h, const void* wg,
                             const float* bg, const void* wc,
                             const float* bc, void* h_new, int n, int hh,
                             int ww, int c, int f32, void* stream) {
  if (c < 1) return (int)cudaErrorInvalidValue;
  Args a{};
  a.in.p[0] = x;
  a.in.c[0] = c;
  a.in.n = 1;
  a.in.total = c;
  a.h = h;
  a.wg = wg;
  a.bg = bg;
  a.wc = wc;
  a.bc = bc;
  a.h_new = h_new;
  a.hh = hh;
  a.ww = ww;
  a.c = c;
  return (int)dispatch(a, n, f32, false, stream);
}

// xs: n_in pointers to (n, cins[i], hh, ww); w: (2c, sum cins, 3, 3);
// scale, bias: (2c,) f32; a_out, h_new: (n, c, hh, ww); GRU weights as in
// vm_planar_gru.
extern "C" int vm_planar_conv_gru(const void* const* xs, const int* cins,
                                  int n_in, const void* w, const float* scale,
                                  const float* bias, const void* h,
                                  const void* wg, const float* bg,
                                  const void* wc, const float* bc,
                                  void* a_out, void* h_new, int n, int hh,
                                  int ww, int c, int f32, void* stream) {
  if (n_in < 1 || n_in > kMaxIn || c < 1) return (int)cudaErrorInvalidValue;
  Args a{};
  a.in = make_planes(xs, cins, n_in);
  a.w = w;
  a.scale = scale;
  a.bias = bias;
  a.h = h;
  a.wg = wg;
  a.bg = bg;
  a.wc = wc;
  a.bc = bc;
  a.a = a_out;
  a.h_new = h_new;
  a.hh = hh;
  a.ww = ww;
  a.c = c;
  return (int)dispatch(a, n, f32, true, stream);
}
