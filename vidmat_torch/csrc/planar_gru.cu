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
// 0.2 G multiply-adds).
//
// bf16 planes (the serving path) run on the tensor cores
// (planar_mma.cuh): every region is staged channels-last, each of the
// three convs is an implicit GEMM over mma.sync.m16n8k16 whose epilogue
// writes the next stage's region (b, then rh and z) in shared memory, and
// the block reorders the weights into [n][tap][k] itself: the decoder
// conv's beside its input, then the gate and candidate weights over both
// once the conv is done. The tile edge (16, 8 or 4) is the one of least
// estimated time whose shared memory fits (mma::plan_tile): at these
// grids device-memory latency of the staging and the halo recompute, not
// the arithmetic, set the time. f32 planes are the parity instantiation:
// the CUDA-core FMAs below (exact products, the 1e-5 bar).

#include "planar_mma.cuh"

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

template <bool FUSED>
cudaError_t launch_f32(Args a, int n, cudaStream_t stream) {
  const int cin = a.in.total;
  auto smem_of = [&](int t) {
    return Smem<float>::bytes(a.c, cin, t, FUSED);
  };
  a.tile = pick_tile(n, a.hh, a.ww, smem_of);
  if (!grid_ok(n, a.hh, a.ww, a.tile)) return cudaErrorInvalidValue;
  const size_t smem = smem_of(a.tile);
  cudaError_t err =
      set_smem((const void*)planar_gru_kernel<float, FUSED>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.ww + a.tile - 1) / a.tile, (a.hh + a.tile - 1) / a.tile,
                  n);
  planar_gru_kernel<float, FUSED><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---- bf16 planes: tensor cores ----

using mma::bf16;

// Shared memory of the bf16 kernel (offsets in bytes): z [t^2][c] f32
// and its error scale dz [t^2][c] f32; bh, the t+4 region [b | h | 0] (ps_bh); rh, the t+2 region (ps_rh); then
// one area used twice: the conv's input region (t+6, ps_in) and weights
// [2c][9 * cinp] (fused only), later the gate weights [2c][9 * up(2c, 16)]
// and the candidate weights [c][9 * 2 * up(c, 16)] (x from bh in the first
// half of each tap's k, rh in the second); the warps' recompute queues.
struct Layout {
  int e3, e2, e1, cinp, ps_in, ps_bh, ps_rh, kg, kc;
  size_t z, bh, rh, in, w, wg, wc, queue, total;

  __host__ __device__ Layout(int c, int cin, int t, bool fused) {
    e3 = t + 6;
    e2 = t + 4;
    e1 = t + 2;
    cinp = mma::up(cin, 16);
    ps_in = mma::pstride(cin);
    ps_bh = mma::pstride(2 * c);
    ps_rh = mma::pstride(c);
    kg = mma::up(2 * c, 16);
    kc = 2 * mma::up(c, 16);
    z = 0;
    bh = z + (size_t)2 * t * t * c * sizeof(float);
    bh = (bh + 15) / 16 * 16;
    rh = bh + (size_t)e2 * e2 * ps_bh * sizeof(bf16);
    in = rh + (size_t)e1 * e1 * ps_rh * sizeof(bf16);
    w = in + (fused ? (size_t)e3 * e3 * ps_in * sizeof(bf16) : 0);
    const size_t conv_end =
        fused ? w + mma::welems(2 * c, cinp) * sizeof(bf16) : in;
    wg = in;
    wc = wg + mma::welems(2 * c, kg) * sizeof(bf16);
    const size_t gru_end = wc + mma::welems(c, kc) * sizeof(bf16);
    queue = conv_end > gru_end ? conv_end : gru_end;
    total = queue + mma::kQueueBytes;
  }
};

template <bool FUSED>
__global__ void __launch_bounds__(kThreads) planar_gru_kernel_mma(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = a.tile, c = a.c, b = blockIdx.z;
  const int oy0 = blockIdx.y * t, ox0 = blockIdx.x * t;
  const int cin = a.in.total;
  const Layout L(c, cin, t, FUSED);
  float* z = (float*)(smem_raw + L.z);
  float* dz = z + t * t * c;
  bf16* bh = (bf16*)(smem_raw + L.bh);
  bf16* rh = (bf16*)(smem_raw + L.rh);
  const int e2 = L.e2, e1 = L.e1;
  const int hw = a.hh * a.ww;

  Planes hp{};
  hp.p[0] = a.h;
  hp.c[0] = c;
  hp.n = 1;
  hp.total = c;
  // bh = [b | h | 0] on the t+4 region (origin -2); rh's padding channels.
  mma::stage_cl(hp, b, a.hh, a.ww, oy0 - 2, ox0 - 2, e2, e2, bh, L.ps_bh, c,
                L.kg);
  mma::zero_cl(rh, e1 * e1, L.ps_rh, c, mma::up(c, 16));
  unsigned* queue = (unsigned*)(smem_raw + L.queue);
  if (FUSED) {
    bf16* in = (bf16*)(smem_raw + L.in);
    bf16* w = (bf16*)(smem_raw + L.w);
    mma::stage_cl(a.in, b, a.hh, a.ww, oy0 - 3, ox0 - 3, L.e3, L.e3, in,
                  L.ps_in, 0, L.cinp);
    mma::stage_w((const bf16*)a.w, 2 * c, cin, L.cinp, cin, cin, w);
    __syncthreads();

    // The decoder conv on the t+4 region (origin -2): channels < c are a,
    // written on the tile to device memory; the rest are b, into bh.
    const mma::Seg segs[1] = {{in, L.e3, L.ps_in, 0, L.cinp / 16, 0, cin}};
    bf16* out_a = (bf16*)a.a + (long long)b * c * hw;
    auto put = [&](int m, int ch, float v) {
      const int ly = m / e2, lx = m - ly * e2;
      if (ch < c)
        out_a[(long long)ch * hw + (oy0 - 2 + ly) * a.ww + ox0 - 2 + lx] =
            __float2bfloat16_rn(v);
      else
        bh[(size_t)m * L.ps_bh + ch - c] = __float2bfloat16_rn(v);
    };
    mma::conv_stage(
        segs, 1, e2, e2, w, L.cinp, 2 * c, queue,
        [&](int m, int ch, float acc, float e) {
          if (ch >= 2 * c) return true;
          const int ly = m / e2, lx = m - ly * e2;
          const int y = oy0 - 2 + ly, x = ox0 - 2 + lx;
          const bool inside = y >= 0 && y < a.hh && x >= 0 && x < a.ww;
          if (ch < c &&
              (!inside || ly < 2 || ly >= t + 2 || lx < 2 || lx >= t + 2))
            return true;  // a: the tile only
          float v = 0.0f;
          if (inside &&
              !mma::affine_checked(acc, e, a.scale[ch], a.bias[ch], 1, &v))
            return false;
          put(m, ch, v);
          return true;
        },
        [&](int m, int ch) {
          put(m, ch, affine(mma::seq_sum(segs, 1, e2, m, w, L.cinp, ch),
                            a.scale[ch], a.bias[ch], 1));
        });
    __syncthreads();
  } else {
    mma::stage_cl(a.in, b, a.hh, a.ww, oy0 - 2, ox0 - 2, e2, e2, bh,
                  L.ps_bh, 0, c);
  }
  bf16* wg = (bf16*)(smem_raw + L.wg);
  bf16* wc = (bf16*)(smem_raw + L.wc);
  const int cp = mma::up(c, 16);
  mma::stage_w((const bf16*)a.wg, 2 * c, 2 * c, L.kg, 2 * c, 2 * c, wg);
  mma::stage_w((const bf16*)a.wc, c, 2 * c, L.kc, c, cp, wc);
  __syncthreads();

  // Gates on the t+2 region (origin -1): r * h into rh (zero outside the
  // image: h is), z and its error scale on the tile.
  const mma::Seg gsegs[1] = {{bh, e2, L.ps_bh, 0, L.kg / 16, 0, 2 * c}};
  auto h_at = [&](int ly, int lx, int ch) {  // h on the t+4 region
    return __bfloat162float(bh[((size_t)ly * e2 + lx) * L.ps_bh + c + ch]);
  };
  auto r_h = [&](int m, int ch, float acc) {
    return __fmul_rn(sigmoid(__fadd_rn(acc, a.bg[ch])),
                     h_at(m / e1 + 1, m % e1 + 1, ch));
  };
  mma::conv_stage(
      gsegs, 1, e1, e1, wg, L.kg, 2 * c, queue,
      [&](int m, int ch, float acc, float e) {
        if (ch >= 2 * c) return true;
        const int ly = m / e1, lx = m - ly * e1;
        const int y = oy0 - 1 + ly, x = ox0 - 1 + lx;
        const bool inside = y >= 0 && y < a.hh && x >= 0 && x < a.ww;
        // sigmoid's slope is at most 1/4.
        const float ds = 0.25f * e;
        if (ch < c) {
          float v = 0.0f;
          if (inside) {
            v = r_h(m, ch, acc);
            if (mma::near_tie(v, ds * fabsf(h_at(ly + 1, lx + 1, ch))))
              return false;
          }
          rh[(size_t)m * L.ps_rh + ch] = __float2bfloat16_rn(v);
        } else if (inside && ly >= 1 && ly <= t && lx >= 1 && lx <= t) {
          const int i = ((ly - 1) * t + lx - 1) * c + ch - c;
          z[i] = sigmoid(__fadd_rn(acc, a.bg[ch]));
          dz[i] = ds;
        }
        return true;
      },
      [&](int m, int ch) {
        rh[(size_t)m * L.ps_rh + ch] = __float2bfloat16_rn(
            r_h(m, ch, mma::seq_sum(gsegs, 1, e1, m, wg, L.kg, ch)));
      });
  __syncthreads();

  // Candidate and update on the tile: conv over [x (bh, first c channels),
  // rh]. Near a rounding midpoint z and the candidate are both recomputed
  // in the CUDA-core order.
  {
    const mma::Seg segs[2] = {{bh, e2, L.ps_bh, 1, cp / 16, 0, c},
                              {rh, e1, L.ps_rh, 0, cp / 16, cp, c}};
    bf16* out = (bf16*)a.h_new + (long long)b * c * hw;
    auto update = [&](int m, int ch, float cacc, float zz) {
      const float cand = tanhf(__fadd_rn(cacc, a.bc[ch]));
      const float hc = h_at(m / t + 2, m % t + 2, ch);
      return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, zz), hc),
                       __fmul_rn(zz, cand));
    };
    auto put = [&](int m, int ch, float hn) {
      const int ly = m / t, lx = m - ly * t;
      out[(long long)ch * hw + (oy0 + ly) * a.ww + ox0 + lx] =
          __float2bfloat16_rn(hn);
    };
    mma::conv_stage(
        segs, 1, t, t, wc, L.kc, c, queue,
        [&](int m, int ch, float acc, float e) {
          const int ly = m / t, lx = m - ly * t;
          if (ch >= c || oy0 + ly >= a.hh || ox0 + lx >= a.ww) return true;
          const float zz = z[m * c + ch];
          const float hn = update(m, ch, acc, zz);
          // h' moves by (c - h) dz + z dc; tanh's slope is at most 1, and
          // |c - h| <= 2.
          if (mma::near_tie(hn, 2.0f * dz[m * c + ch] + zz * e))
            return false;
          put(m, ch, hn);
          return true;
        },
        [&](int m, int ch) {
          const int ly = m / t, lx = m - ly * t;
          const float zs = mma::seq_sum(gsegs, 1, e1, (ly + 1) * e1 + lx + 1,
                                        wg, L.kg, c + ch);
          put(m, ch,
              update(m, ch, mma::seq_sum(segs, 1, t, m, wc, L.kc, ch),
                     sigmoid(__fadd_rn(zs, a.bg[c + ch]))));
        });
  }
}

mma::Plan plan_bf16(int c, int cin, int n, int hh, int ww, bool fused) {
  auto smem_of = [&](int t) { return Layout(c, cin, t, fused).total; };
  auto work_of = [&](int t) {
    const Layout L(c, cin, t, fused);
    double staged = (double)L.e2 * L.e2 * c * (fused ? 1 : 2) +
                    9.0 * (4 * c * c + 2 * c * c);
    double work = 0.0;
    if (fused) {
      staged += (double)L.e3 * L.e3 * L.cinp + 9.0 * 2 * c * cin;
      work += mma::stage_work(L.e2 * L.e2, 2 * c, L.cinp);
    }
    return work + mma::staging_work(staged) +
           mma::stage_work(L.e1 * L.e1, 2 * c, L.kg) +
           mma::stage_work(t * t, c, L.kc);
  };
  return mma::plan_tile(n, hh, ww, smem_of, work_of);
}

template <bool FUSED>
cudaError_t launch_bf16(Args a, int n, cudaStream_t stream) {
  const mma::Plan p = plan_bf16(a.c, a.in.total, n, a.hh, a.ww, FUSED);
  a.tile = p.tile;
  if (!grid_ok(n, a.hh, a.ww, a.tile)) return cudaErrorInvalidValue;
  cudaError_t err =
      set_smem((const void*)planar_gru_kernel_mma<FUSED>, p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.ww + a.tile - 1) / a.tile, (a.hh + a.tile - 1) / a.tile,
                  n);
  planar_gru_kernel_mma<FUSED><<<grid, kThreads, p.smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(const Args& a, int n, int f32, bool fused,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (f32)
    return fused ? launch_f32<true>(a, n, s) : launch_f32<false>(a, n, s);
  return fused ? launch_bf16<true>(a, n, s) : launch_bf16<false>(a, n, s);
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

// The launch vm_planar_conv_gru (fused = 1, cin input channels) or
// vm_planar_gru (fused = 0) makes for bf16 planes of these shapes:
// plan[0] tile edge (0: none fits), plan[1] blocks, plan[2] shared-memory
// bytes. Returns 0, or cudaErrorInvalidValue for shapes it refuses.
extern "C" int vm_planar_gru_plan(int fused, int cin, int n, int hh, int ww,
                                  int c, int* plan) {
  if (c < 1 || cin < 1) return (int)cudaErrorInvalidValue;
  const mma::Plan p = plan_bf16(c, cin, n, hh, ww, fused != 0);
  plan[0] = p.tile;
  plan[1] = p.blocks;
  plan[2] = (int)p.smem;
  return 0;
}
