// Backward of phase_conv over contiguous NHWC on the CUDA cores (sm_90a): the
// weight gradient (two kernels) and the data gradient (one kernel), for the
// shapes the tensor-core kernels of phase_conv_backward_tc.cu do not take
// (weight gradient: Co no multiple of 8, or C no multiple of 8 where no
// flat row fits; data gradient: k other than 1 and 3, or C or Co no
// multiple of 8), and for comparisons on the card.
//
// Replaces: the VJP of eop_tpu/ops/pallas/conv_small_c.py::phase_conv.  The
// Pallas kernel has no backward of its own: the JAX trainer differentiates
// lax.conv_general_dilated and XLA supplies both gradients.  Same functions
// here, for the forward  y[b,ho,wo,co] = sum x[b, s*ho+ky-p, s*wo+kx-p, c] *
// w[ky,kx,c,co]  with fp32 accumulation and fp32 or bf16 in and out:
//
//   dw[ky,kx,c,co] = sum_{b,ho,wo} x[b, s*ho+ky-p, s*wo+kx-p, c] * dy[b,ho,wo,co]
//   dx[b,h,w,c]    = sum_{ky,kx,co} dy[b,ho,wo,co] * w[ky,kx,c,co]
//                    over the taps with s*ho+ky-p = h and s*wo+kx-p = w.
//
// Bound on an H100 at fp32 on the CUDA cores (67 TFLOP/s, 3.35 TB/s): like the
// forward, 3x3 and 6x6 shapes are bound by operations and 1x1 shapes by bytes.
//
// Weight gradient.  The output is tiny (k*k*C x Co, at most 576 x 128 on the
// main path) and the sum runs over every output pixel, so the GEMM
// dw[K, Co] = im2col(x)^T[K, M] * dy[M, Co] is split over M: block (split,
// K tile, Co tile) walks its own contiguous range of output rows (b, ho) in
// chunks of kBK pixels, keeps a register tile of dw, and writes it to
// part[split].  A second kernel adds the splits in index order.  No atomics:
// the result is the same bits on every run.  Walking whole output rows makes
// the pixel decode one division per chunk, and a run of K indices within one
// ky is a run of consecutive addresses in NHWC, so the loads of x coalesce.
//
// Data gradient, in gather form: one thread group per input pixel, so no
// atomics either.  At stride 2 the taps that reach an input pixel depend on
// the parity of (h + p, w + p), so blockIdx.z is the parity class and a block
// holds pixels of one class only: every pixel of a tile then has the same taps
// (ky = (ph + p) % s, step s) and no product with a structural zero is
// computed.  Within a class it is the forward's implicit GEMM with the roles
// turned: M = input pixels of the class, N = C, K = (taps of the class) x Co,
// reading dy where the forward reads x.  The weights come transposed,
// wt[ky,kx,co,c], so that a tile of them loads along consecutive addresses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;  // reduction indices per shared-memory chunk
constexpr int kTN = 4;   // output columns per thread

struct ConvShape {
  int B, H, W, C, Co, k, stride, pad, Ho, Wo;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ---------------------------------------------------------------------------
// weight gradient
// ---------------------------------------------------------------------------

// Tile of dw one block owns: BKD = (kThreads / (BN / kTN)) * TM flat K indices
// (K = k*k*C) by BN output channels; each thread a TM x kTN register tile.
template <int BN, int TM>
struct WgradTile {
  static constexpr int TX = BN / kTN;
  static constexpr int TY = kThreads / TX;
  static constexpr int BKD = TY * TM;
};

template <typename T, int BN, int TM>
__global__ void __launch_bounds__(kThreads)
wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     float* __restrict__ part, ConvShape s, int rows_per_split) {
  using Tile = WgradTile<BN, TM>;
  constexpr int TX = Tile::TX;
  constexpr int BKD = Tile::BKD;
  constexpr int A_PER = kBK * BKD / kThreads;  // x values a thread stages
  constexpr int B_PER = kBK * BN / kThreads;   // dy values a thread stages
  constexpr int A_ROWS = kThreads / BKD;       // pixels one A pass covers
  static_assert(kThreads % BKD == 0 && (kBK * BKD) % kThreads == 0, "tile");
  static_assert(A_PER * A_ROWS == kBK, "tile");

  __shared__ __align__(16) float As[kBK][BKD + 4];
  __shared__ __align__(16) float Bs[kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int K = s.k * s.k * s.C;
  const int kd0 = blockIdx.y * BKD;
  const int n0 = blockIdx.z * BN;
  const int R = s.B * s.Ho;  // output rows
  const int r_begin = blockIdx.x * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  const int cpr = (s.Wo + kBK - 1) / kBK;  // chunks per output row
  const int n_chunks = r_begin < r_end ? (r_end - r_begin) * cpr : 0;

  // every x value this thread stages has the same K index: decode it once
  const int a_kd = tid % BKD;
  const int a_p0 = tid / BKD;
  const int kidx = kd0 + a_kd;
  const bool k_ok = kidx < K;
  const int tap = kidx / s.C;
  const int a_c = kidx - tap * s.C;
  const int a_ky = tap / s.k;
  const int a_kx = tap - a_ky * s.k;

  float a_reg[A_PER];
  float b_reg[B_PER];

  auto load_chunk = [&](int t) {
    const int rr = t / cpr;
    const int row = r_begin + rr;
    const int ox0 = (t - rr * cpr) * kBK;
    const int b = row / s.Ho;
    const int oy = row - b * s.Ho;
    const int iy = oy * s.stride - s.pad + a_ky;
    const bool row_ok = k_ok && iy >= 0 && iy < s.H;
    const long long x_row = ((long long)(b * s.H + iy) * s.W) * s.C + a_c;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int ox = ox0 + a_p0 + i * A_ROWS;
      const int ix = ox * s.stride - s.pad + a_kx;
      const bool ok = row_ok && ox < s.Wo && ix >= 0 && ix < s.W;
      a_reg[i] = ok ? to_f32(x[x_row + (long long)ix * s.C]) : 0.f;
    }
    const long long dy_row = (long long)row * s.Wo;
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * kThreads;
      const int ox = ox0 + e / BN;
      const int col = n0 + e % BN;
      const bool ok = ox < s.Wo && col < s.Co;
      b_reg[i] = ok ? to_f32(dy[(dy_row + ox) * s.Co + col]) : 0.f;
    }
  };

  float acc[TM][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  if (n_chunks > 0) load_chunk(0);
  for (int t = 0; t < n_chunks; ++t) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) As[a_p0 + i * A_ROWS][a_kd] = a_reg[i];
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * kThreads;
      Bs[e / BN][e % BN] = b_reg[i];
    }
    __syncthreads();
    if (t + 1 < n_chunks) load_chunk(t + 1);  // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * kTN]);
      const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + (long long)blockIdx.x * K * s.Co;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int kd = kd0 + ty * TM + i;
    if (kd >= K) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx * kTN + j;
      if (col < s.Co) out[(long long)kd * s.Co + col] = acc[i][j];
    }
  }
}

// dw[i] = part[0][i] + part[1][i] + ... in that order.
template <typename T>
__global__ void wgrad_reduce_kernel(const float* __restrict__ part,
                                    T* __restrict__ dw, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
#pragma unroll 8
  for (int sp = 0; sp < splits; ++sp) acc += part[(long long)sp * n + i];
  dw[i] = from_f32<T>(acc);
}

// The tile for a shape: narrow outputs take 32 columns; TM grows until the
// tile covers K or reaches 4.
struct WgradPlan {
  int bn, tm, ktiles, ntiles;
};

WgradPlan wgrad_plan(int C, int Co, int k) {
  const int K = k * k * C;
  WgradPlan p;
  p.bn = Co <= 32 ? 32 : 64;
  const int ty = kThreads / (p.bn / kTN);
  p.tm = K <= ty ? 1 : (K <= 2 * ty ? 2 : 4);
  const int bkd = ty * p.tm;
  p.ktiles = (K + bkd - 1) / bkd;
  p.ntiles = (Co + p.bn - 1) / p.bn;
  return p;
}

template <typename T, int BN, int TM>
void launch_wgrad_partial(const void* x, const void* dy, float* part,
                          const ConvShape& s, int splits, const WgradPlan& p,
                          cudaStream_t stream) {
  const int R = s.B * s.Ho;
  const int rows_per_split = (R + splits - 1) / splits;
  dim3 grid(splits, p.ktiles, p.ntiles);
  wgrad_partial_kernel<T, BN, TM><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), part, s,
      rows_per_split);
}

template <typename T>
int launch_wgrad(const void* x, const void* dy, void* dw, float* part,
                 const ConvShape& s, int splits, cudaStream_t stream) {
  const WgradPlan p = wgrad_plan(s.C, s.Co, s.k);
#define EOP_WGRAD_CASE(BN_, TM_)                                         \
  if (p.bn == BN_ && p.tm == TM_)                                        \
    launch_wgrad_partial<T, BN_, TM_>(x, dy, part, s, splits, p, stream);
  EOP_WGRAD_CASE(32, 1)
  EOP_WGRAD_CASE(32, 2)
  EOP_WGRAD_CASE(32, 4)
  EOP_WGRAD_CASE(64, 1)
  EOP_WGRAD_CASE(64, 2)
  EOP_WGRAD_CASE(64, 4)
#undef EOP_WGRAD_CASE
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int n = s.k * s.k * s.C * s.Co;
  wgrad_reduce_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part, static_cast<T*>(dw), n, splits);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// data gradient
// ---------------------------------------------------------------------------

constexpr int kTM = 4;  // input pixels per thread

// One block computes a BM x BN tile of dx[M, C] for the pixels of one parity
// class (blockIdx.z).
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
dgrad_kernel(const T* __restrict__ dy, const T* __restrict__ wt,
             T* __restrict__ dx, ConvShape s) {
  constexpr int TX = BN / kTN;
  constexpr int TY = kThreads / TX;
  constexpr int BM = TY * kTM;
  constexpr int A_PER = kBK * BM / kThreads;
  constexpr int B_PER = kBK * BN / kThreads;
  constexpr int A_ROWS = kThreads / kBK;

  __shared__ __align__(16) float As[kBK][BM + 4];
  __shared__ __align__(16) float Bs[kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int st = s.stride;
  const int ph = blockIdx.z / st;
  const int pw = blockIdx.z - ph * st;
  const int Hc = s.H / st;  // pixels of this class: Hc x Wc per image
  const int Wc = s.W / st;
  // taps that reach this class: ky = ky0, ky0 + st, ... < k
  const int ky0 = (ph + s.pad) % st;
  const int kx0 = (pw + s.pad) % st;
  const int nky = ky0 < s.k ? (s.k - ky0 + st - 1) / st : 0;
  const int nkx = kx0 < s.k ? (s.k - kx0 + st - 1) / st : 0;
  const int Kc = nky * nkx * s.Co;
  // output position of tap (ky0, kx0) for class pixel (h2, w2): exact, since
  // ph + pad - ky0 is a multiple of st; tap (iky, ikx) lies iky, ikx before it
  const int dho = (ph + s.pad - ky0) / st;
  const int dwo = (pw + s.pad - kx0) / st;
  const long long M = (long long)s.B * Hc * Wc;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int hw_c = Hc * Wc;

  const int a_kk = tid % kBK;
  long long a_base[A_PER];
  int a_ho0[A_PER], a_wo0[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const long long m = m0 + tid / kBK + i * A_ROWS;
    if (m < M) {
      const int b = (int)(m / hw_c);
      const int r = (int)(m - (long long)b * hw_c);
      const int h2 = r / Wc;
      const int w2 = r - h2 * Wc;
      a_base[i] = (long long)b * s.Ho * s.Wo * s.Co;
      a_ho0[i] = h2 + dho;
      a_wo0[i] = w2 + dwo;
    } else {  // past the last pixel: every tap lands out of bounds
      a_base[i] = 0;
      a_ho0[i] = -(1 << 28);
      a_wo0[i] = 0;
    }
  }

  float a_reg[A_PER];
  float b_reg[B_PER];

  auto load_chunk = [&](int k0) {  // only called while Kc > 0, so nkx > 0
    const int kidx = k0 + a_kk;
    const int tap = kidx / s.Co;
    const int co = kidx - tap * s.Co;
    const int iky = tap / nkx;
    const int ikx = tap - iky * nkx;
    const bool k_ok = kidx < Kc;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int ho = a_ho0[i] - iky;
      const int wo = a_wo0[i] - ikx;
      const bool ok = k_ok && ho >= 0 && ho < s.Ho && wo >= 0 && wo < s.Wo;
      a_reg[i] = ok ? to_f32(dy[a_base[i] + ((long long)ho * s.Wo + wo) * s.Co + co])
                    : 0.f;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * kThreads;
      const int kb = k0 + e / BN;
      const int col = n0 + e % BN;
      const int tb = kb / s.Co;
      const int cb = kb - tb * s.Co;
      const int jy = tb / nkx;
      const int ky = ky0 + jy * st;
      const int kx = kx0 + (tb - jy * nkx) * st;
      const bool ok = kb < Kc && col < s.C;
      b_reg[i] = ok ? to_f32(wt[((long long)(ky * s.k + kx) * s.Co + cb) * s.C + col])
                    : 0.f;
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  if (Kc > 0) load_chunk(0);
  for (int k0 = 0; k0 < Kc; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) As[a_kk][tid / kBK + i * A_ROWS] = a_reg[i];
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * kThreads;
      Bs[e / BN][e % BN] = b_reg[i];
    }
    __syncthreads();
    if (k0 + kBK < Kc) load_chunk(k0 + kBK);  // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * kTM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * kTN]);
      const float av[kTM] = {a.x, a.y, a.z, a.w};
      const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + ty * kTM + i;
    if (m >= M) continue;
    const int b = (int)(m / hw_c);
    const int r = (int)(m - (long long)b * hw_c);
    const int h2 = r / Wc;
    const int w2 = r - h2 * Wc;
    const long long px =
        ((long long)(b * s.H + h2 * st + ph) * s.W + w2 * st + pw) * s.C;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx * kTN + j;
      if (col < s.C) dx[px + col] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch_dgrad(const void* dy, const void* wt, void* dx, const ConvShape& s,
                 cudaStream_t stream) {
  const int st = s.stride;
  const long long M = (long long)s.B * (s.H / st) * (s.W / st);
  if (s.C <= 32) {
    constexpr int BN = 32, BM = (kThreads / (BN / kTN)) * kTM;
    dim3 grid((unsigned)((M + BM - 1) / BM), (s.C + BN - 1) / BN, st * st);
    dgrad_kernel<T, BN><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(wt),
        static_cast<T*>(dx), s);
  } else {
    constexpr int BN = 64, BM = (kThreads / (BN / kTN)) * kTM;
    dim3 grid((unsigned)((M + BM - 1) / BM), (s.C + BN - 1) / BN, st * st);
    dgrad_kernel<T, BN><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(wt),
        static_cast<T*>(dx), s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// How many splits of the output rows phase_conv_wgrad should be given for this
// shape on a card with `sms` multiprocessors: enough blocks to fill the card
// about four times over, at most one split per output row (B * Ho of them).
// The caller allocates part as fp32 [splits, k*k*C*Co].
extern "C" int phase_conv_wgrad_splits(int C, int Co, int k, int rows, int sms) {
  const WgradPlan p = wgrad_plan(C, Co, k);
  const int tiles = p.ktiles * p.ntiles;
  int splits = (4 * sms + tiles - 1) / tiles;
  if (splits > rows) splits = rows;
  if (splits > 1024) splits = 1024;
  return splits < 1 ? 1 : splits;
}

// x [B, H, W, C], dy [B, Ho, Wo, Co], dw [k, k, C, Co], contiguous and of one
// type: dtype 0 = float32, 1 = bfloat16; part is fp32 scratch
// [splits, k*k*C*Co].  Returns the first cudaGetLastError() that is not 0.
extern "C" int phase_conv_wgrad(int dtype, const void* x, const void* dy,
                                void* dw, void* part, int splits, int B, int H,
                                int W, int C, int Co, int k, int stride, int pad,
                                int Ho, int Wo, void* stream) {
  const ConvShape s{B, H, W, C, Co, k, stride, pad, Ho, Wo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0) return launch_wgrad<float>(x, dy, dw, p, s, splits, st);
  if (dtype == 1) return launch_wgrad<__nv_bfloat16>(x, dy, dw, p, s, splits, st);
  return (int)cudaErrorInvalidValue;
}

// dy [B, Ho, Wo, Co], wt [k, k, Co, C] (the HWIO weights with their last two
// axes exchanged), dx [B, H, W, C], contiguous and of one type.  Every element
// of dx is written.  H and W are multiples of the stride.
extern "C" int phase_conv_dgrad(int dtype, const void* dy, const void* wt,
                                void* dx, int B, int H, int W, int C, int Co,
                                int k, int stride, int pad, int Ho, int Wo,
                                void* stream) {
  const ConvShape s{B, H, W, C, Co, k, stride, pad, Ho, Wo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dgrad<float>(dy, wt, dx, s, st);
  if (dtype == 1) return launch_dgrad<__nv_bfloat16>(dy, wt, dx, s, st);
  return (int)cudaErrorInvalidValue;
}
