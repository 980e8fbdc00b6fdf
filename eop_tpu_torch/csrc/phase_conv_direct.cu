// Direct implicit-GEMM convolution over contiguous NHWC on the CUDA cores
// (sm_90a): the variant of phase_conv for the shapes no other kernel takes
// (channel counts that are no multiple of 8, kernels other than 1x1, 3x3 and
// the 6x6 and 3x3 stems, stem rows that are no multiple of 16 bytes or wider
// than wgmma_rows' narrowest N tile leaves room for, small 1x1 convs at
// stride 2), none of which a conv of the port's models has, and the
// comparison the card's smoke run times the other kernels against.
//
// Replaces: eop_tpu/ops/pallas/conv_small_c.py::phase_conv (the Pallas TPU
// kernel `_conv_kernel`, launched by `_phase_conv_s1`).  Same function: an
// NHWC x HWIO convolution with symmetric padding, stride 1 or 2, fp32
// accumulation, output in the input type (fp32 or bf16), optionally followed
// by a per-channel scale and shift and SiLU.
//
// Bound on an H100: at fp32 on the CUDA cores (67 TFLOP/s, 3.35 TB/s) 3x3 and
// 6x6 convs are bound by operations and 1x1 convs by bytes.  The design:
//
//  * the GEMM view is M = output pixels, N = output channels, K = k*k*C, and
//    HWIO weights flatten to exactly [K, Co]; K is walked in flat chunks of
//    kBK, so a 3-channel stem wastes no chunk on padding channels, and a chunk
//    of consecutive K indices for one pixel is a run of consecutive addresses
//    in NHWC (taps along x are adjacent), so the input loads coalesce;
//  * stride and padding are index arithmetic with bounds-checked loads: no
//    padded copy, no space-to-depth copy and none of the structurally-zero
//    taps the TPU's phase form carries (7/16 of them for a 3x3/s2 conv);
//  * tiles are staged in shared memory as fp32 and each thread owns a 4x4
//    register tile of outputs (16 FMAs per two 16-byte shared loads); the next
//    chunk's global loads are issued into registers before the current chunk
//    is consumed, so they overlap the FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;  // K indices per shared-memory chunk
constexpr int kTM = 4;   // output pixels per thread
constexpr int kTN = 4;   // output channels per thread

struct ConvShape {
  int B, H, W, C, Co, k, stride, pad, Ho, Wo;
  const float* scale;  // per-channel epilogue, or null
  const float* shift;
  int act;             // 1 = SiLU
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

// One block computes a BM x BN tile of the [M, Co] output.
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
conv_nhwc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ y, ConvShape s) {
  constexpr int TX = BN / kTN;       // threads along output channels
  constexpr int TY = kThreads / TX;  // threads along output pixels
  constexpr int BM = TY * kTM;
  constexpr int A_PER = kBK * BM / kThreads;  // input values a thread stages
  constexpr int B_PER = kBK * BN / kThreads;  // weight values a thread stages
  constexpr int A_ROWS = kThreads / kBK;      // pixels one A pass covers
  static_assert(kThreads % kBK == 0 && (kBK * BN) % kThreads == 0, "tile");

  // +4 keeps each row 16-byte aligned for the float4 reads below
  __shared__ __align__(16) float As[kBK][BM + 4];
  __shared__ __align__(16) float Bs[kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long long M = (long long)s.B * s.Ho * s.Wo;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = s.k * s.k * s.C;
  const int hw_out = s.Ho * s.Wo;

  // Every A value this thread stages has the same K offset (a_kk) and one of
  // A_PER pixels; decode those pixels once.
  const int a_kk = tid % kBK;
  long long a_base[A_PER];
  int a_iy0[A_PER], a_ix0[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const long long m = m0 + tid / kBK + i * A_ROWS;
    if (m < M) {
      const int b = (int)(m / hw_out);
      const int r = (int)(m - (long long)b * hw_out);
      const int oy = r / s.Wo;
      const int ox = r - oy * s.Wo;
      a_base[i] = (long long)b * s.H * s.W * s.C;
      a_iy0[i] = oy * s.stride - s.pad;
      a_ix0[i] = ox * s.stride - s.pad;
    } else {  // past the last pixel: every tap lands out of bounds
      a_base[i] = 0;
      a_iy0[i] = -(1 << 28);
      a_ix0[i] = 0;
    }
  }

  float a_reg[A_PER];
  float b_reg[B_PER];

  auto load_chunk = [&](int k0) {
    const int kidx = k0 + a_kk;
    const int tap = kidx / s.C;
    const int c = kidx - tap * s.C;
    const int ky = tap / s.k;
    const int kx = tap - ky * s.k;
    const bool k_ok = kidx < K;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int iy = a_iy0[i] + ky;
      const int ix = a_ix0[i] + kx;
      const bool ok = k_ok && iy >= 0 && iy < s.H && ix >= 0 && ix < s.W;
      a_reg[i] = ok ? to_f32(x[a_base[i] + ((long long)iy * s.W + ix) * s.C + c])
                    : 0.f;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * kThreads;
      const int kk = e / BN;
      const int col = n0 + e % BN;
      const bool ok = k0 + kk < K && col < s.Co;
      b_reg[i] = ok ? to_f32(w[(long long)(k0 + kk) * s.Co + col]) : 0.f;
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  load_chunk(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) As[a_kk][tid / kBK + i * A_ROWS] = a_reg[i];
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * kThreads;
      Bs[e / BN][e % BN] = b_reg[i];
    }
    __syncthreads();
    if (k0 + kBK < K) load_chunk(k0 + kBK);  // in flight during the FMAs
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
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx * kTN + j;
      if (col >= s.Co) continue;
      float v = acc[i][j];
      if (s.scale != nullptr) v = fmaf(v, __ldg(s.scale + col), __ldg(s.shift + col));
      if (s.act == 1) v = v / (1.f + __expf(-v));
      y[m * s.Co + col] = from_f32<T>(v);
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, void* y, const ConvShape& s,
            cudaStream_t stream) {
  const long long M = (long long)s.B * s.Ho * s.Wo;
  if (s.Co <= 32) {  // narrow outputs: a 128-pixel x 32-channel tile
    constexpr int BN = 32, BM = (kThreads / (BN / kTN)) * kTM;
    dim3 grid((unsigned)((M + BM - 1) / BM), (s.Co + BN - 1) / BN);
    conv_nhwc_kernel<T, BN><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), s);
  } else {  // a 64-pixel x 64-channel tile
    constexpr int BN = 64, BM = (kThreads / (BN / kTN)) * kTM;
    dim3 grid((unsigned)((M + BM - 1) / BM), (s.Co + BN - 1) / BN);
    conv_nhwc_kernel<T, BN><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), s);
  }
}

}  // namespace

// x [B, H, W, C], w [k, k, C, Co], y [B, Ho, Wo, Co], all contiguous and of
// one type: dtype 0 = float32, 1 = bfloat16.  scale and shift are fp32 [Co]
// or both null; act 0 or 1 (SiLU).  Returns cudaGetLastError() of the launch
// (0 on success).
extern "C" int phase_conv_direct(int dtype, const void* x, const void* w, void* y,
                                 const void* scale, const void* shift, int act,
                                 int B, int H, int W, int C, int Co, int k,
                                 int stride, int pad, int Ho, int Wo,
                                 void* stream) {
  const ConvShape s{B, H, W, C, Co, k, stride, pad, Ho, Wo,
                    static_cast<const float*>(scale),
                    static_cast<const float*>(shift), act};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, w, y, s, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, y, s, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
