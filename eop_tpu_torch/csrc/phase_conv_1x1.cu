// Small 1x1 convolutions over contiguous NHWC on the CUDA cores (sm_90a):
// phase_conv's variant `small_1x1`, for the 1x1 stride-1 convs with C and Co
// multiples of 8 and C * Co at most 512 (YOLOX-Nano's 16- and 32-channel
// ones), forward and data gradient.
//
// Replaces: eop_tpu/ops/pallas/conv_small_c.py::phase_conv (the Pallas TPU
// kernel `_conv_kernel`, launched by `_phase_conv_s1`) at these shapes, and
// their data gradient, which JAX leaves to XLA.  For a 1x1 stride-1 conv the
// NHWC input is a dense [M, C] matrix (M = B * H * W) and the conv is
// y[M, Co] = x[M, C] . W[C, Co]; the data gradient dx[M, C] = dy[M, Co] . W^T
// is the same product with the HWIO weights [1, 1, C, Co] read as [Co, C]
// (`transpose_w`).  fp32 accumulation, output in the input type, optionally
// followed by a per-channel scale and shift and SiLU.
//
// Bound on an H100: bytes.  Nano's 16 -> 32 conv moves 192 bytes a pixel in
// fp32 (96 in bf16) for 512 FMAs; at 3.35 TB/s and 67 TFLOP/s the FMAs take
// about a quarter of the byte time.  So the kernel stays on the CUDA cores
// (fp32 is exact without split-TF32 products, and no weights are packed) and
// its design is about moving each byte once, in whole sectors, with enough
// of them in flight:
//
//  * persistent blocks, as many as fit on the card, walk tiles of kTileM
//    consecutive pixels; a tile of x is one contiguous run of memory, fetched
//    by one bulk asynchronous copy into a ring of kStages shared-memory
//    stages, each completing on an mbarrier, so the next tiles' copies are in
//    flight while this tile's FMAs run.  Small blocks (two warps) keep many
//    tiles in flight on each SM: Nano's convs have only a few hundred tiles;
//  * a thread owns CG consecutive output channels of one pixel at a time
//    (G = N / CG threads a pixel, S = 32 / G pixels a warp), with its K x CG
//    weights, scale and shift in registers, loaded while the block's first
//    tiles are on their way: the only shared-memory reads are x's, each a
//    16-byte broadcast to the G threads of a pixel feeding 4 * CG FMAs
//    (fp32; 8 * CG in bf16);
//  * the S pixels of a warp are consecutive, so its stores (16 bytes a
//    thread in fp32) cover S * N contiguous outputs: whole sectors, where a
//    thread storing a whole pixel would write a part of 32 sectors a
//    store instruction.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 64;   // two warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileM = 128;    // pixels of one tile
constexpr int kStages = 4;     // tiles of the ring
constexpr int kMaxK = 64;      // input channels at most
constexpr int kMaxProduct = 512;  // K * N at most (ops/phase_conv.py SMALL_1X1)

// How a warp splits a pixel's N outputs: CG channels a thread (its weights
// K x CG registers), G threads a pixel, S pixels a warp (the lanes from S * G
// on idle where G does not divide 32).
template <int K, int N>
struct Split {
  static constexpr int CG = K <= 32 ? 4 : 2;
  static constexpr int G = N / CG;
  static constexpr int S = 32 / G;
  static_assert(N % CG == 0 && G >= 1 && G <= 32, "split");
};

struct Params {
  long long M;
  int num_tiles, transpose_w;
  Epilogue epilogue;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// Eight consecutive input values of one pixel's row in the ring, as fp32.
__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(src);
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) v[2 * i] = bf16_lo(u[i]), v[2 * i + 1] = bf16_hi(u[i]);
}

// CG consecutive outputs of one pixel in one store (16 bytes at the most).
__device__ __forceinline__ void store_cg(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_cg(float* dst, const float (&v)[2]) {
  *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ void store_cg(__nv_bfloat16* dst, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}
__device__ __forceinline__ void store_cg(__nv_bfloat16* dst, const float (&v)[2]) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v[0], v[1]);
}

// Shared memory: the ring's kStages stages of kTileM rows of K values (each
// stage a multiple of 16 bytes: K is a multiple of 8), then an mbarrier a
// stage.
constexpr int smem_bytes(int K, int es) { return kStages * (kTileM * K * es + 8); }
constexpr int kMaxSmem = 227 * 1024;
static_assert(smem_bytes(kMaxK, 4) <= kMaxSmem, "ring too deep");

template <typename T, int K, int N>
__global__ void __launch_bounds__(kThreads)
conv1x1_small_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, const Params p) {
  using Sp = Split<K, N>;
  constexpr int CG = Sp::CG, G = Sp::G, S = Sp::S;
  constexpr int kStage = kTileM * K;  // elements of one stage
  extern __shared__ __align__(128) uint8_t smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const uint32_t bars = smem_u32(ring + kStages * kStage);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slot = lane / G;          // this thread's pixel of the warp's S
  const int c0 = (lane % G) * CG;     // its first output channel
  const bool active = slot < S;

  auto fetch = [&](int tile, int s) {
    const long long m0 = (long long)tile * kTileM;
    const long long rows = p.M - m0 < kTileM ? p.M - m0 : kTileM;
    const uint32_t bytes = (uint32_t)(rows * K * (int)sizeof(T));
    mbar_expect_tx(bars + 8u * s, bytes);
    bulk_load_1d(smem_u32(ring + s * kStage), x + m0 * K, bytes, bars + 8u * s);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8u * s, 1);
    fence_barrier_init();
    // the block's first kStages - 1 tiles are in flight while the weights
    // are loaded
    for (int s = 0; s < kStages - 1; ++s)
      if ((int)blockIdx.x + s * (int)gridDim.x < p.num_tiles)
        fetch(blockIdx.x + s * gridDim.x, s);
  }
  // W[k][c0 + c] = w[k * N + c0 + c], or w[(c0 + c) * K + k] for the data
  // gradient; the epilogue of the same channels
  float wr[K][CG], sc[CG], sh[CG];
  const bool affine = p.epilogue.scale != nullptr;
#pragma unroll
  for (int c = 0; c < CG; ++c) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      wr[k][c] = to_f32(p.transpose_w ? w[(c0 + c) * K + k] : w[k * N + c0 + c]);
    sc[c] = affine ? __ldg(p.epilogue.scale + c0 + c) : 1.f;
    sh[c] = affine ? __ldg(p.epilogue.shift + c0 + c) : 0.f;
  }
  __syncthreads();  // the barriers' initialisation is seen by every thread

  int it = 0;
  for (int tile = blockIdx.x; tile < p.num_tiles; tile += gridDim.x, ++it) {
    const int s = it % kStages;
    // the stage before s was read in the previous iteration, which ended in
    // a barrier: refill it with the tile kStages - 1 ahead
    const int ahead = tile + (kStages - 1) * (int)gridDim.x;
    if (tid == 0 && ahead < p.num_tiles) fetch(ahead, (it + kStages - 1) % kStages);
    mbar_wait(bars + 8u * s, (uint32_t)(it / kStages) & 1u);

    const long long m0 = (long long)tile * kTileM;
    const int rows = p.M - m0 < kTileM ? (int)(p.M - m0) : kTileM;
    const T* xs = ring + s * kStage;
    for (int r = warp * S + slot; active && r < rows; r += kWarps * S) {
      float acc[CG];
#pragma unroll
      for (int c = 0; c < CG; ++c) acc[c] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < K; k0 += 8) {
        float xv[8];
        load8(xs + r * K + k0, xv);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int c = 0; c < CG; ++c) acc[c] = fmaf(xv[kk], wr[k0 + kk][c], acc[c]);
      }
      if (affine || p.epilogue.act) {
#pragma unroll
        for (int c = 0; c < CG; ++c) acc[c] = apply(acc[c], sc[c], sh[c], p.epilogue.act);
      }
      store_cg(y + (m0 + r) * N + c0, acc);
    }
    __syncthreads();  // every thread is done with stage s before it is refilled
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <typename T, int K, int N>
int launch(const void* x, const void* w, void* y, const Params& p, cudaStream_t stream) {
  auto kernel = conv1x1_small_kernel<T, K, N>;
  constexpr int smem = smem_bytes(K, (int)sizeof(T));
  static int blocks_per_sm = 0;
  if (blocks_per_sm == 0) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (blocks_per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  }
  const int grid = min(p.num_tiles, sm_count() * blocks_per_sm);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x),
                                           static_cast<const T*>(w), static_cast<T*>(y), p);
  return (int)cudaGetLastError();
}

// Every (K, N) with K and N multiples of 8 and K * N <= kMaxProduct.
template <typename T>
int dispatch(int K, int N, const void* x, const void* w, void* y, const Params& p,
             cudaStream_t st) {
#define EOP_KN(KK, NN) \
  if (K == KK && N == NN) return launch<T, KK, NN>(x, w, y, p, st)
  EOP_KN(8, 8); EOP_KN(8, 16); EOP_KN(8, 24); EOP_KN(8, 32);
  EOP_KN(8, 40); EOP_KN(8, 48); EOP_KN(8, 56); EOP_KN(8, 64);
  EOP_KN(16, 8); EOP_KN(16, 16); EOP_KN(16, 24); EOP_KN(16, 32);
  EOP_KN(24, 8); EOP_KN(24, 16); EOP_KN(32, 8); EOP_KN(32, 16);
  EOP_KN(40, 8); EOP_KN(48, 8); EOP_KN(56, 8); EOP_KN(64, 8);
#undef EOP_KN
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// y[M, N] = x[M, K] . W, W the weights w read as [K, N] (transpose_w = 0: w
// is [K, N], the forward's HWIO [1, 1, C, Co]) or as the transpose of [N, K]
// (transpose_w = 1: the data gradient, K = Co, N = C).  x, w, y contiguous
// and of one type (dtype 0 = float32, 1 = bfloat16), x and y 16-byte
// aligned; K and N multiples of 8, K at most 64, K * N at most 512; scale
// and shift fp32 [N] or both null; act 0 or 1 (SiLU).  Allocates nothing;
// returns cudaGetLastError() of the launch (0 on success).
extern "C" int phase_conv_small_1x1(int dtype, const void* x, const void* w, void* y,
                                    const void* scale, const void* shift, int act,
                                    long long M, int K, int N, int transpose_w,
                                    void* stream) {
  if (K % 8 != 0 || N % 8 != 0 || K < 8 || K > kMaxK || N < 8 || K * N > kMaxProduct ||
      M < 1 || (dtype != 0 && dtype != 1) || (scale == nullptr) != (shift == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.M = M;
  p.num_tiles = (int)((M + kTileM - 1) / kTileM);
  p.transpose_w = transpose_w;
  p.epilogue = {static_cast<const float*>(scale), static_cast<const float*>(shift), act};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(K, N, x, w, y, p, st)
                    : dispatch<__nv_bfloat16>(K, N, x, w, y, p, st);
}
