// Implicit-GEMM convolution over contiguous NHWC on Hopper's tensor cores
// (sm_90a): TMA-fed shared-memory rings, wgmma, BN + SiLU in the epilogue.
//
// Replaces: eop_tpu/ops/pallas/conv_small_c.py::phase_conv (the Pallas TPU
// kernel `_conv_kernel`, launched by `_phase_conv_s1`).  Same function: an
// NHWC x HWIO convolution with symmetric padding, stride 1 or 2, fp32
// accumulation, output in the input type; optionally followed by a
// per-channel affine (an eval-mode BatchNorm folded to scale and shift) and
// SiLU, which the JAX package leaves to XLA's fusion.
//
// Bound on an H100 (3.35 TB/s; 495 TFLOP/s TF32, 989 bf16): with the tensor
// cores the early convs are bound by bytes or sit at the ridge, so the design
// moves each byte once and keeps the tensor cores fed without address work:
//
//  * persistent blocks walk over output tiles; one producer thread keeps a
//    ring of shared-memory stages full with bulk asynchronous copies that
//    complete on mbarriers, two consumer warpgroups multiply the stages that
//    have arrived.  No __syncthreads and no index arithmetic in the loop:
//    stride, padding and the ragged edge are the tensor map's business
//    (out-of-bounds elements read as zero);
//  * fp32 data runs at fp32 accuracy on the TF32 tensor cores by the split
//    a = hi + lo (hi = tf32(a), lo = tf32(a - hi)): three products
//    lo*hi + hi*lo + hi*hi into fp32 accumulators, small terms first.
//    Weights arrive split (and K-permuted for 16-byte fragment loads) from the
//    wrapper; activations are split in registers after the fragment load.
//    A single TF32 product is never used for fp32 data.  The tensor cores
//    add into their accumulator rounding toward zero, so a long K chain
//    drifts toward zero (3x3 over 128 channels: 1.3e-6 of the output's
//    scale, 15x cuDNN's fp32 error, against float64 on an H100).  So the
//    products of a short run of K (conv_taps: one 32-channel run of a tap;
//    conv_rows: two K steps of 8) go into a fresh accumulator that is then
//    added to an fp32 total with round-to-nearest, as the weight gradient's
//    chunks are.
//    bf16 data takes one bf16 wgmma per K step and no split;
//  * scale, shift and SiLU are applied to the accumulators in registers, so
//    the activation crosses device memory once instead of five times.
//
// Two variants, chosen by the wrapper from shape and type alone:
//
//  conv_taps  k in {1, 3}, C and Co multiples of 8.  K is walked tap by tap
//             in runs of one 128-byte (or 64-byte) swizzle row of channels.
//             The A tile of a tap is one box of a tensor map over
//             [B, H, W, C] (stride 1) or over its phase view
//             [B, H/2, 2, W/2, 2C] (stride 2); the weights of the run stream
//             through the same stage.  A run that reaches past C reads zeros
//             (past the tensor) or the next phase's channels (stride 2), and
//             the packed weights hold zero K rows there, so no padded copy of
//             x is made.  Co is cut into N tiles of at most 128 channels (the
//             wrapper zero-pads the last one in the weights); a block owns
//             one (pixel tile, N tile) pair, N tiles of one pixel tile
//             neighbouring in the walk so the second reads A from L2, and
//             stores only the channels below Co.
//  conv_rows  the 6x6/s2 stem (YOLOX) and the 3x3/s1 stem (Darknet-53) on 3
//             channels, Co in N tiles of 32, 64 or 96 (a grid dimension; the
//             wrapper picks the widest tile whose weights leave shared memory
//             room for the row ring).  A pixel is 12 (or 6) bytes, so no tensor
//             map can take channels as its inner dimension: whole input rows
//             are staged by 1-D bulk copies into a ring, and for one ky an
//             output pixel's k taps x 3 channels are a contiguous run of 3k
//             values that the consumers load straight into wgmma A fragments
//             (the windows of neighbouring pixels overlap, so no
//             shared-memory descriptor could describe A).
//
// Shapes outside both run on no path of the port's models: they stay on the
// direct CUDA-core kernel (phase_conv_direct.cu).  YOLOX-Nano's small 1x1
// convs have a CUDA-core kernel of their own (phase_conv_1x1.cu).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kConsumerThreads = 256;            // two warpgroups
constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kTileH = 8, kTileW = 16;           // output pixels of a tile
constexpr int kTileM = kTileH * kTileW;          // 128 GEMM rows

// ===================================================================== taps

struct TapParams {
  int H, W, C, Co, k, pad, Ho, Wo;
  int tiles_x, tiles_y, ntiles, num_tiles, cruns;
  Epilogue epilogue;
};

// Per N tile width CO (32, 64, 96 or 128 output channels) and element type
// T: the wgmma N (64 where CO allows: half the instructions of N = 32), ring
// depth and blocks per SM (two where shared memory and registers allow, so
// four warpgroups hide each other's waits; fp32 keeps a total beside its
// accumulators, and at two blocks it spilled them: one).
template <typename T, int CO>
struct TapConfig {
  static constexpr int kNI = CO % 64 == 0 ? 64 : 32;
  static constexpr int kStages = CO == 64 ? 3 : 4;
  static constexpr int kMinBlocks = CO >= 96 || sizeof(T) == 4 ? 1 : 2;
};

// A tile index walks N tiles fastest, then pixel tiles along x, y, image.
struct TileCoord {
  int nt, tx, ty, b;
};
__device__ __forceinline__ TileCoord tile_coord(int tile, const TapParams& p) {
  TileCoord c;
  c.nt = tile % p.ntiles;
  int rest = tile / p.ntiles;
  c.tx = rest % p.tiles_x;
  rest /= p.tiles_x;
  c.ty = rest % p.tiles_y;
  c.b = rest / p.tiles_y;
  return c;
}

template <typename T, int CO, int STRIDE, int ROWB>
__global__ void __launch_bounds__(kThreads, TapConfig<T, CO>::kMinBlocks)
conv_taps_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w, T* __restrict__ y,
                 const TapParams p) {
  constexpr int kStages = TapConfig<T, CO>::kStages;
  constexpr int NI = TapConfig<T, CO>::kNI, NCH = CO / NI;
  constexpr int NB = sizeof(T) == 4 ? 2 : 1;  // fp32 weights come as hi and lo
  constexpr int KR = ROWB / (int)sizeof(T);   // channels per run
  constexpr uint32_t A_BYTES = kTileM * ROWB;
  constexpr uint32_t B_BYTES = NB * CO * ROWB;
  constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
  static_assert(sizeof(T) == 2 || ROWB == 128, "fp32 runs are 128 bytes");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kStages * STAGE_BYTES;
  auto full_bar = [&](int s) { return bars + 8u * s; };
  auto empty_bar = [&](int s) { return bars + 8u * (kStages + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), kConsumerThreads / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int steps = p.k * p.k * p.cruns;

  if (warp == kConsumerThreads / 32) {
    // ---------------------------------------------------------- producer
    if (lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < p.num_tiles; tile += gridDim.x) {
      const TileCoord tc = tile_coord(tile, p);
      const int b = tc.b;
      const int ox0 = tc.tx * kTileW, oy0 = tc.ty * kTileH;
      for (int ky = 0; ky < p.k; ++ky)
        for (int kx = 0; kx < p.k; ++kx)
          for (int cr = 0; cr < p.cruns; ++cr) {
            mbar_wait(empty_bar(stage), phase ^ 1u);
            mbar_expect_tx(full_bar(stage), STAGE_BYTES);
            const uint32_t a_dst = base + stage * STAGE_BYTES;
            if constexpr (STRIDE == 1) {
              tma_load_4d(a_dst, &map_x, full_bar(stage), cr * KR,
                          ox0 - p.pad + kx, oy0 - p.pad + ky, b);
            } else {
              // input pixel 2*o - pad + k = 2*(o + (d >> 1)) + (d & 1)
              const int dx = kx - p.pad, dy = ky - p.pad;
              tma_load_5d(a_dst, &map_x, full_bar(stage),
                          (dx & 1) * p.C + cr * KR, ox0 + (dx >> 1), dy & 1,
                          oy0 + (dy >> 1), b);
            }
            tma_load_2d(a_dst + A_BYTES, &map_w, full_bar(stage), 0,
                        (((ky * p.k + kx) * p.cruns + cr) * p.ntiles + tc.nt) * NB * CO);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1u;
            }
          }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  int stage = 0;
  uint32_t phase = 0;
  // The wgmmas of a step stay in flight while the next stage is awaited and
  // its A fragments are loaded; a stage is handed back once they retire.
  int pending = -1;  // stage whose wgmmas are in flight
  uint32_t ah[16] = {}, al[16] = {};
  for (int tile = blockIdx.x; tile < p.num_tiles; tile += gridDim.x) {
    float acc[NCH][NI / 2], total[NCH][NI / 2];
#pragma unroll
    for (int n = 0; n < NCH; ++n)
#pragma unroll
      for (int i = 0; i < NI / 2; ++i) acc[n][i] = total[n][i] = 0.f;

    for (int s = 0; s < steps; ++s) {
      mbar_wait(full_bar(stage), phase);
      const uint32_t a_base = base + stage * STAGE_BYTES;
      const uint32_t b_base = a_base + A_BYTES;
      if constexpr (sizeof(T) == 4) {
        // Rows r0 and r0 + 8 of the tile; r0 & 7 == g.  Thread t owns the 8
        // floats k = 8t .. 8t + 7 of the run: 16-byte chunks 2t and 2t + 1,
        // XOR-swizzled with the row, which no two lanes of a quarter warp
        // share.  K step j multiplies floats 2j and 2j + 1 of each thread;
        // the wrapper permuted the weights' K order to match.
        const uint32_t row0 = a_base + (uint32_t)(wg * 64 + w * 16 + g) * 128u;
        const uint32_t row1 = row0 + 8u * 128u;
        const uint32_t c0 = (uint32_t)((2 * t) ^ g) << 4;
        const uint32_t c1 = (uint32_t)((2 * t + 1) ^ g) << 4;
        const float4 q00 = lds128(row0 + c0), q01 = lds128(row0 + c1);
        const float4 q10 = lds128(row1 + c0), q11 = lds128(row1 + c1);
        const float v0[8] = {q00.x, q00.y, q00.z, q00.w, q01.x, q01.y, q01.z, q01.w};
        const float v1[8] = {q10.x, q10.y, q10.z, q10.w, q11.x, q11.y, q11.z, q11.w};
        wgmma_wait<0>();  // the previous step no longer reads ah, al
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          keep(ah[i]);
          keep(al[i]);
        }
        if (pending >= 0) {
          if (lane == 0) mbar_arrive(empty_bar(pending));
          // the previous step's products, into the total
#pragma unroll
          for (int n = 0; n < NCH; ++n)
#pragma unroll
            for (int i = 0; i < NI / 2; ++i) {
              keep(acc[n][i]);
              total[n][i] += acc[n][i];
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          split_tf32(v0[2 * j], ah[4 * j + 0], al[4 * j + 0]);
          split_tf32(v1[2 * j], ah[4 * j + 1], al[4 * j + 1]);
          split_tf32(v0[2 * j + 1], ah[4 * j + 2], al[4 * j + 2]);
          split_tf32(v1[2 * j + 1], ah[4 * j + 3], al[4 * j + 3]);
        }
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int n = 0; n < NCH; ++n) {
            const uint32_t off = n * NI * 128u + j * 32u;
            const uint64_t b_hi = smem_desc<128>(b_base + off);
            const uint64_t b_lo = smem_desc<128>(b_base + CO * 128u + off);
            // the step's first product starts a fresh accumulator
            wgmma_tf32_rs(acc[n], al[4 * j], al[4 * j + 1], al[4 * j + 2],
                          al[4 * j + 3], b_hi, j > 0);
            wgmma_tf32_rs(acc[n], ah[4 * j], ah[4 * j + 1], ah[4 * j + 2],
                          ah[4 * j + 3], b_lo);
            wgmma_tf32_rs(acc[n], ah[4 * j], ah[4 * j + 1], ah[4 * j + 2],
                          ah[4 * j + 3], b_hi);
          }
        wgmma_commit();
      } else {
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < ROWB / 32; ++j)
#pragma unroll
          for (int n = 0; n < NCH; ++n)
            wgmma_bf16_ss(acc[n],
                          smem_desc<ROWB>(a_base + wg * 64u * ROWB + j * 32u),
                          smem_desc<ROWB>(b_base + n * NI * ROWB + j * 32u));
        wgmma_commit();
        wgmma_wait<1>();  // the previous step has retired
        if (pending >= 0 && lane == 0) mbar_arrive(empty_bar(pending));
      }
      pending = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1u;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NCH; ++n)
#pragma unroll
      for (int i = 0; i < NI / 2; ++i) {
        keep(acc[n][i]);
        if constexpr (sizeof(T) == 4) acc[n][i] += total[n][i];
      }
    if (lane == 0) mbar_arrive(empty_bar(pending));
    pending = -1;

    // warp w of warpgroup wg holds tile row 4 * wg + w: pixels g and g + 8;
    // channels c0 .. c0 + CO - 1 of them, those below Co stored
    const TileCoord tc = tile_coord(tile, p);
    const int oy = tc.ty * kTileH + wg * 4 + w;
    const int oxa = tc.tx * kTileW + g, oxb = oxa + 8;
    const int c0 = tc.nt * CO;
    if (oy < p.Ho) {
      T* row = y + ((size_t)tc.b * p.Ho + oy) * p.Wo * p.Co + c0;
      T* pa = oxa < p.Wo ? row + (size_t)oxa * p.Co : nullptr;
      T* pb = oxb < p.Wo ? row + (size_t)oxb * p.Co : nullptr;
#pragma unroll
      for (int n = 0; n < NCH; ++n)
        store_fragment(acc[n], pa ? pa + n * NI : pa, pb ? pb + n * NI : pb,
                       c0 + n * NI, t, p.epilogue, p.Co);
    }
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

constexpr int kEncodeError = 100000;  // + CUresult of the tensor-map encoder

template <typename T, int CO, int STRIDE, int ROWB>
int launch_taps(const void* x, const void* wp, void* y, int B, TapParams p,
                cudaStream_t stream) {
  constexpr int kStages = TapConfig<T, CO>::kStages;
  constexpr int NB = sizeof(T) == 4 ? 2 : 1;
  constexpr int KR = ROWB / (int)sizeof(T);
  constexpr uint32_t STAGE_BYTES = kTileM * ROWB + NB * CO * ROWB;
  constexpr int smem = 1024 + kStages * STAGE_BYTES + 2 * kStages * 8;
  const CUtensorMapDataType type = sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle swz =
      ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t H = p.H, W = p.W, C = p.C;

  alignas(64) CUtensorMap map_x, map_w;
  int rc;
  if (STRIDE == 1) {
    const cuuint64_t dims[4] = {C, W, H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {C * es, W * C * es, H * W * C * es};
    const cuuint32_t box[4] = {KR, kTileW, kTileH, 1};
    rc = encode_tiled(&map_x, type, 4, x, dims, strides, box, swz);
  } else {
    // phase view: [B, H/2, py, W/2, (px, C)]
    const cuuint64_t dims[5] = {2 * C, W / 2, 2, H / 2, (cuuint64_t)B};
    const cuuint64_t strides[4] = {2 * C * es, W * C * es, 2 * W * C * es,
                                   H * W * C * es};
    const cuuint32_t box[5] = {KR, kTileW, 1, kTileH, 1};
    rc = encode_tiled(&map_x, type, 5, x, dims, strides, box, swz);
  }
  if (rc != 0) return kEncodeError + rc;
  {
    const cuuint64_t rows = (cuuint64_t)p.k * p.k * p.cruns * p.ntiles * NB * CO;
    const cuuint64_t dims[2] = {KR, rows};
    const cuuint64_t strides[1] = {ROWB};
    const cuuint32_t box[2] = {KR, NB * CO};
    rc = encode_tiled(&map_w, type, 2, wp, dims, strides, box, swz);
  }
  if (rc != 0) return kEncodeError + rc;

  auto kernel = conv_taps_kernel<T, CO, STRIDE, ROWB>;
  static int blocks_per_sm = 0;
  if (blocks_per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel,
                                                      kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (blocks_per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  }
  const int grid = min(p.num_tiles, sm_count() * blocks_per_sm);
  kernel<<<grid, kThreads, smem, stream>>>(map_x, map_w, static_cast<T*>(y), p);
  return (int)cudaGetLastError();
}

template <typename T, int ROWB>
int dispatch_taps(const void* x, const void* wp, void* y, int B, int stride,
                  int co_tile, const TapParams& p, cudaStream_t st) {
#define EOP_TAPS(CO)                                                      \
  return stride == 1 ? launch_taps<T, CO, 1, ROWB>(x, wp, y, B, p, st)    \
                     : launch_taps<T, CO, 2, ROWB>(x, wp, y, B, p, st)
  switch (co_tile) {
    case 32: EOP_TAPS(32);
    case 64: EOP_TAPS(64);
    case 96: EOP_TAPS(96);
    case 128: EOP_TAPS(128);
  }
#undef EOP_TAPS
  return (int)cudaErrorInvalidValue;
}

// ===================================================================== rows

constexpr int kRowPadLeft = 8;    // zero elements before a staged row
constexpr int kRowPadRight = 16;  // zero elements after it
constexpr int kRowsC = 3;         // the stems' input channels
// The two stems: K = 6 (6x6, stride 2, padding 2) and K = 3 (3x3, stride 1,
// padding 1).  For one ky an output pixel reads kRun = 3K consecutive values
// of a staged row; K runs make the flat K index f = kRun * ky + 3 * kx + c
// (108 or 27 values), walked in K steps of 32 bytes (8 floats, 16 bf16) and
// padded with zero weights to whole 128-byte weight rows: fp32 kRuns runs of
// [hi, lo][CO][32], bf16 kRuns runs of [CO][64].
template <typename T, int K>
struct RowsGeom {
  static constexpr int kStride = K == 6 ? 2 : 1;
  static constexpr int kPad = K == 6 ? 2 : 1;
  static constexpr int kRun = K * kRowsC;
  static constexpr int kFlat = K * kRun;
  static constexpr int kSteps = (kFlat * (int)sizeof(T) + 31) / 32;
  static constexpr int kRuns = (kSteps + 3) / 4;
  static constexpr int kNB = sizeof(T) == 4 ? 2 : 1;
};
// Consumer warpgroups.  Four hide each other's fragment loads and epilogues:
// 0.096 ms against 0.117 ms with two, at 8 x 640 x 640 on an H100.
constexpr int kRowsWarpgroups = 4;

struct RowParams {
  int B, H, W, Ho, Wo, Co;
  int steps_per_image, total_steps, steps_per_block, chunks_x, ring;
  uint32_t slot_bytes;
  Epilogue epilogue;
};

// NWG = kRowsWarpgroups consumer warpgroups; a step is NWG output rows of one
// image, so each warpgroup takes one row's 64-pixel chunks.  With stride S it
// reads input rows S*NWG*s - pad .. S*NWG*s + S*(NWG - 1) - pad + K - 1
// (kLive of them); consecutive steps of an image share kLive - kNew, so kNew
// = S*NWG are loaded per step and the first step of a block or an image
// loads all kLive.  Producer and consumers number the loaded rows alike
// (n = 0, 1, ...): row n lives in slot n % ring and its barriers' parity is
// (n / ring) & 1.  Rows above or below the image are not loaded: their taps
// read a slot of zeros.
//
// In K step s thread t of a quad feeds f = 8s + 2t and 8s + 2t + 1 (fp32) or
// the pairs f = 16s + 2t and 16s + 2t + 8 (bf16).  For K = 6 a pair is one
// aligned 8-byte (4-byte) load that never straddles a ky, since 18 is even;
// for K = 3 (9 values a ky, odd pixel offsets) each value is loaded alone.
// The N tile CO (32, 64 or 96) is NCH wgmmas of N = 32; blockIdx.y is the
// tile: its weights are staged, its channels stored, those from Co on not.
template <typename T, int K, int CO>
__global__ void __launch_bounds__(kRowsWarpgroups * 128 + 32, 1)
conv_rows_kernel(const __grid_constant__ CUtensorMap map_w,
                 const T* __restrict__ x, T* __restrict__ y,
                 const RowParams p) {
  using G = RowsGeom<T, K>;
  constexpr int NWG = kRowsWarpgroups;
  constexpr int S = G::kStride, PAD = G::kPad, RUN = G::kRun;
  constexpr int NCH = CO / 32;
  constexpr uint32_t ES = sizeof(T);
  constexpr uint32_t kWBytes = G::kRuns * G::kNB * CO * 128;
  constexpr int kSteps = G::kSteps;
  static_assert(sizeof(T) == 2 || kSteps % 2 == 0, "fp32 K steps go in pairs");
  constexpr int kLive = S * (NWG - 1) + K, kNew = S * NWG;
  constexpr int kBlockThreads = NWG * 128 + 32;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t slots = base + kWBytes;
  const uint32_t zero_slot = slots + p.ring * p.slot_bytes;
  const uint32_t bars = zero_slot + p.slot_bytes;
  auto full_bar = [&](int s) { return bars + 8u * s; };
  auto empty_bar = [&](int s) { return bars + 8u * (p.ring + s); };
  const uint32_t w_bar = bars + 8u * (2 * p.ring);
  const uint32_t row_bytes = (uint32_t)p.W * kRowsC * ES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.ring; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), NWG * 4);
    }
    mbar_init(w_bar, 1);
    fence_barrier_init();
  }
  // the pads left and right of every slot stay zero: the conv's padding in x
  constexpr int kPadL = kRowPadLeft * ES / 4, kPadR = kRowPadRight * ES / 4;  // words
  for (int i = threadIdx.x; i < p.ring * (kPadL + kPadR); i += kBlockThreads) {
    const int s = i / (kPadL + kPadR);
    const int j = i % (kPadL + kPadR);
    const uint32_t off = j < kPadL ? 4u * j : 4u * kPadL + row_bytes + 4u * (j - kPadL);
    sts32(slots + s * p.slot_bytes + off, 0.f);
  }
  for (uint32_t i = threadIdx.x; i < p.slot_bytes / 4; i += kBlockThreads)
    sts32(zero_slot + 4u * i, 0.f);
  __syncthreads();

  const int s_begin = blockIdx.x * p.steps_per_block;
  const int s_end = min(s_begin + p.steps_per_block, p.total_steps);

  if (warp == NWG * 4) {
    // ---------------------------------------------------------- producer
    if (lane != 0) return;
    mbar_expect_tx(w_bar, kWBytes);
    for (int r = 0; r < G::kRuns; ++r)
      tma_load_2d(base + r * G::kNB * CO * 128, &map_w, w_bar, 0,
                  ((int)blockIdx.y * G::kRuns + r) * G::kNB * CO);
    int n = 0;
    for (int step = s_begin; step < s_end; ++step) {
      const int b = step / p.steps_per_image, sl = step % p.steps_per_image;
      const bool fresh = step == s_begin || sl == 0;
      const int iy_first = kNew * sl - PAD + (fresh ? 0 : kLive - kNew);
      const int count = fresh ? kLive : kNew;
      for (int i = 0; i < count; ++i, ++n) {
        const int iy = iy_first + i;
        const int slot = n % p.ring;
        const uint32_t parity = (uint32_t)(n / p.ring) & 1u;
        mbar_wait(empty_bar(slot), parity ^ 1u);
        if (iy >= 0 && iy < p.H) {
          mbar_expect_tx(full_bar(slot), row_bytes);
          bulk_load_1d(slots + slot * p.slot_bytes + ES * kRowPadLeft,
                       x + ((size_t)b * p.H + iy) * p.W * kRowsC, row_bytes,
                       full_bar(slot));
        } else {
          mbar_arrive(full_bar(slot));  // a padding row: read from zero_slot
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  mbar_wait(w_bar, 0);
  int n_next = 0, n_base = 0;
  for (int step = s_begin; step < s_end; ++step) {
    const int b = step / p.steps_per_image, sl = step % p.steps_per_image;
    const bool fresh = step == s_begin || sl == 0;
    if (fresh) {
      n_base = n_next;
      n_next += kLive;
    } else {
      n_base += kNew;
      n_next += kNew;
    }
    const int oy = NWG * sl + wg;  // this warpgroup's output row
    // its K input rows: slot addresses, or the slot of zeros
    uint32_t slot[K];
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
      const int n = n_base + S * wg + ky;
      const int iy = S * oy - PAD + ky;
      mbar_wait(full_bar(n % p.ring), (uint32_t)(n / p.ring) & 1u);
      slot[ky] = (iy < 0 || iy >= p.H) ? zero_slot
                                       : slots + (n % p.ring) * p.slot_bytes;
    }

    for (int cx = 0; cx < p.chunks_x && oy < p.Ho; ++cx) {
      const int oxa = cx * 64 + w * 16 + g, oxb = oxa + 8;
      // an output pixel's taps of one ky start 3 * (S * ox - PAD) elements
      // into the row: 3 * S * ox + kRowPadLeft - 3 * PAD into the slot
      const uint32_t offa = ES * (3 * S * min(oxa, p.Wo - 1) + kRowPadLeft - 3 * PAD);
      const uint32_t offb = ES * (3 * S * min(oxb, p.Wo - 1) + kRowPadLeft - 3 * PAD);
      // byte address in the slots of flat K index f, which lies in row ky0
      // of this K step or, past its RUN values, in the next; the zero-weight
      // tail (f >= K * RUN) reads on in the last row
      auto k_addr = [&](int first, int f) {
        constexpr int kLastKy = K - 1;
        const int ky0 = first / RUN;
        const int ky1 = ky0 < kLastKy ? ky0 + 1 : kLastKy;
        const bool next = ky1 != ky0 && f >= RUN * ky1;
        return (next ? slot[ky1] : slot[ky0]) + ES * (f - RUN * (next ? ky1 : ky0));
      };
      float acc[NCH][16];
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[c][i] = 0.f;
      if constexpr (sizeof(T) == 4) {
        // Two K steps form a group.  A group's products go into a fresh
        // accumulator that is then added to an fp32 total (see the header);
        // a group's A values are loaded while the last group's wgmmas run.
        float total[NCH][16];
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int i = 0; i < 16; ++i) total[c][i] = 0.f;
        uint32_t h[8], l[8];
#pragma unroll
        for (int grp = 0; grp < kSteps / 2; ++grp) {
          float2 pa[2], pb[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int s = 2 * grp + j;
            if constexpr (K == 6) {
              const uint32_t src = k_addr(8 * s, 8 * s + 2 * t);
              pa[j] = lds64(src + offa);
              pb[j] = lds64(src + offb);
            } else {
              const uint32_t s0 = k_addr(8 * s, 8 * s + 2 * t);
              const uint32_t s1 = k_addr(8 * s, 8 * s + 2 * t + 1);
              pa[j] = make_float2(__uint_as_float(lds32(s0 + offa)),
                                  __uint_as_float(lds32(s1 + offa)));
              pb[j] = make_float2(__uint_as_float(lds32(s0 + offb)),
                                  __uint_as_float(lds32(s1 + offb)));
            }
          }
          if (grp > 0) {
            wgmma_wait<0>();  // group grp - 1 no longer reads h, l or acc
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              keep(h[i]);
              keep(l[i]);
            }
#pragma unroll
            for (int c = 0; c < NCH; ++c)
#pragma unroll
              for (int i = 0; i < 16; ++i) {
                keep(acc[c][i]);
                total[c][i] += acc[c][i];
              }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            split_tf32(pa[j].x, h[4 * j + 0], l[4 * j + 0]);
            split_tf32(pb[j].x, h[4 * j + 1], l[4 * j + 1]);
            split_tf32(pa[j].y, h[4 * j + 2], l[4 * j + 2]);
            split_tf32(pb[j].y, h[4 * j + 3], l[4 * j + 3]);
          }
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int s = 2 * grp + j;
            const uint32_t b_run = base + (s / 4) * 2 * CO * 128 + (s % 4) * 32u;
#pragma unroll
            for (int c = 0; c < NCH; ++c) {
              const uint64_t b_hi = smem_desc<128>(b_run + c * 32 * 128);
              const uint64_t b_lo = smem_desc<128>(b_run + (CO + c * 32) * 128);
              // the group's first product starts a fresh accumulator
              wgmma_tf32_rs(acc[c], l[4 * j], l[4 * j + 1], l[4 * j + 2], l[4 * j + 3],
                            b_hi, j > 0);
              wgmma_tf32_rs(acc[c], h[4 * j], h[4 * j + 1], h[4 * j + 2], h[4 * j + 3], b_lo);
              wgmma_tf32_rs(acc[c], h[4 * j], h[4 * j + 1], h[4 * j + 2], h[4 * j + 3], b_hi);
            }
          }
          wgmma_commit();
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          keep(h[i]);
          keep(l[i]);
        }
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            keep(acc[c][i]);
            acc[c][i] += total[c][i];
          }
      } else {
        uint32_t a[kSteps][4];
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          if constexpr (K == 6) {
            const uint32_t lo = k_addr(16 * s, 16 * s + 2 * t);
            const uint32_t hi = k_addr(16 * s, 16 * s + 2 * t + 8);
            a[s][0] = lds32(lo + offa), a[s][1] = lds32(lo + offb);
            a[s][2] = lds32(hi + offa), a[s][3] = lds32(hi + offb);
          } else {
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const uint32_t e0 = k_addr(16 * s, 16 * s + 2 * t + 8 * q);
              const uint32_t e1 = k_addr(16 * s, 16 * s + 2 * t + 8 * q + 1);
              a[s][2 * q] = lds16(e0 + offa) | (lds16(e1 + offa) << 16);
              a[s][2 * q + 1] = lds16(e0 + offb) | (lds16(e1 + offb) << 16);
            }
          }
        }
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kSteps; ++s)
#pragma unroll
          for (int c = 0; c < NCH; ++c)
            wgmma_bf16_rs(acc[c], a[s][0], a[s][1], a[s][2], a[s][3],
                          smem_desc<128>(base + (s / 4) * CO * 128 + (s % 4) * 32u +
                                         c * 32 * 128));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          keep(a[s][0]), keep(a[s][1]), keep(a[s][2]), keep(a[s][3]);
        }
      }
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int i = 0; i < 16; ++i) keep(acc[c][i]);
      const int c0 = (int)blockIdx.y * CO;
      T* row = y + ((size_t)b * p.Ho + oy) * p.Wo * p.Co + c0;
      T* pa = oxa < p.Wo ? row + (size_t)oxa * p.Co : nullptr;
      T* pb = oxb < p.Wo ? row + (size_t)oxb * p.Co : nullptr;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        store_fragment(acc[c], pa ? pa + c * 32 : pa, pb ? pb + c * 32 : pb, c0 + c * 32,
                       t, p.epilogue, p.Co);
    }

    // retire the rows the next step does not read
    const bool next_fresh = (step + 1) % p.steps_per_image == 0;
    if (lane == 0 && step + 1 < s_end) {
      const int retire = next_fresh ? kLive : kNew;
      for (int i = 0; i < retire; ++i) mbar_arrive(empty_bar((n_base + i) % p.ring));
    }
  }
}

template <typename T, int K, int CO>
int launch_rows(const void* x, const void* wp, void* y, RowParams p,
                cudaStream_t stream) {
  using G = RowsGeom<T, K>;
  constexpr int NWG = kRowsWarpgroups;
  constexpr uint32_t kWBytes = G::kRuns * G::kNB * CO * 128;
  constexpr int kRun = 128 / (int)sizeof(T);  // elements of a weight row
  constexpr int kLive = G::kStride * (NWG - 1) + K, kNew = G::kStride * NWG;
  constexpr int kMaxSmem = 227 * 1024;
  const int ntiles = (p.Co + CO - 1) / CO;
  p.steps_per_image = (p.Ho + NWG - 1) / NWG;
  p.total_steps = p.steps_per_image * p.B;
  // one block an SM in all: the N tiles share the SMs
  const int blocks = min(p.total_steps, max(1, sm_count() / ntiles));
  p.steps_per_block = (p.total_steps + blocks - 1) / blocks;
  // as many slots ahead of the live rows as fit, up to one step's worth
  const int fixed = 1024 + (int)kWBytes + 8 + (int)p.slot_bytes;  // + zero slot
  p.ring = min(kLive + kNew, (kMaxSmem - fixed) / ((int)p.slot_bytes + 16));
  if (p.ring <= kLive) return (int)cudaErrorInvalidValue;
  const int smem = fixed + p.ring * ((int)p.slot_bytes + 16);

  alignas(64) CUtensorMap map_w;
  const cuuint64_t dims[2] = {kRun, (cuuint64_t)ntiles * G::kRuns * G::kNB * CO};
  const cuuint64_t strides[1] = {128};
  const cuuint32_t box[2] = {kRun, G::kNB * CO};
  const int rc = encode_tiled(&map_w,
                              sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                              2, wp, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return kEncodeError + rc;

  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        conv_rows_kernel<T, K, CO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((p.total_steps + p.steps_per_block - 1) / p.steps_per_block, ntiles);
  conv_rows_kernel<T, K, CO><<<grid, NWG * 128 + 32, smem, stream>>>(
      map_w, static_cast<const T*>(x), static_cast<T*>(y), p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_rows(int k, int co_tile, const void* x, const void* wp, void* y,
                  const RowParams& p, cudaStream_t st) {
#define EOP_ROWS(CO)                                                       \
  return k == 6 ? launch_rows<T, 6, CO>(x, wp, y, p, st)                   \
                : launch_rows<T, 3, CO>(x, wp, y, p, st)
  switch (co_tile) {
    case 32: EOP_ROWS(32);
    case 64: EOP_ROWS(64);
    case 96: EOP_ROWS(96);
  }
#undef EOP_ROWS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Tensor-core variant for k in {1, 3}.  x [B, H, W, C] contiguous and 16-byte
// aligned, C * sizeof(T) a multiple of 16; wp the wrapper's packed weights per
// (tap, run of `run` channels, N tile of co_tile channels): fp32 [hi, lo]
// [co_tile][32], K-permuted, bf16 [co_tile][run]; zero where the run passes
// C or the tile passes Co.  run: 32 for fp32, 32 or 64 for bf16; co_tile 32,
// 64, 96 or 128.  y [B, Ho, Wo, Co]; scale and shift fp32 [Co] or both null;
// act 0 or 1 (SiLU).  dtype 0 = float32, 1 = bfloat16.  Returns 0, a
// cudaError_t, or 100000 + the CUresult of the tensor-map encoder.
extern "C" int phase_conv_taps(int dtype, const void* x, const void* wp, void* y,
                               const void* scale, const void* shift, int act,
                               int B, int H, int W, int C, int Co, int k,
                               int stride, int pad, int Ho, int Wo, int run,
                               int co_tile, void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  if ((k != 1 && k != 3) || (stride != 1 && stride != 2) || (C * es) % 16 != 0 ||
      Co % 8 != 0 || (dtype == 0 && run != 32) || (dtype == 1 && run != 32 && run != 64) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  TapParams p;
  p.H = H, p.W = W, p.C = C, p.Co = Co, p.k = k, p.pad = pad, p.Ho = Ho, p.Wo = Wo;
  p.tiles_x = (Wo + kTileW - 1) / kTileW;
  p.tiles_y = (Ho + kTileH - 1) / kTileH;
  p.ntiles = (Co + co_tile - 1) / co_tile;
  p.num_tiles = p.tiles_x * p.tiles_y * B * p.ntiles;
  p.cruns = (C + run - 1) / run;
  p.epilogue = {static_cast<const float*>(scale), static_cast<const float*>(shift),
                act};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_taps<float, 128>(x, wp, y, B, stride, co_tile, p, st);
  return run == 64
             ? dispatch_taps<__nv_bfloat16, 128>(x, wp, y, B, stride, co_tile, p, st)
             : dispatch_taps<__nv_bfloat16, 64>(x, wp, y, B, stride, co_tile, p, st);
}

// Tensor-core variant for the stems on 3 channels: k = 6 (stride 2, padding
// 2) or k = 3 (stride 1, padding 1), Co in ceil(Co / co_tile) N tiles of
// co_tile (32, 64 or 96) channels.  x [B, H, W, 3] contiguous, 16-byte
// aligned, rows a multiple of 16 bytes; wp the wrapper's packed weights, per
// N tile, over the flat K = (ky, kx, c), zero-padded to whole runs and past
// Co: fp32 runs of [hi, lo][co_tile][32], K-permuted; bf16 runs of
// [co_tile][64].  dtype 0 = float32, 1 = bfloat16.
extern "C" int phase_conv_rows(int dtype, const void* x, const void* wp, void* y,
                               const void* scale, const void* shift, int act,
                               int B, int H, int W, int Ho, int Wo, int k, int Co,
                               int co_tile, void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  if ((W * kRowsC * es) % 16 != 0 || (k != 6 && k != 3) || (k == 6 && H % 2 != 0) ||
      Co % 8 != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  RowParams p;
  p.B = B, p.H = H, p.W = W, p.Ho = Ho, p.Wo = Wo, p.Co = Co;
  p.chunks_x = (Wo + 63) / 64;
  p.slot_bytes = (uint32_t)es * (kRowPadLeft + W * kRowsC + kRowPadRight);
  p.epilogue = {static_cast<const float*>(scale), static_cast<const float*>(shift),
                act};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch_rows<float>(k, co_tile, x, wp, y, p, st)
                    : dispatch_rows<__nv_bfloat16>(k, co_tile, x, wp, y, p, st);
}
