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
//    A single TF32 product is never used for fp32 data.  bf16 data takes one
//    bf16 wgmma per K step and no split;
//  * scale, shift and SiLU are applied to the accumulators in registers, so
//    the activation crosses device memory once instead of five times.
//
// Two variants, chosen by the wrapper from shape and type alone:
//
//  conv_taps  k in {1, 3}, C a multiple of 32, Co in {32, 64, 128}.  K is
//             walked tap by tap in runs of one 128-byte (or 64-byte) swizzle
//             row of channels.  The A tile of a tap is one box of a tensor map
//             over [B, H, W, C] (stride 1) or over its phase view
//             [B, H/2, 2, W/2, 2C] (stride 2); the weights of the run stream
//             through the same stage.
//  conv_rows  the 6x6/s2 stem on 3 channels.  A pixel is 12 (or 6) bytes, so
//             no tensor map can take channels as its inner dimension: whole
//             input rows are staged by 1-D bulk copies into a ring, and for
//             one ky an output pixel's 6 taps x 3 channels are a contiguous
//             run of 18 values that the consumers load straight into wgmma A
//             fragments (the windows of neighbouring pixels overlap, so no
//             shared-memory descriptor could describe A).
//
// Shapes outside both stay on the direct CUDA-core kernel
// (phase_conv_direct.cu).

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
  int tiles_x, tiles_y, num_tiles, cruns;
  Epilogue epilogue;
};

// Per output width: the wgmma N (64 where Co allows: half the instructions
// of N = 32), ring depth and blocks per SM (two where shared memory and
// registers allow, so four warpgroups hide each other's waits).
template <int CO>
struct TapConfig {
  static constexpr int kNI = CO >= 64 ? 64 : 32;
  static constexpr int kStages = CO == 64 ? 3 : 4;
  static constexpr int kMinBlocks = CO == 128 ? 1 : 2;
};

template <typename T, int CO, int STRIDE, int ROWB>
__global__ void __launch_bounds__(kThreads, TapConfig<CO>::kMinBlocks)
conv_taps_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w, T* __restrict__ y,
                 const TapParams p) {
  constexpr int kStages = TapConfig<CO>::kStages;
  constexpr int NI = TapConfig<CO>::kNI, NCH = CO / NI;
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
      const int tx = tile % p.tiles_x;
      const int rest = tile / p.tiles_x;
      const int ty = rest % p.tiles_y;
      const int b = rest / p.tiles_y;
      const int ox0 = tx * kTileW, oy0 = ty * kTileH;
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
                        ((ky * p.k + kx) * p.cruns + cr) * NB * CO);
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
    float acc[NCH][NI / 2];
#pragma unroll
    for (int n = 0; n < NCH; ++n)
#pragma unroll
      for (int i = 0; i < NI / 2; ++i) acc[n][i] = 0.f;

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
        if (pending >= 0 && lane == 0) mbar_arrive(empty_bar(pending));
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
            wgmma_tf32_rs(acc[n], al[4 * j], al[4 * j + 1], al[4 * j + 2],
                          al[4 * j + 3], b_hi);
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
      for (int i = 0; i < NI / 2; ++i) keep(acc[n][i]);
    if (lane == 0) mbar_arrive(empty_bar(pending));
    pending = -1;

    // warp w of warpgroup wg holds tile row 4 * wg + w: pixels g and g + 8
    const int tx = tile % p.tiles_x;
    const int rest = tile / p.tiles_x;
    const int ty = rest % p.tiles_y;
    const int b = rest / p.tiles_y;
    const int oy = ty * kTileH + wg * 4 + w;
    const int oxa = tx * kTileW + g, oxb = oxa + 8;
    if (oy < p.Ho) {
      T* row = y + ((size_t)b * p.Ho + oy) * p.Wo * CO;
      T* pa = oxa < p.Wo ? row + (size_t)oxa * CO : nullptr;
      T* pb = oxb < p.Wo ? row + (size_t)oxb * CO : nullptr;
#pragma unroll
      for (int n = 0; n < NCH; ++n)
        store_fragment(acc[n], pa ? pa + n * NI : pa, pb ? pb + n * NI : pb,
                       n * NI, t, p.epilogue);
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
  constexpr int kStages = TapConfig<CO>::kStages;
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
    const cuuint64_t rows = (cuuint64_t)p.k * p.k * p.cruns * NB * CO;
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
                  const TapParams& p, cudaStream_t st) {
#define EOP_TAPS(CO)                                                      \
  return stride == 1 ? launch_taps<T, CO, 1, ROWB>(x, wp, y, B, p, st)    \
                     : launch_taps<T, CO, 2, ROWB>(x, wp, y, B, p, st)
  switch (p.Co) {
    case 32: EOP_TAPS(32);
    case 64: EOP_TAPS(64);
    case 128: EOP_TAPS(128);
  }
#undef EOP_TAPS
  return (int)cudaErrorInvalidValue;
}

// ===================================================================== rows

constexpr int kRowPadLeft = 8;    // zero elements before a staged row
constexpr int kRowPadRight = 16;  // zero elements after it
constexpr int kRowsK = 6, kRowsC = 3, kRowsCo = 32;  // the stem's shape
constexpr int kRowsRun = kRowsK * kRowsC;            // 18 values per ky
// K steps of 32 bytes over the 108 values (padded with zero weights): 14 of 8
// floats, 7 of 16 bf16.  The weights are 128-byte rows of 4 K steps, fp32 as
// hi and lo: 4 boxes of [2 x 32 rows], bf16 one box of [2 runs x 32 rows].
template <typename T>
struct RowsK {
  static constexpr int kSteps = (kRowsK * kRowsRun * (int)sizeof(T) + 31) / 32;
  static constexpr int kBoxes = sizeof(T) == 4 ? (kSteps + 3) / 4 : 1;
  static constexpr uint32_t kWBytes = kBoxes * 2 * kRowsCo * 128;
};
// Consumer warpgroups.  Four hide each other's fragment loads and epilogues:
// 0.096 ms against 0.117 ms with two, at 8 x 640 x 640 on an H100.
constexpr int kRowsWarpgroups = 4;

struct RowParams {
  int B, H, W, Ho, Wo;
  int steps_per_image, total_steps, steps_per_block, chunks_x, ring;
  uint32_t slot_bytes;
  Epilogue epilogue;
};

// NWG = kRowsWarpgroups consumer warpgroups; a step is NWG output rows of one
// image, so each warpgroup takes one row's 64-pixel chunks.  It reads input rows
// 2*NWG*s - 2 .. 2*NWG*s + 2*NWG + 1; consecutive steps of an image share
// four of them, so 2*NWG are loaded per step and the first step of a block or
// an image loads all 2*NWG + 4.  Producer and consumers number the loaded
// rows alike (n = 0, 1, ...): row n lives in slot n % ring and its barriers'
// parity is (n / ring) & 1.  Rows above or below the image are not loaded:
// their taps read a slot of zeros.
//
// K is the flat index f = 18 * ky + 3 * kx + c (108 values, 14 K steps with 4
// zero weights at the end).  In K step s thread t of a quad feeds f = 8s + 2t
// and 8s + 2t + 1: one 8-byte load, which never straddles a ky since 18 is
// even.
//
// bf16 rows are staged and indexed the same way in 2-byte elements; a K step
// is 16 values, thread t feeds the pairs f = 16s + 2t and 16s + 2t + 8 (two
// 4-byte loads), and one bf16 wgmma per step needs no split.
template <typename T>
__global__ void __launch_bounds__(kRowsWarpgroups * 128 + 32, 1)
conv_rows_kernel(const __grid_constant__ CUtensorMap map_w,
                 const T* __restrict__ x, T* __restrict__ y,
                 const RowParams p) {
  constexpr int NWG = kRowsWarpgroups;
  constexpr uint32_t ES = sizeof(T);
  constexpr uint32_t kRowsWBytes = RowsK<T>::kWBytes;
  constexpr int kRowsKSteps = RowsK<T>::kSteps;
  constexpr int kLive = 2 * NWG + 4, kNew = 2 * NWG;
  constexpr int kBlockThreads = NWG * 128 + 32;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t slots = base + kRowsWBytes;
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
    mbar_expect_tx(w_bar, kRowsWBytes);
    for (int r = 0; r < RowsK<T>::kBoxes; ++r)
      tma_load_2d(base + r * 2 * kRowsCo * 128, &map_w, w_bar, 0,
                  r * 2 * kRowsCo);
    int n = 0;
    for (int step = s_begin; step < s_end; ++step) {
      const int b = step / p.steps_per_image, sl = step % p.steps_per_image;
      const bool fresh = step == s_begin || sl == 0;
      const int iy_first = kNew * sl - 2 + (fresh ? 0 : 4);
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
    // its six input rows: slot addresses, or the slot of zeros
    uint32_t slot[kRowsK];
#pragma unroll
    for (int ky = 0; ky < kRowsK; ++ky) {
      const int n = n_base + 2 * wg + ky;
      const int iy = 2 * oy - 2 + ky;
      mbar_wait(full_bar(n % p.ring), (uint32_t)(n / p.ring) & 1u);
      slot[ky] = (iy < 0 || iy >= p.H) ? zero_slot
                                       : slots + (n % p.ring) * p.slot_bytes;
    }

    for (int cx = 0; cx < p.chunks_x && oy < p.Ho; ++cx) {
      const int oxa = cx * 64 + w * 16 + g, oxb = oxa + 8;
      // an output pixel's taps of one ky start 6 * ox - 6 elements into the
      // row: 6 * ox + 2 elements into the slot
      const uint32_t offa = ES * (6 * min(oxa, p.Wo - 1) + 2);
      const uint32_t offb = ES * (6 * min(oxb, p.Wo - 1) + 2);
      // byte address in the slots of flat K index f (even), which lies in
      // row ky0 of this K step or, past its 18 values, in the next; the
      // zero-weight tail (f >= 108) reads on in the last row
      auto k_addr = [&](int first, int f) {
        constexpr int kLastKy = kRowsK - 1;
        const int ky0 = first / kRowsRun;
        const int ky1 = ky0 < kLastKy ? ky0 + 1 : kLastKy;
        const bool next = ky1 != ky0 && f >= kRowsRun * ky1;
        return (next ? slot[ky1] : slot[ky0]) + ES * (f - kRowsRun * (next ? ky1 : ky0));
      };
      float acc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0.f;
      if constexpr (sizeof(T) == 4) {
        // Two K steps form a group; the A fragments of the next group are
        // loaded and split while the wgmmas of this one run: two register
        // sets, each reused once its wgmmas have retired.
        uint32_t ah[2][8], al[2][8];
#pragma unroll
        for (int grp = 0; grp < kRowsKSteps / 2; ++grp) {
          uint32_t(&h)[8] = ah[grp & 1];
          uint32_t(&l)[8] = al[grp & 1];
          if (grp >= 2) {
            wgmma_wait<1>();  // the wgmmas of group grp - 2 no longer read h, l
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              keep(h[i]);
              keep(l[i]);
            }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int s = 2 * grp + j;
            const uint32_t src = k_addr(8 * s, 8 * s + 2 * t);
            const float2 pa = lds64(src + offa);
            const float2 pb = lds64(src + offb);
            split_tf32(pa.x, h[4 * j + 0], l[4 * j + 0]);
            split_tf32(pb.x, h[4 * j + 1], l[4 * j + 1]);
            split_tf32(pa.y, h[4 * j + 2], l[4 * j + 2]);
            split_tf32(pb.y, h[4 * j + 3], l[4 * j + 3]);
          }
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int s = 2 * grp + j;
            const uint32_t b_run = base + (s / 4) * 2 * kRowsCo * 128 + (s % 4) * 32u;
            const uint64_t b_hi = smem_desc<128>(b_run);
            const uint64_t b_lo = smem_desc<128>(b_run + kRowsCo * 128u);
            wgmma_tf32_rs(acc, l[4 * j], l[4 * j + 1], l[4 * j + 2], l[4 * j + 3], b_hi);
            wgmma_tf32_rs(acc, h[4 * j], h[4 * j + 1], h[4 * j + 2], h[4 * j + 3], b_lo);
            wgmma_tf32_rs(acc, h[4 * j], h[4 * j + 1], h[4 * j + 2], h[4 * j + 3], b_hi);
          }
          wgmma_commit();
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          keep(ah[0][i]), keep(al[0][i]), keep(ah[1][i]), keep(al[1][i]);
        }
      } else {
        uint32_t a[kRowsKSteps][4];
#pragma unroll
        for (int s = 0; s < kRowsKSteps; ++s) {
          const uint32_t lo = k_addr(16 * s, 16 * s + 2 * t);
          const uint32_t hi = k_addr(16 * s, 16 * s + 2 * t + 8);
          a[s][0] = lds32(lo + offa), a[s][1] = lds32(lo + offb);
          a[s][2] = lds32(hi + offa), a[s][3] = lds32(hi + offb);
        }
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kRowsKSteps; ++s)
          wgmma_bf16_rs(acc, a[s][0], a[s][1], a[s][2], a[s][3],
                        smem_desc<128>(base + (s / 4) * kRowsCo * 128 + (s % 4) * 32u));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int s = 0; s < kRowsKSteps; ++s) {
          keep(a[s][0]), keep(a[s][1]), keep(a[s][2]), keep(a[s][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) keep(acc[i]);
      T* row = y + ((size_t)b * p.Ho + oy) * p.Wo * kRowsCo;
      store_fragment(acc, oxa < p.Wo ? row + (size_t)oxa * kRowsCo : nullptr,
                     oxb < p.Wo ? row + (size_t)oxb * kRowsCo : nullptr, 0, t,
                     p.epilogue);
    }

    // retire the rows the next step does not read
    const bool next_fresh = (step + 1) % p.steps_per_image == 0;
    if (lane == 0 && step + 1 < s_end) {
      const int retire = next_fresh ? kLive : kNew;
      for (int i = 0; i < retire; ++i) mbar_arrive(empty_bar((n_base + i) % p.ring));
    }
  }
}

template <typename T>
int launch_rows(const void* x, const void* wp, void* y, RowParams p,
                cudaStream_t stream) {
  constexpr int NWG = kRowsWarpgroups;
  constexpr uint32_t kRowsWBytes = RowsK<T>::kWBytes;
  constexpr int kRun = 128 / (int)sizeof(T);  // elements of a weight row
  constexpr int kLive = 2 * NWG + 4, kNew = 2 * NWG;
  constexpr int kMaxSmem = 227 * 1024;
  p.steps_per_image = (p.Ho + NWG - 1) / NWG;
  p.total_steps = p.steps_per_image * p.B;
  const int blocks = min(p.total_steps, sm_count());
  p.steps_per_block = (p.total_steps + blocks - 1) / blocks;
  // as many slots ahead of the live rows as fit, up to one step's worth
  const int fixed = 1024 + (int)kRowsWBytes + 8 + (int)p.slot_bytes;  // + zero slot
  p.ring = min(kLive + kNew, (kMaxSmem - fixed) / ((int)p.slot_bytes + 16));
  if (p.ring <= kLive) return (int)cudaErrorInvalidValue;
  const int smem = fixed + p.ring * ((int)p.slot_bytes + 16);

  alignas(64) CUtensorMap map_w;
  const cuuint64_t dims[2] = {kRun, (cuuint64_t)RowsK<T>::kBoxes * 2 * kRowsCo};
  const cuuint64_t strides[1] = {128};
  const cuuint32_t box[2] = {kRun, 2 * kRowsCo};
  const int rc = encode_tiled(&map_w,
                              sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                              2, wp, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return kEncodeError + rc;

  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        conv_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int grid = (p.total_steps + p.steps_per_block - 1) / p.steps_per_block;
  conv_rows_kernel<T><<<grid, NWG * 128 + 32, smem, stream>>>(
      map_w, static_cast<const T*>(x), static_cast<T*>(y), p);
  return (int)cudaGetLastError();
}

}  // namespace

// Tensor-core variant for k in {1, 3}.  x [B, H, W, C] contiguous and 16-byte
// aligned; wp the wrapper's packed weights (fp32: per (tap, run of 32
// channels) [hi, lo][Co][32], K-permuted; bf16: per (tap, run) [Co][run]);
// y [B, Ho, Wo, Co]; scale and shift fp32 [Co] or both null; act 0 or 1
// (SiLU).  dtype 0 = float32, 1 = bfloat16.  Returns 0, a cudaError_t, or
// 100000 + the CUresult of the tensor-map encoder.
extern "C" int phase_conv_taps(int dtype, const void* x, const void* wp, void* y,
                               const void* scale, const void* shift, int act,
                               int B, int H, int W, int C, int Co, int k,
                               int stride, int pad, int Ho, int Wo, void* stream) {
  const int run = dtype == 0 ? 32 : (C % 64 == 0 ? 64 : 32);
  if ((k != 1 && k != 3) || C % run != 0 || (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  TapParams p;
  p.H = H, p.W = W, p.C = C, p.Co = Co, p.k = k, p.pad = pad, p.Ho = Ho, p.Wo = Wo;
  p.tiles_x = (Wo + kTileW - 1) / kTileW;
  p.tiles_y = (Ho + kTileH - 1) / kTileH;
  p.num_tiles = p.tiles_x * p.tiles_y * B;
  p.cruns = C / run;
  p.epilogue = {static_cast<const float*>(scale), static_cast<const float*>(shift),
                act};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_taps<float, 128>(x, wp, y, B, stride, p, st);
  if (dtype == 1)
    return run == 64 ? dispatch_taps<__nv_bfloat16, 128>(x, wp, y, B, stride, p, st)
                     : dispatch_taps<__nv_bfloat16, 64>(x, wp, y, B, stride, p, st);
  return (int)cudaErrorInvalidValue;
}

// Tensor-core variant for the 6x6/s2/p2 stem on 3 channels, 32 outputs.
// x [B, H, W, 3] contiguous, 16-byte aligned, rows a multiple of 16 bytes; wp
// the wrapper's packed weights over the flat K = (ky, kx, c), 108 padded to
// 128 with zeros: fp32 as 4 runs of [hi, lo][32][32], K-permuted; bf16 as
// 2 runs of [32][64].  dtype 0 = float32, 1 = bfloat16.
extern "C" int phase_conv_rows(int dtype, const void* x, const void* wp, void* y,
                               const void* scale, const void* shift, int act,
                               int B, int H, int W, int Ho, int Wo,
                               void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  if ((W * kRowsC * es) % 16 != 0 || H % 2 != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  RowParams p;
  p.B = B, p.H = H, p.W = W, p.Ho = Ho, p.Wo = Wo;
  p.chunks_x = (Wo + 63) / 64;
  p.slot_bytes = (uint32_t)es * (kRowPadLeft + W * kRowsC + kRowPadRight);
  p.epilogue = {static_cast<const float*>(scale), static_cast<const float*>(shift),
                act};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_rows<float>(x, wp, y, p, st)
                    : launch_rows<__nv_bfloat16>(x, wp, y, p, st);
}
