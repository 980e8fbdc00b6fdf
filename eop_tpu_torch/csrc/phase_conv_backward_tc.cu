// Backward of phase_conv on Hopper's tensor cores (sm_90a): the weight
// gradient, the stride-2 data gradient and the weight packing both data
// gradients read.
//
// Replaces: the VJP of eop_tpu/ops/pallas/conv_small_c.py::phase_conv (the
// JAX trainer differentiates lax.conv_general_dilated; XLA supplies the
// gradients).  Same functions as phase_conv_backward.cu, whose CUDA-core
// kernels stay for the shapes these do not take:
//
//   dw[ky,kx,c,co] = sum_{b,ho,wo} x[b, s*ho+ky-p, s*wo+kx-p, c] * dy[b,ho,wo,co]
//   dx[b,h,w,c]    = sum over the taps reaching (h, w) of dy[b,ho,wo,:] . w[ky,kx,c,:]
//
// fp32 data keeps fp32 accuracy by the split a = hi + lo (three TF32
// products into fp32 accumulators), as the forward does; bf16 data takes one
// bf16 product.  Bound on an H100 (3.35 TB/s, 495 TFLOP/s TF32 so 165 at
// fp32 accuracy): the 3x3 and 6x6 weight gradients by operations, the 1x1
// ones and the data gradients by bytes.
//
// Weight gradient, wgrad_tc_kernel.  dw[K = k*k*C, Co] = im2col(x)^T * dy,
// reduced over up to 3.3 M output pixels.  For TF32 wgmma reads shared
// operands K-major only, and K here is the pixel: neither NHWC tensor is
// K-major.  So
//  * A = im2col(x)^T comes from registers: each block stages, per chunk of 32
//    output pixels along one output row, the input row segments its M tile
//    reads (TMA boxes, 128-byte swizzled runs of 32 channels, the last one
//    zero-filled past C; the stems' 12-byte pixels as flat rows), and a
//    thread reads its two dw rows' values at its fragment's pixels: tap and
//    stride are address arithmetic;
//  * B = dy^T is made K-major once per chunk: the block's threads read the
//    staged [32 pixels x CO] dy box of its N tile (CO of at most 128 output
//    channels, zero-filled past Co) and write it as swizzled [CO][32 pixels]
//    rows (split into hi and lo for fp32), shared by every dw row of the tile;
//  * an M tile is the rows of whole ky values (k*C per ky; the stems' rows in
//    one tile), one warpgroup per 64 rows, so the staged x is what the tile
//    reads and nothing more; where one ky has more than 192 rows (C above 64
//    at k = 3) it is cut into parts of 128 rows that stage the same row;
//  * split-K over the chunks: block (M tile, split) walks a contiguous range
//    of chunks through a ring of 2 to 4 stages, the copies of the next
//    chunks in flight behind this one's products, and writes its sum to
//    part[split]; a second kernel adds the splits in index order.  No
//    atomics: the same bits on every run;
//  * each chunk's products go into a fresh accumulator that is then added to
//    an fp32 register total, so the tensor cores never sum more than 32
//    pixels and the long sum is rounded to nearest like the plain version's.
//
// Data gradient at stride 2, dgrad_tc_kernel.  The input pixels of one
// parity class (h % 2, w % 2) take the same taps: a small stride-1
// convolution of dy whose reduction runs over Co, which NHWC dy stores
// contiguously.  So it is the forward's conv_taps design with the roles
// turned: tiles of class pixels, A = dy boxes (TMA, split in registers),
// B = the class's taps packed K-major, results stored at stride 2.  All
// classes in one launch; a class's taps and their dy offsets come from the
// host (no product with a structural zero).  As in conv_taps, any C and Co
// that are multiples of 8: K runs over Co in runs of 32 (bf16: 64 where
// that pads no further), the box past Co reading the zeros the bulk copy
// fills outside dy against zero K rows of the packed weights, and C in N
// tiles of 32, 64, 96 or 128, a block owning a (class tile, N tile) pair,
// N tiles fastest so that the second reads its dy boxes from L2, the
// store masked past C.  Bound by bytes (dy read, dx written once) in bf16
// and near the ridge in fp32.  In fp32 each K step's products go into a
// fresh accumulator added to an fp32 total (the tensor cores' accumulation
// rounds toward zero: see phase_conv.cu).
//
// Packing, pack_taps_kernel.  One launch writes the K-major tiles both data
// gradients read: at stride 1 those of the forward on the flipped weights
// (the bytes of ops/phase_conv.py::_pack_taps(flipped_weights(w))), at
// stride 2 those of each class's taps; zero past C and past Co.  The host
// gives the taps, the run, the N tile and the fragment's K order.

#include "hopper.cuh"

namespace {

using namespace hopper;

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

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

constexpr CUtensorMapSwizzle swizzle_of(int rowb) {
  return rowb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                     : (rowb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                   : CU_TENSOR_MAP_SWIZZLE_NONE);
}

// Byte offset of element e of row q in a tile of ROWB-byte rows written by a
// TMA box with the matching swizzle (base 1024-aligned): the 16-byte chunk
// index is XORed with address bits 7..9.
template <int ROWB, int ES>
__device__ __forceinline__ uint32_t swz(int q, int e) {
  const uint32_t byte = (uint32_t)e * ES;
  if constexpr (ROWB == 128)
    return (uint32_t)q * 128u + ((((byte >> 4) ^ (uint32_t)(q & 7)) << 4) | (byte & 15u));
  else
    return (uint32_t)q * 64u + ((((byte >> 4) ^ (uint32_t)((q >> 1) & 3)) << 4) | (byte & 15u));
}

// =================================================================== packing

constexpr int kMaxTaps = 64;

struct PackParams {
  int ntaps, C, Co, run, runs, tile, ntiles;
  int src[kMaxTaps];  // HWIO tap ky * k + kx of packed tap j
  int perm[32];       // fp32: logical K index (within a run) of position q
};

// out [ntaps, runs, ntiles, NB, tile, run], NB = 2 (hi, lo) for fp32, 1 for
// bf16: element (j, r, nt, h, n, q) = w[src[j]][nt * tile + n][run * r +
// perm[q]] (bf16: q), zero where the channel reaches C or the K index Co.
template <typename T>
__global__ void pack_taps_kernel(const T* __restrict__ w, T* __restrict__ out,
                                 const PackParams p) {
  constexpr int NB = sizeof(T) == 4 ? 2 : 1;
  const long long n = (long long)p.ntaps * p.runs * p.ntiles * NB * p.tile * p.run;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long rest = i;
  const int q = (int)(rest % p.run);
  rest /= p.run;
  const int nn = (int)(rest % p.tile);
  rest /= p.tile;
  const int h = (int)(rest % NB);
  rest /= NB;
  const int nt = (int)(rest % p.ntiles);
  rest /= p.ntiles;
  const int r = (int)(rest % p.runs);
  const int j = (int)(rest / p.runs);
  const int c = nt * p.tile + nn;
  const int kidx = p.run * r + (NB == 2 ? p.perm[q] : q);
  const bool in = c < p.C && kidx < p.Co;
  const long long src = ((long long)p.src[j] * p.C + c) * p.Co + kidx;
  if constexpr (NB == 2) {
    uint32_t hi, lo;
    split_tf32(in ? w[src] : 0.f, hi, lo);
    out[i] = __uint_as_float(h == 0 ? hi : lo);
  } else {
    out[i] = in ? w[src] : __float2bfloat16(0.f);
  }
}

// ============================================================ weight gradient

constexpr int kChunk = 32;  // output pixels of a chunk: one K row of B

struct WgradParams {
  int H, W, C, Co, k, stride, pad, Ho, Wo;
  int nky;      // ky values of an M tile
  int mparts;   // M tiles over one group of nky ky values
  int rows;     // dw rows of one group of nky ky values: nky * k * C
  int K;        // dw rows: k * k * C
  int span;     // input pixels a chunk reads along one row
  int cruns;    // boxes per staged input row: runs of 32 channels, or 1
  int ntiles;   // N tiles of CO output channels
  int flat_box;  // FLAT: elements of a staged row segment
  int cpr;      // chunks per output row
  int chunks, chunks_per_split;
  int stages;   // ring depth: chunks in flight ahead of the one in use
  uint32_t box_bytes, x_bytes, dy_bytes, stage_bytes, tx_bytes;
};

// dw = sum over pixel chunks of A^T B: NWG warpgroups, 64 dw rows each; an N
// tile of CO output channels; FLAT stages whole input rows of the flat
// [W * C] view.  Block (M tile, split, N tile).
template <typename T, int NWG, int CO, bool FLAT>
__global__ void __launch_bounds__(NWG * 128, (CO >= 96 || NWG == 3) ? 1 : 2)
wgrad_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_dy,
                float* __restrict__ part, const WgradParams p) {
  constexpr int ES = sizeof(T);
  constexpr int ROWB = kChunk * ES;  // a B row: 32 pixels
  constexpr int NI = CO % 64 == 0 ? 64 : 32, NCH = CO / NI;
  constexpr int kThreadsW = NWG * 128;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + (uint32_t)p.stages * p.stage_bytes;
  auto full_bar = [&](int s) { return bars + 8u * s; };

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int ky0 = blockIdx.x / p.mparts * p.nky;
  const int r_first = blockIdx.x % p.mparts * (NWG * 64);  // within the ky group
  const int nt = blockIdx.z;
  const int c_begin = blockIdx.y * p.chunks_per_split;
  const int n = min(p.chunks_per_split, p.chunks - c_begin);

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(full_bar(s), 1);
    fence_barrier_init();
  }
  __syncthreads();

  // this thread's two dw rows (fragment rows g and g + 8 of its warp)
  bool ok[2];
  uint32_t roff[2];
  int rkx[2], rc[2];
  const int kc = p.k * p.C;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_first + wg * 64 + w * 16 + g + 8 * i;
    ok[i] = r < p.rows;
    const int rr = ok[i] ? r : 0;
    const int kyl = rr / kc, rem = rr - kyl * kc;
    rkx[i] = rem / p.C;
    const int c = rem - rkx[i] * p.C;
    if constexpr (FLAT) {
      roff[i] = (uint32_t)kyl * p.box_bytes + (uint32_t)c * ES;
      rc[i] = 0;
    } else {
      roff[i] = (uint32_t)(kyl * p.cruns + (c >> 5)) * p.box_bytes;
      rc[i] = c & 31;
    }
  }
  // A bulk tensor copy starts a row on a 16-byte boundary: a FLAT segment
  // starts up to 16 / ES elements before the chunk's first input element
  constexpr int kAlign = 16 / ES;
  auto lead = [&](int chunk) {
    const int row = chunk / p.cpr;
    const int e0 = (p.stride * (chunk - row * p.cpr) * kChunk - p.pad) * p.C;
    return ((e0 % kAlign) + kAlign) % kAlign;
  };
  // Byte offset in the staged x of row i's value at chunk pixel j.  A K step
  // of KP pixels moves every fragment value KP * stride staged pixels on, a
  // multiple of 8, which leaves the swizzle alone: each value's offset is a
  // base (row i, pixel slot h, pair element e) plus the step times `astep`;
  // FLAT adds the chunk's lead.
  constexpr int KS = ES == 4 ? 4 : 2;   // K steps of a chunk
  constexpr int KP = kChunk / KS;       // pixels of a K step
  constexpr int NE = ES == 4 ? 1 : 2;   // values of a fragment register
  auto a_off = [&](int i, int j) -> uint32_t {
    const int q = p.stride * j + rkx[i];
    if constexpr (FLAT)
      return roff[i] + (uint32_t)q * (uint32_t)(p.C * ES);
    else
      return roff[i] + swz<ROWB, ES>(q, rc[i]);
  };
  uint32_t abase[2][2][NE];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < NE; ++e)
        abase[i][h][e] = a_off(i, ES == 4 ? t + 4 * h : 2 * t + 8 * h + e);
  const uint32_t astep =
      (uint32_t)(KP * p.stride) * (FLAT ? (uint32_t)(p.C * ES) : (uint32_t)ROWB);

  auto issue = [&](int chunk, int s) {
    const int row = chunk / p.cpr;
    const int wo0 = (chunk - row * p.cpr) * kChunk;
    const int b = row / p.Ho, ho = row - b * p.Ho;
    const int ix0 = p.stride * wo0 - p.pad;
    const uint32_t xs = base + s * p.stage_bytes;
    const uint32_t bar = full_bar(s);
    mbar_expect_tx(bar, p.tx_bytes);
    for (int kyl = 0; kyl < p.nky; ++kyl) {
      const int iy = p.stride * ho - p.pad + ky0 + kyl;
      if constexpr (FLAT) {
        tma_load_3d(xs + kyl * p.box_bytes, &map_x, bar, ix0 * p.C - lead(chunk),
                    iy, b);
      } else {
        for (int cr = 0; cr < p.cruns; ++cr)
          tma_load_4d(xs + (kyl * p.cruns + cr) * p.box_bytes, &map_x, bar,
                      cr * 32, ix0, iy, b);
      }
    }
    tma_load_4d(xs + p.x_bytes, &map_dy, bar, nt * CO, wo0, ho, b);
  };

  float total[NCH][NI / 2];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < NI / 2; ++i) total[c][i] = 0.f;

  if (tid == 0)
    for (int i = 0; i < p.stages - 1 && i < n; ++i) issue(c_begin + i, i);
  for (int it = 0, s = 0; it < n; ++it, s = s + 1 == p.stages ? 0 : s + 1) {
    const uint32_t xs = base + s * p.stage_bytes;
    const uint32_t dys = xs + p.x_bytes;
    const uint32_t bs = dys + p.dy_bytes;
    mbar_wait(full_bar(s), (uint32_t)(it / p.stages) & 1u);
    const uint32_t sh = FLAT ? (uint32_t)(lead(c_begin + it) * ES) : 0u;

    // dy [32 pixels][CO] -> B [CO][32 pixels], K-major and swizzled; lanes
    // take 4 pixels x 8 channels so that the stores meet no bank twice
    for (int e = tid; e < kChunk * CO; e += kThreadsW) {
      const int nn = (e >> 2) % CO;
      const int j = ((e >> 2) / CO) * 4 + (e & 3);
      const uint32_t src = dys + (uint32_t)(j * CO + nn) * ES;
      const uint32_t dst = swz<ROWB, ES>(nn, j);
      if constexpr (ES == 4) {
        uint32_t hi, lo;
        split_tf32(__uint_as_float(lds32(src)), hi, lo);
        sts32(bs + dst, __uint_as_float(hi));
        sts32(bs + CO * ROWB + dst, __uint_as_float(lo));
      } else {
        sts16(bs + dst, (uint16_t)lds16(src));
      }
    }
    fence_proxy_async();
    __syncthreads();  // B is whole; every thread is done with chunk it - 1
    if (tid == 0 && it + p.stages - 1 < n)  // into chunk it - 1's stage
      issue(c_begin + it + p.stages - 1, s == 0 ? p.stages - 1 : s - 1);
    __syncwarp();  // wgmma wants whole warps: lane 0 has caught up

    // A fragments of the chunk: fp32 four K steps of 8 pixels, a0 (row g,
    // pixel 8j + t), a1 (row g + 8), a2 and a3 at pixel 8j + t + 4, split
    // into hi and lo; bf16 two K steps of 16 pixels, a0 (row g, pixels
    // 16j + 2t, + 1), a1 (row g + 8), a2 and a3 at pixels 16j + 2t + 8, + 9
    uint32_t ah[KS][4], al[KS][4];
    const uint32_t xa = xs + sh;
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if constexpr (ES == 4) {
            const float v = __uint_as_float(lds32(xa + abase[i][h][0] + j * astep));
            // rows past the tile read row 0's address and multiply zero
            split_tf32(ok[i] ? v : 0.f, ah[j][2 * h + i], al[j][2 * h + i]);
          } else {
            const uint32_t v0 = lds16(xa + abase[i][h][0] + j * astep);
            const uint32_t v1 = lds16(xa + abase[i][h][1] + j * astep);
            ah[j][2 * h + i] = ok[i] ? v0 | (v1 << 16) : 0u;
          }
        }
    __syncwarp();
    // one output-channel chunk at a time, each into a fresh accumulator
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      float acc[NI / 2];
#pragma unroll
      for (int i = 0; i < NI / 2; ++i) acc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const uint32_t off = c * NI * ROWB + j * 32u;
        if constexpr (ES == 4) {
          const uint64_t b_hi = smem_desc<ROWB>(bs + off);
          const uint64_t b_lo = smem_desc<ROWB>(bs + CO * ROWB + off);
          wgmma_tf32_rs(acc, al[j][0], al[j][1], al[j][2], al[j][3], b_hi);
          wgmma_tf32_rs(acc, ah[j][0], ah[j][1], ah[j][2], ah[j][3], b_lo);
          wgmma_tf32_rs(acc, ah[j][0], ah[j][1], ah[j][2], ah[j][3], b_hi);
        } else {
          wgmma_bf16_rs(acc, ah[j][0], ah[j][1], ah[j][2], ah[j][3],
                        smem_desc<ROWB>(bs + off));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NI / 2; ++i) {
        keep(acc[i]);
        total[c][i] += acc[i];
      }
    }
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        keep(ah[j][i]);
        if constexpr (ES == 4) keep(al[j][i]);
      }
  }

  float* out = part + (size_t)blockIdx.y * p.K * p.Co + nt * CO;
  const int r0 = ky0 * kc + r_first + wg * 64 + w * 16 + g;
  float* pa = ok[0] ? out + (size_t)r0 * p.Co : nullptr;
  float* pb = ok[1] ? out + (size_t)(r0 + 8) * p.Co : nullptr;
  const Epilogue none{nullptr, nullptr, 0};
#pragma unroll
  for (int c = 0; c < NCH; ++c)
    store_fragment(total[c], pa ? pa + c * NI : pa, pb ? pb + c * NI : pb,
                   nt * CO + c * NI, t, none, p.Co);
}

// dw[i] = part[0][i] + part[1][i] + ... in that order.
template <typename T>
__global__ void wgrad_tc_reduce_kernel(const float* __restrict__ part,
                                       T* __restrict__ dw, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
#pragma unroll 8
  for (int sp = 0; sp < splits; ++sp) acc += part[(long long)sp * n + i];
  if constexpr (sizeof(T) == 4)
    dw[i] = acc;
  else
    dw[i] = __float2bfloat16(acc);
}

template <typename T, int NWG, int CO, bool FLAT>
int launch_wgrad_tc(const void* x, const void* dy, float* part, int B,
                    WgradParams p, int mtiles, int splits, cudaStream_t stream) {
  constexpr int ES = sizeof(T);
  const cuuint64_t es = ES;
  alignas(64) CUtensorMap map_x, map_dy;
  int rc;
  if (FLAT) {
    // [B, H, W * C]: one box is a row segment of span pixels
    const cuuint64_t dims[3] = {(cuuint64_t)p.W * p.C, (cuuint64_t)p.H, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)p.W * p.C * es,
                                   (cuuint64_t)p.H * p.W * p.C * es};
    const cuuint32_t box[3] = {(cuuint32_t)p.flat_box, 1, 1};
    rc = encode_tiled(&map_x, map_type<T>(), 3, x, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    const cuuint64_t dims[4] = {(cuuint64_t)p.C, (cuuint64_t)p.W, (cuuint64_t)p.H,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {p.C * es, (cuuint64_t)p.W * p.C * es,
                                   (cuuint64_t)p.H * p.W * p.C * es};
    const cuuint32_t box[4] = {32, (cuuint32_t)p.span, 1, 1};
    rc = encode_tiled(&map_x, map_type<T>(), 4, x, dims, strides, box,
                      swizzle_of(32 * ES));
  }
  if (rc != 0) return kEncodeError + rc;
  {
    const cuuint64_t co = p.Co;
    const cuuint64_t dims[4] = {co, (cuuint64_t)p.Wo, (cuuint64_t)p.Ho, (cuuint64_t)B};
    const cuuint64_t strides[3] = {co * es, (cuuint64_t)p.Wo * co * es,
                                   (cuuint64_t)p.Ho * p.Wo * co * es};
    const cuuint32_t box[4] = {CO, kChunk, 1, 1};
    rc = encode_tiled(&map_dy, map_type<T>(), 4, dy, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (rc != 0) return kEncodeError + rc;

  const int smem = 1024 + p.stages * ((int)p.stage_bytes + 8);
  auto kernel = wgrad_tc_kernel<T, NWG, CO, FLAT>;
  static int configured = 0;
  if (configured < smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  kernel<<<dim3(mtiles, splits, p.ntiles), NWG * 128, smem, stream>>>(map_x, map_dy,
                                                                     part, p);
  return (int)cudaGetLastError();
}

template <typename T, int CO, bool FLAT>
int dispatch_wgrad_nwg(int nwg, const void* x, const void* dy, float* part, int B,
                       const WgradParams& p, int mtiles, int splits,
                       cudaStream_t st) {
  switch (nwg) {
    case 1: return launch_wgrad_tc<T, 1, CO, FLAT>(x, dy, part, B, p, mtiles, splits, st);
    case 2: return launch_wgrad_tc<T, 2, CO, FLAT>(x, dy, part, B, p, mtiles, splits, st);
    case 3:
      if constexpr (!FLAT)
        return launch_wgrad_tc<T, 3, CO, FLAT>(x, dy, part, B, p, mtiles, splits, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool FLAT>
int dispatch_wgrad_co(int nwg, int co_tile, const void* x, const void* dy, float* part,
                      int B, const WgradParams& p, int mtiles, int splits,
                      cudaStream_t st) {
  switch (co_tile) {
    case 32: return dispatch_wgrad_nwg<T, 32, FLAT>(nwg, x, dy, part, B, p, mtiles, splits, st);
    case 64: return dispatch_wgrad_nwg<T, 64, FLAT>(nwg, x, dy, part, B, p, mtiles, splits, st);
    case 96: return dispatch_wgrad_nwg<T, 96, FLAT>(nwg, x, dy, part, B, p, mtiles, splits, st);
    case 128: return dispatch_wgrad_nwg<T, 128, FLAT>(nwg, x, dy, part, B, p, mtiles, splits, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_wgrad(int nwg, bool flat, int co_tile, const void* x, const void* dy,
                   float* part, int B, const WgradParams& p, int mtiles, int splits,
                   cudaStream_t st) {
  return flat ? dispatch_wgrad_co<T, true>(nwg, co_tile, x, dy, part, B, p, mtiles, splits, st)
              : dispatch_wgrad_co<T, false>(nwg, co_tile, x, dy, part, B, p, mtiles, splits,
                                            st);
}

// ============================================================== data gradient

constexpr int kConsumerThreads = 256;            // two warpgroups
constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kTileH = 8, kTileW = 16;           // class pixels of a tile
constexpr int kTileM = kTileH * kTileW;
constexpr int kMaxClassTaps = 16;

struct ClassTaps {
  int ntaps[4], first[4];  // per class, in tile order: taps, first packed tap
  int ph[4], pw[4];        // the class's input pixels: h % 2, w % 2
  int oy[kMaxClassTaps], ox[kMaxClassTaps];  // dy pixel = class pixel + (oy, ox)
};

struct DgradParams {
  int H, W, C, Hc, Wc;
  int tiles_x, tiles_y, tiles_per_class, ntiles, num_tiles, cruns;
  ClassTaps ct;
};

// the forward's TapConfig, for an N tile of CO of the C channels of dx
template <typename T, int CO>
struct DgradConfig {
  static constexpr int kNI = CO % 64 == 0 ? 64 : 32;
  static constexpr int kStages = CO == 64 ? 3 : 4;
  static constexpr int kMinBlocks = CO >= 96 || sizeof(T) == 4 ? 1 : 2;
};

// A tile index walks N tiles fastest, then class pixel tiles along x, y,
// image, then the classes (most taps first).
struct ClassTile {
  int nt, cls, tx, ty, b;
};
__device__ __forceinline__ ClassTile class_tile(int tile, const DgradParams& p) {
  ClassTile c;
  c.nt = tile % p.ntiles;
  int rest = tile / p.ntiles;
  c.cls = rest / p.tiles_per_class;
  rest -= c.cls * p.tiles_per_class;
  c.tx = rest % p.tiles_x;
  rest /= p.tiles_x;
  c.ty = rest % p.tiles_y;
  c.b = rest / p.tiles_y;
  return c;
}

template <typename T, int CO, int ROWB>
__global__ void __launch_bounds__(kThreads, DgradConfig<T, CO>::kMinBlocks)
dgrad_tc_kernel(const __grid_constant__ CUtensorMap map_dy,
                const __grid_constant__ CUtensorMap map_w, T* __restrict__ dx,
                const DgradParams p) {
  constexpr int kStages = DgradConfig<T, CO>::kStages;
  constexpr int NI = DgradConfig<T, CO>::kNI, NCH = CO / NI;
  constexpr int NB = sizeof(T) == 4 ? 2 : 1;
  constexpr int KR = ROWB / (int)sizeof(T);
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

  if (warp == kConsumerThreads / 32) {
    // ---------------------------------------------------------- producer
    if (lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < p.num_tiles; tile += gridDim.x) {
      const ClassTile tc = class_tile(tile, p);
      for (int j = 0; j < p.ct.ntaps[tc.cls]; ++j) {
        const int tap = p.ct.first[tc.cls] + j;
        for (int cr = 0; cr < p.cruns; ++cr) {
          mbar_wait(empty_bar(stage), phase ^ 1u);
          mbar_expect_tx(full_bar(stage), STAGE_BYTES);
          const uint32_t a_dst = base + stage * STAGE_BYTES;
          // K past Co: the box reads the zeros filled outside dy
          tma_load_4d(a_dst, &map_dy, full_bar(stage), cr * KR,
                      tc.tx * kTileW + p.ct.ox[tap], tc.ty * kTileH + p.ct.oy[tap],
                      tc.b);
          tma_load_2d(a_dst + A_BYTES, &map_w, full_bar(stage), 0,
                      ((tap * p.cruns + cr) * p.ntiles + tc.nt) * NB * CO);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  int stage = 0;
  uint32_t phase = 0;
  int pending = -1;  // stage whose wgmmas are in flight
  uint32_t ah[16] = {}, al[16] = {};
  for (int tile = blockIdx.x; tile < p.num_tiles; tile += gridDim.x) {
    const ClassTile tc = class_tile(tile, p);
    const int steps = p.ct.ntaps[tc.cls] * p.cruns;
    float acc[NCH][NI / 2], total[NCH][NI / 2];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int i = 0; i < NI / 2; ++i) acc[c][i] = total[c][i] = 0.f;

    for (int s = 0; s < steps; ++s) {
      mbar_wait(full_bar(stage), phase);
      const uint32_t a_base = base + stage * STAGE_BYTES;
      const uint32_t b_base = a_base + A_BYTES;
      if constexpr (sizeof(T) == 4) {
        // as conv_taps_kernel: thread t owns floats 8t .. 8t + 7 of its rows'
        // run; the packed weights' K order matches
        const uint32_t row0 = a_base + (uint32_t)(wg * 64 + w * 16 + g) * 128u;
        const uint32_t row1 = row0 + 8u * 128u;
        const uint32_t c0 = (uint32_t)((2 * t) ^ g) << 4;
        const uint32_t c1 = (uint32_t)((2 * t + 1) ^ g) << 4;
        const float4 q00 = lds128(row0 + c0), q01 = lds128(row0 + c1);
        const float4 q10 = lds128(row1 + c0), q11 = lds128(row1 + c1);
        const float v0[8] = {q00.x, q00.y, q00.z, q00.w, q01.x, q01.y, q01.z, q01.w};
        const float v1[8] = {q10.x, q10.y, q10.z, q10.w, q11.x, q11.y, q11.z, q11.w};
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          keep(ah[i]);
          keep(al[i]);
        }
        if (pending >= 0) {
          if (lane == 0) mbar_arrive(empty_bar(pending));
          // the previous step's products, into the total (as the forward)
#pragma unroll
          for (int c = 0; c < NCH; ++c)
#pragma unroll
            for (int i = 0; i < NI / 2; ++i) {
              keep(acc[c][i]);
              total[c][i] += acc[c][i];
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
          for (int c = 0; c < NCH; ++c) {
            const uint32_t off = c * NI * 128u + j * 32u;
            const uint64_t b_hi = smem_desc<128>(b_base + off);
            const uint64_t b_lo = smem_desc<128>(b_base + CO * 128u + off);
            // the step's first product starts a fresh accumulator
            wgmma_tf32_rs(acc[c], al[4 * j], al[4 * j + 1], al[4 * j + 2], al[4 * j + 3], b_hi,
                          j > 0);
            wgmma_tf32_rs(acc[c], ah[4 * j], ah[4 * j + 1], ah[4 * j + 2], ah[4 * j + 3], b_lo);
            wgmma_tf32_rs(acc[c], ah[4 * j], ah[4 * j + 1], ah[4 * j + 2], ah[4 * j + 3], b_hi);
          }
        wgmma_commit();
      } else {
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < ROWB / 32; ++j)
#pragma unroll
          for (int c = 0; c < NCH; ++c)
            wgmma_bf16_ss(acc[c], smem_desc<ROWB>(a_base + wg * 64u * ROWB + j * 32u),
                          smem_desc<ROWB>(b_base + c * NI * ROWB + j * 32u));
        wgmma_commit();
        wgmma_wait<1>();
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
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int i = 0; i < NI / 2; ++i) {
        keep(acc[c][i]);
        if constexpr (sizeof(T) == 4) acc[c][i] += total[c][i];
      }
    if (pending >= 0 && lane == 0) mbar_arrive(empty_bar(pending));
    pending = -1;

    // warp w of warpgroup wg holds tile row 4 * wg + w: class pixels g,
    // g + 8; channels c0 .. c0 + CO - 1 of them, those below C stored
    const int h2 = tc.ty * kTileH + wg * 4 + w;
    const int w2a = tc.tx * kTileW + g, w2b = w2a + 8;
    const int c0 = tc.nt * CO;
    if (h2 < p.Hc) {
      T* row = dx + ((size_t)tc.b * p.H + 2 * h2 + p.ct.ph[tc.cls]) * p.W * p.C + c0;
      T* pa = w2a < p.Wc ? row + (size_t)(2 * w2a + p.ct.pw[tc.cls]) * p.C : nullptr;
      T* pb = w2b < p.Wc ? row + (size_t)(2 * w2b + p.ct.pw[tc.cls]) * p.C : nullptr;
      const Epilogue none{nullptr, nullptr, 0};
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        store_fragment(acc[c], pa ? pa + c * NI : pa, pb ? pb + c * NI : pb,
                       c0 + c * NI, t, none, p.C);
    }
  }
}

template <typename T, int CO, int ROWB>
int launch_dgrad_tc(const void* dy, const void* wp, void* dx, int B, int Co,
                    int Ho, int Wo, int total_taps, const DgradParams& p,
                    cudaStream_t stream) {
  constexpr int kStages = DgradConfig<T, CO>::kStages;
  constexpr int NB = sizeof(T) == 4 ? 2 : 1;
  constexpr int KR = ROWB / (int)sizeof(T);
  constexpr uint32_t STAGE_BYTES = kTileM * ROWB + NB * CO * ROWB;
  constexpr int smem = 1024 + kStages * STAGE_BYTES + 2 * kStages * 8;
  const cuuint64_t es = sizeof(T);
  alignas(64) CUtensorMap map_dy, map_w;
  int rc;
  {
    const cuuint64_t dims[4] = {(cuuint64_t)Co, (cuuint64_t)Wo, (cuuint64_t)Ho,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {Co * es, (cuuint64_t)Wo * Co * es,
                                   (cuuint64_t)Ho * Wo * Co * es};
    const cuuint32_t box[4] = {KR, kTileW, kTileH, 1};
    rc = encode_tiled(&map_dy, map_type<T>(), 4, dy, dims, strides, box,
                      swizzle_of(ROWB));
  }
  if (rc != 0) return kEncodeError + rc;
  {
    const cuuint64_t rows = (cuuint64_t)total_taps * p.cruns * p.ntiles * NB * CO;
    const cuuint64_t dims[2] = {KR, rows};
    const cuuint64_t strides[1] = {ROWB};
    const cuuint32_t box[2] = {KR, NB * CO};
    rc = encode_tiled(&map_w, map_type<T>(), 2, wp, dims, strides, box,
                      swizzle_of(ROWB));
  }
  if (rc != 0) return kEncodeError + rc;

  auto kernel = dgrad_tc_kernel<T, CO, ROWB>;
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
  kernel<<<grid, kThreads, smem, stream>>>(map_dy, map_w, static_cast<T*>(dx), p);
  return (int)cudaGetLastError();
}

template <typename T, int ROWB>
int dispatch_dgrad(int co_tile, const void* dy, const void* wp, void* dx, int B, int Co,
                   int Ho, int Wo, int total_taps, const DgradParams& p,
                   cudaStream_t st) {
#define EOP_DGRAD(CO) \
  return launch_dgrad_tc<T, CO, ROWB>(dy, wp, dx, B, Co, Ho, Wo, total_taps, p, st)
  switch (co_tile) {
    case 32: EOP_DGRAD(32);
    case 64: EOP_DGRAD(64);
    case 96: EOP_DGRAD(96);
    case 128: EOP_DGRAD(128);
  }
#undef EOP_DGRAD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Packs HWIO w [k, k, C, Co] for the data gradients: packed tap j is HWIO tap
// src[j] (ntaps of them, at most 64); perm is the fp32 K order of a run of 32
// (ops/phase_conv.py::K_ORDER["wgmma_taps"]); K = Co in runs of run (32 for
// fp32, 32 or 64 for bf16), N = C in tiles of tile (32, 64, 96 or 128).
// out: fp32 [ntaps, runs, ntiles, 2, tile, 32], bf16 [ntaps, runs, ntiles *
// tile, run], runs = ceil(Co / run), ntiles = ceil(C / tile); zero past C
// and past Co.
extern "C" int phase_conv_pack_taps(int dtype, const void* w, void* out,
                                    const int* src, int ntaps, int C, int Co,
                                    int run, int tile, const int* perm,
                                    void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || C < 1 || Co < 1 ||
      (dtype == 0 && run != 32) || (dtype == 1 && run != 32 && run != 64) ||
      (tile != 32 && tile != 64 && tile != 96 && tile != 128))
    return (int)cudaErrorInvalidValue;
  PackParams p;
  p.ntaps = ntaps, p.C = C, p.Co = Co, p.run = run, p.tile = tile;
  p.runs = (Co + run - 1) / run;
  p.ntiles = (C + tile - 1) / tile;
  for (int j = 0; j < ntaps; ++j) p.src[j] = src[j];
  for (int q = 0; q < 32; ++q) p.perm[q] = perm[q];
  const long long n = (long long)ntaps * p.runs * p.ntiles * tile * run *
                      (dtype == 0 ? 2 : 1);
  const unsigned blocks = (unsigned)((n + 255) / 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    pack_taps_kernel<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(w), static_cast<float*>(out), p);
  else if (dtype == 1)
    pack_taps_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out), p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Weight gradient on the tensor cores.  x [B, H, W, C], dy [B, Ho, Wo, Co],
// dw [k, k, C, Co], contiguous, 16-byte aligned, one type (dtype 0 = float32,
// 1 = bfloat16), Co a multiple of 8; part fp32 scratch [splits, k*k*C*Co].
// The host's plan: M tiles of nky ky values and wgs warpgroups (64 dw rows
// each), mparts of them over one group of ky values; flat = 1 to stage x as
// flat rows (C no multiple of 8), else C * sizeof(T) a multiple of 16; N
// tiles of co_tile (32, 64, 96, 128) output channels; splits blocks per
// (M tile, N tile) over chunks of 32 output pixels, chunks_per_split each.
// Launches the partial sums and the ordered reduction; returns the first
// error that is not 0.
extern "C" int phase_conv_wgrad_tc(int dtype, const void* x, const void* dy,
                                   void* dw, void* part, int splits,
                                   int chunks_per_split, int nky, int wgs,
                                   int flat, int mparts, int co_tile, int B, int H,
                                   int W, int C, int Co, int k, int stride, int pad,
                                   int Ho, int Wo, void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || k % nky != 0 || wgs < 1 || wgs > 3 ||
      mparts < 1 || Co % 8 != 0 || co_tile < 1)
    return (int)cudaErrorInvalidValue;
  WgradParams p;
  p.H = H, p.W = W, p.C = C, p.Co = Co, p.k = k, p.stride = stride, p.pad = pad;
  p.Ho = Ho, p.Wo = Wo;
  p.nky = nky;
  p.mparts = mparts;
  p.rows = nky * k * C;
  p.K = k * k * C;
  p.ntiles = (Co + co_tile - 1) / co_tile;
  if (p.rows > 64 * wgs * mparts || (!flat && (C * es) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  p.span = stride * (kChunk - 1) + k;
  const int span_rows = (p.span + 7) & ~7;  // swizzle atoms of 8 rows
  const int align = 16 / es;  // elements of 16 bytes
  p.flat_box = 0;
  if (flat) {
    // the segment, from the 16-byte boundary before its first element
    p.flat_box = (p.span * C + align - 1) / align * align + align;
    p.cruns = 1;
    if (p.flat_box > 256) return (int)cudaErrorInvalidValue;
    p.box_bytes = (uint32_t)((p.flat_box * es + 127) & ~127);
  } else {
    p.cruns = (C + 31) / 32;
    p.box_bytes = (uint32_t)(span_rows * 32 * es);
  }
  p.x_bytes = (uint32_t)((nky * p.cruns * p.box_bytes + 1023) & ~1023u);
  p.dy_bytes = (uint32_t)((kChunk * co_tile * es + 1023) & ~1023);
  const uint32_t b_bytes = (uint32_t)((dtype == 0 ? 2 : 1) * co_tile * kChunk * es);
  p.stage_bytes = (p.x_bytes + p.dy_bytes + b_bytes + 1023u) & ~1023u;
  // as deep a ring as the blocks an SM holds (4 / wgs of them) leave room
  // for, 2 to 4 stages: a chunk's copies are issued stages - 1 chunks ahead
  const int per_block = (220 * 1024) / (4 / wgs > 0 ? 4 / wgs : 1);
  p.stages = max(2, min(4, per_block / (int)p.stage_bytes));
  if (1024 + p.stages * ((int)p.stage_bytes + 8) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const uint32_t x_box = flat ? (uint32_t)(p.flat_box * es) : (uint32_t)(p.span * 32 * es);
  p.tx_bytes = (uint32_t)(nky * p.cruns) * x_box + (uint32_t)(kChunk * co_tile * es);
  p.cpr = (Wo + kChunk - 1) / kChunk;
  p.chunks = B * Ho * p.cpr;
  p.chunks_per_split = chunks_per_split;
  if ((long long)splits * chunks_per_split < p.chunks || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int mtiles = k / nky * mparts;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  int err = dtype == 0 ? dispatch_wgrad<float>(wgs, flat != 0, co_tile, x, dy, pp, B, p,
                                               mtiles, splits, st)
                       : dispatch_wgrad<__nv_bfloat16>(wgs, flat != 0, co_tile, x, dy, pp,
                                                       B, p, mtiles, splits, st);
  if (err != 0) return err;
  const int n = p.K * Co;
  if (dtype == 0)
    wgrad_tc_reduce_kernel<float><<<(n + 255) / 256, 256, 0, st>>>(
        pp, static_cast<float*>(dw), n, splits);
  else
    wgrad_tc_reduce_kernel<__nv_bfloat16><<<(n + 255) / 256, 256, 0, st>>>(
        pp, static_cast<__nv_bfloat16*>(dw), n, splits);
  return (int)cudaGetLastError();
}

// Stride-2 data gradient on the tensor cores, one launch for the four parity
// classes.  dy [B, Ho, Wo, Co] contiguous and 16-byte aligned, Co a multiple
// of 8 (a dy pixel a multiple of 16 bytes, as the bulk copies need); C a
// multiple of 8; wp the classes' taps packed by phase_conv_pack_taps with
// the same run (32 for fp32, 32 or 64 for bf16) and N tile co_tile (32, 64,
// 96 or 128); dx [B, H, W, C] with H and W even, every element written.
// classes: 4 x (ntaps, first packed tap, h % 2, w % 2) in tile order;
// offsets: total_taps x (oy, ox), the dy pixel of class pixel (h2, w2) for
// that tap being (h2 + oy, w2 + ox).
extern "C" int phase_conv_dgrad_tc(int dtype, const void* dy, const void* wp,
                                   void* dx, const int* classes,
                                   const int* offsets, int total_taps, int B,
                                   int H, int W, int C, int Co, int Ho, int Wo,
                                   int run, int co_tile, void* stream) {
  if ((dtype != 0 && dtype != 1) || (dtype == 0 && run != 32) ||
      (dtype == 1 && run != 32 && run != 64) || C < 1 || C % 8 != 0 ||
      Co < 1 || Co % 8 != 0 || H % 2 || W % 2 || total_taps > kMaxClassTaps ||
      (co_tile != 32 && co_tile != 64 && co_tile != 96 && co_tile != 128))
    return (int)cudaErrorInvalidValue;
  DgradParams p;
  p.H = H, p.W = W, p.C = C, p.Hc = H / 2, p.Wc = W / 2;
  p.tiles_x = (p.Wc + kTileW - 1) / kTileW;
  p.tiles_y = (p.Hc + kTileH - 1) / kTileH;
  p.tiles_per_class = p.tiles_x * p.tiles_y * B;
  p.ntiles = (C + co_tile - 1) / co_tile;
  p.num_tiles = 4 * p.tiles_per_class * p.ntiles;
  p.cruns = (Co + run - 1) / run;
  for (int c = 0; c < 4; ++c) {
    p.ct.ntaps[c] = classes[4 * c], p.ct.first[c] = classes[4 * c + 1];
    p.ct.ph[c] = classes[4 * c + 2], p.ct.pw[c] = classes[4 * c + 3];
    if (p.ct.first[c] + p.ct.ntaps[c] > total_taps) return (int)cudaErrorInvalidValue;
  }
  for (int j = 0; j < total_taps; ++j) p.ct.oy[j] = offsets[2 * j], p.ct.ox[j] = offsets[2 * j + 1];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dgrad<float, 128>(co_tile, dy, wp, dx, B, Co, Ho, Wo, total_taps, p, st);
  return run == 64
             ? dispatch_dgrad<__nv_bfloat16, 128>(co_tile, dy, wp, dx, B, Co, Ho, Wo,
                                                  total_taps, p, st)
             : dispatch_dgrad<__nv_bfloat16, 64>(co_tile, dy, wp, dx, B, Co, Ho, Wo,
                                                 total_taps, p, st);
}
