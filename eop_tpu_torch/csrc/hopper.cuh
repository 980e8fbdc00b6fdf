// Thin wrappers over the Hopper (sm_90a) PTX the port's kernels are built
// from: mbarriers, bulk asynchronous copies (TMA), warpgroup matrix multiply
// (wgmma) and the host-side tensor-map encoder.  No library code: every
// function is one or two instructions.
#pragma once

#include <cuda.h>  // CUtensorMap types only; the encoder is reached by entry point
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------- addresses
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float2 lds64(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ uint32_t lds16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts16(uint32_t addr, uint16_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}

// Makes this thread's generic-proxy shared-memory stores visible to the async
// proxy (wgmma operands, bulk copies); a barrier follows before they are read.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// --------------------------------------------------- bulk asynchronous copies
__device__ __forceinline__ void bulk_load_1d(uint32_t dst, const void* src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// -------------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps a register operand of an asynchronous wgmma alive and in place until
// the wait that retires it.
__device__ __forceinline__ void keep(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// Shared-memory matrix descriptor of a K-major operand whose rows are ROWB
// bytes (one swizzle span: 128 or 64) and 8-row groups follow each other
// densely.  `addr` may point 32*j bytes into a row to select a K step.
template <int ROWB>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  static_assert(ROWB == 128 || ROWB == 64, "swizzle span");
  constexpr uint64_t layout = ROWB == 128 ? 1 : 2;  // B128 / B64
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * ROWB) >> 4) << 32) | (layout << 62);
}

// Round to nearest (ties away) to TF32: 10 mantissa bits, low 13 bits clear.
// Two integer instructions give cvt.rna.tf32.f32's result for every finite
// value, and measured 4-15 % faster on the operation-bound convs (H100).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// a = hi + lo with hi = tf32(a), lo = tf32(a - hi)
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

// D[64 x 32] (+)= A[64 x 8] (registers, TF32) * B[32 x 8]^T (shared,
// K-major); with accumulate = 0 D is overwritten (the instruction's scale-d)
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t desc_b,
                                              int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0,  %1,  %2,  %3,  %4,  %5,  %6,  %7,  "
      " %8,  %9,  %10, %11, %12, %13, %14, %15},"
      "{%16, %17, %18, %19},"
      " %20,"
      " p,   1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 8] (registers, TF32) * B[64 x 8]^T (shared,
// K-major); with accumulate = 0 D is overwritten
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t desc_b,
                                              int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0,  %1,  %2,  %3,  %4,  %5,  %6,  %7,  "
      " %8,  %9,  %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      "{%32, %33, %34, %35},"
      " %36,"
      " p,   1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// D[64 x 32] += A[64 x 16] (shared, K-major, bf16) * B[32 x 16]^T (shared)
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[16], uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,  %1,  %2,  %3,  %4,  %5,  %6,  %7,  "
      " %8,  %9,  %10, %11, %12, %13, %14, %15},"
      " %16,"
      " %17,"
      " p,   1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D[64 x 32] += A[64 x 16] (registers, bf16 pairs) * B[32 x 16]^T (shared)
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[16], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,  %1,  %2,  %3,  %4,  %5,  %6,  %7,  "
      " %8,  %9,  %10, %11, %12, %13, %14, %15},"
      "{%16, %17, %18, %19},"
      " %20,"
      " p,   1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A[64 x 16] (registers, bf16 pairs) * B[64 x 16]^T (shared)
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,  %1,  %2,  %3,  %4,  %5,  %6,  %7,  "
      " %8,  %9,  %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      "{%32, %33, %34, %35},"
      " %36,"
      " p,   1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A[64 x 16] (shared, K-major, bf16) * B[64 x 16]^T (shared)
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,  %1,  %2,  %3,  %4,  %5,  %6,  %7,  "
      " %8,  %9,  %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32,"
      " %33,"
      " p,   1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// ------------------------------------------------------- tensor maps (host)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point lookup, so the
// library links against nothing but the CUDA runtime.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tiled map of `rank` dimensions (innermost first), element strides 1,
// out-of-bounds elements read as zero.  strides_bytes[i] is the stride of
// dimension i + 1.  Returns the encoder's CUresult (0 on success, -1 when the
// encoder cannot be found).
inline int encode_tiled(CUtensorMap* map, CUtensorMapDataType type, int rank,
                        const void* base, const cuuint64_t* dims,
                        const cuuint64_t* strides_bytes, const cuuint32_t* box,
                        CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return -1;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return static_cast<int>(fn(map, type, static_cast<cuuint32_t>(rank),
                             const_cast<void*>(base), dims, strides_bytes, box,
                             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// ------------------------------------------------------------------ epilogue
// What a kernel applies to its fp32 accumulators before the store:
// acc * scale[c] + shift[c] where scale is not null, then SiLU when act == 1.
struct Epilogue {
  const float* scale;
  const float* shift;
  int act;
};

__device__ __forceinline__ float apply(float v, float sc, float sh, int act) {
  v = fmaf(v, sc, sh);
  if (act == 1) v = __fdividef(v, 1.f + __expf(-v));
  return v;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Stores one thread's share of a wgmma accumulator (m64 x N, N = 2 * NV):
// for each 8-channel group i, quad thread t holds channels 8i + 2t, 8i + 2t + 1
// of the pixels pa (rows g) and pb (rows g + 8) of its warp's 16 rows.  `pa`
// and `pb` point at channel `c0` of those pixels, or are null past the edge.
// Channels from `limit` on (a multiple of 8: a zero-padded N tile's tail) are
// neither read from scale and shift nor stored.
template <typename T, int NV>
__device__ __forceinline__ void store_fragment(const float (&acc)[NV], T* pa, T* pb,
                                               int c0, int t, const Epilogue& e,
                                               int limit = 1 << 30) {
#pragma unroll
  for (int i = 0; i < NV / 4; ++i) {
    if (c0 + i * 8 >= limit) break;
    const int c = i * 8 + 2 * t;
    float sc0 = 1.f, sc1 = 1.f, sh0 = 0.f, sh1 = 0.f;
    if (e.scale != nullptr) {
      sc0 = __ldg(e.scale + c0 + c), sc1 = __ldg(e.scale + c0 + c + 1);
      sh0 = __ldg(e.shift + c0 + c), sh1 = __ldg(e.shift + c0 + c + 1);
    }
    if (pa != nullptr)
      store2(pa + c, apply(acc[4 * i + 0], sc0, sh0, e.act),
             apply(acc[4 * i + 1], sc1, sh1, e.act));
    if (pb != nullptr)
      store2(pb + c, apply(acc[4 * i + 2], sc0, sh0, e.act),
             apply(acc[4 * i + 3], sc1, sh1, e.act));
  }
}

}  // namespace hopper
