// Hopper tensor-core plumbing shared by the wgmma kernels (assign.cu:
// TF32, maxsim_bf16.cu: bf16, knn.cu: both): the K-major shared-memory
// layout and its descriptors, wgmma m64n64 with both operands in shared
// memory and m64nN (N = 8, 16, 32, 64) with A in registers, f32
// accumulators, the fences and group waits around it, the cp.async copies
// that fill a staging ring, and the barriers and bulk copies of a ring that a
// producer warp fills.
//
// Layout. A tile of `rows` x kp values (kp a multiple of the instruction's
// depth) is stored K-major without swizzle, in 16-byte column chunks: chunk
// q holds elements [E q, E q + E) of every row, row after row, so 8
// consecutive rows of one chunk form one 128-byte core matrix. In the
// descriptor (PTX ISA, "Matrix Descriptor Format"; CUTLASS's canonical
// K-major INTERLEAVE layout ((8, m), (E, 2)) : ((E, SBO), (1, LBO))) the
// leading byte offset is the chunk stride (rows x 16 bytes) and the stride
// byte offset the 8-row stride (128 bytes). The stores that fill such a
// tile from 8 consecutive rows and one chunk write 128 contiguous bytes,
// free of bank conflicts.
//
// Accumulators. wgmma m64nN with f32 accumulation leaves register i of
// thread t (0..127 in its warpgroup) at row 16 (t / 32) + (t % 32) / 4 +
// 8 ((i / 2) % 2) and column 8 (i / 4) + 2 (t % 4) + i % 2 of the 64 x N
// tile: a row's N values lie in the 4 lanes of one quad.
//
// Visibility. Shared memory written by ordinary stores or cp.async is read
// by wgmma through the async proxy: fence.proxy.async, then a barrier,
// then wgmma.fence before the first wgmma.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWgThreads = 128;  // one warpgroup

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of (r, k) in a K-major tile of `rows` rows with E elements
// per 16 bytes (E = 4 for f32 / TF32, 8 for bf16).
template <int E>
__device__ __forceinline__ int kmajor_offset(int r, int k, int rows) {
  return (k / E) * rows * E + r * E + (k % E);
}

// Descriptor of the K-major tile whose first row of the wanted 64 (or N)
// starts at shared address `addr`; `rows` is the tile's row count (the
// chunk stride). Layout type 0: no swizzle.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, int rows) {
  const uint64_t start = (addr >> 4) & 0x3FFF;
  const uint64_t lbo = static_cast<uint64_t>(rows) & 0x3FFF;  // rows x 16 B, in 16 B units
  const uint64_t sbo = 128 >> 4;                               // 8 rows x 16 B
  return start | (lbo << 16) | (sbo << 32);
}

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Generic-proxy shared stores (st.shared, cp.async) made visible to wgmma.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define INNR_ACC32(a)                                                                          \
  "+f"(a[0]), "+f"(a[1]), "+f"(a[2]), "+f"(a[3]), "+f"(a[4]), "+f"(a[5]), "+f"(a[6]),          \
      "+f"(a[7]), "+f"(a[8]), "+f"(a[9]), "+f"(a[10]), "+f"(a[11]), "+f"(a[12]), "+f"(a[13]),  \
      "+f"(a[14]), "+f"(a[15]), "+f"(a[16]), "+f"(a[17]), "+f"(a[18]), "+f"(a[19]),            \
      "+f"(a[20]), "+f"(a[21]), "+f"(a[22]), "+f"(a[23]), "+f"(a[24]), "+f"(a[25]),            \
      "+f"(a[26]), "+f"(a[27]), "+f"(a[28]), "+f"(a[29]), "+f"(a[30]), "+f"(a[31])

#define INNR_REGS32                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// acc (64 x 64, f32) += A (64 x 8, TF32) B^T (64 x 8, TF32); both operands
// K-major in shared memory, read as f32 whose low 13 mantissa bits the
// tensor core ignores.
__device__ __forceinline__ void wgmma_tf32_m64n64k8(float (&acc)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " INNR_REGS32
      ", %32, %33, p, 1, 1;\n}\n"
      : INNR_ACC32(acc)
      : "l"(a), "l"(b), "r"(1));
}

// acc (64 x 64, f32) += A (64 x 16, bf16) B^T (64 x 16, bf16); both
// operands K-major (no transpose).
__device__ __forceinline__ void wgmma_bf16_m64n64k16(float (&acc)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " INNR_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : INNR_ACC32(acc)
      : "l"(a), "l"(b), "r"(1));
}

// acc (64 x N, f32) += A (64 x 8 TF32, or 64 x 16 bf16, from registers)
// B^T (N x 8, or N x 16, K-major in shared memory). A's fragment: thread
// t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 and that + 8, in
// a0 / a1 (columns t % 4: TF32; 2 (t % 4) and + 1: bf16, two per register)
// and a2 / a3 (those + 4 for TF32, + 8 for bf16).
__device__ __forceinline__ void wgmma_tf32_rs(float (&acc)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&acc)[8], uint32_t a0, uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]), "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&acc)[16], uint32_t a0, uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]), "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7]), "+f"(acc[8]), "+f"(acc[9]), "+f"(acc[10]), "+f"(acc[11]), "+f"(acc[12]), "+f"(acc[13]), "+f"(acc[14]), "+f"(acc[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&acc)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]), "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7]), "+f"(acc[8]), "+f"(acc[9]), "+f"(acc[10]), "+f"(acc[11]), "+f"(acc[12]), "+f"(acc[13]), "+f"(acc[14]), "+f"(acc[15]), "+f"(acc[16]), "+f"(acc[17]), "+f"(acc[18]), "+f"(acc[19]), "+f"(acc[20]), "+f"(acc[21]), "+f"(acc[22]), "+f"(acc[23]), "+f"(acc[24]), "+f"(acc[25]), "+f"(acc[26]), "+f"(acc[27]), "+f"(acc[28]), "+f"(acc[29]), "+f"(acc[30]), "+f"(acc[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_bf16_rs(float (&acc)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_bf16_rs(float (&acc)[8], uint32_t a0, uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]), "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_bf16_rs(float (&acc)[16], uint32_t a0, uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]), "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7]), "+f"(acc[8]), "+f"(acc[9]), "+f"(acc[10]), "+f"(acc[11]), "+f"(acc[12]), "+f"(acc[13]), "+f"(acc[14]), "+f"(acc[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_bf16_rs(float (&acc)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]), "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7]), "+f"(acc[8]), "+f"(acc[9]), "+f"(acc[10]), "+f"(acc[11]), "+f"(acc[12]), "+f"(acc[13]), "+f"(acc[14]), "+f"(acc[15]), "+f"(acc[16]), "+f"(acc[17]), "+f"(acc[18]), "+f"(acc[19]), "+f"(acc[20]), "+f"(acc[21]), "+f"(acc[22]), "+f"(acc[23]), "+f"(acc[24]), "+f"(acc[25]), "+f"(acc[26]), "+f"(acc[27]), "+f"(acc[28]), "+f"(acc[29]), "+f"(acc[30]), "+f"(acc[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

#undef INNR_ACC32
#undef INNR_REGS32

__device__ __forceinline__ int acc_row(int i, int t) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i, int t) { return 8 * (i >> 2) + 2 * (t & 3) + (i & 1); }

// One 16-byte global-to-shared copy, cached in L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A shared-memory ring's barriers (mbarrier, CTA scope) and the bulk copy
// that fills a stage: one thread asks for `bytes` contiguous bytes (a
// multiple of 16, both addresses 16-byte aligned), and the copy counts them
// off the stage's barrier, whose phase completes when the bytes are in and
// its arrivals made. Parity: a wait on parity p returns once the phase of
// that parity has completed (a fresh barrier counts the phase before the
// first, parity 1, as completed).
__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, unsigned bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A warpgroup's registers per thread, raised or lowered to N (a multiple of
// 8 in 24..256; all 128 threads execute it), so that consumer warpgroups can
// take what a producer warpgroup gives up.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// A barrier of the `threads` threads (whole warps) that name it; id 1..15
// (0 is __syncthreads).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace
