// Hopper (sm_90a) building blocks for the port's hand-written kernels:
// shared-memory mbarriers, TMA tensor loads from 2-D, 3-D and 4-D tensor maps,
// TMA tensor stores with their bulk groups, 1-D bulk loads, thread block
// clusters (barriers, distributed shared memory), named barriers, register
// rebalancing between warpgroups, and warpgroup matrix multiplies (wgmma)
// with their shared-memory descriptors. Raw PTX, no CUTLASS. A source that includes this header is rebuilt when the header
// changes (ops/cuda_build.py hashes every header a source includes).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace hopper {

// -- shared memory and mbarriers ---------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to the
// TMA unit (the async proxy).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A wait that lasts
// ~10 s (a phase that can never complete: a fault in the kernel's protocol)
// traps, so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// -- TMA ----------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Copy the box at (c0, c1, c2) (innermost first) of a 3-D tensor map into
// shared memory at `dst`; completion is counted in bytes on `bar`. Elements
// outside the tensor are zero-filled.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Copy the box at (c0, c1, c2, c3) (innermost first) of a 4-D tensor map into
// shared memory at `dst`; completion is counted in bytes on `bar`. Elements
// outside the tensor are zero-filled (and counted).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Copy shared memory at `src`, laid out as one box of a 4-D tensor map, to
// the box at (c0, c1, c2, c3) of the tensor; elements outside the tensor are
// not written. The store joins the issuing thread's current bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Copy the box at (c0, c1) (innermost first) of a 2-D tensor map into shared
// memory at `dst`; completion is counted in bytes on `bar`. Elements outside
// the tensor are zero-filled (and counted).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Copy shared memory at `src`, laid out as one box of a 2-D tensor map, to
// the box at (c0, c1) of the tensor; elements outside the tensor are not
// written. The store joins the issuing thread's current bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// Closes the issuing thread's bulk group (its TMA stores since the last
// commit).
__device__ __forceinline__ void bulk_commit_group() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most kPending of the issuing thread's bulk groups have not
// yet finished reading their shared memory (which may then be rewritten).
template <int kPending>
__device__ __forceinline__ void bulk_wait_group_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
}

// Waits until at most kPending of the issuing thread's bulk groups are not
// yet complete (their writes to global memory done).
template <int kPending>
__device__ __forceinline__ void bulk_wait_group() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Orders this thread's ordinary shared-memory writes before later reads of
// the same memory by the TMA unit (the async proxy), such as a TMA store.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) of global
// memory at `src` into this block's shared memory at `dst` with one bulk
// copy; completion is counted in bytes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// -- thread block clusters ----------------------------------------------------

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster calls both, arrive then wait;
// the arrive releases the thread's earlier memory operations to the threads
// that return from the wait, across the cluster.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The float at `p` (this block's shared memory) in the shared memory of the
// cluster's block `rank`: the same offset, read through distributed shared
// memory.
__device__ __forceinline__ float ld_cluster_f32(const float* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// -- named barriers and register rebalancing ---------------------------------

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// -- wgmma --------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Pins registers that an asynchronous wgmma reads or writes, so that the
// compiler neither moves their uses across a wgmma fence or wait nor reuses
// them while the product is in flight.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a tile written by TMA with 128-byte
// swizzle: rows of 128 bytes (64 bf16), 8-row swizzle atoms of 1024 bytes.
//   K-major operand (K contiguous): SBO = 1024 (the next 8 rows of M/N), LBO
//   unused; a k16 step inside the 64-wide atom adds 32 bytes to the start.
//   MN-major operand (M/N contiguous, "transposed"): SBO = 1024 (the next 8
//   rows of K), LBO = the byte stride from one 64-wide M/N panel to the next.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t smem_addr, uint32_t lbo_bytes) {
  uint64_t d = static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // layout type 1: 128-byte swizzle
  return d;
}

// K-major descriptor of a tile written by TMA with the swizzle of its row
// width: rows of `row_bytes` (128, 64 or 32) bytes, 8-row atoms of
// 8 * row_bytes bytes (SBO); layout type 1, 2 or 3 (128-, 64-, 32-byte
// swizzle). A k step inside a row adds its byte offset to the start.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t smem_addr, uint32_t row_bytes) {
  uint64_t d = static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;  // LBO: unused by swizzled K-major tiles
  d |= static_cast<uint64_t>((8 * row_bytes) >> 4) << 32;
  const uint64_t layout = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
  d |= layout << 62;
  return d;
}

// `desc` moved on by `bytes` (a multiple of 16) in shared memory. The add is
// an opaque instruction at its point of use, so that the compiler does not
// hoist every descriptor of an unrolled k loop into registers of its own.
__device__ __forceinline__ uint64_t desc_advance(uint64_t desc, uint32_t bytes) {
  uint32_t lo = static_cast<uint32_t>(desc);
  asm volatile("add.u32 %0, %0, %1;\n" : "+r"(lo) : "r"(bytes >> 4));
  return (desc & 0xFFFFFFFF00000000ull) | lo;
}

// 2^x on the special-function unit (flushes denormal results to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 2^x for x <= 0 on the FMA units instead of the exp2 unit: x is rounded to
// the nearest integer n by a magic-number add, 2^(x - n) on [-0.5, 0.5] is a
// degree-3 polynomial (relative error 1.2e-4, far below the bf16 rounding
// of p), and n is added to the exponent bits. x <= -127 gives 0.
__device__ __forceinline__ float exp2_fma(float x) {
  x = fmaxf(x, -127.f);
  const float t = x + 12582912.f;  // 1.5 * 2^23: n sits in the low mantissa bits
  const float f = x - (t - 12582912.f);
  const float p = fmaf(fmaf(fmaf(0.05459282f, f, 0.24221784f), f, 0.69336860f), f, 1.f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[16] (+)= a . b over one k16 step, m64n32k16, bf16 in, fp32 out; a and b
// from shared-memory descriptors, both K-major.
__device__ __forceinline__ void wgmma_ss_m64n32(float (&d)[16], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[32] (+)= a . b over one k16 step, m64n64k16, bf16 in, fp32 out; a and b
// from shared-memory descriptors, both K-major.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64] (+)= a . b over one k16 step, m64n128k16, bf16 in, fp32 out; a and b
// from shared-memory descriptors, both K-major.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[32] += a . b over one k16 step, m64n64k16, bf16 in, fp32 out; a from
// registers (the accumulator layout of m64nXk16 packed to bf16x2), b from a
// shared-memory descriptor of an MN-major (transposed) tile.
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64] += a . b over one k16 step, m64n128k16, bf16 in, fp32 out; a from
// registers (the accumulator layout of m64nXk16 packed to bf16x2), b from a
// shared-memory descriptor of an MN-major (transposed) tile.
__device__ __forceinline__ void wgmma_rs_m64n128_tb(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[128] += a . b over one k16 step, m64n256k16, bf16 in, fp32 out; a from
// registers (the accumulator layout of m64nXk16 packed to bf16x2), b from a
// shared-memory descriptor of an MN-major (transposed) tile.
__device__ __forceinline__ void wgmma_rs_m64n256_tb(float (&d)[128], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// -- wgmma, 8-bit integers ----------------------------------------------------
//
// d (+)= a . b over one k32 step, s8 in, s32 out. 8-bit wgmma takes both
// operands K-major only: b from a K-major descriptor; a from a K-major
// descriptor (_ss) or from registers (_rs: four 32-bit registers of four
// s8 each, the layout of mma.m16n8k32's A fragment within each warp).
// scale_d = 0 overwrites d instead of adding to it.

#define HOPPER_R4(b) "+r"(d[b]), "+r"(d[b + 1]), "+r"(d[b + 2]), "+r"(d[b + 3])
#define HOPPER_R16(b) HOPPER_R4(b), HOPPER_R4(b + 4), HOPPER_R4(b + 8), HOPPER_R4(b + 12)
#define HOPPER_D16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_D32                                                                   \
  HOPPER_D16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
             "%30, %31"
#define HOPPER_D64                                                                     \
  HOPPER_D32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "   \
             "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
             "%61, %62, %63"

__device__ __forceinline__ void wgmma_s8_ss_m64n32(int (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {" HOPPER_D16 "}, %16, %17, p;\n}\n"
      : HOPPER_R16(0)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_ss_m64n64(int (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" HOPPER_D32 "}, %32, %33, p;\n}\n"
      : HOPPER_R16(0), HOPPER_R16(16)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_ss_m64n128(int (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" HOPPER_D64 "}, %64, %65, p;\n}\n"
      : HOPPER_R16(0), HOPPER_R16(16), HOPPER_R16(32), HOPPER_R16(48)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_rs_m64n32(int (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {" HOPPER_D16
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : HOPPER_R16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_rs_m64n64(int (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" HOPPER_D32
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : HOPPER_R16(0), HOPPER_R16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_rs_m64n128(int (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" HOPPER_D64
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : HOPPER_R16(0), HOPPER_R16(16), HOPPER_R16(32), HOPPER_R16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_ss_m64n160(int (&d)[80], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p;\n}\n"
      : HOPPER_R16(0), HOPPER_R16(16), HOPPER_R16(32), HOPPER_R16(48), HOPPER_R16(64)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

#undef HOPPER_R4
#undef HOPPER_R16
#undef HOPPER_D16
#undef HOPPER_D32
#undef HOPPER_D64

// -- host: tensor maps --------------------------------------------------------

// cuTensorMapEncodeTiled is a driver function. It is reached through the
// runtime's driver entry point (CUDA 12.5 or later), so the library needs no
// -lcuda.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  });
  return fn;
}

// A 3-D tensor map over a contiguous bf16 tensor [outer, rows, cols] with
// boxes of [1, box_rows, 64] and 128-byte swizzle. Rows past `rows` of one
// outer index read as zeros (never the next index's rows). Returns false if
// the driver refuses it.
inline bool encode_bf16_3d(CUtensorMap* map, const void* ptr, int outer, int rows, int cols,
                           int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-D tensor map over a contiguous int8 tensor [outer, rows, cols] with
// boxes of [1, box_rows, box_cols] and the swizzle of a box row's width
// (box_cols = 128, 64 or 32 bytes), the layout `desc_kmajor` describes. Rows
// past `rows` of one outer index read as zeros. Returns false if the driver
// refuses it.
inline bool encode_s8_3d(CUtensorMap* map, const void* ptr, int outer, int rows, int cols,
                         int box_rows, int box_cols) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols),
                                 static_cast<cuuint64_t>(rows) * cols};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = box_cols == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D tensor map over a bf16 tensor of any strides: dims[0..3] innermost
// first, strides[0..2] the byte strides of dims 1..3 (multiples of 16; the
// innermost stride is one element), boxes of box[0..3] elements (each at
// most 256; box[0] * 2 bytes at most the swizzle span). Elements outside the
// tensor read as zeros and are not written by a store. Returns false if
// cuTensorMapEncodeTiled refuses it.
inline bool encode_bf16_4d(CUtensorMap* map, const void* ptr, const uint64_t (&dims)[4],
                           const uint64_t (&strides)[3], const uint32_t (&box)[4],
                           CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t st[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t b[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), d, st, b,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D tensor map over a row-major tensor [rows, cols] of `elem_bytes`-byte
// elements (`dtype`) whose rows lie `row_bytes` apart (a multiple of 16),
// with boxes of [box_rows, box_cols] and the given swizzle (box_cols *
// elem_bytes at most its span). Elements outside the tensor read as zeros
// and are not written by a store. Returns false if the driver refuses it.
inline bool encode_2d(CUtensorMap* map, CUtensorMapDataType dtype, const void* ptr, uint64_t rows,
                      uint64_t cols, uint64_t row_bytes, uint32_t box_rows, uint32_t box_cols,
                      CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, dtype, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
