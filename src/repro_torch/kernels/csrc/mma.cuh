// Warp-level tensor-core and async-copy helpers for Hopper (sm_90a), shared
// by verify_attn.cu (the copies, the bf16 packing), ssd_scan.cu (the
// tensor-core products; its backward also ldmatrix, the copies and the
// mbarrier) and attn_bwd.cu (all but the mbarrier);
// kernels/build.py hashes this header into each library's name, so an edit
// rebuilds all three.
//
// Fragment layouts of mma.sync (g = lane / 4, t = lane % 4; row-major A,
// column-major B, i.e. B given as B[k][n]):
//   m16n8k16 bf16: a0 (g, 2t:2t+2)  a1 (g+8, 2t:2t+2)  a2 (g, 8+2t:..)  a3 (g+8, 8+2t:..)
//                  b0 (k 2t:2t+2, n g)  b1 (k 8+2t:8+2t+2, n g)
//   m16n8k8 tf32:  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//                  b0 (k t, n g)  b1 (k t+4, n g)
//   accumulator:   c0, c1 (g, 2t), (g, 2t+1)   c2, c3 (g+8, 2t), (g+8, 2t+1)
// A pair of bf16 in one 32-bit register holds the lower column in its low half.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

// d += a * b on the tensor cores: bf16 operands, products exact, f32 sums.
__device__ __forceinline__ void bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b on the tensor cores: tf32 operands (f32 bit patterns whose low
// 13 mantissa bits are zero), f32 sums.
__device__ __forceinline__ void tf32_1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32 -> tf32, rounded to nearest (ties away), as a bit pattern
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|): both parts tf32. A product whose other
// operand is exact in tf32 (a bf16 value) then runs as two tf32 mma with
// about f32's precision ("2xTF32").
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// a bf16 value widened to f32 is exact in tf32
__device__ __forceinline__ uint32_t bf16_as_tf32(__nv_bfloat16 v) {
  return __float_as_uint(__bfloat162float(v));
}

// two f32 -> one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix: four (x4) or two (x2) 8x8 bf16 matrices from shared memory, one
// register each; lane l gives the address of row l % 8 of matrix l / 8 (x2:
// lanes 0-15), each row 16 contiguous bytes. Lane l receives (row l / 4,
// columns 2(l % 4), 2(l % 4) + 1) of each matrix, or with .trans (rows
// 2(l % 4), 2(l % 4) + 1, column l / 4): a row-major tile gives an A or a
// column-major B fragment as stored, and the other one transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// 16 bytes global -> shared without passing through registers; live ==
// false writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// mbarrier in shared memory: init with the number of arrivals a phase
// takes; cp_async_arrive makes the completion of all of this thread's
// cp.async copies issued so far one of those arrivals (noinc); wait spins
// until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" :: "r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

}  // namespace mma
