// Warp-level bf16 tensor-core helpers shared by the port's kernels (sm_90a).
//
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with its operands loaded from
// shared memory by ldmatrix, and 16-byte cp.async copies into shared memory.
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A (16x16, row-major)  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16x8, k by n)      b0 (k = 2t..2t+1, n = g)            b1 (k = 2t+8.., n = g)
//   C/D (16x8, fp32)      c0, c1 (g, 2t..2t+1)                c2, c3 (g+8, 2t..2t+1)
// The address helpers below give each lane the shared-memory row it passes to
// ldmatrix.x4 so that the four 8x8 matrices land as those fragments.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-fills the 16 bytes when !pred
// (src-size 0 reads nothing, so src may then be any mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane l supplies the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b for one m16n8k16 tile.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> their bf16 pair hi (a in the low half, round to nearest) and
// the bf16 pair of the remainder lo, so that hi + lo carries about 16
// significant bits of each.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// Row-major A tile (rows by k, k contiguous, `ld` elements a row): the lane's
// address for the 16x16 A fragment whose top-left is (row0, k0).
__device__ __forceinline__ const __nv_bfloat16* a_frag_ptr(const __nv_bfloat16* s, int ld,
                                                          int row0, int k0, int lane) {
  return s + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8;
}
// B stored k by n (n contiguous), loaded with .trans: the lane's address for
// the 16 (k) x 16 (n) block at (k0, n0); r[0], r[1] are b0, b1 of the n8 tile
// n0 and r[2], r[3] those of n0 + 8.
__device__ __forceinline__ const __nv_bfloat16* bt_frag_ptr(const __nv_bfloat16* s, int ld,
                                                           int k0, int n0, int lane) {
  return s + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8;
}
// B stored n by k (k contiguous, as K rows for Q.K^T), loaded without .trans:
// the lane's address for the 16 (n) x 16 (k) block at (n0, k0); r[0], r[1] are
// b0, b1 of the n8 tile n0 and r[2], r[3] those of n0 + 8.
__device__ __forceinline__ const __nv_bfloat16* bn_frag_ptr(const __nv_bfloat16* s, int ld,
                                                           int n0, int k0, int lane) {
  return s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8;
}

}  // namespace tc
