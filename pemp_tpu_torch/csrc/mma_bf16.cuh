// Device helpers of the port's bf16 tensor-core kernels: K1's bf16 form
// (fused_step.cu, namespace tc) and K2's bf16 form (typed_message.cu,
// namespace tc). Rows are 64 bf16 wide and lie in shared memory at the
// stride kLd, so that the eight rows one ldmatrix reads fall in distinct
// banks; cp.async brings them in 16-byte pieces; mma.sync m16n8k16 takes
// bf16 inputs and keeps f32 sums.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace pemp {
namespace bf16mma {

typedef __nv_bfloat16 bf16;
constexpr int kLd = 64 + 8;  // bf16 row stride in shared memory: 144 bytes, ldmatrix conflict-free

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a 16-byte copy; with fill false, 16 zero bytes and no read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16x16, row-major fragment) @ b (16x8, column fragment), f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float2 bf2_to_f2(uint32_t u) {
  __nv_bfloat162 v;
  *reinterpret_cast<uint32_t*>(&v) = u;
  return __bfloat1622float2(v);
}

}  // namespace bf16mma
}  // namespace pemp
