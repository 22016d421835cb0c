// Warp-level tensor-core building blocks of the mma.sync generation
// (sm_80 and later, so Hopper too), shared by the attention kernels:
//   - ldmatrix x4 (plain and .trans) from shared memory into fragments,
//   - mma.sync m16n8k16 bf16 x bf16 -> float32, and f16 x f16 -> float32,
//   - the repack of float32 C fragments into the 16-bit A fragment of the
//     next product,
//   - products over several 16-row tiles that share each B fragment,
// and, from common.cuh, exp2 on the special-function unit and the cp.async
// copies.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16 with
// floating point type"), with g = lane / 4 and c = 2 * (lane % 4), each
// register two consecutive 16-bit values, bf16 or f16 alike (the lower
// column in the low half):
//   A, 16 x 16 row-major:  a[0] = (row g, cols c, c+1)     a[1] = (g+8, c, c+1)
//                          a[2] = (g, c+8, c+9)           a[3] = (g+8, c+8, c+9)
//   B, 16 (k) x 8 (n):     b[0] = (k c, c+1; n g)         b[1] = (k c+8, c+9; n g)
//   C, 16 x 8 float32:     c[0], c[1] = (g, c), (g, c+1)  c[2], c[3] = (g+8, c), (g+8, c+1)
// Two C fragments side by side (16 x 16) hold exactly the elements of one A
// fragment in the same lanes, so a product's result becomes the next
// product's A operand by rounding pairs to the 16-bit type, with no shuffle
// and no trip through shared memory (FlashAttention-2's register reuse).
// Every function is a template over that type T (__nv_bfloat16 or __half):
// ldmatrix moves 16-bit elements whatever they are, and only the mma
// instruction and the pair rounding (pack2) differ.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "common.cuh"

namespace ptt {
namespace frag {

using ptt::cp_async_16;
using ptt::cp_async_4;
using ptt::cp_async_commit;
using ptt::cp_async_wait;
using ptt::exp2_approx;
using ptt::smem_addr;

// r[i]: this lane's fragment of the 8 x 8 16-bit matrix i whose rows lanes
// 8i .. 8i+7 address (16 bytes each, 16-byte aligned).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// The same, each matrix transposed on the way: lane l gets the elements
// (rows 2(l%4), 2(l%4)+1; column l/4) of the stored matrix.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// d[16 x 8] += a[16 x 16] * b[16 x 8], T operands, float32 accumulators.
template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to nearest even, as torch's .to(bfloat16), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two floats rounded to nearest even, as torch's .to(float16) (past 65504
// +-inf), lo in the low half: __floats2half2_rn puts its first argument in
// .x, the low 16 bits, as __floats2bfloat162_rn does.
__device__ __forceinline__ uint32_t pack_half(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The pair rounding of T.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value)
    return pack_half(lo, hi);
  else
    return pack_bf16(lo, hi);
}

// A fragments of a 16 x K block, row-major in shared memory with a
// leading dimension of `ld` elements (a multiple of 8).
template <int K, typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[K / 16][4], const T* A, int ld) {
  const int lane = threadIdx.x & 31;
  // matrices 0-3: (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
  const T* p = A + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int k = 0; k < K / 16; ++k) ldmatrix_x4(a[k], p + 16 * k);
}

// This lane's address for the B operands of gemm_nt: B stored row-major as
// [N][K], matrices 0-3 of an ldmatrix x4 (n 0-7, k 0-7), (n 0-7, k 8-15),
// (n 8-15, k 0-7), (n 8-15, k 8-15).
template <typename T>
__device__ __forceinline__ const T* nt_b_row(const T* B, int ld) {
  const int lane = threadIdx.x & 31;
  return B + ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
}

// acc[16 x N] += a[16 x 16] * B[N][16]^T, one k-step; pb from nt_b_row.
template <int N, typename T>
__device__ __forceinline__ void nt_step(float (&acc)[N / 8][4], const uint32_t (&a)[4],
                                        const T* pb, int ld) {
#pragma unroll
  for (int n = 0; n < N / 16; ++n) {
    uint32_t b[4];
    ldmatrix_x4(b, pb + n * 16 * ld);
    mma_16816<T>(acc[2 * n], a, b[0], b[1]);
    mma_16816<T>(acc[2 * n + 1], a, b[2], b[3]);
  }
}

// acc[16 x N] += A[16 x K] * B^T, B stored row-major as [N][K] in shared
// memory (so B^T is the "col" operand as it lies): S = Q K^T and its kin.
template <int K, int N, typename T>
__device__ __forceinline__ void gemm_nt(float (&acc)[N / 8][4], const uint32_t (&a)[K / 16][4],
                                        const T* B, int ld) {
  const T* pb = nt_b_row(B, ld);
#pragma unroll
  for (int k = 0; k < K / 16; ++k) nt_step<N>(acc, a[k], pb + 16 * k, ld);
}

// The same with A too row-major in shared memory (leading dimension lda),
// its fragments loaded one k-step at a time: 4 registers instead of K / 4.
template <int K, int N, typename T>
__device__ __forceinline__ void gemm_nt_smem(float (&acc)[N / 8][4], const T* A, int lda,
                                             const T* B, int ld) {
  const int lane = threadIdx.x & 31;
  const T* pa = A + ((lane & 7) + ((lane >> 3) & 1) * 8) * lda + (lane >> 4) * 8;
  const T* pb = nt_b_row(B, ld);
#pragma unroll
  for (int k = 0; k < K / 16; ++k) {
    uint32_t a[4];
    ldmatrix_x4(a, pa + 16 * k);
    nt_step<N>(acc, a, pb + 16 * k, ld);
  }
}

// acc[16 x N] += A[16 x K] * B, B stored row-major as [K][N] in shared
// memory, transposed by ldmatrix.trans: dV += P^T dO, dQ += dS K, dK += dS^T Q.
template <int K, int N, typename T>
__device__ __forceinline__ void gemm_nn(float (&acc)[N / 8][4], const uint32_t (&a)[K / 16][4],
                                        const T* B, int ld) {
  const int lane = threadIdx.x & 31;
  // matrices 0-3: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
  const T* p = B + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int k = 0; k < K / 16; ++k)
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, p + k * 16 * ld + n * 16);
      mma_16816<T>(acc[2 * n], a[k], b[0], b[1]);
      mma_16816<T>(acc[2 * n + 1], a[k], b[2], b[3]);
    }
}

// acc[m] += A_m * B^T for MT 16-row tiles m (B as in gemm_nt): each B
// fragment that ldmatrix brings feeds MT products.
template <int MT, int K, int N, typename T>
__device__ __forceinline__ void gemm_nt_rows(float (&acc)[MT][N / 8][4],
                                             const uint32_t (&a)[MT][K / 16][4], const T* B,
                                             int ld) {
  const T* pb = nt_b_row(B, ld);
#pragma unroll
  for (int k = 0; k < K / 16; ++k)
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      uint32_t b[4];
      ldmatrix_x4(b, pb + n * 16 * ld + 16 * k);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_16816<T>(acc[m][2 * n], a[m][k], b[0], b[1]);
        mma_16816<T>(acc[m][2 * n + 1], a[m][k], b[2], b[3]);
      }
    }
}

// acc[m] += A_m * B for MT 16-row tiles m (B as in gemm_nn, transposed by
// ldmatrix.trans): each B fragment feeds MT products.
template <int MT, int K, int N, typename T>
__device__ __forceinline__ void gemm_nn_rows(float (&acc)[MT][N / 8][4],
                                             const uint32_t (&a)[MT][K / 16][4], const T* B,
                                             int ld) {
  const int lane = threadIdx.x & 31;
  const T* p = B + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int k = 0; k < K / 16; ++k)
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, p + k * 16 * ld + n * 16);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_16816<T>(acc[m][2 * n], a[m][k], b[0], b[1]);
        mma_16816<T>(acc[m][2 * n + 1], a[m][k], b[2], b[3]);
      }
    }
}

// The float32 C fragments of a 16 x N result as the T A fragments of a
// 16 x N operand: C tiles 2k and 2k+1 are A tile k, element for element.
template <int N, typename T>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4], const float (&c)[N / 8][4]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k) {
    a[k][0] = pack2<T>(c[2 * k][0], c[2 * k][1]);
    a[k][1] = pack2<T>(c[2 * k][2], c[2 * k][3]);
    a[k][2] = pack2<T>(c[2 * k + 1][0], c[2 * k + 1][1]);
    a[k][3] = pack2<T>(c[2 * k + 1][2], c[2 * k + 1][3]);
  }
}

}  // namespace frag
}  // namespace ptt
