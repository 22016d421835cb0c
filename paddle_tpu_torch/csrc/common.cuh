// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes float32 or bfloat16 tensors (dtype code 0 and 1 in the
// C entry points), computes in float32 and rounds once on the store, which
// is what the TPU kernels they replace do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// VEC elements moved as one load or store: 16 bytes when VEC * sizeof(T) == 16.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Second pass of the backward kernels' column reductions: out[k][c] =
// sum over r < n of part[k][r][c], for k = blockIdx.z.  A block takes 32
// columns; its kSumRows thread rows each add every kSumRows-th partial row
// of those columns in row order, and thread row 0 adds the kSumRows sums in
// order.  Which thread adds which value is fixed by the shape alone, so the
// result does not depend on how blocks were scheduled: no float atomics,
// bitwise repeatable.  (Internal linkage: every object that includes this
// header has its own copy.)
namespace {
constexpr int kSumRows = 8;

__global__ void column_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  int n, int d) {
  __shared__ float sums[kSumRows][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const float* p = part + static_cast<int64_t>(blockIdx.z) * n * d + col;
  float t = 0.f;
  if (col < d)
    for (int r = threadIdx.y; r < n; r += kSumRows) t += p[static_cast<int64_t>(r) * d];
  sums[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && col < d) {
    float u = 0.f;
#pragma unroll
    for (int y = 0; y < kSumRows; ++y) u += sums[y][threadIdx.x];
    out[static_cast<int64_t>(blockIdx.z) * d + col] = u;
  }
}

// part: [k][n][d] float32, out: [k][d] float32.
cudaError_t column_sum(const float* part, float* out, int k, int n, int d, cudaStream_t stream) {
  const dim3 grid((d + 31) / 32, 1, k);
  column_sum_kernel<<<grid, dim3(32, kSumRows), 0, stream>>>(part, out, n, d);
  return cudaGetLastError();
}
}  // namespace

}  // namespace ptt
