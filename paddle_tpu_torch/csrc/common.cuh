// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes float32, bfloat16 or float16 tensors (dtype code 0, 1
// and 2 in the C entry points), computes in float32 and rounds once on the
// store (to nearest even; a float16 past 65504 becomes +-inf, never clamped,
// as torch's .to(float16)), which is what the TPU kernels they replace do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ptt {

enum DType : int { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);  // nearest even; past 65504 +-inf, as torch's .to(float16)
}

// VEC elements moved as one load or store: 16 bytes when VEC * sizeof(T) == 16.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// A Vec as floats, and floats rounded once into a Vec; bfloat16 and float16
// pairs go through the packed conversions (one instruction a pair for the
// rounding).
template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Vec<T, VEC>& v, float (&f)[VEC]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && VEC % 2 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 2) {
      const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.v[i]));
      f[i] = p.x;
      f[i + 1] = p.y;
    }
  } else if constexpr (std::is_same<T, __half>::value && VEC % 2 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 2) {
      const float2 p = __half22float2(*reinterpret_cast<const __half2*>(&v.v[i]));
      f[i] = p.x;
      f[i + 1] = p.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_f32(v.v[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> pack(const float (&f)[VEC]) {
  Vec<T, VEC> v;
  if constexpr (std::is_same<T, __nv_bfloat16>::value && VEC % 2 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 2)
      *reinterpret_cast<__nv_bfloat162*>(&v.v[i]) = __floats2bfloat162_rn(f[i], f[i + 1]);
  } else if constexpr (std::is_same<T, __half>::value && VEC % 2 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 2)
      *reinterpret_cast<__half2*>(&v.v[i]) = __floats2half2_rn(f[i], f[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v.v[i] = from_f32<T>(f[i]);
  }
  return v;
}

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the special-function unit (ex2.approx: about 2 ulp; results below
// 2^-126 flush to 0, and 2^-inf is 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes from global to shared memory without passing through registers;
// with `valid` false nothing is read and the 16 bytes are zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// The same for 4 bytes (a float of a row that need not be 16-byte aligned).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

// Close the group of the copies this thread issued since the last commit.
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// SMs of the current device: a persistent grid is a whole number of waves.
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
    return 1;
  return n;
}

// Second pass of the backward kernels' column reductions: out[k][c] = the
// sum over r < n of part[k][r][c], k = blockIdx.z.  A block takes 32
// columns; its thread row y adds partial rows y, y + kColRows, ... in row
// order, kColUnroll loads in flight at a time, and thread row 0 adds the
// kColRows sums in order.  Which thread adds which value, and in what
// order, is fixed by the shape alone, so the result does not depend on how
// blocks were scheduled: no float atomics, bitwise repeatable.  (Internal
// linkage: every object that includes this header has its own copy.)
namespace {
constexpr int kColRows = 8;    // thread rows of a column-pass block
constexpr int kColUnroll = 8;  // partial rows a column-pass thread has in flight

__global__ void __launch_bounds__(32 * kColRows)
    column_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int n, int d) {
  __shared__ float sums[kColRows][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const float* p = part + static_cast<int64_t>(blockIdx.z) * n * d + col;
  float t = 0.f;
  if (col < d) {
    int r = threadIdx.y;
    for (; r + (kColUnroll - 1) * kColRows < n; r += kColUnroll * kColRows) {
      float a[kColUnroll];
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u) a[u] = p[static_cast<int64_t>(r + u * kColRows) * d];
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u) t += a[u];
    }
    for (; r < n; r += kColRows) t += p[static_cast<int64_t>(r) * d];
  }
  sums[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && col < d) {
    float u = 0.f;
#pragma unroll
    for (int y = 0; y < kColRows; ++y) u += sums[y][threadIdx.x];
    out[static_cast<int64_t>(blockIdx.z) * d + col] = u;
  }
}

// part: [k][n][d] float32, out: [k][d] float32.
cudaError_t column_sum(const float* part, float* out, int k, int n, int d, cudaStream_t stream) {
  const dim3 grid((d + 31) / 32, 1, k);
  column_sum_kernel<<<grid, dim3(32, kColRows), 0, stream>>>(part, out, n, d);
  return cudaGetLastError();
}
}  // namespace

}  // namespace ptt
