// Hard-label softmax cross-entropy over the rows of logits [R, V]:
//   forward   loss[r] = lse(x[r]) - x[r, label[r]],   0 where label == ignore;
//   backward  dx[r]   = (softmax(x[r]) - onehot(label[r])) * g[r], 0 rows where ignored.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py fused_softmax_xent, forward
// (_sxe_fwd_kernel / _sxe_fwd, the pl.pallas_call at :444) and backward
// (_sxe_bwd_kernel / _sxe_bwd, the pl.pallas_call at :462).
//
// Bound on the H100: memory.  A row of BERT's vocabulary (V = 30522) is
// 61 KB in bf16 and each element costs a handful of float operations.  The
// forward reads each row that is not ignored once; the backward reads those
// rows once and writes every row of dx once.  With the MLM labels about 85%
// of the rows are ignored, so the bound counts the rows this run's labels
// need: at R = 4096 every row would be 250 MB (forward) and 500 MB
// (backward).
//
// Design: one block per row.  An ignored row returns at once in the forward
// (loss 0) and only writes its zeros in the backward: none of its logits are
// read.  Otherwise the block streams the row with 16-byte loads (a row of
// odd length starts off the 16-byte grid: a few scalar elements first, then
// vectors, then a scalar tail; the backward writes dx in vectors only where
// dx's rows share x's offset from the 16-byte grid), each thread keeping a running max and a sum
// of exponentials rescaled to that max (the online softmax), and the block
// combines the threads' pairs in a fixed tree, so the result is bitwise
// repeatable.  The picked logit is read by its index.  The forward saves
// lse [R] float32 for the backward, which then needs one pass over the row
// instead of recomputing the max and the sum.  Labels are int32 (the JAX
// package's x32 rule); a label outside [0, V) that is not `ignore` picks 0,
// as the TPU kernel's one-hot does.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Add value x to the running (max m, sum s of exp(. - m)).
__device__ __forceinline__ void online_add(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;  // exp(-inf) = 0 on the first element
    m = x;
  } else if (x != -INFINITY) {
    s += expf(x - m);
  }
}

// Merge (m2, s2) into (m, s).
__device__ __forceinline__ void online_merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// Elements of row `xr` before its first 16-byte boundary.
template <typename T>
__device__ __forceinline__ int head_len(const T* xr, int v) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(xr) & 15u);
  const int h = mis == 0 ? 0 : (16 - mis) / static_cast<int>(sizeof(T));
  return h < v ? h : v;
}

template <typename T>
__global__ void softmax_xent_fwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                                        float* __restrict__ loss, float* __restrict__ lse_out,
                                        int v, int ignore) {
  constexpr int VEC = 16 / sizeof(T);
  using Vt = ptt::Vec<T, VEC>;
  __shared__ float sm[32], ss[32];
  const int64_t row = blockIdx.x;
  const int lab = labels[row];
  if (lab == ignore) {
    if (threadIdx.x == 0) {
      loss[row] = 0.f;
      lse_out[row] = 0.f;
    }
    return;
  }
  const T* xr = x + row * v;
  const int head = head_len(xr, v);
  const int n_vec = (v - head) / VEC;
  float m = -INFINITY, s = 0.f;
  for (int j = threadIdx.x; j < head; j += blockDim.x) online_add(m, s, ptt::to_f32(xr[j]));
  const Vt* body = reinterpret_cast<const Vt*>(xr + head);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const Vt xv = body[i];
#pragma unroll
    for (int k = 0; k < VEC; ++k) online_add(m, s, ptt::to_f32(xv.v[k]));
  }
  for (int j = head + n_vec * VEC + threadIdx.x; j < v; j += blockDim.x)
    online_add(m, s, ptt::to_f32(xr[j]));

  // warp tree, then the warps' pairs in warp order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    online_merge(m, s, m2, s2);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float mt = sm[0], st = ss[0];
    for (int w = 1; w < (blockDim.x >> 5); ++w) online_merge(mt, st, sm[w], ss[w]);
    const float lse = mt + logf(st);
    const float picked = (lab >= 0 && lab < v) ? ptt::to_f32(xr[lab]) : 0.f;
    loss[row] = lse - picked;
    lse_out[row] = lse;
  }
}

template <typename T>
__global__ void softmax_xent_bwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ g, T* __restrict__ dx, int v,
                                        int ignore, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  using Vt = ptt::Vec<T, VEC>;
  const int64_t row = blockIdx.x;
  const int lab = labels[row];
  const T* xr = x + row * v;
  T* dr = dx + row * v;
  // with `vec`, dx rows sit on the same 16-byte grid as x rows; without it
  // the whole row is the scalar head
  const int head = vec ? head_len(xr, v) : v;
  const int n_vec = (v - head) / VEC;
  Vt* body = reinterpret_cast<Vt*>(dr + head);
  if (lab == ignore) {
    Vt z;
#pragma unroll
    for (int k = 0; k < VEC; ++k) z.v[k] = ptt::from_f32<T>(0.f);
    for (int j = threadIdx.x; j < head; j += blockDim.x) dr[j] = z.v[0];
    for (int i = threadIdx.x; i < n_vec; i += blockDim.x) body[i] = z;
    for (int j = head + n_vec * VEC + threadIdx.x; j < v; j += blockDim.x) dr[j] = z.v[0];
    return;
  }
  const float l = lse[row], gr = g[row];
  for (int j = threadIdx.x; j < head; j += blockDim.x)
    dr[j] = ptt::from_f32<T>((expf(ptt::to_f32(xr[j]) - l) - (j == lab ? 1.f : 0.f)) * gr);
  const Vt* in = reinterpret_cast<const Vt*>(xr + head);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const Vt xv = in[i];
    const int j0 = head + i * VEC;
    Vt ov;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      ov.v[k] = ptt::from_f32<T>((expf(ptt::to_f32(xv.v[k]) - l) - (j0 + k == lab ? 1.f : 0.f)) * gr);
    body[i] = ov;
  }
  for (int j = head + n_vec * VEC + threadIdx.x; j < v; j += blockDim.x)
    dr[j] = ptt::from_f32<T>((expf(ptt::to_f32(xr[j]) - l) - (j == lab ? 1.f : 0.f)) * gr);
}

}  // namespace

// x: [rows, v] contiguous, dtype `dtype`; labels: [rows] int32;
// loss, lse: [rows] float32.  Launches on `stream`; returns the CUDA error code.
extern "C" int ptt_softmax_xent_fwd(const void* x, const void* labels, void* loss, void* lse,
                                    int64_t rows, int v, int ignore, int dtype, void* stream) {
  if (rows == 0) return 0;
  if (rows < 0 || rows > 0x7fffffff || v <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(rows);
  if (dtype == ptt::kFloat32)
    softmax_xent_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(labels), static_cast<float*>(loss),
        static_cast<float*>(lse), v, ignore);
  else if (dtype == ptt::kBFloat16)
    softmax_xent_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(labels),
        static_cast<float*>(loss), static_cast<float*>(lse), v, ignore);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// x, dx: [rows, v] contiguous, dtype `dtype`; labels: [rows] int32;
// lse (from the forward), g: [rows] float32.  The rows move in 16-byte
// vectors only when x and dx lie equally far off the 16-byte grid (a fresh
// dx is aligned; x may be a view that starts at any element); otherwise
// every element is read and written alone.
extern "C" int ptt_softmax_xent_bwd(const void* x, const void* labels, const void* lse,
                                    const void* g, void* dx, int64_t rows, int v, int ignore,
                                    int dtype, void* stream) {
  if (rows == 0) return 0;
  if (rows < 0 || rows > 0x7fffffff || v <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(rows);
  const bool vec = ((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(dx)) & 15u) == 0;
  if (dtype == ptt::kFloat32)
    softmax_xent_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(labels),
        static_cast<const float*>(lse), static_cast<const float*>(g), static_cast<float*>(dx), v,
        ignore, vec);
  else if (dtype == ptt::kBFloat16)
    softmax_xent_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(labels),
        static_cast<const float*>(lse), static_cast<const float*>(g),
        static_cast<__nv_bfloat16*>(dx), v, ignore, vec);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
