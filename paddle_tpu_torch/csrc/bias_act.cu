// Bias add + activation epilogue: y = act(x + b[col]), act = relu or the
// exact erf gelu 0.5*z*(1 + erf(z/sqrt(2))), computed in float32.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py fused_bias_act forward
// (_bias_act_fwd_kernel / _bias_act_fwd, the pl.pallas_call at :548).
//
// Bound on the H100: memory.  x is read once and y written once; the
// erf costs a few dozen float operations per element, still far below the
// card's operations-per-byte balance.  At the BERT-base FFN shape
// (R = B*128, D = 3072, bf16) the bound is 2*R*D*2 bytes over 3.35 TB/s.
//
// Design: one grid-stride pass over 16-byte vectors of x (scalars when D
// or the pointers do not allow vectors), so the pre-activation never
// exists in HBM.  The bias row is small and stays in L1/L2.
//
// Backward: dx = g * act'(x + b) and dbias = sum of dx over the rows.
// Replaces _bias_act_bwd / _bias_act_bwd_kernel (the pl.pallas_call at
// :565).  Bound on the H100: memory, x and g read and dx written once; at
// R = 4096, D = 3072, bf16 that is 75.5 MB, 22.5 us at 3.35 TB/s.  The TPU
// kernel adds dbias into one shared block across its in-order grid steps.
// Here each block takes a band of rows and a tile of columns; a thread walks
// its 16-byte column vector down the band, keeping the column sums in
// registers, and writes them to the band's partial row [n_blocks, D]; a
// second kernel adds the partial rows in an order fixed by the shape
// (common.cuh column_sum).  No float atomics, so dbias is bitwise
// repeatable.  Any R and D work.
#include "common.cuh"

namespace {

constexpr int kRelu = 0;
constexpr int kGelu = 1;

__device__ __forceinline__ float activate(float z, int act) {
  if (act == kRelu) return z < 0.f ? 0.f : z;  // NaN stays NaN, as jnp.maximum
  return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
}

template <typename T, int VEC>
__global__ void bias_act_fwd_kernel(const T* __restrict__ x, const float* __restrict__ b,
                                    T* __restrict__ out, int64_t n_vec, int d, int act) {
  using V = ptt::Vec<T, VEC>;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_vec;
       i += step) {
    const V xv = reinterpret_cast<const V*>(x)[i];
    const int col = static_cast<int>((i * VEC) % d);  // d % VEC == 0: one row per vector
    V ov;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      ov.v[k] = ptt::from_f32<T>(activate(ptt::to_f32(xv.v[k]) + b[col + k], act));
    reinterpret_cast<V*>(out)[i] = ov;
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* b, void* out, int64_t rows, int d, int act,
                   cudaStream_t stream) {
  const int64_t n_vec = rows * d / VEC;
  constexpr int kThreads = 256;
  int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 16;  // enough blocks to fill every SM; the loop covers the rest
  if (blocks > cap) blocks = cap;
  bias_act_fwd_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(b), static_cast<T*>(out), n_vec, d,
      act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* b, void* out, int64_t rows, int d, int act,
                     cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (d % kVec == 0 && ptt::aligned16(x) && ptt::aligned16(out))
    return launch<T, kVec>(x, b, out, rows, d, act, stream);
  return launch<T, 1>(x, b, out, rows, d, act, stream);
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// d act(z) / dz: relu's step, or exact gelu's Phi(z) + z * phi(z).
__device__ __forceinline__ float activate_grad(float z, int act) {
  if (act == kRelu) return z > 0.f ? 1.f : 0.f;
  const float phi = expf(-0.5f * z * z) * 0.3989422804014327f;
  return 0.5f * (1.f + erff(z * 0.70710678118654752f)) + z * phi;
}

constexpr int kBwdThreads = 128;

// grid (row blocks, column tiles of kBwdThreads * VEC).  Each thread walks
// its column vector down the block's rows_per_block rows: dx = g * act'(x+b)
// stored in x's dtype, and the float32 column sums of dx written to the
// block's partial row part[blockIdx.x][:].
template <typename T, int VEC>
__global__ void bias_act_bwd_kernel(const T* __restrict__ x, const float* __restrict__ b,
                                    const T* __restrict__ g, T* __restrict__ dx,
                                    float* __restrict__ part, int64_t rows, int d, int act,
                                    int64_t rows_per_block) {
  using V = ptt::Vec<T, VEC>;
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (col >= d) return;  // d % VEC == 0: a vector is wholly in or out
  float bv[VEC], acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    bv[k] = b[col + k];
    acc[k] = 0.f;
  }
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
#pragma unroll 4
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t at = r * d + col;
    const V xv = *reinterpret_cast<const V*>(x + at);
    const V gw = *reinterpret_cast<const V*>(g + at);
    V ov;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float dz = ptt::to_f32(gw.v[k]) * activate_grad(ptt::to_f32(xv.v[k]) + bv[k], act);
      acc[k] += dz;
      ov.v[k] = ptt::from_f32<T>(dz);
    }
    *reinterpret_cast<V*>(dx + at) = ov;
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) part[static_cast<int64_t>(blockIdx.x) * d + col + k] = acc[k];
}

template <typename T, int VEC>
cudaError_t launch_bwd(const void* x, const void* b, const void* g, void* dx, void* part,
                       void* db, int64_t rows, int d, int act, int n_blocks,
                       cudaStream_t stream) {
  const int64_t per = (rows + n_blocks - 1) / n_blocks;
  const dim3 grid(n_blocks, (d + kBwdThreads * VEC - 1) / (kBwdThreads * VEC));
  bias_act_bwd_kernel<T, VEC><<<grid, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(b), static_cast<const T*>(g),
      static_cast<T*>(dx), static_cast<float*>(part), rows, d, act, per);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return ptt::column_sum(static_cast<const float*>(part), static_cast<float*>(db), 1, n_blocks,
                         d, stream);
}

template <typename T>
cudaError_t dispatch_bwd(const void* x, const void* b, const void* g, void* dx, void* part,
                         void* db, int64_t rows, int d, int act, int n_blocks,
                         cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (d % kVec == 0 && ptt::aligned16(x) && ptt::aligned16(g) && ptt::aligned16(dx))
    return launch_bwd<T, kVec>(x, b, g, dx, part, db, rows, d, act, n_blocks, stream);
  return launch_bwd<T, 1>(x, b, g, dx, part, db, rows, d, act, n_blocks, stream);
}

}  // namespace

// x, out: [rows, d] contiguous, dtype `dtype`; b: [d] float32;
// act: 0 relu, 1 gelu.  Launches on `stream`; returns the CUDA error code.
extern "C" int ptt_bias_act_fwd(const void* x, const void* b, void* out, int64_t rows, int d,
                                int act, int dtype, void* stream) {
  if (rows == 0) return 0;
  if (rows < 0 || d <= 0 || (act != kRelu && act != kGelu))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32) return dispatch<float>(x, b, out, rows, d, act, s);
  if (dtype == ptt::kBFloat16) return dispatch<__nv_bfloat16>(x, b, out, rows, d, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward.  x, g, dx: [rows, d] contiguous, dtype `dtype`; b: [d] float32;
// part: [n_blocks, d] float32 scratch, n_blocks the row blocks, each taking
// ceil(rows / n_blocks) rows; db: [d] float32.
extern "C" int ptt_bias_act_bwd(const void* x, const void* b, const void* g, void* dx,
                                void* part, void* db, int64_t rows, int d, int act,
                                int n_blocks, int dtype, void* stream) {
  if (rows <= 0 || d <= 0 || n_blocks <= 0 || n_blocks > rows ||
      (act != kRelu && act != kGelu))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return dispatch_bwd<float>(x, b, g, dx, part, db, rows, d, act, n_blocks, s);
  if (dtype == ptt::kBFloat16)
    return dispatch_bwd<__nv_bfloat16>(x, b, g, dx, part, db, rows, d, act, n_blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
