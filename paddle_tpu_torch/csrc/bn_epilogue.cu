// Batch-norm epilogue: per-row scale / shift (+ relu) over x:[R, W] with
// float32 per-row multipliers, y = max(x*mul[r] + add[r], 0), computed in
// float32 and rounded once to x's dtype.  Callers flatten NCHW to
// [N*C, H*W] and tile the per-channel vectors N times.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py fused_scale_shift_relu /
// bn_epilogue forward (_epilogue_fwd_kernel / _epilogue_fwd, the
// pl.pallas_call at :271) and backward (_epilogue_bwd_kernel /
// _epilogue_bwd, the pl.pallas_call at :288).
//
// Bound on the H100: memory.  The forward reads x once and writes y once,
// plus 8 bytes a row of multipliers: 2*|x| + 8R bytes over 3.35 TB/s (at
// the ResNet-50 stem, [256*64, 12544] bf16, 823 MB: 0.245 ms).  The
// backward reads x and g and writes dx, plus 16 bytes a row: 3*|x| + 16R.
// A few float operations an element are far below the card's balance.
//
// Forward design: one grid-stride pass over 16-byte vectors of the flat
// array.  Rows are not 16-byte aligned at ResNet-50's widths (W = 12544,
// 3136, 784, 196, 49; a bf16 row of 49 is 98 bytes), so vectors are taken
// over the flat array, which is aligned, and each element of a vector finds
// its row: one division for the vector's first element, then a column
// counter that wraps into the next row.  A scalar tail takes the last
// n % VEC elements; an input or output off the 16-byte grid takes the
// scalar path throughout.  Indices are 32-bit when n < 2^31 (every ResNet-50
// shape at batch 256), 64-bit otherwise.
//
// Backward design: rows are disjoint, so one warp owns a row: it writes
// dx = g*mul*live and reduces dmul = sum(g*live*x), dadd = sum(g*live) in
// float32 registers, lanes strided by 32 over the row, then a butterfly of
// shuffles.  No atomics and no second pass; which lane adds which element is
// fixed by the shape, so the sums repeat bit for bit.  Warps walk the rows
// grid-stride.  One warp a row serves both ends of ResNet-50: 16384 rows of
// 12544 at the stem, 524288 rows of 49 in the last stage.
//
// The relu mask of the backward must be the forward's to the bit: an element
// whose x*mul + add rounds to 0 in one and not the other would take another
// branch.  Both kernels therefore compute x*mul + add as __fmul_rn then
// __fadd_rn, two roundings and never a contracted FMA, as the plain
// versions' float32 `x * mul + add` (two tensor operations) rounds.
#include "common.cuh"

namespace {

__device__ __forceinline__ float scale_shift(float x, float m, float a) {
  return __fadd_rn(__fmul_rn(x, m), a);  // two roundings, never an FMA (see above)
}

__device__ __forceinline__ float relu_f(float y) {
  return y < 0.f ? 0.f : y;  // NaN stays NaN, as jnp.maximum
}

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // enough to fill every SM; the loops cover the rest

// Flat index type I: uint32_t when n < 2^31, else int64_t.
template <typename T, int VEC, typename I>
__global__ void epilogue_fwd_kernel(const T* __restrict__ x, const float* __restrict__ mul,
                                    const float* __restrict__ add, T* __restrict__ out, I n, I w,
                                    int relu) {
  using V = ptt::Vec<T, VEC>;
  const I n_vec = n / VEC;
  const I step = static_cast<I>(gridDim.x) * blockDim.x;
  for (I i = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_vec; i += step) {
    const V xv = reinterpret_cast<const V*>(x)[i];
    I r = (i * VEC) / w;
    I c = i * VEC - r * w;
    float m = mul[r], a = add[r];
    V ov;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (c == w) {  // the vector crosses into the next row
        c = 0;
        ++r;
        m = mul[r];
        a = add[r];
      }
      float y = scale_shift(ptt::to_f32(xv.v[k]), m, a);
      if (relu) y = relu_f(y);
      ov.v[k] = ptt::from_f32<T>(y);
      ++c;
    }
    reinterpret_cast<V*>(out)[i] = ov;
  }
  // scalar tail: the last n % VEC elements, one thread each
  const I j = n_vec * VEC + threadIdx.x;
  if (blockIdx.x == 0 && j < n) {
    const I r = j / w;
    float y = scale_shift(ptt::to_f32(x[j]), mul[r], add[r]);
    if (relu) y = relu_f(y);
    out[j] = ptt::from_f32<T>(y);
  }
}

template <typename T, int VEC, typename I>
cudaError_t launch_fwd(const void* x, const void* mul, const void* add, void* out, int64_t n,
                       int w, int relu, cudaStream_t stream) {
  const int64_t n_vec = n / VEC;
  int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;  // the tail alone
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  epilogue_fwd_kernel<T, VEC, I><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mul), static_cast<const float*>(add),
      static_cast<T*>(out), static_cast<I>(n), static_cast<I>(w), relu);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fwd(const void* x, const void* mul, const void* add, void* out,
                         int64_t rows, int w, int relu, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t n = rows * w;
  const bool vec = ptt::aligned16(x) && ptt::aligned16(out);
  if (n < (int64_t(1) << 31)) {
    if (vec) return launch_fwd<T, kVec, uint32_t>(x, mul, add, out, n, w, relu, stream);
    return launch_fwd<T, 1, uint32_t>(x, mul, add, out, n, w, relu, stream);
  }
  if (vec) return launch_fwd<T, kVec, int64_t>(x, mul, add, out, n, w, relu, stream);
  return launch_fwd<T, 1, int64_t>(x, mul, add, out, n, w, relu, stream);
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

constexpr int kBwdWarps = 8;                // warps (rows in flight) a block
constexpr int kBwdMaxBlocks = 132 * 8;      // 8 blocks of 256 threads fill an SM's 2048

template <typename T>
__global__ void epilogue_bwd_kernel(const T* __restrict__ x, const float* __restrict__ mul,
                                    const float* __restrict__ add, const T* __restrict__ g,
                                    T* __restrict__ dx, float* __restrict__ dmul,
                                    float* __restrict__ dadd, int64_t rows, int w, int relu) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kBwdWarps;
  // r is the same for every lane of a warp, so the shuffles below see all 32
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kBwdWarps + (threadIdx.x >> 5); r < rows;
       r += n_warps) {
    const float m = mul[r], a = add[r];
    const T* xr = x + r * w;
    const T* gr = g + r * w;
    T* dr = dx + r * w;
    float sm = 0.f, sa = 0.f;
#pragma unroll 4
    for (int c = lane; c < w; c += 32) {
      const float xv = ptt::to_f32(xr[c]);
      float gv = ptt::to_f32(gr[c]);
      if (relu && !(scale_shift(xv, m, a) > 0.f)) gv = 0.f;
      dr[c] = ptt::from_f32<T>(__fmul_rn(gv, m));
      sm += gv * xv;
      sa += gv;
    }
    sm = ptt::warp_sum(sm);
    sa = ptt::warp_sum(sa);
    if (lane == 0) {
      dmul[r] = sm;
      dadd[r] = sa;
    }
  }
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* mul, const void* add, const void* g, void* dx,
                       void* dmul, void* dadd, int64_t rows, int w, int relu,
                       cudaStream_t stream) {
  int64_t blocks = (rows + kBwdWarps - 1) / kBwdWarps;
  if (blocks > kBwdMaxBlocks) blocks = kBwdMaxBlocks;
  epilogue_bwd_kernel<T><<<static_cast<unsigned>(blocks), kBwdWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mul), static_cast<const float*>(add),
      static_cast<const T*>(g), static_cast<T*>(dx), static_cast<float*>(dmul),
      static_cast<float*>(dadd), rows, w, relu);
  return cudaGetLastError();
}

}  // namespace

// x, out: [rows, w] contiguous, dtype `dtype`; mul, add: [rows] float32;
// relu: 0 or 1.  Launches on `stream`; returns the CUDA error code.
extern "C" int ptt_bn_epilogue_fwd(const void* x, const void* mul, const void* add, void* out,
                                   int64_t rows, int w, int relu, int dtype, void* stream) {
  if (rows <= 0 || w <= 0 || (relu != 0 && relu != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32) return dispatch_fwd<float>(x, mul, add, out, rows, w, relu, s);
  if (dtype == ptt::kBFloat16)
    return dispatch_fwd<__nv_bfloat16>(x, mul, add, out, rows, w, relu, s);
  if (dtype == ptt::kFloat16) return dispatch_fwd<__half>(x, mul, add, out, rows, w, relu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward.  x, g, dx: [rows, w] contiguous, dtype `dtype`; mul, add, dmul,
// dadd: [rows] float32.
extern "C" int ptt_bn_epilogue_bwd(const void* x, const void* mul, const void* add,
                                   const void* g, void* dx, void* dmul, void* dadd, int64_t rows,
                                   int w, int relu, int dtype, void* stream) {
  if (rows <= 0 || w <= 0 || (relu != 0 && relu != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch_bwd<float>(x, mul, add, g, dx, dmul, dadd, rows, w, relu, s);
  if (dtype == ptt::kBFloat16)
    return launch_bwd<__nv_bfloat16>(x, mul, add, g, dx, dmul, dadd, rows, w, relu, s);
  if (dtype == ptt::kFloat16)
    return launch_bwd<__half>(x, mul, add, g, dx, dmul, dadd, rows, w, relu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
