// LayerNorm over the last axis with an optional fused residual add:
//   y = LN(x + res) * scale + bias, statistics in float32.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py fused_ln_residual forward
// (_ln_fwd_kernel / _ln_call, the pl.pallas_call at :170).
//
// Bound on the H100: memory.  Per element it reads x (and res) once and
// writes y once, against ~10 float operations, far below the ~295
// operations per byte where the card stops being limited by HBM.  At the
// BERT-base serving shape (R = B*128, D = 768, bf16, with residual) the
// bound is 3*R*D*2 bytes over 3.35 TB/s.
//
// Design: one row is held in registers by one warp (D <= 1024 in bf16) or
// by 2..32 warps of one block (wider rows), loaded with 16-byte vector
// loads when D and the pointers allow it.  The row is read from HBM once;
// the mean, then the variance of the centred values (the TPU kernel's
// two-pass formula, not E[x^2] - mean^2) and the affine output are
// computed from the registers.  Rows are independent, so any R works and
// the ragged end of D is masked; the TPU kernel's divisor rule for its row
// slabs (_pick_slab) was a VMEM constraint and has no counterpart here.
//
// Backward: dx (which is also dres), dscale and dbias from x, res, scale and
// the output gradient g.  Replaces _ln_bwd / _ln_bwd_kernel (the
// pl.pallas_call at :200).  Bound on the H100: memory, 4*R*D elements moved
// (x, res, g read, dx written) against ~20 float operations each; at the
// BERT-base training shape (R = 4096, D = 768, bf16) 25.2 MB, 7.5 us at
// 3.35 TB/s.  The TPU kernel adds dscale/dbias into one shared block across
// its grid steps, which is right only because a TPU grid runs in order.
// Here one warp takes one row at a time (the statistics recomputed in
// float32 from registers, as _ln_bwd_kernel does), each lane keeps its
// columns' dscale/dbias in registers across the rows it visits, the block
// adds its warps' sums in warp order into a partial row [n_blocks, D], and a
// second kernel adds the partial rows in an order fixed by the shape
// (common.cuh column_sum).  No float atomics: the gradients are bitwise
// repeatable.  The register tile limits D to 1024.
#include "common.cuh"

namespace {

constexpr int kMaxChunks = 4;  // vectors a thread holds for one row

// Sum of `v` over the threads of one row (blockDim.x threads, one y index).
__device__ __forceinline__ float row_sum(float v, float* red, int wpr, int warp, int lane) {
  v = ptt::warp_sum(v);
  if (wpr == 1) return v;  // uniform across the block
  float* r = red + threadIdx.y * wpr;
  __syncthreads();  // earlier readers of `red` are done
  if (lane == 0) r[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < wpr; ++w) t += r[w];
  return t;
}

template <typename T, int VEC>
__global__ void ln_residual_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ bias, T* __restrict__ out,
                                       int64_t rows, int d, float eps) {
  extern __shared__ float red[];  // [blockDim.y][warps per row]
  const int wpr = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  const bool active = row < rows;  // no early return: row_sum synchronises the block
  const int64_t base = row * d;
  const int stride = blockDim.x * VEC;
  using V = ptt::Vec<T, VEC>;

  float v[kMaxChunks][VEC];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int col = c * stride + threadIdx.x * VEC;
    if (active && col < d) {
      const V xv = *reinterpret_cast<const V*>(x + base + col);
      if (res != nullptr) {
        const V rv = *reinterpret_cast<const V*>(res + base + col);
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[c][i] = ptt::to_f32(xv.v[i]) + ptt::to_f32(rv.v[i]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[c][i] = ptt::to_f32(xv.v[i]);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) sum += v[c][i];
    }
  }
  const float mean = row_sum(sum, red, wpr, warp, lane) / static_cast<float>(d);

  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int col = c * stride + threadIdx.x * VEC;
    if (active && col < d) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[c][i] -= mean;
        sq += v[c][i] * v[c][i];
      }
    }
  }
  const float var = row_sum(sq, red, wpr, warp, lane) / static_cast<float>(d);
  const float inv = rsqrtf(var + eps);

#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int col = c * stride + threadIdx.x * VEC;
    if (active && col < d) {
      V ov;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        ov.v[i] = ptt::from_f32<T>(v[c][i] * inv * scale[col + i] + bias[col + i]);
      *reinterpret_cast<V*>(out + base + col) = ov;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* res, const void* scale, const void* bias,
                   void* out, int64_t rows, int d, float eps, cudaStream_t stream) {
  int wpr = 1;  // warps per row: the fewest that hold the row in kMaxChunks vectors each
  while (wpr * 32 * VEC * kMaxChunks < d) wpr *= 2;
  if (wpr > 32) return cudaErrorInvalidValue;
  const int rpb = wpr >= 4 ? 1 : 4 / wpr;  // rows per block: 128 threads at least
  const dim3 block(32 * wpr, rpb);
  const int64_t blocks = (rows + rpb - 1) / rpb;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * rpb * wpr;
  ln_residual_fwd_kernel<T, VEC><<<static_cast<unsigned>(blocks), block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(out), rows, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* res, const void* scale, const void* bias,
                     void* out, int64_t rows, int d, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 && ptt::aligned16(x) && ptt::aligned16(out) &&
                   (res == nullptr || ptt::aligned16(res));
  if (vec) return launch<T, kVec>(x, res, scale, bias, out, rows, d, eps, stream);
  return launch<T, 1>(x, res, scale, bias, out, rows, d, eps, stream);
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

constexpr int kBwdWarps = 8;  // rows in flight per block, one per warp

// Sum the per-lane column accumulators of the block's warps, in warp order,
// through shared memory `red` [warps][d], into out[0:d].
template <int VEC, int E>
__device__ __forceinline__ void block_partial(const float (&acc)[E], float* red, float* out,
                                              int d, int lane, int warp, int warps) {
#pragma unroll
  for (int c = 0; c < E / VEC; ++c) {
    const int col = c * 32 * VEC + lane * VEC;
    if (col < d) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) red[warp * d + col + i] = acc[c * VEC + i];
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    float t = 0.f;
    for (int w = 0; w < warps; ++w) t += red[w * d + col];
    out[col] = t;
  }
  __syncthreads();
}

// One warp per row.  Lane `lane` owns the columns c*32*VEC + lane*VEC + i
// (c < E/VEC, i < VEC) of every row it visits, so it can keep its share of
// dscale and dbias in registers across rows.  E >= ceil(d / 32): d <= 32*E.
template <typename T, int VEC, int E>
__global__ void ln_residual_bwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                                       const float* __restrict__ scale,
                                       const T* __restrict__ g, T* __restrict__ dx,
                                       float* __restrict__ part, int64_t rows, int d,
                                       float eps) {
  extern __shared__ float red[];  // [warps][d]
  constexpr int C = E / VEC;
  using V = ptt::Vec<T, VEC>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const float inv_d = 1.f / static_cast<float>(d);

  float ds[E], db[E];
#pragma unroll
  for (int k = 0; k < E; ++k) ds[k] = db[k] = 0.f;

  for (int64_t row = static_cast<int64_t>(blockIdx.x) * warps + warp; row < rows;
       row += static_cast<int64_t>(gridDim.x) * warps) {
    const int64_t base = row * d;
    float v[E], gv[E];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = c * 32 * VEC + lane * VEC;
      if (col < d) {
        const V xv = *reinterpret_cast<const V*>(x + base + col);
        const V gw = *reinterpret_cast<const V*>(g + base + col);
        V rv;
        if (res != nullptr) rv = *reinterpret_cast<const V*>(res + base + col);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float t = ptt::to_f32(xv.v[i]);
          if (res != nullptr) t += ptt::to_f32(rv.v[i]);
          v[c * VEC + i] = t;
          gv[c * VEC + i] = ptt::to_f32(gw.v[i]);
          sum += t;
        }
      }
    }
    const float mean = ptt::warp_sum(sum) * inv_d;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c * 32 * VEC + lane * VEC < d) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float t = v[c * VEC + i] - mean;
          v[c * VEC + i] = t;
          sq += t * t;
        }
      }
    }
    const float inv = rsqrtf(ptt::warp_sum(sq) * inv_d + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = c * 32 * VEC + lane * VEC;
      if (col < d) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int k = c * VEC + i;
          const float xhat = v[k] * inv;
          const float gs = gv[k] * scale[col + i];
          v[k] = xhat;
          s1 += gs;
          s2 += gs * xhat;
          ds[k] += gv[k] * xhat;
          db[k] += gv[k];
        }
      }
    }
    const float m1 = ptt::warp_sum(s1) * inv_d;
    const float m2 = ptt::warp_sum(s2) * inv_d;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = c * 32 * VEC + lane * VEC;
      if (col < d) {
        V ov;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int k = c * VEC + i;
          ov.v[i] = ptt::from_f32<T>(inv * (gv[k] * scale[col + i] - m1 - v[k] * m2));
        }
        *reinterpret_cast<V*>(dx + base + col) = ov;
      }
    }
  }

  // This block's dscale / dbias partials: part[0][block][:] and
  // part[1][block][:], the warps' register sums added in warp order.
  block_partial<VEC, E>(ds, red, part + static_cast<int64_t>(blockIdx.x) * d, d, lane, warp,
                        warps);
  block_partial<VEC, E>(db, red, part + (static_cast<int64_t>(gridDim.x) + blockIdx.x) * d, d,
                        lane, warp, warps);
}

template <typename T, int VEC, int E>
cudaError_t launch_bwd(const void* x, const void* res, const void* scale, const void* g,
                       void* dx, void* part, void* dsdb, int64_t rows, int d, float eps,
                       int n_blocks, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kBwdWarps * d;
  ln_residual_bwd_kernel<T, VEC, E><<<n_blocks, 32 * kBwdWarps, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const float*>(scale),
      static_cast<const T*>(g), static_cast<T*>(dx), static_cast<float*>(part), rows, d, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return ptt::column_sum(static_cast<const float*>(part), static_cast<float*>(dsdb), 2,
                         n_blocks, d, stream);
}

template <typename T, int VEC>
cudaError_t dispatch_bwd_e(const void* x, const void* res, const void* scale, const void* g,
                           void* dx, void* part, void* dsdb, int64_t rows, int d, float eps,
                           int n_blocks, cudaStream_t stream) {
  // the fewest registers per lane that cover d: E elements per lane, E a
  // multiple of 8 (and so of VEC)
  const int need = (d + 31) / 32;
#define PTT_LN_BWD_E(EE)                                                                  \
  if (need <= EE)                                                                         \
    return launch_bwd<T, VEC, EE>(x, res, scale, g, dx, part, dsdb, rows, d, eps, n_blocks, \
                                  stream);
  PTT_LN_BWD_E(8)
  PTT_LN_BWD_E(16)
  PTT_LN_BWD_E(24)
  PTT_LN_BWD_E(32)
#undef PTT_LN_BWD_E
  return cudaErrorInvalidValue;  // d > 1024: refused by the wrapper first
}

template <typename T>
cudaError_t dispatch_bwd(const void* x, const void* res, const void* scale, const void* g,
                         void* dx, void* part, void* dsdb, int64_t rows, int d, float eps,
                         int n_blocks, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 && ptt::aligned16(x) && ptt::aligned16(g) &&
                   ptt::aligned16(dx) && (res == nullptr || ptt::aligned16(res));
  if (vec)
    return dispatch_bwd_e<T, kVec>(x, res, scale, g, dx, part, dsdb, rows, d, eps, n_blocks,
                                   stream);
  return dispatch_bwd_e<T, 1>(x, res, scale, g, dx, part, dsdb, rows, d, eps, n_blocks, stream);
}

}  // namespace

// x, res, out: [rows, d] contiguous, dtype `dtype`; res may be null.
// scale, bias: [d] float32.  Launches on `stream`; returns the CUDA error code.
extern "C" int ptt_ln_residual_fwd(const void* x, const void* res, const void* scale,
                                   const void* bias, void* out, int64_t rows, int d, float eps,
                                   int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return rows == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32) return dispatch<float>(x, res, scale, bias, out, rows, d, eps, s);
  if (dtype == ptt::kBFloat16)
    return dispatch<__nv_bfloat16>(x, res, scale, bias, out, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward.  x, res, g, dx: [rows, d] contiguous, dtype `dtype`; res may be
// null; scale: [d] float32; part: [2, n_blocks, d] float32 scratch;
// dsdb: [2, d] float32, dscale then dbias.  d <= 1024.
extern "C" int ptt_ln_residual_bwd(const void* x, const void* res, const void* scale,
                                   const void* g, void* dx, void* part, void* dsdb,
                                   int64_t rows, int d, float eps, int n_blocks, int dtype,
                                   void* stream) {
  if (rows < 0 || d <= 0 || d > 1024 || n_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return dispatch_bwd<float>(x, res, scale, g, dx, part, dsdb, rows, d, eps, n_blocks, s);
  if (dtype == ptt::kBFloat16)
    return dispatch_bwd<__nv_bfloat16>(x, res, scale, g, dx, part, dsdb, rows, d, eps,
                                       n_blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
