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
// loads when D and the pointers allow it; a block holds 4 warps.  The row
// is read from HBM once; the mean, then the variance of the centred values
// (the TPU kernel's two-pass formula, not E[x^2] - mean^2) and the affine
// output are computed from the registers in float32.  Scale and bias are
// read 16 bytes at a time beside the row's chunk: read as scalars, each
// warp-wide load touched 8 cache lines, 4.8 of the kernel's 10.4 us at
// [4096, 768] bf16 (NVIDIA H100 80GB HBM3, 700 W; PERF.md,
// tools/port_rowwise_ab.py).  A persistent grid that staged a warp's next
// rows by cp.async was tried and gained too little over this to keep.
// Rows are independent, so any R works and the ragged end of D is masked;
// D % VEC != 0 or pointers off the 16-byte grid take the scalar route.  The
// TPU kernel's divisor rule for its row slabs (_pick_slab) was a VMEM
// constraint and has no counterpart here.
//
// Backward: dx (which is also dres), dscale and dbias from x, res, scale and
// the output gradient g.  Replaces _ln_bwd / _ln_bwd_kernel (the
// pl.pallas_call at :200).  Bound on the H100: memory, 4*R*D elements moved
// (x, res, g read, dx written) against ~20 float operations each; at the
// BERT-base training shape (R = 4096, D = 768, bf16) 25.2 MB, 7.5 us at
// 3.35 TB/s.  The TPU kernel adds dscale/dbias into one shared block across
// its grid steps, which is right only because a TPU grid runs in order.
// Here two launches, and no memset (the second writes every output):
//   - the row kernel: blocks of 4 warps, one wave of the card (at most 3
//     blocks an SM); a warp takes one row at a time, recomputing the
//     statistics in float32 as _ln_bwd_kernel does.  A lane owns the same
//     columns of every row, so its share of dscale/dbias stays in
//     registers across rows; the scale row sits in shared memory.  Each
//     lane copies its own 16-byte pieces of the warp's next two rows into
//     shared memory by cp.async and reads back only those, so the next
//     rows' loads fly through this row's three rounds of warp reductions
//     with no barrier, and registers hold one row of floats (prefetched
//     into registers instead, the rows spilled).  The block adds its warps'
//     sums in warp order through shared memory into a partial row
//     [n_blocks, D] of each;
//   - the column pass adds the partial rows in an order fixed by the shape,
//     eight independent loads in flight a thread.
// No float atomics: the gradients are bitwise repeatable.  The register
// tile limits D to 1024.
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

// VEC floats, 16 bytes at a time where VEC allows (src then 16-byte aligned).
template <int VEC>
__device__ __forceinline__ void load_f32(float (&dst)[VEC], const float* src) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(src)[q];
      dst[4 * q] = t.x;
      dst[4 * q + 1] = t.y;
      dst[4 * q + 2] = t.z;
      dst[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = src[i];
  }
}

// One row is held in registers by one warp (d <= 1024 in bf16) or by
// wpr = 2..32 warps of one block, which add their sums through shared
// memory; blockDim.y rows a block.
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
      float sc[VEC], bi[VEC];
      load_f32<VEC>(sc, scale + col);
      load_f32<VEC>(bi, bias + col);
      V ov;
#pragma unroll
      for (int i = 0; i < VEC; ++i) ov.v[i] = ptt::from_f32<T>(v[c][i] * inv * sc[i] + bi[i]);
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
                   (res == nullptr || ptt::aligned16(res)) && ptt::aligned16(scale) &&
                   ptt::aligned16(bias);
  if (vec) return launch<T, kVec>(x, res, scale, bias, out, rows, d, eps, stream);
  return launch<T, 1>(x, res, scale, bias, out, rows, d, eps, stream);
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

constexpr int kBwdWarps = 4;   // warps of a row-kernel block, one row each at a time
constexpr int kBwdStages = 2;  // rows a warp has in flight ahead of the one it computes

// Row-kernel blocks an SM that the launch bounds ask for: 3 (at most 170
// registers a thread) where a lane's columns fit, bf16 to d = 768, else 2.
constexpr int bwd_min_blocks(int elem_bytes, int e) { return elem_bytes == 2 && e <= 24 ? 3 : 2; }

// Dynamic shared memory of the row kernel: the scale row, then the warps'
// row stages (16-byte pieces only), which the block's dscale/dbias sums
// [2][kBwdWarps][d] reuse at the end.
template <typename T, int VEC>
size_t bwd_smem(int d) {
  const size_t ring = VEC * sizeof(T) == 16 ? sizeof(T) * kBwdWarps * kBwdStages * 3 * d : 0;
  const size_t red = sizeof(float) * 2 * kBwdWarps * d;
  return sizeof(float) * d + (ring > red ? ring : red);
}

// One warp per row at a time.  Lane `lane` owns the columns c*32*VEC +
// lane*VEC + i (c < E/VEC, i < VEC) of every row it visits, so it keeps its
// share of dscale and dbias in registers across rows.  With 16-byte pieces
// (VEC * sizeof(T) == 16) each lane copies its own pieces of the warp's
// next kBwdStages rows (x, res, g) into the warp's stages of shared memory
// by cp.async and reads back only what it copied, so no barrier is needed
// and those rows' loads fly while the warp computes this one; registers
// hold only this row's floats.  Other shapes read device memory directly.
// E >= ceil(d / 32): d <= 32*E.
template <typename T, int VEC, int E>
__global__ void __launch_bounds__(32 * kBwdWarps, bwd_min_blocks(sizeof(T), E))
    ln_residual_bwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                           const float* __restrict__ scale, const T* __restrict__ g,
                           T* __restrict__ dx, float* __restrict__ part, int64_t rows, int d,
                           float eps) {
  constexpr int C = E / VEC;
  constexpr bool kStaged = VEC * sizeof(T) == 16;
  using V = ptt::Vec<T, VEC>;
  // the scale row, then the warps' stages [kBwdWarps][kBwdStages][x, res, g][d]
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* stages = reinterpret_cast<T*>(smem + d) + static_cast<int64_t>(warp) * kBwdStages * 3 * d;
  const float inv_d = 1.f / static_cast<float>(d);
  const auto col_of = [lane](int c) { return c * 32 * VEC + lane * VEC; };

  for (int i = threadIdx.x; i < d; i += blockDim.x) sc[i] = scale[i];
  __syncthreads();
  float ds[E], db[E];
#pragma unroll
  for (int k = 0; k < E; ++k) ds[k] = db[k] = 0.f;

  const int64_t stride = static_cast<int64_t>(gridDim.x) * kBwdWarps;
  int64_t row = static_cast<int64_t>(blockIdx.x) * kBwdWarps + warp;
  // copy this lane's pieces of row `r` into stage `st`; one group, maybe empty
  const auto stage_row = [&](int64_t r, int st) {
    T* b = stages + st * 3 * d;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = col_of(c);
      if (r < rows && col < d) {
        const int64_t at = r * d + col;
        ptt::cp_async_16(b + col, x + at, true);
        if (res != nullptr) ptt::cp_async_16(b + d + col, res + at, true);
        ptt::cp_async_16(b + 2 * d + col, g + at, true);
      }
    }
    ptt::cp_async_commit();
  };
  if constexpr (kStaged) {
#pragma unroll
    for (int st = 0; st < kBwdStages; ++st) stage_row(row + st * stride, st);
  }
  for (int it = 0; row < rows; ++it, row += stride) {
    const T *xs = x + row * d, *rs = res == nullptr ? nullptr : res + row * d, *gs = g + row * d;
    if constexpr (kStaged) {
      ptt::cp_async_wait<kBwdStages - 1>();  // this lane's pieces of `row` landed
      xs = stages + (it % kBwdStages) * 3 * d;
      rs = xs + d;
      gs = xs + 2 * d;
    }
    float v[E];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = col_of(c);
      if (col < d) {
        const V xv = *reinterpret_cast<const V*>(xs + col);
        V rv;
        if (res != nullptr) rv = *reinterpret_cast<const V*>(rs + col);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float t = ptt::to_f32(xv.v[i]);
          if (res != nullptr) t += ptt::to_f32(rv.v[i]);
          v[c * VEC + i] = t;
          sum += t;
        }
      }
    }
    const float mean = ptt::warp_sum(sum) * inv_d;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (col_of(c) < d) {
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
      const int col = col_of(c);
      if (col < d) {
        const V gw = *reinterpret_cast<const V*>(gs + col);
        float scv[VEC];
        load_f32<VEC>(scv, sc + col);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int k = c * VEC + i;
          const float gk = ptt::to_f32(gw.v[i]);
          const float xhat = v[k] * inv;
          const float gsk = gk * scv[i];
          v[k] = xhat;
          s1 += gsk;
          s2 += gsk * xhat;
          ds[k] += gk * xhat;
          db[k] += gk;
        }
      }
    }
    // the two sums share their shuffle rounds
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float m1 = s1 * inv_d, m2 = s2 * inv_d;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = col_of(c);
      if (col < d) {
        const V gw = *reinterpret_cast<const V*>(gs + col);
        float scv[VEC];
        load_f32<VEC>(scv, sc + col);
        V ov;
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          ov.v[i] = ptt::from_f32<T>(inv * (ptt::to_f32(gw.v[i]) * scv[i] - m1 - v[c * VEC + i] * m2));
        *reinterpret_cast<V*>(dx + row * d + col) = ov;
      }
    }
    if constexpr (kStaged) stage_row(row + kBwdStages * stride, it % kBwdStages);
  }

  // This block's dscale / dbias partials, part[0][block][:] and
  // part[1][block][:]: the warps' register sums added in warp order,
  // through the shared memory of the stages (no copy is left in flight)
  ptt::cp_async_wait<0>();
  __syncthreads();
  float* red = smem + d;  // [2][kBwdWarps][d]
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (col_of(c) < d) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        red[warp * d + col_of(c) + i] = ds[c * VEC + i];
        red[(kBwdWarps + warp) * d + col_of(c) + i] = db[c * VEC + i];
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * d; j += blockDim.x) {
    const int k = j / d, col = j % d;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) t += red[(k * kBwdWarps + w) * d + col];
    part[(static_cast<int64_t>(k) * gridDim.x + blockIdx.x) * d + col] = t;
  }
}

// The shared-memory attribute of one instantiation, set once, for the
// widest row it takes (d = 32 * E): a launch then makes no runtime call but
// its own, as a CUDA graph's capture wants.
template <typename T, int VEC, int E>
cudaError_t bwd_smem_attribute() {
  static const cudaError_t err = cudaFuncSetAttribute(
      ln_residual_bwd_kernel<T, VEC, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bwd_smem<T, VEC>(32 * E)));
  return err;
}

template <typename T, int VEC, int E>
cudaError_t launch_bwd(const void* x, const void* res, const void* scale, const void* g,
                       void* dx, void* part, void* dsdb, int64_t rows, int d, float eps,
                       int n_blocks, cudaStream_t stream) {
  const size_t smem = bwd_smem<T, VEC>(d);
  cudaError_t err = bwd_smem_attribute<T, VEC, E>();
  if (err != cudaSuccess) return err;
  ln_residual_bwd_kernel<T, VEC, E><<<n_blocks, 32 * kBwdWarps, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const float*>(scale),
      static_cast<const T*>(g), static_cast<T*>(dx), static_cast<float*>(part), rows, d, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return ptt::column_sum(static_cast<const float*>(part), static_cast<float*>(dsdb), 2, n_blocks,
                         d, stream);
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
  if (dtype == ptt::kFloat16) return dispatch<__half>(x, res, scale, bias, out, rows, d, eps, s);
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
  if (dtype == ptt::kFloat16)
    return dispatch_bwd<__half>(x, res, scale, g, dx, part, dsdb, rows, d, eps, n_blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
