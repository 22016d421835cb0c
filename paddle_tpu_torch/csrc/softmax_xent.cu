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
// Forward design: a block reads the labels of its rows (one, or two once
// the rows exceed one wave of blocks) and works the labelled ones in turn;
// an ignored row only writes loss 0 and lse 0: none of its logits are read.
// A labelled row keeps its loads in flight while it computes: each thread
// holds kUnroll 16-byte vectors of the row in registers and issues the
// loads of the next kUnroll before it works on these (a row of odd length
// starts off the 16-byte grid: a few scalar elements at its head and its
// tail, see head_len).  Per chunk of kUnroll vectors a thread takes the
// chunk's max first and rescales its running (max m, sum s) once, then adds
// 2^(x*log2e - m*log2e) of every element, one FFMA and one ex2.approx each,
// into four independent partial sums: no branch and no serial chain per
// element.  The labelled logit is
// loaded when the block starts, so its latency hides behind the row.  The
// block combines its threads' pairs in a fixed tree (warp shuffles, then
// the warps' pairs in one warp), so the result is bitwise repeatable.  The
// forward saves lse [R] float32 for the backward, which then needs one pass
// over the row instead of recomputing the max and the sum.  Labels are
// int32 (the JAX package's x32 rule); a label outside [0, V) that is not
// `ignore` picks 0, as the TPU kernel's one-hot does.
//
// Backward design: one block per row.  An ignored row only writes its
// zeros; otherwise the block streams the row with 16-byte loads (the head
// and tail scalar, as above; dx in vectors only where dx's rows share x's
// offset from the 16-byte grid) and writes (exp(x - lse) - onehot) * g.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;     // 16-byte vectors of the row a forward thread holds per step
constexpr int kMinBlocks = 4;  // forward blocks an SM holds at once (<= 64 registers a thread)
constexpr float kLog2e = 1.4426950408889634f;

// Merge (m2, s2) into (m, s), where s sums 2^(x*log2e - m*log2e).  The
// arithmetic is symmetric in the two pairs, so both lanes of a butterfly
// get the same bits.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  const float ml = mn * kLog2e;
  s = s * ptt::exp2_approx(fmaf(m, kLog2e, -ml)) + s2 * ptt::exp2_approx(fmaf(m2, kLog2e, -ml));
  m = mn;
}

// Fold N values (-inf where a slot held no element) into (m, s): the max
// first, one rescale of s, then the exponentials into four partial sums.
template <int N>
__device__ __forceinline__ void absorb(const float (&f)[N], float& m, float& s) {
  static_assert(N >= 2, "a chunk holds two values or more");
  float c[4] = {f[0], f[1], -INFINITY, -INFINITY};
#pragma unroll
  for (int k = 2; k < N; ++k) c[k % 4] = fmaxf(c[k % 4], f[k]);
  const float cm = fmaxf(fmaxf(c[0], c[1]), fmaxf(c[2], c[3]));
  if (cm == -INFINITY) return;  // no element (or only -inf): adds nothing
  const float mn = fmaxf(m, cm);
  const float ml = mn * kLog2e;
  s *= ptt::exp2_approx(fmaf(m, kLog2e, -ml));  // 0 while m is -inf
  m = mn;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < N; ++k) a[k % 4] += ptt::exp2_approx(fmaf(f[k], kLog2e, -ml));
  s += (a[0] + a[1]) + (a[2] + a[3]);
}

// Elements of row `xr` before its first 16-byte boundary.
template <typename T>
__device__ __forceinline__ int head_len(const T* xr, int v) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(xr) & 15u);
  const int h = mis == 0 ? 0 : (16 - mis) / static_cast<int>(sizeof(T));
  return h < v ? h : v;
}

// Vectors (q*kUnroll + k)*kThreads + threadIdx.x of the row body, k < kUnroll;
// -inf past the body's n_vec vectors (no load).
template <typename T, int VEC>
__device__ __forceinline__ void load_step(ptt::Vec<T, VEC> (&dst)[kUnroll],
                                          const ptt::Vec<T, VEC>* body, int n_vec, int q) {
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int i = (q * kUnroll + k) * kThreads + static_cast<int>(threadIdx.x);
    if (i < n_vec) {
      dst[k] = body[i];
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[k].v[e] = ptt::from_f32<T>(-INFINITY);
    }
  }
}

// One labelled row: (loss, lse) of row `xr`, written by thread 0.  Every
// thread of the block calls it (it synchronises the block).
template <typename T>
__device__ __forceinline__ void xent_row(const T* __restrict__ xr, int lab, int v,
                                         float* __restrict__ loss, float* __restrict__ lse_out,
                                         float (&sm)[kThreads / 32], float (&ss)[kThreads / 32]) {
  constexpr int VEC = 16 / sizeof(T);
  using Vt = ptt::Vec<T, VEC>;
  const int tid = threadIdx.x;
  // the labelled logit, in flight while the row streams
  const float picked = (tid == 0 && lab >= 0 && lab < v) ? ptt::to_f32(xr[lab]) : 0.f;
  const int head = head_len(xr, v);
  const int n_vec = (v - head) / VEC;
  const int tail0 = head + n_vec * VEC;  // fewer than VEC elements from here on
  const Vt* body = reinterpret_cast<const Vt*>(xr + head);
  const int n_steps = (n_vec + kThreads * kUnroll - 1) / (kThreads * kUnroll);

  float m = -INFINITY, s = 0.f;
  Vt cur[kUnroll];
  load_step(cur, body, n_vec, 0);
  {  // the scalar head and tail: at most VEC - 1 elements each
    const float ends[2] = {tid < head ? ptt::to_f32(xr[tid]) : -INFINITY,
                           tail0 + tid < v ? ptt::to_f32(xr[tail0 + tid]) : -INFINITY};
    absorb(ends, m, s);
  }
  for (int q = 0; q < n_steps; ++q) {
    Vt nxt[kUnroll];
    load_step(nxt, body, n_vec, q + 1);  // in flight while this step computes
    float f[kUnroll * VEC];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      float e[VEC];
      ptt::unpack(cur[k], e);
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[k * VEC + j] = e[j];
    }
    absorb(f, m, s);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) cur[k] = nxt[k];
  }

  // warp tree, then the warps' pairs in one warp, each in a fixed order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
  }
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? sm[lane] : -INFINITY;
    s = lane < kThreads / 32 ? ss[lane] : 0.f;
#pragma unroll
    for (int o = kThreads / 64; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
      merge(m, s, m2, s2);
    }
    if (lane == 0) {
      const float lse = m + logf(s);
      *loss = lse - picked;
      *lse_out = lse;
    }
  }
  __syncthreads();  // sm and ss are free for the block's next row
}

// Rows RPB * blockIdx.x + r, r < RPB: their labels are read first, then
// each labelled row in turn by the whole block.
template <typename T, int RPB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    softmax_xent_fwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                            float* __restrict__ loss, float* __restrict__ lse_out, int64_t rows,
                            int v, int ignore) {
  __shared__ float sm[kThreads / 32], ss[kThreads / 32];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * RPB;
  int lab[RPB];
#pragma unroll
  for (int r = 0; r < RPB; ++r) lab[r] = row0 + r < rows ? labels[row0 + r] : ignore;
#pragma unroll
  for (int r = 0; r < RPB; ++r) {
    const int64_t row = row0 + r;
    if (row >= rows) break;
    if (lab[r] == ignore) {
      if (threadIdx.x == 0) {
        loss[row] = 0.f;
        lse_out[row] = 0.f;
      }
      continue;
    }
    xent_row(x + row * v, lab[r], v, loss + row, lse_out + row, sm, ss);
  }
}

// Blocks of the forward that the card holds at once (one wave).
template <typename T>
int64_t fwd_wave_blocks() {
  static const int64_t n = [] {
    int k = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, softmax_xent_fwd_kernel<T, 1>,
                                                      kThreads, 0) != cudaSuccess ||
        k < 1)
      k = 1;
    return static_cast<int64_t>(k) * ptt::sm_count();
  }();
  return n;
}

// One block a row while the rows fit one wave; past it, two rows a block:
// with MLM labels most rows are ignored, and a block that only reads a
// label and leaves costs a launch slot that labelled rows wait behind (4
// rows a block measured slower).  The choice depends on the shape alone.
template <typename T>
cudaError_t launch_fwd(const void* x, const void* labels, void* loss, void* lse, int64_t rows,
                       int v, int ignore, cudaStream_t stream) {
  const auto* xt = static_cast<const T*>(x);
  const auto* lab = static_cast<const int*>(labels);
  auto* lo = static_cast<float*>(loss);
  auto* ls = static_cast<float*>(lse);
  if (rows <= fwd_wave_blocks<T>())
    softmax_xent_fwd_kernel<T, 1><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
        xt, lab, lo, ls, rows, v, ignore);
  else
    softmax_xent_fwd_kernel<T, 2><<<static_cast<unsigned>((rows + 1) / 2), kThreads, 0, stream>>>(
        xt, lab, lo, ls, rows, v, ignore);
  return cudaGetLastError();
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
  if (dtype == ptt::kFloat32)
    return static_cast<int>(launch_fwd<float>(x, labels, loss, lse, rows, v, ignore, s));
  if (dtype == ptt::kBFloat16)
    return static_cast<int>(launch_fwd<__nv_bfloat16>(x, labels, loss, lse, rows, v, ignore, s));
  if (dtype == ptt::kFloat16)
    return static_cast<int>(launch_fwd<__half>(x, labels, loss, lse, rows, v, ignore, s));
  return static_cast<int>(cudaErrorInvalidValue);
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
  else if (dtype == ptt::kFloat16)
    softmax_xent_bwd_kernel<__half><<<grid, kThreads, 0, s>>>(
        static_cast<const __half*>(x), static_cast<const int*>(labels),
        static_cast<const float*>(lse), static_cast<const float*>(g), static_cast<__half*>(dx), v,
        ignore, vec);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
