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
// R = 4096, D = 3072, bf16 that is 75.5 MB, 22.5 us at 3.35 TB/s.  The
// instruction issue is close behind: the loop below is 40.4 SASS
// instructions an element (cuobjdump; erff alone ~25: seven coefficient
// selects, seven FMAs, a predicated ex2), so 12.6M elements over 132 SMs x
// 4 schedulers take 17.1 us of issue at 1.755 GHz, and the loads must fly
// while the math runs or the two add up (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md, tools/port_rowwise_ab.py --sass).  The TPU kernel adds dbias into
// one shared block across its in-order grid steps.
// Here two launches and no memset:
//   - the row kernel: a persistent grid of one wave (blocks of 16 warps,
//     2 an SM: 32 warps; 64 registers at bf16 gelu, 0 spilled).  A block
//     takes a band of rows and a tile of 1024 columns (bf16); its four row
//     groups of four warps walk every fourth row of the band, a lane one
//     16-byte column vector, keeping that vector's dbias sums in
//     registers.  Each lane copies its own pieces of x and g of its
//     group's rows into a ring of three rows in shared memory by cp.async
//     and reads back only those (no barrier), so the next two rows' bytes
//     are in flight while it computes one.
//     phi(z) is one ex2.approx of a pre-scaled argument, Phi(z) one FMA
//     around erff (kept: the exact-erf contract), bf16 pairs convert with
//     the packed intrinsics.  The groups add their sums in group order
//     through shared memory into the band's partial row [bands, D]; fewer
//     bands than blocks of one row group keep the second pass short.  (A
//     ring of TMA bulk copies, one elected lane and one mbarrier a stage,
//     was tried and was not faster);
//   - the column pass (common.cuh column_sum) adds the partial rows in an
//     order fixed by the shape.
// No float atomics, so dbias is bitwise repeatable.  Any R and D: D % VEC
// != 0 or pointers off the 16-byte grid take the scalar route, which reads
// device memory directly.
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

// d act(z) / dz: relu's step, or exact gelu's Phi(z) + z * phi(z), with
// phi(z) = exp(-z^2 / 2) / sqrt(2 pi) as one exp2 of a pre-scaled argument.
template <int ACT>
__device__ __forceinline__ float activate_grad(float z) {
  if constexpr (ACT == kRelu) {
    return z > 0.f ? 1.f : 0.f;
  } else {
    const float e = ptt::exp2_approx(z * z * -0.72134752044448170f);  // -log2(e) / 2
    const float cdf = fmaf(0.5f, erff(z * 0.70710678118654752f), 0.5f);
    return fmaf(z * 0.3989422804014327f, e, cdf);
  }
}

constexpr int kBwdWarps = 4;                          // warps across a column tile
constexpr int kBwdTile = 32 * kBwdWarps;              // lanes across a column tile
constexpr int kBwdGroups = 4;                         // row groups of a block
constexpr int kBwdThreads = kBwdTile * kBwdGroups;    // threads of a block
constexpr int kBwdStages = 3;     // rows in a lane's ring: two in flight while it computes one
constexpr int kBwdMinBlocks = 2;  // at most 64 registers: 32 warps an SM or more

// Dynamic shared memory of a block: the lanes' rings [kBwdStages][x, g]
// [kBwdThreads * VEC] (16-byte pieces only), then the column sums of row
// groups 1.. [kBwdGroups - 1][kBwdTile * VEC] floats.
template <typename T, int VEC>
__host__ __device__ constexpr size_t bwd_ring_bytes() {
  return VEC * sizeof(T) == 16 ? kBwdStages * 2 * kBwdThreads * VEC * sizeof(T) : 0;
}
template <typename T, int VEC>
constexpr size_t bwd_smem() {
  return bwd_ring_bytes<T, VEC>() + (kBwdGroups - 1) * kBwdTile * VEC * sizeof(float);
}

// grid (bands of rows_per_band rows, column tiles of kBwdTile * VEC).  Lane
// t % kBwdTile of row group t / kBwdTile owns one column vector of the tile
// and walks it down the group's rows of the band (every kBwdGroups-th):
// dx = g * act'(x + b) stored in x's dtype, and the float32 column sums of
// dx kept in registers.  With 16-byte pieces each lane copies its own
// pieces of x and g of the group's next rows into its slots of the ring by
// cp.async, one group of copies a row, and reads back only those: no
// barrier, and nothing of them passes through registers before it is used.
// At the end the groups' sums are added in group order through shared
// memory into the band's partial row part[band][:].
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
    bias_act_bwd_kernel(const T* __restrict__ x, const float* __restrict__ b,
                        const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
                        int64_t rows, int d, int64_t rows_per_band) {
  using V = ptt::Vec<T, VEC>;
  constexpr bool kStaged = VEC * sizeof(T) == 16;
  constexpr int kSlot = kBwdThreads * VEC;  // elements of one slot of the ring
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem) + threadIdx.x * VEC;  // this lane's piece of slot 0
  const int lane = threadIdx.x & 31;
  const int tl = threadIdx.x % kBwdTile;   // lane across the tile
  const int group = threadIdx.x / kBwdTile;
  const int col = (blockIdx.y * kBwdTile + tl) * VEC;
  const bool warp_live = col - lane * VEC < d;  // some lane of the warp has columns
  const bool live = col < d;                    // d % VEC == 0: a vector is wholly in or out
  float bv[VEC], acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    bv[k] = live ? b[col + k] : 0.f;
    acc[k] = 0.f;
  }
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_band;
  const int64_t r1 = r0 + rows_per_band < rows ? r0 + rows_per_band : rows;
  const int64_t first = r0 + group;  // this group's rows: first, first + kBwdGroups, ...
  constexpr int64_t kStep = kBwdGroups;
  // copy this lane's pieces of x and g at `at` into stage `s`; one group, maybe empty
  const auto stage = [&](int64_t at, bool valid, int s) {
    if (valid) {
      ptt::cp_async_16(ring + 2 * s * kSlot, x + at, true);
      ptt::cp_async_16(ring + (2 * s + 1) * kSlot, g + at, true);
    }
    ptt::cp_async_commit();
  };
  if constexpr (kStaged) {
#pragma unroll
    for (int s = 0; s < kBwdStages; ++s)
      stage((first + s * kStep) * d + col, live && first + s * kStep < r1, s);
  }
  // the group's rows, kBwdStages at a time, so that its i-th row sits in
  // stage i % kBwdStages, a constant of the unrolled loop
#pragma unroll 1
  for (int64_t r = warp_live ? first : r1; r < r1; r += kBwdStages * kStep) {
#pragma unroll
    for (int s = 0; s < kBwdStages; ++s) {
      const int64_t row = r + s * kStep;
      if (row >= r1) break;  // past the group's last row of the band
      const int64_t at = row * d + col;
      // this lane's pieces of `row` landed: at most kBwdStages - 1 younger groups in flight
      if constexpr (kStaged) ptt::cp_async_wait<kBwdStages - 1>();
      if (live) {
        V xv, gw;
        if constexpr (kStaged) {
          xv = *reinterpret_cast<const V*>(ring + 2 * s * kSlot);
          gw = *reinterpret_cast<const V*>(ring + (2 * s + 1) * kSlot);
        } else {
          xv = *reinterpret_cast<const V*>(x + at);
          gw = *reinterpret_cast<const V*>(g + at);
        }
        float xf[VEC], dz[VEC];
        ptt::unpack(xv, xf);
        ptt::unpack(gw, dz);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          dz[k] *= activate_grad<ACT>(xf[k] + bv[k]);
          acc[k] += dz[k];
        }
        *reinterpret_cast<V*>(dx + at) = ptt::pack<T, VEC>(dz);
      }
      if constexpr (kStaged)
        stage(at + kBwdStages * kStep * d, live && row + kBwdStages * kStep < r1, s);
    }
  }
  // the band's partial row: the groups' sums added in group order
  float* red = reinterpret_cast<float*>(smem + bwd_ring_bytes<T, VEC>());
  if (group > 0) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) red[((group - 1) * kBwdTile + tl) * VEC + k] = acc[k];
  }
  __syncthreads();
  if (group == 0 && live) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float t = acc[k];
#pragma unroll
      for (int y = 1; y < kBwdGroups; ++y) t += red[((y - 1) * kBwdTile + tl) * VEC + k];
      part[static_cast<int64_t>(blockIdx.x) * d + col + k] = t;
    }
  }
}

// Blocks of one instantiation that one wave of the card holds, found once
// (the shared-memory attribute is set then too, so a launch makes no
// runtime call but its own).  A function of the build and the card, not of
// the data, so the bands, and with them the order of db's sums, are fixed
// by the shape.  0 where the attribute could not be set.
template <typename T, int VEC, int ACT>
int bwd_wave_blocks() {
  static const int n = [] {
    const auto kernel = bias_act_bwd_kernel<T, VEC, ACT>;
    int k = 0;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bwd_smem<T, VEC>())) != cudaSuccess)
      return 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, kernel, kBwdThreads,
                                                      bwd_smem<T, VEC>()) != cudaSuccess ||
        k < 1)
      k = 1;
    return k * ptt::sm_count();
  }();
  return n;
}

template <typename T, int VEC, int ACT>
cudaError_t launch_bwd(const void* x, const void* b, const void* g, void* dx, void* part,
                       void* db, int64_t rows, int d, int n_blocks, cudaStream_t stream) {
  const int wave = bwd_wave_blocks<T, VEC, ACT>();
  if (wave == 0) return cudaErrorInvalidValue;
  const int tiles = (d + kBwdTile * VEC - 1) / (kBwdTile * VEC);
  // one wave: bands x tiles blocks, at most n_blocks bands (part's rows)
  int64_t bands = wave / tiles;
  if (bands > n_blocks) bands = n_blocks;
  if (bands < 1) bands = 1;
  const int64_t per = (rows + bands - 1) / bands;
  bands = (rows + per - 1) / per;  // no empty band
  const dim3 grid(static_cast<unsigned>(bands), tiles);
  bias_act_bwd_kernel<T, VEC, ACT><<<grid, kBwdThreads, bwd_smem<T, VEC>(), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(b), static_cast<const T*>(g),
      static_cast<T*>(dx), static_cast<float*>(part), rows, d, per);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return ptt::column_sum(static_cast<const float*>(part), static_cast<float*>(db), 1,
                         static_cast<int>(bands), d, stream);
}

template <typename T, int VEC>
cudaError_t launch_bwd_act(const void* x, const void* b, const void* g, void* dx, void* part,
                           void* db, int64_t rows, int d, int act, int n_blocks,
                           cudaStream_t stream) {
  if (act == kRelu)
    return launch_bwd<T, VEC, kRelu>(x, b, g, dx, part, db, rows, d, n_blocks, stream);
  return launch_bwd<T, VEC, kGelu>(x, b, g, dx, part, db, rows, d, n_blocks, stream);
}

template <typename T>
cudaError_t dispatch_bwd(const void* x, const void* b, const void* g, void* dx, void* part,
                         void* db, int64_t rows, int d, int act, int n_blocks,
                         cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (d % kVec == 0 && ptt::aligned16(x) && ptt::aligned16(g) && ptt::aligned16(dx))
    return launch_bwd_act<T, kVec>(x, b, g, dx, part, db, rows, d, act, n_blocks, stream);
  return launch_bwd_act<T, 1>(x, b, g, dx, part, db, rows, d, act, n_blocks, stream);
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
  if (dtype == ptt::kFloat16) return dispatch<__half>(x, b, out, rows, d, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward.  x, g, dx: [rows, d] contiguous, dtype `dtype`; b: [d] float32;
// part: [n_blocks, d] float32 scratch, n_blocks the most bands of rows the
// kernel may take (it takes as many as one wave of its blocks fills);
// db: [d] float32.
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
  if (dtype == ptt::kFloat16)
    return dispatch_bwd<__half>(x, b, g, dx, part, db, rows, d, act, n_blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
