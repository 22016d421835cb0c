// Scaled dot-product attention, forward and backward, streaming over the
// key (or query) axis with an online softmax:
//   O = softmax(Q K^T * scale + bias, causal mask) V,  lse = log-sum-exp of each row
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - di) * scale,  dQ = dS K,  dK = dS^T Q
// with di = rowsum(dO * O) and P recomputed from lse.
//
// Replaces: paddle_tpu/ops/pallas_attention.py fused_sdpa, forward
// (_fused_sdpa_fwd, the pl.pallas_call at :193) and backward
// (_fused_sdpa_bwd, the pl.pallas_call at :221), and the stock streaming
// kernel that paddle_tpu/ops/nn_ops.py:637-643 calls for kv length >= 2048
// (jax/experimental/pallas/ops/tpu/flash_attention.py: forward pallas_call
// at :758, dK/dV at :1121, dQ at :1456).  One contract, the composite's
// (paddle_tpu/ops/nn_ops.py:672-689) and fused_sdpa's: q [B, H, Lq, dh],
// k and v [B, H, Lk, dh], float32 or bfloat16, dh in {16, 32, 64, 128};
// optional float32 bias [B, 1|H, Lq, Lk] added after the scale; causal keeps
// key c for query i when c <= i + (Lk - Lq), masked scores are -1e30 (a row
// with no visible key is the uniform average of V, as in the composite); no
// length limit.  (The stock kernel adds its bias before the scale and masks
// causal without the Lk - Lq offset; the two agree when there is no bias
// and Lq == Lk.)
//
// Bound on the H100: operations at long L, bytes at BERT's L = 128.  The
// forward does 4*B*H*Lq*Lk*dh operations (half when causal) on q, k, v and
// o; at [8, 12, 2048, 64] bf16 that is 103 GFLOP, 104 us at 989 TFLOP/s,
// against 101 MB, 30 us at 3.35 TB/s.  At [32, 12, 128, 64] it is 1.6 GFLOP
// against 25 MB: 7.5 us of bytes.  The backward does 10*B*H*Lq*Lk*dh
// operations in all (S and dP recomputed, dV, dQ, dK).  What the TPU
// kernels keep out of HBM, the [Lq, Lk] scores and probabilities, stays out
// here too: only o, lse (float32 [B, H, Lq]) and di (float32 [B, H, Lq])
// are written besides the gradients.
//
// Design (simple and right first; wgmma, TMA and warp specialization are
// later work): 128 threads, 4 warps, 64 rows of the CTA's own axis, each
// warp owning 16 of them, so everything after a tile load is warp-local.
//   forward: one CTA per (b*h, 64 query rows); K/V tiles of 64 keys stream
//     through shared memory; S = Q K^T lands in a float32 tile, each row's
//     running max and sum move online, P = exp(S - m_run) is rounded to the
//     input type before P V, and the float32 O tile in shared memory is
//     rescaled by exp(m_old - m_new) before each P V; O / l at the end.
//   dQ: one CTA per (b*h, 64 query rows); it first writes di for its rows,
//     then streams K/V tiles: S, P = exp(S - lse), dP = dO V^T, dS rounded
//     to the input type, dQ += dS K.
//   dK/dV: one CTA per (b*h, 64 key rows); query tiles stream through
//     shared memory, the warp works on S^T (its 16 keys against 64 queries):
//     dV += P^T dO, dP^T = V dO^T, dK += dS^T Q.
// dK/dV and dQ are separate kernels, as in the stock kernel, so no float
// atomics: the gradients repeat bit for bit.  bf16 products run on the
// tensor cores through WMMA 16x16x16 with float32 accumulators; float32
// products run as FFMA on the CUDA cores (never TF32).  Causal tiles that
// every row of the CTA masks are skipped only when Lq <= Lk (then every row
// sees key 0 and a masked probability is exactly 0); with Lq > Lk no tile
// is skipped, so rows with no visible key stay the uniform average.  In the
// backward a masked score is a constant: its dS is 0, and its P is 1/Lk in
// a row with no visible key, else 0 (taken from the indices, since lse of
// such a row is -1e30 + log(Lk), which float32 cannot tell from -1e30).
#include <mma.h>

#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kRows = 64;  // rows of a CTA's own axis, and of each streamed tile
constexpr int kThreads = 128;
constexpr float kMasked = -1e30f;

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Leading dimensions (in elements) of the shared tiles.  bf16: multiples of 8
// (WMMA, 16-byte vector stores), float32 accumulators multiples of 4.  float:
// odd strides, so the FFMA lanes that walk different rows hit different banks.
template <typename T, int DH>
struct Ld {
  static constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kTile = kBF16 ? DH + 8 : DH + 1;  // T [64][DH]: q, k, v, dO tiles
  static constexpr int kP = kBF16 ? kRows + 8 : kRows + 1;  // T [64][64]: P or dS
  static constexpr int kF = kBF16 ? kRows + 4 : kRows + 1;  // float [64][64]: S, dP
  static constexpr int kAcc = kBF16 ? DH + 4 : DH + 1;  // float [64][DH]: O, dQ, dK, dV
  static constexpr size_t kTileBytes = align128(sizeof(T) * kRows * kTile);
  static constexpr size_t kPBytes = align128(sizeof(T) * kRows * kP);
  static constexpr size_t kFBytes = align128(sizeof(float) * kRows * kF);
  static constexpr size_t kAccBytes = align128(sizeof(float) * kRows * kAcc);
  static constexpr size_t kVecBytes = align128(sizeof(float) * kRows);
  // float32 inputs keep P in the T tile itself (T is float): no second S tile
  static constexpr size_t kDPBytes = kBF16 ? kFBytes : 0;
  // forward: q, k, v tiles, S, P, O and the running max, sum and rescale
  static constexpr size_t kFwd = 3 * kTileBytes + kFBytes + kPBytes + kAccBytes + 3 * kVecBytes;
  // dQ: four tiles, S, P, dP (bf16), the dQ accumulator, lse and di
  static constexpr size_t kDQ = 4 * kTileBytes + kFBytes + kPBytes + kDPBytes + kAccBytes +
                                2 * kVecBytes;
  // dK/dV: the same with two accumulators (float32 at dh 128: 231,936 bytes)
  static constexpr size_t kDKV = kDQ + kAccBytes;
};

// A bump allocator over the dynamic shared memory.
struct Carve {
  unsigned char* p;
  template <typename U>
  __device__ U* take(size_t bytes) {
    U* r = reinterpret_cast<U*>(p);
    p += bytes;
    return r;
  }
};

// dst[r * LD + c] = r < valid ? src[r * DH + c] : 0, for r < kRows, c < DH.
template <typename T, int DH, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int valid) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr int kPerRow = DH / 8;  // 16-byte vectors per row
    for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
      const int r = i / kPerRow, c = i % kPerRow;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid) val = reinterpret_cast<const uint4*>(src + static_cast<int64_t>(r) * DH)[c];
      *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
    }
  } else {
    for (int i = threadIdx.x; i < kRows * DH; i += kThreads) {
      const int r = i / DH, c = i % DH;
      dst[r * LD + c] = r < valid ? src[static_cast<int64_t>(r) * DH + c] : T(0);
    }
  }
}

// One warp: C[16][N] = A[16][K] * B[N][K]^T (A and B row-major in shared
// memory, C float32).
template <typename T, int K, int N>
__device__ __forceinline__ void warp_nt(float* C, int ldc, const T* A, int lda, const T* B,
                                        int ldb) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, A + k0, lda);
        wmma::load_matrix_sync(b, B + n0 * ldb + k0, ldb);  // B^T, column-major
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(C + n0, acc, ldc, wmma::mem_row_major);
    }
  } else {
    // lane: rows r0..r0+3, columns c0 + 8j
    const int lane = threadIdx.x & 31, r0 = (lane >> 3) * 4, c0 = lane & 7;
    float acc[4][N / 8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < N / 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < K; ++d) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(r0 + i) * lda + d];
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float b = B[(c0 + 8 * j) * ldb + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < N / 8; ++j) C[(r0 + i) * ldc + c0 + 8 * j] = acc[i][j];
  }
}

// One warp: C[16][N] += A[16][K] * B[K][N] (A and B row-major in shared
// memory, C float32 in shared memory).
template <typename T, int K, int N>
__device__ __forceinline__ void warp_nn_acc(float* C, int ldc, const T* A, int lda, const T* B,
                                            int ldb) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, C + n0, ldc, wmma::mem_row_major);
#pragma unroll
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, A + k0, lda);
        wmma::load_matrix_sync(b, B + k0 * ldb + n0, ldb);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(C + n0, acc, ldc, wmma::mem_row_major);
    }
  } else {
    const int lane = threadIdx.x & 31, r0 = (lane >> 3) * 4, c0 = lane & 7;
    float acc[4][N / 8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < N / 8; ++j) acc[i][j] = C[(r0 + i) * ldc + c0 + 8 * j];
#pragma unroll 4
    for (int kk = 0; kk < K; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(r0 + i) * lda + kk];
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float b = B[kk * ldb + c0 + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < N / 8; ++j) C[(r0 + i) * ldc + c0 + 8 * j] = acc[i][j];
  }
}

// What every kernel needs to know about one (batch, head) pair.
struct Problem {
  int H, Lq, Lk;
  int64_t bias_b_stride, bias_h_stride;
  float scale;
  int causal;
  __device__ int offset() const { return Lk - Lq; }
  __device__ bool masked(int qi, int kc) const { return causal && kc > qi + Lk - Lq; }
  // tiles of 64 keys that queries [0, q_end) need: with Lq <= Lk every row
  // sees key 0, so tiles past the last visible key contribute exactly 0
  __device__ int key_tiles(int q_end) const {
    int keys = Lk;
    if (causal && Lk >= Lq) keys = min(Lk, q_end + Lk - Lq);
    return (keys + kRows - 1) / kRows;
  }
  __device__ const float* bias_of(const float* bias, int bh) const {
    return bias == nullptr ? nullptr : bias + (bh / H) * bias_b_stride + (bh % H) * bias_h_stride;
  }
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const float* __restrict__ bias, T* __restrict__ out,
                         float* __restrict__ lse, Problem pr) {
  using L = Ld<T, DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Qs = cv.take<T>(L::kTileBytes);
  T* Ks = cv.take<T>(L::kTileBytes);
  T* Vs = cv.take<T>(L::kTileBytes);
  float* Sb = cv.take<float>(L::kFBytes);
  T* PT = cv.take<T>(L::kPBytes);
  float* Ob = cv.take<float>(L::kAccBytes);
  float* m_s = cv.take<float>(L::kVecBytes);
  float* l_s = cv.take<float>(L::kVecBytes);
  float* a_s = cv.take<float>(L::kVecBytes);

  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int q_rows = min(kRows, pr.Lq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wr = warp * 16;
  const T* kp = k + static_cast<int64_t>(bh) * pr.Lk * DH;
  const T* vp = v + static_cast<int64_t>(bh) * pr.Lk * DH;
  const float* bias_bh = pr.bias_of(bias, bh);

  load_tile<T, DH, L::kTile>(Qs, q + (static_cast<int64_t>(bh) * pr.Lq + q0) * DH, q_rows);
  for (int i = threadIdx.x; i < kRows * L::kAcc; i += kThreads) Ob[i] = 0.f;
  if (threadIdx.x < kRows) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }
  const int n_tiles = pr.key_tiles(q0 + q_rows);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kRows, kv_rows = min(kRows, pr.Lk - k0);
    __syncthreads();  // the previous K/V tiles are consumed
    load_tile<T, DH, L::kTile>(Ks, kp + static_cast<int64_t>(k0) * DH, kv_rows);
    load_tile<T, DH, L::kTile>(Vs, vp + static_cast<int64_t>(k0) * DH, kv_rows);
    __syncthreads();
    warp_nt<T, DH, kRows>(Sb + wr * L::kF, L::kF, Qs + wr * L::kTile, L::kTile, Ks, L::kTile);
    __syncwarp();
    // the warp's 16 rows one at a time, two key columns a lane
    for (int r = 0; r < 16; ++r) {
      const int row = wr + r, qi = q0 + row;
      float s[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h, kc = k0 + c;
        if (c >= kv_rows) {
          s[h] = -INFINITY;  // past the end of the keys: no weight at all
        } else {
          s[h] = Sb[row * L::kF + c] * pr.scale;
          if (row < q_rows) {
            if (bias_bh != nullptr) s[h] += bias_bh[static_cast<int64_t>(qi) * pr.Lk + kc];
            if (pr.masked(qi, kc)) s[h] = kMasked;
          }
        }
      }
      // tile 0 holds a real key, so m_new is finite from the first tile on
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, ptt::warp_max(fmaxf(s[0], s[1])));
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      PT[row * L::kP + lane] = ptt::from_f32<T>(p0);
      PT[row * L::kP + lane + 32] = ptt::from_f32<T>(p1);
      const float psum = ptt::warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile (m_old = -inf)
        m_s[row] = m_new;
        l_s[row] = l_s[row] * alpha + psum;
        a_s[row] = alpha;
      }
    }
    __syncwarp();
    for (int e = lane; e < 16 * DH; e += 32) {
      const int row = wr + e / DH;
      Ob[row * L::kAcc + e % DH] *= a_s[row];
    }
    __syncwarp();
    warp_nn_acc<T, kRows, DH>(Ob + wr * L::kAcc, L::kAcc, PT + wr * L::kP, L::kP, Vs, L::kTile);
  }
  __syncwarp();
  T* op = out + (static_cast<int64_t>(bh) * pr.Lq + q0) * DH;
  for (int e = lane; e < 16 * DH; e += 32) {
    const int row = wr + e / DH;
    if (row < q_rows)
      op[static_cast<int64_t>(row) * DH + e % DH] =
          ptt::from_f32<T>(Ob[row * L::kAcc + e % DH] / l_s[row]);
  }
  if (lane < 16 && wr + lane < q_rows)
    lse[static_cast<int64_t>(bh) * pr.Lq + q0 + wr + lane] = m_s[wr + lane] + logf(l_s[wr + lane]);
}

// dQ (and di = rowsum(dO * O), which the dK/dV kernel reads after it).
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const float* __restrict__ bias,
                            const T* __restrict__ out, const T* __restrict__ dout,
                            const float* __restrict__ lse, float* __restrict__ di,
                            T* __restrict__ dq, Problem pr) {
  using L = Ld<T, DH>;
  constexpr bool kBF16 = L::kBF16;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Qs = cv.take<T>(L::kTileBytes);
  T* dOs = cv.take<T>(L::kTileBytes);
  T* Ks = cv.take<T>(L::kTileBytes);
  T* Vs = cv.take<T>(L::kTileBytes);
  float* Sb = cv.take<float>(L::kFBytes);
  T* PT = cv.take<T>(L::kPBytes);
  float* DPb = kBF16 ? cv.take<float>(L::kDPBytes) : Sb;
  float* dQb = cv.take<float>(L::kAccBytes);
  float* lse_s = cv.take<float>(L::kVecBytes);
  float* di_s = cv.take<float>(L::kVecBytes);
  // P in float32: the S tile itself (bf16), or the float P tile (float32)
  float* P32 = kBF16 ? Sb : reinterpret_cast<float*>(PT);
  const int ldp32 = kBF16 ? L::kF : L::kP;

  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int q_rows = min(kRows, pr.Lq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wr = warp * 16;
  const int64_t row0 = static_cast<int64_t>(bh) * pr.Lq + q0;
  const T* kp = k + static_cast<int64_t>(bh) * pr.Lk * DH;
  const T* vp = v + static_cast<int64_t>(bh) * pr.Lk * DH;
  const float* bias_bh = pr.bias_of(bias, bh);

  load_tile<T, DH, L::kTile>(Qs, q + row0 * DH, q_rows);
  load_tile<T, DH, L::kTile>(dOs, dout + row0 * DH, q_rows);
  for (int i = threadIdx.x; i < kRows * L::kAcc; i += kThreads) dQb[i] = 0.f;
  // di of the warp's rows, from O and dO in device memory
  for (int r = 0; r < 16; ++r) {
    const int row = wr + r;
    float acc = 0.f;
    if (row < q_rows)
      for (int c = lane; c < DH; c += 32)
        acc += ptt::to_f32(out[(row0 + row) * DH + c]) * ptt::to_f32(dout[(row0 + row) * DH + c]);
    acc = ptt::warp_sum(acc);
    if (lane == 0) {
      di_s[row] = acc;
      lse_s[row] = row < q_rows ? lse[row0 + row] : 0.f;
      if (row < q_rows) di[row0 + row] = acc;
    }
  }
  const int n_tiles = pr.key_tiles(q0 + q_rows);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kRows, kv_rows = min(kRows, pr.Lk - k0);
    __syncthreads();
    load_tile<T, DH, L::kTile>(Ks, kp + static_cast<int64_t>(k0) * DH, kv_rows);
    load_tile<T, DH, L::kTile>(Vs, vp + static_cast<int64_t>(k0) * DH, kv_rows);
    __syncthreads();
    warp_nt<T, DH, kRows>(Sb + wr * L::kF, L::kF, Qs + wr * L::kTile, L::kTile, Ks, L::kTile);
    __syncwarp();
    for (int r = 0; r < 16; ++r) {  // P = exp(S - lse) where it feeds dS
      const int row = wr + r, qi = q0 + row;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h, kc = k0 + c;
        float p = 0.f;
        if (c < kv_rows && row < q_rows && !pr.masked(qi, kc)) {
          float s = Sb[row * L::kF + c] * pr.scale;
          if (bias_bh != nullptr) s += bias_bh[static_cast<int64_t>(qi) * pr.Lk + kc];
          p = expf(s - lse_s[row]);
        }
        P32[row * ldp32 + c] = p;
      }
    }
    __syncwarp();
    warp_nt<T, DH, kRows>(DPb + wr * L::kF, L::kF, dOs + wr * L::kTile, L::kTile, Vs, L::kTile);
    __syncwarp();
    for (int e = lane; e < 16 * kRows; e += 32) {  // dS; 0 where the score is a constant
      const int row = wr + e / kRows, c = e % kRows;
      const float ds = P32[row * ldp32 + c] * (DPb[row * L::kF + c] - di_s[row]) * pr.scale;
      PT[row * L::kP + c] = ptt::from_f32<T>(ds);
    }
    __syncwarp();
    warp_nn_acc<T, kRows, DH>(dQb + wr * L::kAcc, L::kAcc, PT + wr * L::kP, L::kP, Ks, L::kTile);
  }
  __syncwarp();
  for (int e = lane; e < 16 * DH; e += 32) {
    const int row = wr + e / DH;
    if (row < q_rows) dq[(row0 + row) * DH + e % DH] = ptt::from_f32<T>(dQb[row * L::kAcc + e % DH]);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const float* __restrict__ bias,
                             const T* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ di, T* __restrict__ dk,
                             T* __restrict__ dv, Problem pr) {
  using L = Ld<T, DH>;
  constexpr bool kBF16 = L::kBF16;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Ks = cv.take<T>(L::kTileBytes);
  T* Vs = cv.take<T>(L::kTileBytes);
  T* Qs = cv.take<T>(L::kTileBytes);
  T* dOs = cv.take<T>(L::kTileBytes);
  float* Sb = cv.take<float>(L::kFBytes);
  T* PT = cv.take<T>(L::kPBytes);
  float* DPb = kBF16 ? cv.take<float>(L::kDPBytes) : Sb;
  float* dKb = cv.take<float>(L::kAccBytes);
  float* dVb = cv.take<float>(L::kAccBytes);
  float* lse_s = cv.take<float>(L::kVecBytes);
  float* di_s = cv.take<float>(L::kVecBytes);
  float* P32 = kBF16 ? Sb : reinterpret_cast<float*>(PT);
  const int ldp32 = kBF16 ? L::kF : L::kP;

  const int bh = blockIdx.y, k0 = blockIdx.x * kRows;
  const int k_rows = min(kRows, pr.Lk - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wr = warp * 16;
  const int64_t key0 = static_cast<int64_t>(bh) * pr.Lk + k0;
  const int64_t qrow0 = static_cast<int64_t>(bh) * pr.Lq;
  const float* bias_bh = pr.bias_of(bias, bh);
  const float uniform = 1.f / pr.Lk;  // P of a row with no visible key

  load_tile<T, DH, L::kTile>(Ks, k + key0 * DH, k_rows);
  load_tile<T, DH, L::kTile>(Vs, v + key0 * DH, k_rows);
  for (int i = threadIdx.x; i < kRows * L::kAcc; i += kThreads) dKb[i] = dVb[i] = 0.f;
  // with Lq <= Lk, queries before k0 - (Lk - Lq) see none of these keys
  int t_begin = 0;
  if (pr.causal && pr.Lk >= pr.Lq && k0 - pr.offset() > 0) t_begin = (k0 - pr.offset()) / kRows;
  const int t_end = (pr.Lq + kRows - 1) / kRows;
  for (int t = t_begin; t < t_end; ++t) {
    const int q0 = t * kRows, q_rows = min(kRows, pr.Lq - q0);
    __syncthreads();
    load_tile<T, DH, L::kTile>(Qs, q + (qrow0 + q0) * DH, q_rows);
    load_tile<T, DH, L::kTile>(dOs, dout + (qrow0 + q0) * DH, q_rows);
    if (threadIdx.x < kRows) {
      const bool in = static_cast<int>(threadIdx.x) < q_rows;
      lse_s[threadIdx.x] = in ? lse[qrow0 + q0 + threadIdx.x] : 0.f;
      di_s[threadIdx.x] = in ? di[qrow0 + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    // S^T: the warp's 16 keys against the tile's 64 queries
    warp_nt<T, DH, kRows>(Sb + wr * L::kF, L::kF, Ks + wr * L::kTile, L::kTile, Qs, L::kTile);
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int row = wr + r, kc = k0 + row;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h, qi = q0 + j;
        float p = 0.f;
        if (j < q_rows && row < k_rows) {
          if (pr.masked(qi, kc)) {
            p = qi + pr.offset() < 0 ? uniform : 0.f;
          } else {
            float s = Sb[row * L::kF + j] * pr.scale;
            if (bias_bh != nullptr) s += bias_bh[static_cast<int64_t>(qi) * pr.Lk + kc];
            p = expf(s - lse_s[j]);
          }
        }
        P32[row * ldp32 + j] = p;
        if constexpr (kBF16) PT[row * L::kP + j] = ptt::from_f32<T>(p);
      }
    }
    __syncwarp();
    warp_nn_acc<T, kRows, DH>(dVb + wr * L::kAcc, L::kAcc, PT + wr * L::kP, L::kP, dOs, L::kTile);
    warp_nt<T, DH, kRows>(DPb + wr * L::kF, L::kF, Vs + wr * L::kTile, L::kTile, dOs, L::kTile);
    __syncwarp();
    for (int e = lane; e < 16 * kRows; e += 32) {
      const int row = wr + e / kRows, j = e % kRows, qi = q0 + j;
      float ds = 0.f;
      if (j < q_rows && row < k_rows && !pr.masked(qi, k0 + row))
        ds = P32[row * ldp32 + j] * (DPb[row * L::kF + j] - di_s[j]) * pr.scale;
      PT[row * L::kP + j] = ptt::from_f32<T>(ds);
    }
    __syncwarp();
    warp_nn_acc<T, kRows, DH>(dKb + wr * L::kAcc, L::kAcc, PT + wr * L::kP, L::kP, Qs, L::kTile);
  }
  __syncwarp();
  for (int e = lane; e < 16 * DH; e += 32) {
    const int row = wr + e / DH, c = e % DH;
    if (row < k_rows) {
      dk[(key0 + row) * DH + c] = ptt::from_f32<T>(dKb[row * L::kAcc + c]);
      dv[(key0 + row) * DH + c] = ptt::from_f32<T>(dVb[row * L::kAcc + c]);
    }
  }
}

enum Which { kForward, kBwdDQ, kBwdDKV };

struct Args {
  const void *q, *k, *v, *bias, *out, *dout;
  void *o_or_dq, *dk, *dv;
  float *lse_w;
  const float* lse_r;
  float* di_w;
  const float* di_r;
};

template <typename T, int DH>
cudaError_t launch(Which which, const Args& a, int B, int H, const Problem& pr,
                   cudaStream_t stream) {
  using L = Ld<T, DH>;
  const size_t bytes = which == kForward ? L::kFwd : which == kBwdDQ ? L::kDQ : L::kDKV;
  if (bytes > 227u * 1024u) return cudaErrorInvalidValue;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const float* bias = static_cast<const float*>(a.bias);
  const int own = which == kBwdDKV ? pr.Lk : pr.Lq;
  const dim3 grid((own + kRows - 1) / kRows, static_cast<unsigned>(B) * H);
  cudaError_t e = cudaSuccess;
  if (which == kForward) {
    auto kern = attention_fwd_kernel<T, DH>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    kern<<<grid, kThreads, bytes, stream>>>(q, k, v, bias, static_cast<T*>(a.o_or_dq), a.lse_w,
                                            pr);
  } else if (which == kBwdDQ) {
    auto kern = attention_bwd_dq_kernel<T, DH>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    kern<<<grid, kThreads, bytes, stream>>>(q, k, v, bias, static_cast<const T*>(a.out),
                                            static_cast<const T*>(a.dout), a.lse_r, a.di_w,
                                            static_cast<T*>(a.o_or_dq), pr);
  } else {
    auto kern = attention_bwd_dkv_kernel<T, DH>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    kern<<<grid, kThreads, bytes, stream>>>(q, k, v, bias, static_cast<const T*>(a.dout),
                                            a.lse_r, a.di_r, static_cast<T*>(a.dk),
                                            static_cast<T*>(a.dv), pr);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(Which which, const Args& a, int B, int H, int dh, const Problem& pr,
                     cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(which, a, B, H, pr, s);
    case 32: return launch<T, 32>(which, a, B, H, pr, s);
    case 64: return launch<T, 64>(which, a, B, H, pr, s);
    case 128: return launch<T, 128>(which, a, B, H, pr, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(Which which, const Args& a, const void* const* aligned, int n_aligned, int B, int H,
        int Lq, int Lk, int dh, int bias_heads, float scale, int causal, int dtype,
        void* stream) {
  if (B < 0 || H < 0 || Lq < 0 || Lk < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Lq == 0 || (which == kBwdDKV && Lk == 0)) return 0;
  if (Lk == 0 || static_cast<int64_t>(B) * H > 65535 || (a.bias == nullptr) != (bias_heads == 0) ||
      (bias_heads != 0 && bias_heads != 1 && bias_heads != H))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_aligned; ++i)
    if (!ptt::aligned16(aligned[i])) return static_cast<int>(cudaErrorInvalidValue);
  Problem pr;
  pr.H = H;
  pr.Lq = Lq;
  pr.Lk = Lk;
  const int64_t plane = static_cast<int64_t>(Lq) * Lk;
  pr.bias_h_stride = bias_heads == 1 ? 0 : plane;
  pr.bias_b_stride = static_cast<int64_t>(bias_heads) * plane;
  pr.scale = scale;
  pr.causal = causal;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32) return dispatch<float>(which, a, B, H, dh, pr, s);
  if (dtype == ptt::kBFloat16) return dispatch<__nv_bfloat16>(which, a, B, H, dh, pr, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Every tensor is contiguous and 16-byte aligned; q, out, dout, dq: [B, H, Lq,
// dh]; k, v, dk, dv: [B, H, Lk, dh], all of dtype `dtype` (0 float32, 1
// bfloat16); lse, di: float32 [B, H, Lq]; bias: null (bias_heads 0) or
// float32 [B, bias_heads, Lq, Lk] with bias_heads 1 or H.  Each launches on
// `stream` and returns the CUDA error code.

// out = attention(q, k, v), lse = the log-sum-exp of each score row.
extern "C" int ptt_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                                 void* out, void* lse, int B, int H, int Lq, int Lk, int dh,
                                 int bias_heads, float scale, int causal, int dtype,
                                 void* stream) {
  Args a{q, k, v, bias, nullptr, nullptr, out, nullptr, nullptr,
         static_cast<float*>(lse), nullptr, nullptr, nullptr};
  const void* al[] = {q, k, v, out};
  return run(kForward, a, al, 4, B, H, Lq, Lk, dh, bias_heads, scale, causal, dtype, stream);
}

// dq, and di = rowsum(dout * out) for the dK/dV kernel, which runs after it.
extern "C" int ptt_attention_bwd_dq(const void* q, const void* k, const void* v,
                                    const void* bias, const void* out, const void* dout,
                                    const void* lse, void* di, void* dq, int B, int H, int Lq,
                                    int Lk, int dh, int bias_heads, float scale, int causal,
                                    int dtype, void* stream) {
  Args a{q, k, v, bias, out, dout, dq, nullptr, nullptr, nullptr,
         static_cast<const float*>(lse), static_cast<float*>(di), nullptr};
  const void* al[] = {q, k, v, out, dout, dq};
  return run(kBwdDQ, a, al, 6, B, H, Lq, Lk, dh, bias_heads, scale, causal, dtype, stream);
}

// dk and dv, from the forward's lse and the dQ kernel's di.
extern "C" int ptt_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                     const void* bias, const void* dout, const void* lse,
                                     const void* di, void* dk, void* dv, int B, int H, int Lq,
                                     int Lk, int dh, int bias_heads, float scale, int causal,
                                     int dtype, void* stream) {
  Args a{q, k, v, bias, nullptr, dout, nullptr, dk, dv, nullptr,
         static_cast<const float*>(lse), nullptr, static_cast<const float*>(di)};
  const void* al[] = {q, k, v, dout, dk, dv};
  return run(kBwdDKV, a, al, 6, B, H, Lq, Lk, dh, bias_heads, scale, causal, dtype, stream);
}
