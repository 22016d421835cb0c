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
// k and v [B, H, Lk, dh], float32, bfloat16 or float16, dh in {16, 32, 64, 128};
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
// against 25 MB: 7.5 us of bytes.  The backward recomputes S and dP in both
// of its kernels: 6 units of B*H*Lq*Lk*dh in dQ (S, dP, dS K) and 8 in
// dK/dV (S^T, P^T dO, dP^T, dS^T Q), 14 in all against the 10 one kernel
// with float atomics would do; at [8, 12, 2048, 64] 0.156 ms and 0.209 ms
// of bf16 tensor-core peak.  What the TPU kernels keep out of HBM, the
// [Lq, Lk] scores and probabilities, stays out here too: only o, lse
// (float32 [B, H, Lq]) and di (float32 [B, H, Lq]) are written besides the
// gradients.
//
// bf16 forward (the main path: BERT serving and training; TPU rows 10 and
// 12a): one kernel of 4 warps, FlashAttention-2's forward on mma.sync.  A
// CTA owns FwdTiles::kRowsQ query rows, a warp FwdTiles::kWarpRows of them
// (kMT tiles of 16 rows that share every B fragment ldmatrix brings).  Q is
// copied once by cp.async and held as A fragments in registers; K and V
// tiles of 64 keys stream through a 2-stage cp.async ring, so tile t + 1 is
// in flight while tile t is computed.  Per pass of kC keys S = Q K^T lands
// in C fragments; the online softmax runs on them in registers: the row max
// over the lane's own elements, then across its quad (the 4 lanes that hold
// rows g and g + 8), alpha = 2^(m_old - m_new) and P = 2^(s scale log2e -
// m_new) on the special-function unit, the running sum l kept per lane and
// added across the quad once at the end.  O is a float32 accumulator in
// registers, rescaled by alpha per row; P is rounded to bf16 pairwise into
// the A fragments of O += P V (V through ldmatrix.trans).  At the end O / l
// goes out by 4-byte stores and lse = m + log l from the lanes that own a
// row's first column.  Shared memory holds only the Q tile and the ring.
// Passes with ragged keys, a bias, causal keys past the diagonal (or a
// scale <= 0) take a per-element path; BERT's take one without checks,
// whose row max is taken on the raw scores and scaled once.
//
// bf16 backward (the main path: BERT training): two kernels of 4 warps.
//   dQ: a CTA owns 64 query rows, a warp 16; it writes di for its rows.
//   dK/dV: a CTA owns 64 keys, a warp 16.
// Every product is mma.sync m16n8k16 bf16 -> float32 (mma_sm80.cuh), its
// operands from shared memory by ldmatrix (.trans where the B operand lies
// row-major: dO in P^T dO, Q in dS^T Q, K in dS K).  S, P, dP and dS never
// leave registers: each product's C fragments are the next one's A
// fragments after a pairwise round to bf16 (P^T into dV += P^T dO, dS into
// dQ += dS K, dS^T into dK += dS^T Q), and the accumulators (dQ; dK and dV)
// stay in registers for the whole loop, 16 x dh float32 a warp.  A warp
// takes a streamed tile 32 columns at a time, so S and dP are 16 registers
// each.  The CTA's own two tiles load once (dQ: Q and dO, held as A
// fragments for the whole loop; dK/dV: K and V, whose A fragments ldmatrix
// takes one k-step at a time, since held beside dK and dV they spilled at
// dh 64); the streamed tiles (dQ: K and V; dK/dV: Q, dO, lse and di) go
// through a 2-stage ring of 16-byte cp.async.cg copies, zero-filled past
// the end of the sequence, so tile t + 1 is in flight while tile t is
// computed.  Tiles are [64][dh + 8] bf16: the pad puts the 8 rows of an
// ldmatrix on distinct banks.  Shared memory is only tiles; launch bounds
// ask for 3 CTAs an SM (at most 168 registers a thread) to dh 64 and 2 at
// dh 128.  Each instantiation, the forward's too, on an NVIDIA H100 80GB
// HBM3 at 700 W (ptxas -v;
// CTAs an SM from cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// chip_smoke.py phase 2; the forward with 32 rows a warp to dh 64):
//   kernel  dh   registers  spill bytes  shared bytes  CTAs (warps) an SM
//   fwd     16   166        0            18,432        3 (12)
//   fwd     32   200        0            30,720        2 (8)
//   fwd     64   255        0            55,296        2 (8)
//   fwd     128  251        0            87,040        2 (8)
//   dQ      16   106        0            18,688        4 (16)
//   dQ      32   150        0            30,976        3 (12)
//   dQ      64   168        0            55,552        3 (12)
//   dQ      128  255        0            104,704       2 (8)
//   dK/dV   16   102        0            19,456        4 (16)
//   dK/dV   32   140        0            31,744        3 (12)
//   dK/dV   64   166        0            56,320        3 (12)
//   dK/dV   128  253        0            105,472       2 (8)
// Registers, not shared memory, set the count to dh 64.  The backward's
// tiles with ragged rows, masked scores or a bias take a per-element path;
// the others (all of BERT's) take one without checks.
//
// float16 (fault C6: the kernels refused it, the JAX kernels compute it):
// the bf16 kernels' code instantiated for __half (mma.sync
// m16n8k16.f32.f16.f16.f32, pairs rounded by __floats2half2_rn: to nearest
// even, past 65504 to +-inf, as torch's .to(float16)); P goes to float16
// before the PV product, as the composite's p.astype(q.dtype).  With bf16
// scores, float16 inputs take the FFMA kBS twins below, instantiated for
// __half loads: the warpgroup kernels stay bf16-only.
//
// float32 forward and backward (for float32 parity with the CPU; untimed):
// 64 rows a CTA, 16 a warp, the backward's split, FFMA on the CUDA cores
// (never TF32), S, P, dP, dS and the accumulators in shared memory tiles,
// synchronous tile loads.
//
// bf16 scores (score_dtype="bfloat16" of the JAX composite,
// paddle_tpu/ops/nn_ops.py:680-684: s rounded to bf16, the row max m over
// the rounded scores, P = exp(f32(bf16(s - m))) / l, l summed in float32):
// the forward saves log l and m; the backward recomputes P from the same
// roundings and rounds P (dP - di) to bf16 (the cast's VJP) before the
// scale.  With bfloat16 inputs all three are warpgroup kernels of their own
// (wgmma fed by a TMA producer warp, helpers in hopper.cuh):
// attention_fwd_bs.cu, launched from ptt_attention_fwd (an online softmax
// cannot give bf16(s - m) nor round the normalized P / l, so each 64-row
// block computes its scores once, keeps them rounded in shared memory and
// makes its sum and output passes over them; long rows split over a
// thread-block cluster), and attention_bwd_bs.cu, launched from
// ptt_attention_bwd_dq and ptt_attention_bwd_dkv (this file's split, each
// CTA's own two tiles resident, the other two streamed, the per-score work
// in bf16 pairs).  Each file's note says what bounds it and what ptxas
// makes of it.  The float32 kernels have a compile-time variant kBS: the
// forward makes three passes (max, sum, output) with m and l fixed, the
// backward recomputes P as above and takes the row max's cotangent: dQ sums
// each row's bf16(P (dP - di)) in float32 (dm = -that, rounded once),
// writes each row's share t = bf16(dm / c) of its c ties beside di, and
// dK/dV adds t in bf16 where its score ties; the non-kBS instantiations
// compile as before (the terms sit under `if constexpr (kBS)`).
//
// Why two kernels and no atomics: dK/dV and dQ reduce over different axes
// (queries and keys).  One kernel would have to add its dQ partial sums
// across CTAs with float atomics, in an order that changes from run to
// run; instead each gradient is summed by one CTA in a fixed order, and
// two runs agree bit for bit, at the price of S and dP computed twice.
// Causal tiles that every row of the CTA masks are skipped only when
// Lq <= Lk (then every row sees key 0 and a masked probability is exactly
// 0); with Lq > Lk no tile is skipped, so rows with no visible key stay the
// uniform average.  In the backward a masked score is a constant: its dS is
// 0, and its P is 1/Lk in a row with no visible key, else 0 (taken from the
// indices, since lse of such a row is -1e30 + log(Lk), which float32 cannot
// tell from -1e30).
#include <cmath>
#include <type_traits>

#include "common.cuh"
#include "mma_sm80.cuh"

namespace ptt {
// attention_fwd_bs.cu: the bf16-score forward of bf16 inputs (occ != null:
// its occupancy query).
cudaError_t attention_fwd_bf16_scores(const void* q, const void* k, const void* v,
                                      const float* bias, void* out, float* lse, float* rowmax,
                                      int B, int H, int Lq, int Lk, int dh,
                                      int64_t bias_b_stride, int64_t bias_h_stride, float scale,
                                      int causal, cudaStream_t stream, int* occ);
// attention_bwd_bs.cu: the bf16-score dQ and dK/dV of bf16 inputs (occ !=
// null: their occupancy query).
cudaError_t attention_bwd_dq_bf16_scores(const void* q, const void* k, const void* v,
                                         const void* bias, const void* out, const void* dout,
                                         const float* lse, const float* rowmax, float* di,
                                         void* dq, int B, int H, int Lq, int Lk, int dh,
                                         int64_t bias_b_stride, int64_t bias_h_stride,
                                         float scale, int causal, cudaStream_t stream, int* occ);
cudaError_t attention_bwd_dkv_bf16_scores(const void* q, const void* k, const void* v,
                                          const void* bias, const void* dout, const float* lse,
                                          const float* rowmax, const float* di, void* dk, void* dv,
                                          int B, int H, int Lq, int Lk, int dh,
                                          int64_t bias_b_stride, int64_t bias_h_stride,
                                          float scale, int causal, cudaStream_t stream, int* occ);
}  // namespace ptt

namespace {

constexpr int kRows = 64;  // rows of a CTA's own axis, and of each streamed tile
constexpr int kThreads = 128;
constexpr float kMasked = -1e30f;

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Leading dimensions (in elements) of the float32 kernels' shared tiles: odd
// strides, so the FFMA lanes that walk different rows hit different banks.
template <int DH>
struct Ld {
  static constexpr int kTile = DH + 1;  // [64][DH]: q, k, v, dO tiles
  static constexpr int kP = kRows + 1;  // [64][64]: P or dS
  static constexpr int kF = kRows + 1;  // [64][64]: S, dP
  static constexpr int kAcc = DH + 1;   // [64][DH]: O, dQ, dK, dV
  static constexpr size_t kTileBytes = align128(sizeof(float) * kRows * kTile);
  static constexpr size_t kPBytes = align128(sizeof(float) * kRows * kP);
  static constexpr size_t kFBytes = align128(sizeof(float) * kRows * kF);
  static constexpr size_t kAccBytes = align128(sizeof(float) * kRows * kAcc);
  static constexpr size_t kVecBytes = align128(sizeof(float) * kRows);
  // forward: q, k, v tiles, S, P, O and the running max, sum and rescale
  static constexpr size_t kFwd = 3 * kTileBytes + kFBytes + kPBytes + kAccBytes + 3 * kVecBytes;
  // dQ: four tiles, S (then dP), P (then dS), the dQ
  // accumulator, lse and di
  static constexpr size_t kDQ = 4 * kTileBytes + kFBytes + kPBytes + kAccBytes + 2 * kVecBytes;
  // dK/dV: the same with two accumulators (231,936 bytes at dh 128)
  static constexpr size_t kDKV = kDQ + kAccBytes;
  // the bf16-score dQ's tie slots: each row's first kTies ties (key, g)
  static constexpr int kTies = 8;
  static constexpr size_t kTieBytes = align128(sizeof(float) * kRows * 2 * kTies);
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

// dst[r * LD + c] = r < valid ? src[r * DH + c] : 0, for r < kRows, c < DH,
// as float32 (src float32 or float16).
template <int DH, int LD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int valid) {
  for (int i = threadIdx.x; i < kRows * DH; i += kThreads) {
    const int r = i / DH, c = i % DH;
    dst[r * LD + c] = r < valid ? ptt::to_f32(src[static_cast<int64_t>(r) * DH + c]) : 0.f;
  }
}

// x rounded to RA and back, as a float (RA float: x itself).
template <typename RA>
__device__ __forceinline__ float round_to(float x) {
  return ptt::to_f32(ptt::from_f32<RA>(x));
}

// One warp, FFMA: C[16][N] = A[16][K] * B[N][K]^T (row-major in shared
// memory); the lane holds rows r0..r0+3, columns c0 + 8j.
template <int K, int N>
__device__ __forceinline__ void warp_nt(float* C, int ldc, const float* A, int lda,
                                        const float* B, int ldb) {
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

// One warp, FFMA: C[16][N] += A[16][K] * B[K][N] (row-major in shared
// memory), each element of A rounded to RA first (float: as it is).
template <int K, int N, typename RA = float>
__device__ __forceinline__ void warp_nn_acc(float* C, int ldc, const float* A, int lda,
                                            const float* B, int ldb) {
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
    for (int i = 0; i < 4; ++i) a[i] = round_to<RA>(A[(r0 + i) * lda + kk]);
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

// ---------------------------------------------------------------------------
// The 16-bit kernels (T = __nv_bfloat16 or __half): mma.sync fragments in
// registers, cp.async ring.  bf16 is the type the notes below name; f16
// takes the same code with the f16 mma.sync and pair rounding.

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared tiles of the 16-bit kernels: [64][DH + 8] bf16 (or f16), the 16-byte pad
// putting the 8 row addresses of each ldmatrix on 8 distinct 16-byte bank
// groups.  A backward CTA holds its own two tiles for the whole loop and a
// ring of kStages pairs of streamed tiles.
template <int DH>
struct MmaTiles {
  static constexpr int kLd = DH + 8;
  static constexpr int kStages = 2;
  static constexpr int kChunk = 32;  // streamed rows a warp takes in one pass (columns of S)
  static constexpr int kTileElems = kRows * kLd;
  static constexpr size_t kTileBytes = sizeof(bf16) * kTileElems;
  static constexpr size_t kVecBytes = sizeof(float) * kRows;
  // dQ: Q, dO, di of the CTA's rows; a stage is a K and a V tile
  static constexpr size_t kStageDQ = 2 * kTileBytes;
  static constexpr size_t kDQ = 2 * kTileBytes + kVecBytes + kStages * kStageDQ;
  // dK/dV: K, V; a stage is a Q and a dO tile, then lse and di
  static constexpr size_t kStageDKV = 2 * kTileBytes + 2 * kVecBytes;
  static constexpr size_t kDKV = 2 * kTileBytes + kStages * kStageDKV;
  // registers: at most 168 a thread (3 CTAs an SM) to dh 64, 255 at dh 128
  static constexpr int kMinBlocks = DH <= 64 ? 3 : 2;
};

// Start copying rows [0, 64) of a [rows][DH] bf16 block into a tile (rows
// at or past `valid` become zeros, and nothing past them is read).
template <int DH, typename T>
__device__ __forceinline__ void cp_async_tile(T* dst, const T* src, int valid) {
  constexpr int kPerRow = DH / 8;  // 16-byte pieces of a row
  constexpr int kLd = MmaTiles<DH>::kLd;
#pragma unroll
  for (int it = 0; it < kRows * kPerRow / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kPerRow, c = i % kPerRow * 8;
    const bool in = r < valid;
    ptt::frag::cp_async_16(dst + r * kLd + c, in ? src + static_cast<int64_t>(r) * DH + c : src, in);
  }
}

// Write a warp's 16 x DH float32 accumulator fragments, rounded, to rows
// [row0, row0 + 16) of a [rows][DH] bf16 tensor; rows at or past `valid` are
// not written.
template <int DH, typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[DH / 8][4], int row0,
                                           int valid) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= valid) continue;
    T* p = dst + static_cast<int64_t>(row) * DH + c2;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) = ptt::frag::pack2<T>(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 forward.

// m16 tiles of query rows a warp owns, and keys a warp takes in one pass, at
// dh <= 64 (dh 128 takes one tile: two would hold 128 accumulator
// registers).  At [8, 12, 2048, 64] on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/port_attention_variants.py) 2 tiles and 32 keys beat 1 tile and
// 64 keys by 5%; 2 tiles and 64 keys were faster still but spilled.
constexpr int kFwdWarpTiles = 2;
constexpr int kFwdChunk = 32;

// Shapes of the bf16 forward: a CTA's Q tile, then a ring of kStages K and V
// tile pairs, [rows][DH + 8] bf16 as in MmaTiles.
template <int DH>
struct FwdTiles {
  static constexpr int kMT = DH <= 64 ? kFwdWarpTiles : 1;
  static constexpr int kC = DH <= 64 ? kFwdChunk : 64;
  static constexpr int kWarpRows = 16 * kMT;
  static constexpr int kRowsQ = 4 * kWarpRows;  // query rows a CTA owns
  static constexpr int kLd = MmaTiles<DH>::kLd;
  static constexpr int kStages = MmaTiles<DH>::kStages;
  static constexpr int kTileElems = MmaTiles<DH>::kTileElems;  // one K or V tile
  static constexpr size_t kBytes = sizeof(bf16) * (kRowsQ * kLd + kStages * 2 * kTileElems);
  // registers: at most 168 a thread (3 CTAs an SM) with 16 rows a warp to
  // dh 64, else 255 (2 CTAs: 32 rows a warp hold twice the fragments)
  static constexpr int kMinBlocks = DH <= 64 && kMT == 1 ? 3 : 2;
};

// Forward, per pass of N keys that needs checks (ragged keys, a bias,
// causal keys past the diagonal, or a scale <= 0): the lane's raw scores
// become (s * scale + bias) * log2(e), kMasked * log2(e) where causal masks
// them, and -inf past the end of the keys.  Element (m, j, e) is query row
// r + 16 m + 8 (e / 2) of the CTA and key column c + 8 j + e % 2 of the pass.
template <int MT, int N>
__device__ __forceinline__ void fwd_edge_scores(float (&s)[MT][N / 8][4], const Problem& pr,
                                                const float* bias, int q0, int k0, int r, int c,
                                                int q_rows, int kv_rows) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r + 16 * m + 8 * (e >> 1), col = c + 8 * j + (e & 1);
        float x = -INFINITY;  // past the end of the keys: no weight at all
        if (col < kv_rows) {
          const int qi = q0 + row, kc = k0 + col;
          x = s[m][j][e] * pr.scale;
          if (row < q_rows) {
            if (bias != nullptr) x += bias[static_cast<int64_t>(qi) * pr.Lk + kc];
            if (pr.masked(qi, kc)) x = kMasked;
          }
          x *= kLog2e;
        }
        s[m][j][e] = x;
      }
}

// bf16(x), as a float: the one rounding of a score in the bf16-score variant.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// out = attention(q, k, v) and lse, bf16 or f16 (T).  One CTA per (b*h, kRowsQ query
// rows), each warp kWarpRows of them; Q held as A fragments, K and V tiles
// through the cp.async ring, S, P, the running max and sum and O in
// registers (see the note at the top).  The bf16-score forward of bf16
// inputs is a kernel of its own (attention_fwd_bs.cu).
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, FwdTiles<DH>::kMinBlocks)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ bias,
                         T* __restrict__ out, float* __restrict__ lse, Problem pr) {
  using F = FwdTiles<DH>;
  constexpr int kLd = F::kLd, kMT = F::kMT, kC = F::kC;
  namespace fr = ptt::frag;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* ring = Qs + F::kRowsQ * kLd;  // stage st: K, then V
  auto k_tile = [&](int st) { return ring + 2 * st * F::kTileElems; };

  const int bh = blockIdx.y, q0 = blockIdx.x * F::kRowsQ;
  const int q_rows = min(F::kRowsQ, pr.Lq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wr = warp * F::kWarpRows;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int64_t row0 = static_cast<int64_t>(bh) * pr.Lq + q0;
  const T* kp = k + static_cast<int64_t>(bh) * pr.Lk * DH;
  const T* vp = v + static_cast<int64_t>(bh) * pr.Lk * DH;
  const float* bias_bh = pr.bias_of(bias, bh);
  const int n_tiles = pr.key_tiles(q0 + q_rows);  // >= 1; the forward's key tiles
  const float scale_log2 = pr.scale * kLog2e;

  auto load_kv = [&](int t, int st) {
    const int k0 = t * kRows, rows = min(kRows, pr.Lk - k0);
    cp_async_tile<DH>(k_tile(st), kp + static_cast<int64_t>(k0) * DH, rows);
    cp_async_tile<DH>(k_tile(st) + F::kTileElems, vp + static_cast<int64_t>(k0) * DH, rows);
    fr::cp_async_commit();
  };
#pragma unroll
  for (int h = 0; h < F::kRowsQ / kRows; ++h) {  // Q, 64 rows at a time
    const int rows = q_rows - h * kRows;
    cp_async_tile<DH>(Qs + h * kRows * kLd, q + (row0 + (rows > 0 ? h * kRows : 0)) * DH, rows);
  }
  load_kv(0, 0);  // one group with Q

  uint32_t qa[kMT][DH / 16][4];
  float o[kMT][DH / 8][4] = {};
  // rows wr + 16 m + g + 8 h: the running max of the scores in log2 units,
  // and this lane's share of the running sum of P
  float m_run[kMT][2], l_run[kMT][2];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_run[m][h] = -INFINITY;
      l_run[m][h] = 0.f;
    }
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % F::kStages;
    if (t + 1 < n_tiles) {
      load_kv(t + 1, (t + 1) % F::kStages);
      fr::cp_async_wait<1>();
    } else {
      fr::cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and at t = 0 Q) landed for every thread
    if (t == 0) {
#pragma unroll
      for (int m = 0; m < kMT; ++m) fr::load_a<DH>(qa[m], Qs + (wr + 16 * m) * kLd, kLd);
    }
    const int k0 = t * kRows, kv_rows = min(kRows, pr.Lk - k0);
#pragma unroll
    for (int c0 = 0; c0 < kRows; c0 += kC) {
      const T* Kc = k_tile(st) + c0 * kLd;
      float s[kMT][kC / 8][4] = {};
      fr::gemm_nt_rows<kMT, DH, kC>(s, qa, Kc, kLd);
      const bool edge = bias_bh != nullptr || kv_rows < c0 + kC || !(pr.scale > 0.f) ||
                        (pr.causal && k0 + c0 + kC - 1 > q0 + wr + pr.offset());
      if (edge)
        fwd_edge_scores<kMT, kC>(s, pr, bias_bh, q0, k0 + c0, wr + g, c2, q_rows, kv_rows - c0);
      // the edge path's scores are in log2 units already; the others are
      // raw, and scale > 0 keeps their max where it is
      const float mul = edge ? 1.f : scale_log2;
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < kC / 8; ++j) mx = fmaxf(mx, fmaxf(s[m][j][2 * h], s[m][j][2 * h + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          // finite from the first pass on: it holds key 0, a real key
          const float m_new = fmaxf(m_run[m][h], mx * mul);
          const float alpha = fr::exp2_approx(m_run[m][h] - m_new);  // 0 on the first pass
          m_run[m][h] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < kC / 8; ++j)
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e) {
              const float p = fr::exp2_approx(fmaf(s[m][j][e], mul, -m_new));
              s[m][j][e] = p;
              sum += p;
            }
          l_run[m][h] = l_run[m][h] * alpha + sum;
#pragma unroll
          for (int j = 0; j < DH / 8; ++j) {
            o[m][j][2 * h] *= alpha;
            o[m][j][2 * h + 1] *= alpha;
          }
        }
      uint32_t pa[kMT][kC / 16][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m) fr::to_a<kC, T>(pa[m], s[m]);  // P rounded to T
      fr::gemm_nn_rows<kMT, kC, DH>(o, pa, Kc + F::kTileElems, kLd);  // V
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[m][h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[h] = 1.f / l;
      const int row = wr + 16 * m + g + 8 * h;
      if (c2 == 0 && row < q_rows) lse[row0 + row] = (m_run[m][h] + log2f(l)) * kLn2;
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[m][j][e] *= inv[e >> 1];
    store_rows<DH>(out + row0 * DH, o[m], wr + 16 * m, q_rows);
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 backward.

// dQ kernel, per pass of N keys: S (this lane's fragments) becomes dS = P *
// (dP - di) * scale with P = exp(S * scale + bias - lse), in place.  The
// lane's element (j, e) is query row r + 8 * (e / 2) of the CTA and key
// column c + 8 * j + e % 2 of the tile.  kEdge: the tile has ragged rows or
// columns, masked scores or a bias, each checked per element (P and dS of
// a masked or absent score are 0); else none of them.
template <bool kEdge, int N>
__device__ __forceinline__ void dq_scores(float (&s)[N / 8][4], const float (&dp)[N / 8][4],
                                          const float (&lse)[2], const float (&di)[2],
                                          const Problem& pr, const float* bias, int q0, int k0,
                                          int r, int c, int q_rows, int kv_rows) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float p;
      if constexpr (kEdge) {
        const int row = r + 8 * h, col = c + 8 * j + (e & 1);
        const int qi = q0 + row, kc = k0 + col;
        p = 0.f;
        if (row < q_rows && col < kv_rows && !pr.masked(qi, kc)) {
          float x = s[j][e] * pr.scale;
          if (bias != nullptr) x += bias[static_cast<int64_t>(qi) * pr.Lk + kc];
          p = exp2f((x - lse[h]) * kLog2e);
        }
      } else {
        p = exp2f((s[j][e] * pr.scale - lse[h]) * kLog2e);
      }
      s[j][e] = p * (dp[j][e] - di[h]) * pr.scale;
    }
}

// dK/dV kernel, per pass of N queries: S^T (keys x queries) becomes P^T in
// place.  The lane's element (j, e) is key row r + 8 * (e / 2) of the CTA
// and query column c + 8 * j + e % 2 of the tile; lse holds the tile's 64
// values.  A masked score's P is 0, or 1/Lk in a query row with no visible
// key (its scores are all the constant -1e30: the uniform average).
template <bool kEdge, int N>
__device__ __forceinline__ void dkv_probs(float (&s)[N / 8][4], const float* lse,
                                          const Problem& pr, const float* bias, int q0, int k0,
                                          int r, int c, int q_rows, int k_rows) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse + c + 8 * j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lq = e & 1 ? l.y : l.x;
      if constexpr (kEdge) {
        const int row = r + 8 * (e >> 1), col = c + 8 * j + (e & 1);
        const int kc = k0 + row, qi = q0 + col;
        float p = 0.f;
        if (col < q_rows && row < k_rows) {
          if (pr.masked(qi, kc)) {
            p = qi + pr.offset() < 0 ? 1.f / pr.Lk : 0.f;
          } else {
            float x = s[j][e] * pr.scale;
            if (bias != nullptr) x += bias[static_cast<int64_t>(qi) * pr.Lk + kc];
            p = exp2f((x - lq) * kLog2e);
          }
        }
        s[j][e] = p;
      } else {
        s[j][e] = exp2f((s[j][e] * pr.scale - lq) * kLog2e);
      }
    }
  }
}

// dK/dV kernel: dS^T = P^T * (dP^T - di) * scale, 0 at masked scores, into dp.
template <bool kEdge, int N>
__device__ __forceinline__ void dkv_dscores(float (&dp)[N / 8][4], const float (&p)[N / 8][4],
                                            const float* di, const Problem& pr, int q0, int k0,
                                            int r, int c) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 d = *reinterpret_cast<const float2*>(di + c + 8 * j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float ds = p[j][e] * (dp[j][e] - (e & 1 ? d.y : d.x)) * pr.scale;
      if constexpr (kEdge) {
        if (pr.masked(q0 + c + 8 * j + (e & 1), k0 + r + 8 * (e >> 1))) ds = 0.f;
      }
      dp[j][e] = ds;
    }
  }
}

// dQ (and di = rowsum(dO * O), which the dK/dV kernel reads after it), bf16 or f16.
// One CTA per (b*h, 64 query rows), each warp 16 of them.  Q and dO load
// once and stay as A fragments in registers; K and V tiles of 64 keys
// stream through a 2-stage cp.async ring; per pass of 32 keys a warp does
// S = Q K^T and dP = dO V^T, dS = P (dP - di) scale rounded to bf16 as the A
// fragments of dQ += dS K, all in registers.  (The bf16-score dQ of bf16
// inputs is a kernel of its own, attention_bwd_bs.cu.)
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, MmaTiles<DH>::kMinBlocks)
    attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const float* __restrict__ bias,
                            const T* __restrict__ out, const T* __restrict__ dout,
                            const float* __restrict__ lse, float* __restrict__ di,
                            T* __restrict__ dq, Problem pr) {
  using M = MmaTiles<DH>;
  constexpr int kLd = M::kLd, kC = M::kChunk;
  namespace fr = ptt::frag;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Qs = cv.take<T>(M::kTileBytes);
  T* dOs = cv.take<T>(M::kTileBytes);
  float* di_s = cv.take<float>(M::kVecBytes);
  T* ring = cv.take<T>(M::kStages * M::kStageDQ);  // stage st: K, then V
  auto k_tile = [&](int st) { return ring + 2 * st * M::kTileElems; };

  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int q_rows = min(kRows, pr.Lq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wr = warp * 16;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int64_t row0 = static_cast<int64_t>(bh) * pr.Lq + q0;
  const T* kp = k + static_cast<int64_t>(bh) * pr.Lk * DH;
  const T* vp = v + static_cast<int64_t>(bh) * pr.Lk * DH;
  const float* bias_bh = pr.bias_of(bias, bh);
  const int n_tiles = pr.key_tiles(q0 + q_rows);  // >= 1: every row sees key 0 or all keys

  auto load_kv = [&](int t, int st) {
    const int k0 = t * kRows, rows = min(kRows, pr.Lk - k0);
    cp_async_tile<DH>(k_tile(st), kp + static_cast<int64_t>(k0) * DH, rows);
    cp_async_tile<DH>(k_tile(st) + M::kTileElems, vp + static_cast<int64_t>(k0) * DH, rows);
    fr::cp_async_commit();
  };
  cp_async_tile<DH>(Qs, q + row0 * DH, q_rows);
  cp_async_tile<DH>(dOs, dout + row0 * DH, q_rows);
  load_kv(0, 0);  // one group with Q and dO

  // di of the warp's rows from O and dO in device memory, while the copies
  // fly: DH / 8 lanes a row, 16 bytes a lane
  {
    constexpr int kLanes = DH / 8, kPerPass = 32 / kLanes;
    for (int r0 = 0; r0 < 16; r0 += kPerPass) {
      const int row = wr + r0 + lane / kLanes, c = lane % kLanes * 8;
      float acc = 0.f;
      if (row < q_rows) {
        float of[8], df[8];
        ptt::unpack(*reinterpret_cast<const ptt::Vec<T, 8>*>(out + (row0 + row) * DH + c), of);
        ptt::unpack(*reinterpret_cast<const ptt::Vec<T, 8>*>(dout + (row0 + row) * DH + c), df);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc += of[2 * i] * df[2 * i] + of[2 * i + 1] * df[2 * i + 1];
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane % kLanes == 0) {
        di_s[row] = acc;
        if (row < q_rows) di[row0 + row] = acc;
      }
    }
  }
  float lse_r[2], di_r[2];  // rows wr + g and wr + g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wr + g + 8 * h;
    lse_r[h] = row < q_rows ? lse[row0 + row] : 0.f;
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) di_r[h] = di_s[wr + g + 8 * h];

  uint32_t qa[DH / 16][4], doa[DH / 16][4];
  float acc[DH / 8][4] = {};
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % M::kStages;
    if (t + 1 < n_tiles) {
      load_kv(t + 1, (t + 1) % M::kStages);
      fr::cp_async_wait<1>();
    } else {
      fr::cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and at t = 0 Q and dO) landed for every thread
    if (t == 0) {
      fr::load_a<DH>(qa, Qs + wr * kLd, kLd);
      fr::load_a<DH>(doa, dOs + wr * kLd, kLd);
    }
    const int k0 = t * kRows, kv_rows = min(kRows, pr.Lk - k0);
    const bool edge = bias_bh != nullptr || q_rows < kRows || kv_rows < kRows ||
                      (pr.causal && k0 + kRows - 1 > q0 + pr.offset());
#pragma unroll
    for (int c0 = 0; c0 < kRows; c0 += kC) {
      const T* Kc = k_tile(st) + c0 * kLd;
      float s[kC / 8][4] = {}, dp[kC / 8][4] = {};
      fr::gemm_nt<DH, kC>(s, qa, Kc, kLd);
      fr::gemm_nt<DH, kC>(dp, doa, Kc + M::kTileElems, kLd);  // V
      if (edge)
        dq_scores<true, kC>(s, dp, lse_r, di_r, pr, bias_bh, q0, k0 + c0, wr + g, c2, q_rows,
                            kv_rows - c0);
      else
        dq_scores<false, kC>(s, dp, lse_r, di_r, pr, bias_bh, q0, k0 + c0, wr + g, c2, q_rows,
                             kv_rows - c0);
      uint32_t ds[kC / 16][4];
      fr::to_a<kC, T>(ds, s);  // dS rounded to T
      fr::gemm_nn<kC, DH>(acc, ds, Kc, kLd);
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  store_rows<DH>(dq + row0 * DH, acc, wr, q_rows);
}

// dK and dV, bf16 or f16, from the forward's lse and the dQ kernel's di.  One CTA
// per (b*h, 64 key rows), each warp 16 keys.  K and V load once into shared
// memory, whence ldmatrix takes their A fragments one k-step at a time (held
// in registers they would spill beside dK and dV); Q, dO, lse and di tiles
// of 64 queries stream through a 2-stage cp.async ring.  Per pass of 32 queries a
// warp does S^T = K Q^T, P^T in place, dV += bf16(P^T) dO, dP^T = V dO^T,
// dS^T rounded to T, dK += dS^T Q, all in registers.  (The bf16-score
// dK/dV of bf16 inputs is a kernel of its own, attention_bwd_bs.cu.)
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, MmaTiles<DH>::kMinBlocks)
    attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const float* __restrict__ bias,
                             const T* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ di, T* __restrict__ dk,
                             T* __restrict__ dv, Problem pr) {
  using M = MmaTiles<DH>;
  constexpr int kLd = M::kLd, kC = M::kChunk;
  constexpr size_t kStage = M::kStageDKV;
  namespace fr = ptt::frag;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Ks = cv.take<T>(M::kTileBytes);
  T* Vs = cv.take<T>(M::kTileBytes);
  unsigned char* ring = cv.take<unsigned char>(M::kStages * kStage);
  // stage st: Q, dO, then lse and di of its 64 queries
  auto q_tile = [&](int st) { return reinterpret_cast<T*>(ring + st * kStage); };
  auto lse_of = [&](int st) {
    return reinterpret_cast<float*>(ring + st * kStage + 2 * M::kTileBytes);
  };

  const int bh = blockIdx.y, k0 = blockIdx.x * kRows;
  const int k_rows = min(kRows, pr.Lk - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wr = warp * 16;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int64_t key0 = static_cast<int64_t>(bh) * pr.Lk + k0;
  const int64_t qrow0 = static_cast<int64_t>(bh) * pr.Lq;
  const float* bias_bh = pr.bias_of(bias, bh);
  // with Lq <= Lk, queries before k0 - (Lk - Lq) see none of these keys;
  // t_begin < t_end, since k0 - (Lk - Lq) < Lq
  int t_begin = 0;
  if (pr.causal && pr.Lk >= pr.Lq && k0 - pr.offset() > 0) t_begin = (k0 - pr.offset()) / kRows;
  const int t_end = (pr.Lq + kRows - 1) / kRows;

  auto load_q = [&](int t, int st) {
    const int q0 = t * kRows, rows = min(kRows, pr.Lq - q0);
    cp_async_tile<DH>(q_tile(st), q + (qrow0 + q0) * DH, rows);
    cp_async_tile<DH>(q_tile(st) + M::kTileElems, dout + (qrow0 + q0) * DH, rows);
    // threads 0-63 copy lse, 64-127 di (kThreads = 2 * kRows): 4 bytes
    // each, zeros past the end
    const int i = threadIdx.x % kRows;
    const float* src = (threadIdx.x < kRows ? lse : di) + qrow0 + q0;
    fr::cp_async_4(lse_of(st) + threadIdx.x, src + (i < rows ? i : 0), i < rows);
    fr::cp_async_commit();
  };
  cp_async_tile<DH>(Ks, k + key0 * DH, k_rows);
  cp_async_tile<DH>(Vs, v + key0 * DH, k_rows);
  load_q(t_begin, 0);  // one group with K and V

  const T* Kw = Ks + wr * kLd;  // the warp's 16 keys
  const T* Vw = Vs + wr * kLd;
  float dk_acc[DH / 8][4] = {}, dv_acc[DH / 8][4] = {};
  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) % M::kStages;
    if (t + 1 < t_end) {
      load_q(t + 1, (t + 1 - t_begin) % M::kStages);
      fr::cp_async_wait<1>();
    } else {
      fr::cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and at the first K and V) landed for every thread
    const int q0 = t * kRows, q_rows = min(kRows, pr.Lq - q0);
    const bool edge = bias_bh != nullptr || q_rows < kRows || k_rows < kRows ||
                      (pr.causal && k0 + kRows - 1 > q0 + pr.offset());
    // not unrolled: two passes interleaved by the compiler spill at dh 64
#pragma unroll 1
    for (int c0 = 0; c0 < kRows; c0 += kC) {
      const T* Qc = q_tile(st) + c0 * kLd;
      const T* dOc = Qc + M::kTileElems;
      const float* lse_c = lse_of(st) + c0;
      const float* di_c = lse_c + kRows;
      float s[kC / 8][4] = {};
      fr::gemm_nt_smem<DH, kC>(s, Kw, kLd, Qc, kLd);  // S^T: the warp's 16 keys x 32 queries
      if (edge)
        dkv_probs<true, kC>(s, lse_c, pr, bias_bh, q0 + c0, k0, wr + g, c2, q_rows - c0, k_rows);
      else
        dkv_probs<false, kC>(s, lse_c, pr, bias_bh, q0 + c0, k0, wr + g, c2, q_rows - c0,
                             k_rows);
      uint32_t a[kC / 16][4];
      fr::to_a<kC, T>(a, s);  // P^T rounded to T
      fr::gemm_nn<kC, DH>(dv_acc, a, dOc, kLd);
      float dp[kC / 8][4] = {};
      fr::gemm_nt_smem<DH, kC>(dp, Vw, kLd, dOc, kLd);  // dP^T
      if (edge)
        dkv_dscores<true, kC>(dp, s, di_c, pr, q0 + c0, k0, wr + g, c2);
      else
        dkv_dscores<false, kC>(dp, s, di_c, pr, q0 + c0, k0, wr + g, c2);
      fr::to_a<kC, T>(a, dp);  // dS^T rounded to T
      fr::gemm_nn<kC, DH>(dk_acc, a, Qc, kLd);
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  store_rows<DH>(dk + key0 * DH, dk_acc, wr, k_rows);
  store_rows<DH>(dv + key0 * DH, dv_acc, wr, k_rows);
}

// ---------------------------------------------------------------------------
// The float32 forward and backward: FFMA on the CUDA cores, tiles in shared
// memory.

// out = attention(q, k, v) and lse, float32: the warp's 16 rows one at a
// time, two key columns a lane, with a full-warp max and sum per row.
// kBS: the bf16-score variant (the composite's, as attention_fwd_bs.cu
// computes it for bf16 inputs): a first pass over the K tiles takes each
// row's max m of bf16(s), the second runs with m fixed and P =
// exp(bf16(bf16(s) - m)); lse = log l, rowmax = m.  T is float, or __half
// for the kBS variant of float16 inputs, which loads them as floats and
// rounds once on the store, as the float32 one; and rounds P / l to float16
// before the PV product, as the composite's p.astype(q.dtype) does: a
// second pass takes each row's sum l, a third the output with P / l, not
// divided at the end.
template <typename T, int DH, bool kBS>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const float* __restrict__ bias,
                             T* __restrict__ out, float* __restrict__ lse,
                             float* __restrict__ rowmax, Problem pr) {
  constexpr bool kRoundP = kBS && !std::is_same<T, float>::value;
  using L = Ld<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* Qs = cv.take<float>(L::kTileBytes);
  float* Ks = cv.take<float>(L::kTileBytes);
  float* Vs = cv.take<float>(L::kTileBytes);
  float* Sb = cv.take<float>(L::kFBytes);
  float* PT = cv.take<float>(L::kPBytes);
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

  load_tile<DH, L::kTile>(Qs, q + (static_cast<int64_t>(bh) * pr.Lq + q0) * DH, q_rows);
  for (int i = threadIdx.x; i < kRows * L::kAcc; i += kThreads) Ob[i] = 0.f;
  if (threadIdx.x < kRows) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }
  const int n_tiles = pr.key_tiles(q0 + q_rows);
  // row r's scores of the tile in Sb: s * scale + bias, kMasked where causal
  // masks them, -inf past the end of the keys; kBS rounds them to bf16
  auto row_scores = [&](int row, int k0, int kv_rows, float (&s)[2]) {
    const int qi = q0 + row;
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
        if constexpr (kBS) s[h] = round_bf16(s[h]);
      }
    }
  };
  if constexpr (kBS) {  // the first pass: each row's max, K tiles only
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kRows, kv_rows = min(kRows, pr.Lk - k0);
      __syncthreads();
      load_tile<DH, L::kTile>(Ks, kp + static_cast<int64_t>(k0) * DH, kv_rows);
      __syncthreads();
      warp_nt<DH, kRows>(Sb + wr * L::kF, L::kF, Qs + wr * L::kTile, L::kTile, Ks, L::kTile);
      __syncwarp();
      for (int r = 0; r < 16; ++r) {
        float s[2];
        row_scores(wr + r, k0, kv_rows, s);
        const float mx = ptt::warp_max(fmaxf(s[0], s[1]));
        if (lane == 0) m_s[wr + r] = fmaxf(m_s[wr + r], mx);
      }
      __syncwarp();
    }
  }
  if constexpr (kRoundP) {  // the sum pass: each row's l, K tiles only
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kRows, kv_rows = min(kRows, pr.Lk - k0);
      __syncthreads();
      load_tile<DH, L::kTile>(Ks, kp + static_cast<int64_t>(k0) * DH, kv_rows);
      __syncthreads();
      warp_nt<DH, kRows>(Sb + wr * L::kF, L::kF, Qs + wr * L::kTile, L::kTile, Ks, L::kTile);
      __syncwarp();
      for (int r = 0; r < 16; ++r) {
        float s[2];
        row_scores(wr + r, k0, kv_rows, s);
        const float m = m_s[wr + r];
        const float psum = ptt::warp_sum(expf(round_bf16(s[0] - m)) + expf(round_bf16(s[1] - m)));
        if (lane == 0) l_s[wr + r] += psum;
      }
      __syncwarp();
    }
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kRows, kv_rows = min(kRows, pr.Lk - k0);
    __syncthreads();  // the previous K/V tiles are consumed
    load_tile<DH, L::kTile>(Ks, kp + static_cast<int64_t>(k0) * DH, kv_rows);
    load_tile<DH, L::kTile>(Vs, vp + static_cast<int64_t>(k0) * DH, kv_rows);
    __syncthreads();
    warp_nt<DH, kRows>(Sb + wr * L::kF, L::kF, Qs + wr * L::kTile, L::kTile, Ks, L::kTile);
    __syncwarp();
    // the warp's 16 rows one at a time, two key columns a lane
    for (int r = 0; r < 16; ++r) {
      const int row = wr + r;
      float s[2];
      row_scores(row, k0, kv_rows, s);
      // tile 0 holds a real key, so m_new is finite from the first tile on
      // (kBS: m is the row's max from the first pass, fixed)
      const float m_old = m_s[row];
      const float m_new = kBS ? m_old : fmaxf(m_old, ptt::warp_max(fmaxf(s[0], s[1])));
      float p0, p1;
      if constexpr (kRoundP) {  // P / l, rounded to T
        p0 = round_to<T>(expf(round_bf16(s[0] - m_new)) / l_s[row]);
        p1 = round_to<T>(expf(round_bf16(s[1] - m_new)) / l_s[row]);
      } else if constexpr (kBS) {
        p0 = expf(round_bf16(s[0] - m_new));
        p1 = expf(round_bf16(s[1] - m_new));
      } else {
        p0 = expf(s[0] - m_new);
        p1 = expf(s[1] - m_new);
      }
      PT[row * L::kP + lane] = p0;
      PT[row * L::kP + lane + 32] = p1;
      const float psum = kRoundP ? 0.f : ptt::warp_sum(p0 + p1);  // kRoundP: l is known
      if (lane == 0) {
        // 0 on the first tile (m_old = -inf); kBS: 1, nothing to rescale
        const float alpha = kBS ? 1.f : expf(m_old - m_new);
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
    warp_nn_acc<kRows, DH>(Ob + wr * L::kAcc, L::kAcc, PT + wr * L::kP, L::kP, Vs, L::kTile);
  }
  __syncwarp();
  T* op = out + (static_cast<int64_t>(bh) * pr.Lq + q0) * DH;
  for (int e = lane; e < 16 * DH; e += 32) {
    const int row = wr + e / DH;
    if (row < q_rows) {
      const float o = Ob[row * L::kAcc + e % DH];
      op[static_cast<int64_t>(row) * DH + e % DH] = ptt::from_f32<T>(kRoundP ? o : o / l_s[row]);
    }
  }
  if (lane < 16 && wr + lane < q_rows) {
    const int64_t i = static_cast<int64_t>(bh) * pr.Lq + q0 + wr + lane;
    if constexpr (kBS) {
      lse[i] = logf(l_s[wr + lane]);
      rowmax[i] = m_s[wr + lane];
    } else {
      lse[i] = m_s[wr + lane] + logf(l_s[wr + lane]);
    }
  }
}

// dQ (and di = rowsum(dO * O), which the dK/dV kernel reads after it).
// (kBS: P and dS as in dq_scores, and the row max's cotangent: g =
// bf16(P (dP - di)) summed over each row in float32 and rounded once, dm =
// -that, t = bf16(dm / c) over the row's c ties (x - m is 0), written to
// di + B H Lq for the dK/dV kernel; each tie a takes bf16(g_a + t) in place
// of g_a.  A row's first kTies ties are kept (key, g) in shared memory in
// key order, and their share, scale (bf16(g + t) - g) K_a, goes into the
// accumulator after the loop; a row with more takes it in a second pass
// over the key tiles.)
// (T: float, or __half for the kBS variant of float16 inputs: loaded as
// floats, dq rounded once on the store; dS stays float32 after its bf16
// rounding, as the composite's cotangent of the scores does.)
template <typename T, int DH, bool kBS>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const float* __restrict__ bias,
                                const T* __restrict__ out, const T* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ rowmax,
                                float* __restrict__ di, T* __restrict__ dq, Problem pr) {
  using L = Ld<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* Qs = cv.take<float>(L::kTileBytes);
  float* dOs = cv.take<float>(L::kTileBytes);
  float* Ks = cv.take<float>(L::kTileBytes);
  float* Vs = cv.take<float>(L::kTileBytes);
  float* Sb = cv.take<float>(L::kFBytes);  // S, then dP
  float* PT = cv.take<float>(L::kPBytes);  // P, then dS
  float* dQb = cv.take<float>(L::kAccBytes);
  float* lse_s = cv.take<float>(L::kVecBytes);
  float* di_s = cv.take<float>(L::kVecBytes);
  float* m_s = kBS ? cv.take<float>(L::kVecBytes) : nullptr;
  int* tie_key = kBS ? cv.take<int>(L::kTieBytes) : nullptr;
  float* tie_g = kBS ? reinterpret_cast<float*>(tie_key + kRows * L::kTies) : nullptr;

  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int q_rows = min(kRows, pr.Lq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wr = warp * 16;
  const int64_t row0 = static_cast<int64_t>(bh) * pr.Lq + q0;
  const T* kp = k + static_cast<int64_t>(bh) * pr.Lk * DH;
  const T* vp = v + static_cast<int64_t>(bh) * pr.Lk * DH;
  const float* bias_bh = pr.bias_of(bias, bh);

  load_tile<DH, L::kTile>(Qs, q + row0 * DH, q_rows);
  load_tile<DH, L::kTile>(dOs, dout + row0 * DH, q_rows);
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
      if constexpr (kBS) m_s[row] = row < q_rows ? rowmax[row0 + row] : 0.f;
      if (row < q_rows) di[row0 + row] = acc;
    }
  }
  // kBS: the lane's sums of g over its keys of the warp's 16 rows, the
  // rows' tie counts (warp-uniform), and after the loop the rows' t and
  // whether they overflow their slots (bit r)
  float dmacc[16];
  int tcnt[16];
  float t_r[16];
  uint32_t over = 0u;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    dmacc[r] = t_r[r] = 0.f;
    tcnt[r] = 0;
  }
  const int n_tiles = pr.key_tiles(q0 + q_rows);
  // key tile t; the second pass (fix) adds only the overflowing rows'
  // share of their ties
  auto tile = [&](int t, bool fix) {
    const int k0 = t * kRows, kv_rows = min(kRows, pr.Lk - k0);
    __syncthreads();
    load_tile<DH, L::kTile>(Ks, kp + static_cast<int64_t>(k0) * DH, kv_rows);
    load_tile<DH, L::kTile>(Vs, vp + static_cast<int64_t>(k0) * DH, kv_rows);
    __syncthreads();
    warp_nt<DH, kRows>(Sb + wr * L::kF, L::kF, Qs + wr * L::kTile, L::kTile, Ks, L::kTile);
    __syncwarp();
    uint32_t ties = 0u;  // kBS: bit 2 r + h, score (wr + r, lane + 32 h) tied at m
    for (int r = 0; r < 16; ++r) {  // P = exp(S - lse) where it feeds dS
      const int row = wr + r, qi = q0 + row;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h, kc = k0 + c;
        float p = 0.f;
        if (c < kv_rows && row < q_rows && !pr.masked(qi, kc)) {
          float s = Sb[row * L::kF + c] * pr.scale;
          if (bias_bh != nullptr) s += bias_bh[static_cast<int64_t>(qi) * pr.Lk + kc];
          if constexpr (kBS) {
            s = round_bf16(round_bf16(s) - m_s[row]);
            ties |= (s == 0.f ? 1u : 0u) << (2 * r + h);
          }
          p = expf(s - lse_s[row]);
        }
        PT[row * L::kP + c] = p;
      }
    }
    __syncwarp();
    warp_nt<DH, kRows>(Sb + wr * L::kF, L::kF, dOs + wr * L::kTile, L::kTile, Vs, L::kTile);
    __syncwarp();
    if constexpr (!kBS) {
      for (int e = lane; e < 16 * kRows; e += 32) {  // dS; 0 where the score is a constant
        const int row = wr + e / kRows, c = e % kRows;
        const float ds = PT[row * L::kP + c] * (Sb[row * L::kF + c] - di_s[row]);
        PT[row * L::kP + c] = ds * pr.scale;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {  // the same, element e = lane + 32 i: row wr + i / 2
        const int e = lane + 32 * i, row = wr + e / kRows, c = e % kRows;
        float ds = round_bf16(PT[row * L::kP + c] * (Sb[row * L::kF + c] - di_s[row]));
        const bool tie = (ties >> i) & 1u;
        if (fix) {
          ds = tie && ((over >> (i / 2)) & 1u) ? round_bf16(ds + t_r[i / 2]) - ds : 0.f;
        } else {
          dmacc[i / 2] += ds;
          const uint32_t b = __ballot_sync(0xffffffffu, tie);
          if (b != 0u) {  // the row's ties in key order: the lane's slot
            const int at = tcnt[i / 2] + __popc(b & ((1u << lane) - 1u));
            if (tie && at < L::kTies) {
              tie_key[row * L::kTies + at] = k0 + c;
              tie_g[row * L::kTies + at] = ds;
            }
            tcnt[i / 2] += __popc(b);
          }
        }
        PT[row * L::kP + c] = ds * pr.scale;
      }
    }
    __syncwarp();
    warp_nn_acc<kRows, DH>(dQb + wr * L::kAcc, L::kAcc, PT + wr * L::kP, L::kP, Ks,
                           L::kTile);
  };
  for (int t = 0; t < n_tiles; ++t) tile(t, false);
  if constexpr (kBS) {
    float* tie_out = di + static_cast<int64_t>(gridDim.y) * pr.Lq;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float sum = __shfl_sync(0xffffffffu, ptt::warp_sum(dmacc[r]), 0);
      const int c = tcnt[r];
      t_r[r] = c > 0 ? round_bf16(round_bf16(-sum) / static_cast<float>(c)) : 0.f;
      over |= (c > L::kTies ? 1u : 0u) << r;
      if (lane == 0 && wr + r < q_rows) tie_out[row0 + wr + r] = t_r[r];
    }
    if (__syncthreads_or(over != 0u))
      for (int t = 0; t < n_tiles; ++t) tile(t, true);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {  // the other rows' ties, from the slots
      const int row = wr + r, ties = (over >> r) & 1u ? 0 : tcnt[r];
      for (int j = 0; j < ties; ++j) {
        const float g = tie_g[row * L::kTies + j];
        const float corr = pr.scale * (round_bf16(g + t_r[r]) - g);
        const T* krow = kp + static_cast<int64_t>(tie_key[row * L::kTies + j]) * DH;
        for (int c = lane; c < DH; c += 32) dQb[row * L::kAcc + c] += corr * ptt::to_f32(krow[c]);
      }
    }
  }
  __syncwarp();
  for (int e = lane; e < 16 * DH; e += 32) {
    const int row = wr + e / DH;
    if (row < q_rows) dq[(row0 + row) * DH + e % DH] = ptt::from_f32<T>(dQb[row * L::kAcc + e % DH]);
  }
}

// (kBS: P and dS as in dkv_probs and dkv_dscores.  T: float, or __half for
// the kBS variant of float16 inputs: loaded as floats, dk and dv rounded
// once on the store, P rounded to float16 in dV += P^T dO, as the
// composite's p.astype(q.dtype) is, and dS from the unrounded P.)
template <typename T, int DH, bool kBS>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkv_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, const float* __restrict__ bias,
                                 const T* __restrict__ dout, const float* __restrict__ lse,
                                 const float* __restrict__ rowmax, const float* __restrict__ di,
                                 T* __restrict__ dk, T* __restrict__ dv, Problem pr) {
  using L = Ld<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* Ks = cv.take<float>(L::kTileBytes);
  float* Vs = cv.take<float>(L::kTileBytes);
  float* Qs = cv.take<float>(L::kTileBytes);
  float* dOs = cv.take<float>(L::kTileBytes);
  float* Sb = cv.take<float>(L::kFBytes);  // S^T, then dP^T
  float* PT = cv.take<float>(L::kPBytes);  // P^T, then dS^T
  float* dKb = cv.take<float>(L::kAccBytes);
  float* dVb = cv.take<float>(L::kAccBytes);
  float* lse_s = cv.take<float>(L::kVecBytes);
  float* di_s = cv.take<float>(L::kVecBytes);
  float* m_s = kBS ? cv.take<float>(L::kVecBytes) : nullptr;
  float* t_s = kBS ? cv.take<float>(L::kVecBytes) : nullptr;

  const int bh = blockIdx.y, k0 = blockIdx.x * kRows;
  const int k_rows = min(kRows, pr.Lk - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wr = warp * 16;
  const int64_t key0 = static_cast<int64_t>(bh) * pr.Lk + k0;
  const int64_t qrow0 = static_cast<int64_t>(bh) * pr.Lq;
  const float* bias_bh = pr.bias_of(bias, bh);
  const float uniform = 1.f / pr.Lk;  // P of a row with no visible key

  load_tile<DH, L::kTile>(Ks, k + key0 * DH, k_rows);
  load_tile<DH, L::kTile>(Vs, v + key0 * DH, k_rows);
  for (int i = threadIdx.x; i < kRows * L::kAcc; i += kThreads) dKb[i] = dVb[i] = 0.f;
  // with Lq <= Lk, queries before k0 - (Lk - Lq) see none of these keys
  int t_begin = 0;
  if (pr.causal && pr.Lk >= pr.Lq && k0 - pr.offset() > 0) t_begin = (k0 - pr.offset()) / kRows;
  const int t_end = (pr.Lq + kRows - 1) / kRows;
  for (int t = t_begin; t < t_end; ++t) {
    const int q0 = t * kRows, q_rows = min(kRows, pr.Lq - q0);
    __syncthreads();
    load_tile<DH, L::kTile>(Qs, q + (qrow0 + q0) * DH, q_rows);
    load_tile<DH, L::kTile>(dOs, dout + (qrow0 + q0) * DH, q_rows);
    if (threadIdx.x < kRows) {
      const bool in = static_cast<int>(threadIdx.x) < q_rows;
      lse_s[threadIdx.x] = in ? lse[qrow0 + q0 + threadIdx.x] : 0.f;
      di_s[threadIdx.x] = in ? di[qrow0 + q0 + threadIdx.x] : 0.f;
      if constexpr (kBS) {
        m_s[threadIdx.x] = in ? rowmax[qrow0 + q0 + threadIdx.x] : 0.f;
        t_s[threadIdx.x] = in ? di[static_cast<int64_t>(gridDim.y) * pr.Lq + qrow0 + q0 +
                                   threadIdx.x] : 0.f;
      }
    }
    __syncthreads();
    // S^T: the warp's 16 keys against the tile's 64 queries
    warp_nt<DH, kRows>(Sb + wr * L::kF, L::kF, Ks + wr * L::kTile, L::kTile, Qs, L::kTile);
    __syncwarp();
    uint32_t ties = 0u;  // kBS: bit 2 r + h, score (key wr + r, query lane + 32 h) tied at m
    for (int r = 0; r < 16; ++r) {
      const int row = wr + r, kc = k0 + row;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h, qi = q0 + j;
        float p = 0.f;
        if (j < q_rows && row < k_rows) {
          if constexpr (kBS) {
            float s = kMasked;
            const bool masked = pr.masked(qi, kc);
            if (!masked) {
              s = Sb[row * L::kF + j] * pr.scale;
              if (bias_bh != nullptr) s += bias_bh[static_cast<int64_t>(qi) * pr.Lk + kc];
            }
            s = round_bf16(round_bf16(s) - m_s[j]);
            ties |= (s == 0.f && !masked ? 1u : 0u) << (2 * r + h);
            p = expf(s - lse_s[j]);
          } else if (pr.masked(qi, kc)) {
            p = qi + pr.offset() < 0 ? uniform : 0.f;
          } else {
            float s = Sb[row * L::kF + j] * pr.scale;
            if (bias_bh != nullptr) s += bias_bh[static_cast<int64_t>(qi) * pr.Lk + kc];
            p = expf(s - lse_s[j]);
          }
        }
        PT[row * L::kP + j] = p;
      }
    }
    __syncwarp();
    warp_nn_acc<kRows, DH, T>(dVb + wr * L::kAcc, L::kAcc, PT + wr * L::kP, L::kP, dOs,
                              L::kTile);
    warp_nt<DH, kRows>(Sb + wr * L::kF, L::kF, Vs + wr * L::kTile, L::kTile, dOs, L::kTile);
    __syncwarp();
    if constexpr (!kBS) {
      for (int e = lane; e < 16 * kRows; e += 32) {
        const int row = wr + e / kRows, j = e % kRows, qi = q0 + j;
        float ds = 0.f;
        if (j < q_rows && row < k_rows && !pr.masked(qi, k0 + row))
          ds = PT[row * L::kP + j] * (Sb[row * L::kF + j] - di_s[j]);
        PT[row * L::kP + j] = ds * pr.scale;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {  // the same, key wr + i / 2, query lane + 32 (i % 2)
        const int e = lane + 32 * i, row = wr + e / kRows, j = e % kRows, qi = q0 + j;
        float ds = 0.f;
        if (j < q_rows && row < k_rows && !pr.masked(qi, k0 + row))
          ds = PT[row * L::kP + j] * (Sb[row * L::kF + j] - di_s[j]);
        ds = round_bf16(ds);
        if ((ties >> i) & 1u) ds = round_bf16(ds + t_s[j]);  // a tie takes its row's share
        PT[row * L::kP + j] = ds * pr.scale;
      }
    }
    __syncwarp();
    warp_nn_acc<kRows, DH>(dKb + wr * L::kAcc, L::kAcc, PT + wr * L::kP, L::kP, Qs,
                           L::kTile);
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

// ---------------------------------------------------------------------------
// Launch.

enum Which { kForward, kBwdDQ, kBwdDKV };

// Each kernel's pointer parameters (the ones it does not take are null).
struct Args {
  const void *q, *k, *v, *bias, *out, *dout;
  void *o_or_dq, *dk, *dv;
  float *lse_w;
  const float* lse_r;
  float* di_w;
  const float* di_r;
  float* m_w;  // the bf16-score variant's row maxima: the forward writes them
  const float* m_r;  // and the backward reads them
};

// Which kernels an instantiation takes: the mma.sync kernels for 16-bit
// inputs (bf16, f16) with f32 scores; the FFMA kernels for float32 inputs,
// and for f16 inputs with bf16 scores (their kBS twins, instantiated for
// __half loads).  (bf16 inputs with bf16 scores take the kernels of
// attention_fwd_bs.cu and attention_bwd_bs.cu: own_kernel.)
template <typename T, bool BS>
constexpr bool kMma = !std::is_same<T, float>::value && !BS;

template <typename T, int DH, bool BS>
const void* kernel_of(Which which) {
  if constexpr (kMma<T, BS>) {
    if (which == kForward) return reinterpret_cast<const void*>(attention_fwd_kernel<T, DH>);
    return which == kBwdDQ ? reinterpret_cast<const void*>(attention_bwd_dq_kernel<T, DH>)
                           : reinterpret_cast<const void*>(attention_bwd_dkv_kernel<T, DH>);
  } else {
    if (which == kForward)
      return reinterpret_cast<const void*>(attention_fwd_f32_kernel<T, DH, BS>);
    return which == kBwdDQ ? reinterpret_cast<const void*>(attention_bwd_dq_f32_kernel<T, DH, BS>)
                           : reinterpret_cast<const void*>(attention_bwd_dkv_f32_kernel<T, DH, BS>);
  }
}

// Dynamic shared memory of a kernel, in bytes.
template <typename T, int DH, bool BS>
size_t smem_of(Which which) {
  if constexpr (kMma<T, BS>) {
    if (which == kForward) return FwdTiles<DH>::kBytes;
    return which == kBwdDQ ? MmaTiles<DH>::kDQ : MmaTiles<DH>::kDKV;
  } else {
    if (which == kForward) return Ld<DH>::kFwd;
    // the row maxima, and dQ's tie slots or dK/dV's row max shares
    const size_t more = BS ? Ld<DH>::kVecBytes + (which == kBwdDQ ? Ld<DH>::kTieBytes
                                                                  : Ld<DH>::kVecBytes) : 0;
    return (which == kBwdDQ ? Ld<DH>::kDQ : Ld<DH>::kDKV) + more;
  }
}

// Rows of its own axis a CTA of the kernel owns (queries, or dK/dV's keys).
template <typename T, int DH, bool BS>
int cta_rows(Which which) {
  if constexpr (kMma<T, BS>)
    if (which == kForward) return FwdTiles<DH>::kRowsQ;
  return kRows;
}

template <typename T, int DH, bool BS>
cudaError_t set_smem_attribute(Which which) {
  const size_t bytes = smem_of<T, DH, BS>(which);
  if (bytes > 227u * 1024u) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel_of<T, DH, BS>(which),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

// The shared-memory attributes of an instantiation's three kernels, set
// once, at its first launch or query: a launch then makes no runtime call
// but its own, as a CUDA graph's capture wants.
template <typename T, int DH, bool BS>
cudaError_t prepare(Which which) {
  static const cudaError_t set[3] = {set_smem_attribute<T, DH, BS>(kForward),
                                     set_smem_attribute<T, DH, BS>(kBwdDQ),
                                     set_smem_attribute<T, DH, BS>(kBwdDKV)};
  return set[which];
}

// The bf16-score kernels of bf16 inputs are kernels of their own
// (attention_fwd_bs.cu, attention_bwd_bs.cu): launch one (a != null) or ask
// for its occupancy (into occ).
template <int DH>
cudaError_t own_kernel(Which which, const Args* a, int B, int H, const Problem& pr,
                       cudaStream_t s, int* occ) {
  static const Args none{};
  const Args& x = a != nullptr ? *a : none;
  if (which == kForward)
    return ptt::attention_fwd_bf16_scores(x.q, x.k, x.v, static_cast<const float*>(x.bias),
                                          x.o_or_dq, x.lse_w, x.m_w, B, H, pr.Lq, pr.Lk, DH,
                                          pr.bias_b_stride, pr.bias_h_stride, pr.scale,
                                          pr.causal, s, occ);
  if (which == kBwdDQ)
    return ptt::attention_bwd_dq_bf16_scores(x.q, x.k, x.v, x.bias, x.out, x.dout, x.lse_r,
                                             x.m_r, x.di_w, x.o_or_dq, B, H, pr.Lq, pr.Lk, DH,
                                             pr.bias_b_stride, pr.bias_h_stride, pr.scale,
                                             pr.causal, s, occ);
  return ptt::attention_bwd_dkv_bf16_scores(x.q, x.k, x.v, x.bias, x.dout, x.lse_r, x.m_r,
                                            x.di_r, x.dk, x.dv, B, H, pr.Lq, pr.Lk, DH,
                                            pr.bias_b_stride, pr.bias_h_stride, pr.scale,
                                            pr.causal, s, occ);
}

template <typename T, int DH, bool BS>
cudaError_t launch(Which which, Args a, int B, int H, Problem pr, cudaStream_t stream) {
  cudaError_t e = prepare<T, DH, BS>(which);
  if (e != cudaSuccess) return e;
  const int own = which == kBwdDKV ? pr.Lk : pr.Lq, rows = cta_rows<T, DH, BS>(which);
  const dim3 grid((own + rows - 1) / rows, static_cast<unsigned>(B) * H);
  // each kernel's parameters, in order (the FFMA kernels also take the row
  // maxima of their kBS variant)
  constexpr bool kMmaArgs = kMma<T, BS>;
  void* fwd[] = {&a.q, &a.k, &a.v, &a.bias, &a.o_or_dq, &a.lse_w, &pr};
  void* fwd_f32[] = {&a.q, &a.k, &a.v, &a.bias, &a.o_or_dq, &a.lse_w, &a.m_w, &pr};
  void* dq[] = {&a.q, &a.k, &a.v, &a.bias, &a.out, &a.dout, &a.lse_r, &a.di_w, &a.o_or_dq, &pr};
  void* dq_f32[] = {&a.q,   &a.k,   &a.v,    &a.bias,    &a.out, &a.dout,
                    &a.lse_r, &a.m_r, &a.di_w, &a.o_or_dq, &pr};
  void* dkv[] = {&a.q, &a.k, &a.v, &a.bias, &a.dout, &a.lse_r, &a.di_r, &a.dk, &a.dv, &pr};
  void* dkv_f32[] = {&a.q,   &a.k,   &a.v,    &a.bias, &a.dout, &a.lse_r,
                     &a.m_r, &a.di_r, &a.dk, &a.dv,   &pr};
  return cudaLaunchKernel(kernel_of<T, DH, BS>(which), grid, dim3(kThreads),
                          which == kForward ? (kMmaArgs ? fwd : fwd_f32)
                          : which == kBwdDQ ? (kMmaArgs ? dq : dq_f32)
                                            : (kMmaArgs ? dkv : dkv_f32),
                          smem_of<T, DH, BS>(which), stream);
}

// What the card makes of a kernel: out = {CTAs an SM holds, registers a
// thread, dynamic shared bytes a CTA, local (spilled) bytes a thread}.
template <typename T, int DH, bool BS>
cudaError_t occupancy(Which which, int* out) {
  cudaError_t e = prepare<T, DH, BS>(which);
  if (e != cudaSuccess) return e;
  const void* kern = kernel_of<T, DH, BS>(which);
  const size_t bytes = smem_of<T, DH, BS>(which);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kern, kThreads, bytes);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(bytes);
  out[3] = static_cast<int>(attr.localSizeBytes);
  return e;
}

template <typename T, int DH, bool BS>
cudaError_t launch_or_query(Which which, const Args* a, int B, int H, const Problem& pr,
                            cudaStream_t s, int* occ) {
  if constexpr (std::is_same<T, bf16>::value && BS)
    return own_kernel<DH>(which, a, B, H, pr, s, occ);
  else
    return a != nullptr ? launch<T, DH, BS>(which, *a, B, H, pr, s)
                        : occupancy<T, DH, BS>(which, occ);
}

template <typename T, bool BS>
cudaError_t dispatch_dh(Which which, const Args* a, int B, int H, int dh, const Problem& pr,
                        cudaStream_t s, int* occ) {
  switch (dh) {
    case 16: return launch_or_query<T, 16, BS>(which, a, B, H, pr, s, occ);
    case 32: return launch_or_query<T, 32, BS>(which, a, B, H, pr, s, occ);
    case 64: return launch_or_query<T, 64, BS>(which, a, B, H, pr, s, occ);
    case 128: return launch_or_query<T, 128, BS>(which, a, B, H, pr, s, occ);
    default: return cudaErrorInvalidValue;
  }
}

// Launch (a != null) or ask for the occupancy (into occ) of one instantiation.
template <typename T>
cudaError_t dispatch(Which which, const Args* a, int B, int H, int dh, int score_bf16,
                     const Problem& pr, cudaStream_t s, int* occ) {
  return score_bf16 ? dispatch_dh<T, true>(which, a, B, H, dh, pr, s, occ)
                    : dispatch_dh<T, false>(which, a, B, H, dh, pr, s, occ);
}

int run(Which which, const Args& a, const void* const* aligned, int n_aligned, int B, int H,
        int Lq, int Lk, int dh, int bias_heads, float scale, int causal, int dtype,
        int score_bf16, const void* rowmax, void* stream) {
  if (B < 0 || H < 0 || Lq < 0 || Lk < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Lq == 0 || (which == kBwdDKV && Lk == 0)) return 0;
  if (Lk == 0 || static_cast<int64_t>(B) * H > 65535 || (a.bias == nullptr) != (bias_heads == 0) ||
      (bias_heads != 0 && bias_heads != 1 && bias_heads != H) ||
      (rowmax == nullptr) != (score_bf16 == 0))
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
  if (dtype == ptt::kFloat32) return dispatch<float>(which, &a, B, H, dh, score_bf16, pr, s, nullptr);
  if (dtype == ptt::kBFloat16) return dispatch<bf16>(which, &a, B, H, dh, score_bf16, pr, s, nullptr);
  if (dtype == ptt::kFloat16)
    return dispatch<__half>(which, &a, B, H, dh, score_bf16, pr, s, nullptr);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Every tensor is contiguous and 16-byte aligned; q, out, dout, dq: [B, H, Lq,
// dh]; k, v, dk, dv: [B, H, Lk, dh], all of dtype `dtype` (0 float32, 1
// bfloat16, 2 float16); lse, di, rowmax: float32 [B, H, Lq]; bias: null (bias_heads 0)
// or float32 [B, bias_heads, Lq, Lk] with bias_heads 1 or H.  score_bf16
// picks the bf16-score variant, whose rowmax is not null (and is null
// otherwise).  Each launches on `stream` and returns the CUDA error code.

// out = attention(q, k, v), lse = the log-sum-exp of each score row (the
// bf16-score variant: lse = log l and rowmax = m, P = exp(bf16(bf16(s) - m) - lse)).
extern "C" int ptt_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                                 void* out, void* lse, void* rowmax, int B, int H, int Lq,
                                 int Lk, int dh, int bias_heads, float scale, int causal,
                                 int dtype, int score_bf16, void* stream) {
  Args a{q, k, v, bias, nullptr, nullptr, out, nullptr, nullptr,
         static_cast<float*>(lse), nullptr, nullptr, nullptr, static_cast<float*>(rowmax), nullptr};
  const void* al[] = {q, k, v, out};
  return run(kForward, a, al, 4, B, H, Lq, Lk, dh, bias_heads, scale, causal, dtype, score_bf16,
             rowmax, stream);
}

// dq, and di = rowsum(dout * out) for the dK/dV kernel, which runs after it.
extern "C" int ptt_attention_bwd_dq(const void* q, const void* k, const void* v,
                                    const void* bias, const void* out, const void* dout,
                                    const void* lse, const void* rowmax, void* di, void* dq,
                                    int B, int H, int Lq, int Lk, int dh, int bias_heads,
                                    float scale, int causal, int dtype, int score_bf16,
                                    void* stream) {
  Args a{q, k, v, bias, out, dout, dq, nullptr, nullptr, nullptr,
         static_cast<const float*>(lse), static_cast<float*>(di), nullptr, nullptr,
         static_cast<const float*>(rowmax)};
  const void* al[] = {q, k, v, out, dout, dq};
  return run(kBwdDQ, a, al, 6, B, H, Lq, Lk, dh, bias_heads, scale, causal, dtype, score_bf16,
             rowmax, stream);
}

// dk and dv, from the forward's lse (and rowmax) and the dQ kernel's di.
extern "C" int ptt_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                     const void* bias, const void* dout, const void* lse,
                                     const void* rowmax, const void* di, void* dk, void* dv,
                                     int B, int H, int Lq, int Lk, int dh, int bias_heads,
                                     float scale, int causal, int dtype, int score_bf16,
                                     void* stream) {
  Args a{q, k, v, bias, nullptr, dout, nullptr, dk, dv, nullptr,
         static_cast<const float*>(lse), nullptr, static_cast<const float*>(di), nullptr,
         static_cast<const float*>(rowmax)};
  const void* al[] = {q, k, v, dout, dk, dv};
  return run(kBwdDKV, a, al, 6, B, H, Lq, Lk, dh, bias_heads, scale, causal, dtype, score_bf16,
             rowmax, stream);
}

// out[0..3] = CTAs an SM holds, registers a thread, dynamic shared bytes a
// CTA and local (spilled) bytes a thread of one kernel: `which` 0 forward,
// 1 dQ, 2 dK/dV, at head dim `dh`, dtype `dtype` and score_bf16.
extern "C" int ptt_attention_occupancy(int which, int dh, int dtype, int score_bf16, int* out) {
  if (which < kForward || which > kBwdDKV) return static_cast<int>(cudaErrorInvalidValue);
  const Which w = static_cast<Which>(which);
  const Problem pr{};
  if (dtype == ptt::kFloat32)
    return dispatch<float>(w, nullptr, 0, 0, dh, score_bf16, pr, nullptr, out);
  if (dtype == ptt::kBFloat16)
    return dispatch<bf16>(w, nullptr, 0, 0, dh, score_bf16, pr, nullptr, out);
  if (dtype == ptt::kFloat16)
    return dispatch<__half>(w, nullptr, 0, 0, dh, score_bf16, pr, nullptr, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
