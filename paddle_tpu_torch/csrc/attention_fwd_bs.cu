// The bf16-score attention forward with bfloat16 inputs, a warpgroup kernel
// for Hopper.  The JAX composite's score_dtype="bfloat16"
// (paddle_tpu/ops/nn_ops.py:680-684):
//   x = bf16(s * scale + bias) (-1e30 where causal masks, rounded alike),
//   m = max_j x_j,  d_j = bf16(x_j - m),  l = sum_j exp(d_j) in float32,
//   out = bf16(sum_j bf16(exp(d_j) / l) v_j),  saved: log l and m.
// Replaces, for these inputs, the kBS variant of paddle_tpu/ops/
// pallas_attention.py _fused_sdpa_fwd (the pl.pallas_call at :193, row 10 bs
// of PERF.md's kernel table); flash_attention.cu keeps the f32-score
// forward, the float32-input twin and the backward kernels, and launches
// this one from ptt_attention_fwd.
//
// What bounds it on the H100: the function is 4 B H Lq Lk dh operations
// (Q K^T and P V), 104 us of bf16 tensor-core peak at [8, 12, 2048, 64],
// against 30 us of its bytes; at [32, 12, 128, 64] its 25 MB, 7.5 us.  An
// online softmax cannot compute it: bf16(s - m_j) under a running max is
// not bf16(s - m), and the composite rounds the normalized P / l, so m and
// l must both be known before P V.  Past those bounds the special-function
// unit bounds it: two exps a score (one for l, one for P), 0.8 G at
// [8, 12, 2048, 64], about 0.22 ms at 16 a clock an SM.  The design:
//   - Each score is computed once.  A CTA owns 64 query rows and a range of
//     key tiles (64 keys each).  Its score pass runs S = Q K^T on wgmma
//     m64n64k16 (Q and K from shared memory; tile i + 1's S in flight while
//     tile i's scores are worked), applies scale, bias and mask, takes the
//     row max of the raw float32 scores (rounding is monotonic, so bf16 of
//     that max is the max of the rounded scores: one rounding a row), and
//     keeps the rounded scores in a shared-memory buffer of kBufTiles tiles.
//     The sum pass reads them back, writes d = bf16(x - m) over them
//     (__hsub2: one rounding of the exact difference, which is what
//     rounding through float32 gives for two bf16 values: their float32
//     difference is exact whenever it is not far below bf16's resolution of
//     the larger) and sums exp(d).  The output pass reads d, forms P =
//     bf16(2^(d log2 e - log2 l)) in registers as the A operand of wgmma
//     (the register form; P of tile i + 1 is made while tile i's product
//     runs), with V from shared memory: 4 units of work, K read once and V
//     once.  The buffer is thread-private (each thread keeps its own
//     accumulator fragments, 16-byte vectors interleaved by thread), so no
//     thread waits for another between the passes.
//   - Longer rows split their keys over a thread-block cluster of up to
//     kMaxCluster CTAs (the least power of 2 whose buffers hold them).  The
//     partial row maxima and row sums, then the partial P V tiles (each CTA
//     sums the column groups j with j % C == rank), travel as st.async
//     stores that complete on the receiver's mbarrier: no cluster-scope
//     fence, which cost microseconds an exchange.  Each CTA folds the
//     parts in rank order, so two runs agree bit for bit.  Keys beyond what
//     the largest cluster holds are recomputed by the sum and output passes
//     (K loaded again for them).
//   - A producer warp keeps TMA loads of K (score pass) and V (output pass)
//     in flight through a ring of kStages tiles with full and empty mbarriers;
//     the tensor maps use the widest swizzle the rows allow (128 bytes at dh
//     64 and, in two boxes a tile, at dh 128), which the wgmma descriptors
//     read.  setmaxnreg moves registers from the producer warpgroup (40 a
//     thread) to the consumer warpgroup (216).  Two CTAs fit on an SM, so one
//     CTA's softmax work overlaps the other's products and exchanges.
//   - ptxas serializes a kernel's wgmma when a non-wgmma instruction writes
//     an accumulator inside a pipeline stage, or an accumulator is read in a
//     lane-dependent branch: the scores go to a separate array, the edge
//     tests are selects, and the score pass issues the next tile's S in
//     every step of its loop (a wgmma result merged at a branch would be
//     copied).  The build prints any "Potential Performance Loss" line.
// ptxas -v, sm_90a, dh 16 / 32 / 64 / 128: 128 registers a thread at launch
// (the consumers' 216 through setmaxnreg), 0 spill bytes, 81,000 / 91,240 /
// 111,720 / 103,512 dynamic shared bytes a CTA, 2 CTAs (16 warps) an SM
// (chip_smoke.py phase 2).
#include <cuda.h>

#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace h = ptt::sm90;

constexpr int kRowsBS = 64;       // query rows a CTA owns; keys a tile
constexpr int kConsumers = 128;   // the consumer warpgroup
constexpr int kThreadsBS = 256;   // and the producer warpgroup
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr float kMaskedBS = -1e30f;
constexpr float kLog2eBS = 1.4426950408889634f;
constexpr float kLn2BS = 0.6931471805599453f;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 216;  // 128 (40 + 216) = 256 threads x 128 registers

// Shapes of one instantiation; byte offsets from the 1024-aligned base of
// the dynamic shared memory.
template <int DH>
struct Bs {
  static constexpr int kBox = DH < 64 ? DH : 64;            // columns of one TMA box
  static constexpr int kSwizzle = kBox * 2;                 // its row, bytes: 32, 64, 128
  static constexpr int kBoxes = DH / kBox;                  // 2 at dh 128, else 1
  static constexpr int kBoxBytes = kRowsBS * kBox * 2;
  static constexpr int kTileBytes = kRowsBS * DH * 2;       // a Q, K or V tile
  static constexpr int kStages = DH == 128 ? 3 : 4;
  static constexpr int kBufTiles = DH == 128 ? 4 : 8;       // score tiles a CTA holds
  static constexpr int kScoreTileBytes = kRowsBS * kRowsBS * 2;
  static constexpr int kBufBytes = kBufTiles * kScoreTileBytes;
  static_assert(kBufBytes >= kRowsBS * DH * 4, "the partial O reuses the score buffer");
  static constexpr int kQ = 0;
  static constexpr int kRing = kQ + kTileBytes;
  static constexpr int kBuf = kRing + kStages * kTileBytes;
  static constexpr int kParts = kBuf + kBufBytes;  // row maxima, then row sums: [C][64] each
  static constexpr int kBars = kParts + 2 * kMaxCluster * kRowsBS * 4;
  static constexpr int kNumBars = 2 * kStages + 5;  // full, empty, Q, max, sum, free, O
  static constexpr int kBytes = kBars + kNumBars * 8 + 1024;  // + the alignment slack
};

struct BsArgs {
  const float* bias;  // null, or float32 [B, 1|H, Lq, Lk]
  bf16* out;
  float* lse;     // log l
  float* rowmax;  // m
  int H, Lq, Lk;
  int64_t bias_b_stride, bias_h_stride;
  float scale;
  int causal;
};

// Key tiles of the row block at q0 (with q_rows rows): with Lq <= Lk every
// row sees key 0, so causal tiles past the block's last visible key hold
// only scores whose exp(d) is exactly 0 and are skipped.
__host__ __device__ inline int row_block_tiles(int Lq, int Lk, int causal, int q_end) {
  int keys = Lk;
  if (causal && Lk >= Lq) keys = (q_end + Lk - Lq) < Lk ? q_end + Lk - Lq : Lk;
  return (keys + kRowsBS - 1) / kRowsBS;
}

// The path a launch takes: `cluster` CTAs share a row block, each takes
// `per_cta` of the longest row block's tiles, keeps `buffered` of them in its
// score buffer and recomputes the rest.
struct Plan {
  int cluster, per_cta, buffered, recomputed;
};

template <int DH>
Plan plan_of(int Lk) {
  const int tiles = (Lk + kRowsBS - 1) / kRowsBS;
  const int need = (tiles + Bs<DH>::kBufTiles - 1) / Bs<DH>::kBufTiles;
  int c = 1;
  while (c < need && c < kMaxCluster) c *= 2;
  const int per = (tiles + c - 1) / c;
  const int kept = per < Bs<DH>::kBufTiles ? per : Bs<DH>::kBufTiles;
  return Plan{c, per, kept, per - kept};
}

// The 16 packed words of a thread's 64 x 64 accumulator fragment: word k
// holds elements 2k and 2k + 1 (row half k % 2, key pair k / 2).
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float2 unpack2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ uint32_t sub2(uint32_t w, uint32_t m) {
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&w),
                                   *reinterpret_cast<const __nv_bfloat162*>(&m));
  return *reinterpret_cast<const uint32_t*>(&d);
}

template <int DH>
__global__ void __launch_bounds__(kThreadsBS, 2)
    attention_fwd_bf16_scores_kernel(const __grid_constant__ CUtensorMap tm_q,
                                     const __grid_constant__ CUtensorMap tm_k,
                                     const __grid_constant__ CUtensorMap tm_v, const BsArgs a) {
  using T = Bs<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (h::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = base + T::kRing;
  uint4* buf = reinterpret_cast<uint4*>(base + T::kBuf);
  float* max_parts = reinterpret_cast<float*>(base + T::kParts);
  float* sum_parts = max_parts + kMaxCluster * kRowsBS;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + T::kBars);
  uint64_t* empty = full + T::kStages;
  uint64_t* q_full = empty + T::kStages;
  uint64_t* max_bar = q_full + 1;   // the cluster's row maxima have arrived
  uint64_t* sum_bar = q_full + 2;   // its row sums
  uint64_t* buf_free = q_full + 3;  // every CTA's warps are done with their score buffers
  uint64_t* o_full = q_full + 4;    // this CTA's share of the partial P V has arrived

  const int C = static_cast<int>(h::cluster_size()), rank = static_cast<int>(h::cluster_rank());
  const int bh = blockIdx.y, q0 = (blockIdx.x / C) * kRowsBS;
  const int q_rows = min(kRowsBS, a.Lq - q0);
  const int n_all = row_block_tiles(a.Lq, a.Lk, a.causal, q0 + q_rows);
  const int per = (n_all + C - 1) / C;
  const int t_lo = min(n_all, rank * per), t_hi = min(n_all, t_lo + per);
  const int n = t_hi - t_lo, nb = min(n, T::kBufTiles);  // tiles; buffered tiles

  if (threadIdx.x == kConsumers) {  // the producer thread: barriers, then Q at once
    h::prefetch_tensor_map(&tm_q);
    h::prefetch_tensor_map(&tm_k);
    h::prefetch_tensor_map(&tm_v);
    for (int s = 0; s < T::kStages; ++s) {
      h::mbar_init(&full[s], 1);
      h::mbar_init(&empty[s], kConsumers / 32);
    }
    h::mbar_init(q_full, 1);
    // the cluster's exchanges: st.async bytes from every CTA (the row maxima
    // and sums: 32 threads x 8 bytes each; P V: this CTA's column groups,
    // 128 threads x 16 bytes a group from each), and for buf_free one
    // arrival from each consumer warp of each CTA
    const int groups = rank < DH / 8 ? (DH / 8 - rank + C - 1) / C : 0;
    h::mbar_init(max_bar, 1);
    h::mbar_arrive_expect_tx(max_bar, 256 * C);
    h::mbar_init(sum_bar, 1);
    h::mbar_arrive_expect_tx(sum_bar, 256 * C);
    h::mbar_init(buf_free, kConsumers / 32 * C);
    h::mbar_init(o_full, 1);
    h::mbar_arrive_expect_tx(o_full, C * groups * kConsumers * 16);
    h::fence_barrier_init();
    h::mbar_arrive_expect_tx(q_full, T::kTileBytes);
    for (int b = 0; b < T::kBoxes; ++b)
      h::tma_load_3d(base + T::kQ + b * T::kBoxBytes, &tm_q, q_full, b * T::kBox, q0, bh);
  }
  if (C > 1)
    h::cluster_sync_relaxed();  // every CTA's barriers exist before any peer uses them
  else
    __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup: one thread issues
    h::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      int item = 0;  // the consumer takes the ring's tiles in this order
      auto load = [&](const CUtensorMap* map, int t) {
        const int st = item % T::kStages;
        h::mbar_wait(&empty[st], ((item / T::kStages) & 1) ^ 1);
        h::mbar_arrive_expect_tx(&full[st], T::kTileBytes);
        for (int b = 0; b < T::kBoxes; ++b)
          h::tma_load_3d(ring + st * T::kTileBytes + b * T::kBoxBytes, map, &full[st],
                         b * T::kBox, t * kRowsBS, bh);
        ++item;
      };
      for (int t = t_lo; t < t_hi; ++t) load(&tm_k, t);       // the score pass
      for (int t = t_lo + nb; t < t_hi; ++t) load(&tm_k, t);  // the sum pass's recomputed tiles
      for (int t = t_lo; t < t_hi; ++t) {                     // the output pass
        if (t - t_lo >= nb) load(&tm_k, t);
        load(&tm_v, t);
      }
    }
    return;
  }
  h::reg_alloc<kConsumerRegs>();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), c2 = 2 * (lane & 3);  // rows r0, r0 + 8
  const float* bias_bh =
      a.bias == nullptr ? nullptr : a.bias + (bh / a.H) * a.bias_b_stride + (bh % a.H) * a.bias_h_stride;
  const int off = a.Lk - a.Lq;
  const uint32_t q_addr = h::smem_u32(base + T::kQ), ring_addr = h::smem_u32(ring);
  int taken = 0;  // ring tiles taken so far

  auto take = [&]() {  // the ring's next tile: wait for it, return its stage
    const int st = taken % T::kStages;
    h::mbar_wait(&full[st], (taken / T::kStages) & 1);
    ++taken;
    return st;
  };
  auto give_back = [&](int st) {  // after the warp's wgmma on stage st completed
    if (lane == 0) h::mbar_arrive(&empty[st]);
  };
  // issue S = Q K^T of the K tile in stage st (wgmma m64n64k16, DH / 16
  // steps), one commit group
  auto qk_issue = [&](float (&s)[32], int st) {
    const uint32_t k_addr = ring_addr + st * T::kTileBytes;
    h::fence_regs(s);
    h::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t at = (kk * 16 / T::kBox) * T::kBoxBytes + (kk * 16 % T::kBox) * 2;
      h::wgmma_ss_n64(s, h::matrix_desc(q_addr + at, 16, 8 * T::kSwizzle, T::kSwizzle),
                      h::matrix_desc(k_addr + at, 16, 8 * T::kSwizzle, T::kSwizzle), kk > 0);
    }
    h::wgmma_commit();
  };
  // raw scores of key tile t: s * scale (+ bias), kMaskedBS where causal
  // masks them, -inf past the end of the keys; element 4 j + e is row r0 +
  // 8 (e / 2), key 64 t + 8 j + c2 + e % 2
  // (Only wgmma writes an accumulator, and every thread reads them outside
  // lane-dependent branches: ptxas serializes the kernel's wgmma otherwise.)
  auto scores = [&](const float (&s)[32], float (&x)[32], int t) {
    const int k0 = t * kRowsBS;
    const bool edge = bias_bh != nullptr || k0 + kRowsBS > a.Lk ||
                      (a.causal && k0 + kRowsBS - 1 > q0 + off);
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = s[i] * a.scale;
    if (!edge) return;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e >> 1), col = k0 + 8 * j + c2 + (e & 1), qi = q0 + row;
        float v = x[4 * j + e];
        if (row < q_rows && col < a.Lk) {
          if (bias_bh != nullptr) v += bias_bh[static_cast<int64_t>(qi) * a.Lk + col];
          if (a.causal && col > qi + off) v = kMaskedBS;
        }
        x[4 * j + e] = col < a.Lk ? v : -INFINITY;
      }
  };
  // the rounded scores of a recomputed tile (one that is not buffered)
  auto recompute = [&](float (&s)[32], uint32_t (&w)[16], int t) {
    const int st = take();
    qk_issue(s, st);
    h::wgmma_wait<0>();
    h::fence_regs(s);
    give_back(st);
    float x[32];
    scores(s, x, t);
#pragma unroll
    for (int k = 0; k < 16; ++k) w[k] = pack2(x[2 * k], x[2 * k + 1]);
  };
  // buffer tile i: vector v of thread tid at ((4 i + v) * 128 + tid)
  auto load_words = [&](int i, uint32_t (&w)[16]) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const uint4 x = buf[(4 * i + v) * kConsumers + tid];
      w[4 * v] = x.x, w[4 * v + 1] = x.y, w[4 * v + 2] = x.z, w[4 * v + 3] = x.w;
    }
  };
  auto store_words = [&](int i, const uint32_t (&w)[16]) {
#pragma unroll
    for (int v = 0; v < 4; ++v)
      buf[(4 * i + v) * kConsumers + tid] = make_uint4(w[4 * v], w[4 * v + 1], w[4 * v + 2], w[4 * v + 3]);
  };
  // combine one value a row across the cluster (rows r0 and r0 + 8, held by
  // the lanes with c2 == 0, at slots 2 (8 warp + lane / 4) + 0, 1): push the
  // pair into every CTA's parts[rank], wait for the cluster's, fold them in
  // rank order
  const int slot = 2 * (8 * warp + (lane >> 2));
  auto combine = [&](float (&v)[2], float* parts, uint64_t* bar, bool is_max) {
    if (c2 == 0)
      for (int p = 0; p < C; ++p)
        h::st_async_v2(h::map_rank(h::smem_u32(parts + rank * kRowsBS + slot), p), v[0], v[1],
                       h::map_rank(h::smem_u32(bar), p));
    h::mbar_wait_cluster(bar, 0);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float r = is_max ? -INFINITY : 0.f;
      for (int x = 0; x < C; ++x) {
        const float part = parts[x * kRowsBS + slot + hh];
        r = is_max ? fmaxf(r, part) : r + part;
      }
      v[hh] = r;
    }
  };

  float s0[32], s1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s0[i] = s1[i] = 0.f;
  uint32_t w[16];

  // the score pass: each row's max of the raw scores, the rounded scores
  // kept; S of tile i + 1 is in flight while tile i's scores are worked
  float mx[2] = {-INFINITY, -INFINITY};
  h::mbar_wait(q_full, 0);
  // tile i's scores: issue the next tile's S first when there is one (the
  // loop below issues it in every step: a wgmma result merged at a branch
  // with another value would make ptxas serialize the kernel's wgmma)
  int st_cur = 0;
  auto score_step = [&](float (&cur)[32], float (&nxt)[32], int i, bool issue_next) {
    int st_nxt = 0;
    if (issue_next) {
      st_nxt = take();
      qk_issue(nxt, st_nxt);
      h::wgmma_wait<1>();
    } else {
      h::wgmma_wait<0>();
    }
    h::fence_regs(cur);
    give_back(st_cur);
    st_cur = st_nxt;
    float x[32];
    scores(cur, x, t_lo + i);
#pragma unroll
    for (int k = 0; k < 32; ++k) mx[(k >> 1) & 1] = fmaxf(mx[(k >> 1) & 1], x[k]);
    if (i < nb) {
#pragma unroll
      for (int k = 0; k < 16; ++k) w[k] = pack2(x[2 * k], x[2 * k + 1]);
      store_words(i, w);
    }
  };
  if (n > 0) {
    st_cur = take();
    qk_issue(s0, st_cur);
    int i = 0;
    for (; i + 2 < n; i += 2) {
      score_step(s0, s1, i, true);
      score_step(s1, s0, i + 1, true);
    }
    if (i + 1 < n) {
      score_step(s0, s1, i, true);
      score_step(s1, s0, i + 1, false);
    } else {
      score_step(s0, s1, i, false);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
  }
  if (C > 1) combine(mx, max_parts, max_bar, true);
  float m[2];
  uint32_t m2[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m[hh] = __bfloat162float(__float2bfloat16_rn(mx[hh]));  // = max of the rounded scores
    m2[hh] = pack2(m[hh], m[hh]);
  }

  // the sum pass: d = bf16(x - m) over x, l = sum exp(d)
  float l[2] = {0.f, 0.f};
  for (int i = 0; i < n; ++i) {
    if (i < nb)
      load_words(i, w);
    else
      recompute(s0, w, t_lo + i);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      w[k] = sub2(w[k], m2[k & 1]);
      const float2 d = unpack2(w[k]);
      l[k & 1] += ptt::exp2_approx(d.x * kLog2eBS);
      l[k & 1] += ptt::exp2_approx(d.y * kLog2eBS);
    }
    if (i < nb) store_words(i, w);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  if (C > 1) combine(l, sum_parts, sum_bar, false);
  // exp(d) / l = 2^(d log2(e) - log2(l)): one FFMA and the exp a probability
  const float log2_l[2] = {log2f(l[0]), log2f(l[1])};

  // the output pass: O += bf16(exp(d) / l) V; P of tile i + 1 is made while
  // the product of tile i runs
  float o[T::kBoxes][T::kBox / 2];
#pragma unroll
  for (int b = 0; b < T::kBoxes; ++b)
#pragma unroll
    for (int i = 0; i < T::kBox / 2; ++i) o[b][i] = 0.f;
  auto make_p = [&](int i, uint32_t (&pa)[16]) {
    if (i < nb) {
      load_words(i, w);
    } else {
      recompute(s0, w, t_lo + i);
#pragma unroll
      for (int k = 0; k < 16; ++k) w[k] = sub2(w[k], m2[k & 1]);
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float2 d = unpack2(w[k]);
      pa[k] = pack2(ptt::exp2_approx(fmaf(d.x, kLog2eBS, -log2_l[k & 1])),
                    ptt::exp2_approx(fmaf(d.y, kLog2eBS, -log2_l[k & 1])));
    }
  };
  auto pv_issue = [&](const uint32_t (&pa)[16], int st) {
    const uint32_t v_addr = ring_addr + st * T::kTileBytes;
#pragma unroll
    for (int b = 0; b < T::kBoxes; ++b) h::fence_regs(o[b]);
    h::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t frag[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
#pragma unroll
      for (int b = 0; b < T::kBoxes; ++b) {
        const uint64_t dv = h::matrix_desc(v_addr + b * T::kBoxBytes + kk * 16 * T::kSwizzle,
                                           8 * T::kSwizzle, 8 * T::kSwizzle, T::kSwizzle);
        if constexpr (T::kBox == 64) h::wgmma_rs_n64_tb(o[b], frag, dv);
        else if constexpr (T::kBox == 32) h::wgmma_rs_n32_tb(o[b], frag, dv);
        else h::wgmma_rs_n16_tb(o[b], frag, dv);
      }
    }
    h::wgmma_commit();
  };
  uint32_t p0[16], p1[16];
  auto out_step = [&](uint32_t (&cur)[16], uint32_t (&nxt)[16], int i) {
    const int st = take();  // V
    pv_issue(cur, st);
    if (i + 1 < n) make_p(i + 1, nxt);
    h::wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < T::kBoxes; ++b) h::fence_regs(o[b]);
    h::fence_regs(cur);
    give_back(st);
  };
  if (n > 0) make_p(0, p0);
  for (int i = 0; i < n; i += 2) {
    out_step(p0, p1, i);
    if (i + 1 < n) out_step(p1, p0, i + 1);
  }

  // out: this CTA's P V (C == 1), or the cluster's partial P V summed in
  // rank order, each CTA the column groups j with j % C == rank
  const int64_t row0 = static_cast<int64_t>(bh) * a.Lq + q0;
  auto store_out = [&](int j, const float (&v)[4]) {
    uint32_t packed[2] = {pack2(v[0], v[1]), pack2(v[2], v[3])};
    h::fence_regs(packed);  // rounded here, outside the row test
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row < q_rows)
        *reinterpret_cast<uint32_t*>(a.out + (row0 + row) * DH + 8 * j + c2) = packed[hh];
    }
  };
  if (C == 1) {
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const float v[4] = {o[j / 8][4 * (j % 8)], o[j / 8][4 * (j % 8) + 1],
                          o[j / 8][4 * (j % 8) + 2], o[j / 8][4 * (j % 8) + 3]};
      store_out(j, v);
    }
  } else {
    // once every CTA's warps are done with their score buffers, push each
    // column group j of this CTA's partial to CTA j % C, slot (rank, j / C)
    __syncwarp();
    if (lane == 0)
      for (int p = 0; p < C; ++p) h::mbar_arrive_remote(h::map_rank(h::smem_u32(buf_free), p));
    h::mbar_wait_cluster(buf_free, 0);
    const int G = (DH / 8 + C - 1) / C;  // slots a sender has in a receiver
    float4* recv = reinterpret_cast<float4*>(buf);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int to = j % C;
      h::st_async_v4(h::map_rank(h::smem_u32(recv + (rank * G + j / C) * kConsumers + tid), to),
                     make_float4(o[j / 8][4 * (j % 8)], o[j / 8][4 * (j % 8) + 1],
                                 o[j / 8][4 * (j % 8) + 2], o[j / 8][4 * (j % 8) + 3]),
                     h::map_rank(h::smem_u32(o_full), to));
    }
    h::mbar_wait_cluster(o_full, 0);
    for (int j = rank; j < DH / 8; j += C) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      for (int x = 0; x < C; ++x) {  // the cluster's partial P V, in rank order
        const float4 pv = recv[(x * G + j / C) * kConsumers + tid];
        v[0] += pv.x, v[1] += pv.y, v[2] += pv.z, v[3] += pv.w;
      }
      store_out(j, v);
    }
  }
  if (rank == 0 && c2 == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row < q_rows) {
        a.lse[row0 + row] = log2_l[hh] * kLn2BS;
        a.rowmax[row0 + row] = m[hh];
      }
    }
  }
}

template <int DH>
cudaError_t prepare_bs() {
  static const cudaError_t set = cudaFuncSetAttribute(
      attention_fwd_bf16_scores_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Bs<DH>::kBytes);
  return set;
}

template <int DH>
cudaError_t launch_bs(const void* q, const void* k, const void* v, const float* bias, void* out,
                      float* lse, float* rowmax, int B, int H, int Lq, int Lk,
                      int64_t bias_b_stride, int64_t bias_h_stride, float scale, int causal,
                      cudaStream_t stream) {
  cudaError_t e = prepare_bs<DH>();
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tk, tv;
  const int BH = B * H;
  constexpr int kBox = Bs<DH>::kBox;
  if ((e = h::tensor_map_rows(&tq, q, DH, Lq, BH, kBox, kRowsBS)) != cudaSuccess ||
      (e = h::tensor_map_rows(&tk, k, DH, Lk, BH, kBox, kRowsBS)) != cudaSuccess ||
      (e = h::tensor_map_rows(&tv, v, DH, Lk, BH, kBox, kRowsBS)) != cudaSuccess)
    return e;
  BsArgs a;
  a.bias = bias;
  a.out = static_cast<bf16*>(out);
  a.lse = lse;
  a.rowmax = rowmax;
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  a.bias_b_stride = bias_b_stride;
  a.bias_h_stride = bias_h_stride;
  a.scale = scale;
  a.causal = causal;
  const Plan p = plan_of<DH>(Lk);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.cluster * ((Lq + kRowsBS - 1) / kRowsBS)),
                     static_cast<unsigned>(BH));
  cfg.blockDim = dim3(kThreadsBS);
  cfg.dynamicSmemBytes = Bs<DH>::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, attention_fwd_bf16_scores_kernel<DH>, tq, tk, tv, a);
}

template <int DH>
cudaError_t occupancy_bs(int* out) {
  cudaError_t e = prepare_bs<DH>();
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, attention_fwd_bf16_scores_kernel<DH>);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], attention_fwd_bf16_scores_kernel<DH>,
                                                    kThreadsBS, Bs<DH>::kBytes);
  out[1] = attr.numRegs;
  out[2] = Bs<DH>::kBytes;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return e;
}

}  // namespace

namespace ptt {

// The bf16-score forward of bf16 q, k, v ([B, H, L, dh], contiguous, 16-byte
// aligned; the checks are flash_attention.cu's run()) and a float32 bias
// (null, or batch and head strides in elements): out, lse = log l and
// rowmax = m.  occ != null: the occupancy query instead (out[0..3] as
// ptt_attention_occupancy's).
cudaError_t attention_fwd_bf16_scores(const void* q, const void* k, const void* v,
                                      const float* bias, void* out, float* lse, float* rowmax,
                                      int B, int H, int Lq, int Lk, int dh,
                                      int64_t bias_b_stride, int64_t bias_h_stride, float scale,
                                      int causal, cudaStream_t stream, int* occ) {
  switch (dh) {
#define PTT_BS_CASE(D)                                                                           \
  case D:                                                                                        \
    return occ != nullptr ? occupancy_bs<D>(occ)                                                 \
                          : launch_bs<D>(q, k, v, bias, out, lse, rowmax, B, H, Lq, Lk,          \
                                         bias_b_stride, bias_h_stride, scale, causal, stream);
    PTT_BS_CASE(16)
    PTT_BS_CASE(32)
    PTT_BS_CASE(64)
    PTT_BS_CASE(128)
#undef PTT_BS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ptt

// The path of the bf16-score forward at key length Lk and head dim dh:
// out[0..3] = CTAs of a cluster, key tiles (64 keys) each CTA takes at most,
// of them kept in its score buffer, and recomputed by the later passes.
extern "C" int ptt_attention_fwd_bs_plan(int Lk, int dh, int* out) {
  Plan p;
  switch (dh) {
    case 16: p = plan_of<16>(Lk); break;
    case 32: p = plan_of<32>(Lk); break;
    case 64: p = plan_of<64>(Lk); break;
    case 128: p = plan_of<128>(Lk); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Lk < 1) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = p.cluster;
  out[1] = p.per_cta;
  out[2] = p.buffered;
  out[3] = p.recomputed;
  return 0;
}
