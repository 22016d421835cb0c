// The bf16-score attention backward with bfloat16 inputs, two warpgroup
// kernels for Hopper.  The JAX composite's score_dtype="bfloat16"
// (paddle_tpu/ops/nn_ops.py:680-684) and the VJP of its casts:
//   x = bf16(s * scale + bias) (-1e30 where causal masks, rounded alike),
//   P = exp(bf16(x - m) - log l) with the forward's m and log l,
//   dP = dO V^T,  di = rowsum(dO * O),  g = bf16(P (dP - di)),
//   dm = -bf16(sum_j g_j) (the row max's cotangent),  t = bf16(dm / c) over
//   the row's c scores tied at m,  dS = (g, or bf16(g + t) at a tie) * scale
//   (0 where masked),  dQ = dS K,  dK = dS^T Q,  dV = bf16(P)^T dO.
// Replaces, for these inputs, the kBS variant of paddle_tpu/ops/
// pallas_attention.py _fused_sdpa_bwd (the pl.pallas_call at :221, row 11 bs
// of PERF.md's kernel table); flash_attention.cu keeps the f32-score
// backward and the float32-input twins and launches these two from
// ptt_attention_bwd_dq and ptt_attention_bwd_dkv.
//
// What bounds them on the H100: dK/dV recomputes S^T and dP^T and does dV
// and dK, 8 units of B H Lq Lk dh operations; dQ recomputes S and dP and
// does dQ, 6 units: 0.2085 and 0.1563 ms of bf16 tensor-core peak at
// [8, 12, 2048, 64], against their bytes' 0.0114 ms at [32, 12, 128, 64].
// Past the tensor cores each score takes one exp on the special-function
// unit (16 a clock an SM: 403 M scores at [8, 12, 2048, 64], 0.11 ms a
// kernel at 1.755 GHz) and float32 -> bf16 conversions, two a score in
// dK/dV (x, bf16(P), the rounded dS and the scaled dS, each a pair a
// cvt.rn.bf16x2) and one and a half in dQ (no bf16(P)): if they issue at 16
// a clock too, 0.22 and 0.16 ms more.  Each 64-row tile streamed is 16 KB
// from L2 (1.6 GB a kernel at [8, 12, 2048, 64]).  The design:
//   - One consumer warpgroup owns 64 rows of the CTA's own axis (dK/dV:
//     keys, dQ: queries); the CTA's own two tiles (K and V; Q and dO) load
//     once by TMA and stay in shared memory as wgmma operands.  A producer
//     warp streams the other two tiles (Q and dO; K and V) through a ring of
//     kStages stages with full and empty mbarriers; dK/dV's stages also
//     carry the 64 queries' log l, di and m, which the producer warp's lanes
//     copy by cp.async completing on the stage's barrier (TMA would need
//     16-byte aligned rows, which [B, H, Lq] float32 rows are not; plain
//     loads held the producer a load latency a tile).  setmaxnreg moves
//     registers from the producer warpgroup (24 a thread) to the consumers
//     (232); two CTAs fit on an SM (dQ at dh 128: one, for its 3 stages).
//   - Every product is wgmma: S^T = K Q^T and dP^T = V dO^T (dQ: S = Q K^T
//     and dP = dO V^T) from shared memory, K-major, two commit groups; dV +=
//     bf16(P^T) dO and dK += dS^T Q (dQ: dQ += dS K) take their A operand
//     from registers, the accumulator fragments rounded pairwise, and B
//     MN-major from the tiles as TMA wrote them.  A unit (a tile, or at dh
//     128 in dK/dV half a tile: dK and dV alone hold 128 registers a thread,
//     so S^T and dP^T are m64n32k16) issues the next unit's S and dP before
//     its own register-form products, and its per-score work runs while the
//     previous unit's products do (the A fragments are kept twice).  A
//     stage is freed two units after its tile's last.  dK and dV (dQ) stay
//     in registers to the end; each CTA stores them once: no atomics, every
//     sum in one order, two runs agree bit for bit.
//   - The per-score work goes in pairs: x rounded by one cvt.rn.bf16x2, x -
//     m by __hsub2 (one rounding of the exact difference, as the forward:
//     the backward recomputes the forward's d bit for bit), one ex2 a score,
//     P (dP - di) rounded by one cvt a pair, scaled in float32 and packed
//     into the next product's A fragment.  Interior tiles run a copy of the
//     pair loop without the edge tests: tests inside the unrolled loop cut
//     it into a basic block a pair, and with two consumer warps a scheduler
//     the exp and conversion latencies then showed.
//   - The row max's cotangent: dQ sums each row's g in float32 (a lane its
//     keys, then the quad) and rounds once (the JAX composite's CPU order of
//     bf16 steps is another: cuda_attention.TIE_RULE), counts the ties (x -
//     m is 0: one compare a pair), and writes t beside di; dK/dV stages t
//     with di and adds it where its recomputed x - m is 0 (one bf16 add, one
//     compare and one select a pair).  dQ's own share, (bf16(g + t) - g) K
//     at each tie, is known only after the row's last key tile: dQ takes g
//     unscaled as its A fragment (one multiply by scale at the end, and g
//     stays exact), each lane keeps a row's tie of a tile (key, g; picked
//     out of the A fragment by a select chain after the pair loop) in
//     shared memory, up to kTieSub, and after the loop the
//     warp adds each tie's share with K's row read from device memory, in
//     lane and key order, no atomics.  A row with two ties in one lane's
//     keys of a tile, or more than its slots hold (equal scores), takes the
//     share in a second pass over the key tiles, the same S, dP and g, one
//     stage loaded by a consumer thread: a slow path only where it is
//     needed.  Recording the ties costs dQ most of what the repair costs
//     it (tools/port_bs_bwd_variants.py times dQ without the tie block and
//     without the sum; PERF.md has the numbers).
//   - Causal dK/dV CTAs (Lq <= Lk) skip the query tiles that see none of
//     their keys, and dQ CTAs the key tiles past their last visible key;
//     columns past the end (queries in dK/dV, keys in dQ), which TMA fills
//     with zeros, get P = 0 and dS = 0 explicitly.
//   - ptxas serializes a kernel's wgmma when a non-wgmma instruction writes
//     an accumulator inside a pipeline stage, an accumulator is read in a
//     lane-dependent branch, or registers run short (C7512: P kept in
//     float32 across the dP wait did, at first): the scores go to separate
//     values, the edge tests are selects after an unconditional read, and
//     the last unit is its own copy of the loop body.
// ptxas -v, sm_90a, dh 16 / 32 / 64 / 128 (chip_smoke.py phase 2): 128
// registers a thread at launch (the consumers' 232 through setmaxnreg), 0
// spill bytes but dQ at dh 128 (160 stored, 184 loaded: the row max's
// cotangent's state, its second pass and epilogue); dQ 31,064 / 51,544 /
// 92,504 / 141,640 dynamic shared bytes, 2 / 2 / 2 / 1 CTAs an SM; dK/dV
// 25,672 / 46,152 / 87,112 / 101,416, 2 CTAs an SM.
#include <cuda.h>

#include <cmath>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace h = ptt::sm90;

constexpr int kRowsBW = 64;        // rows of a CTA's own axis, and of a streamed tile
constexpr int kConsumersBW = 128;  // the consumer warpgroup
constexpr int kThreadsBW = 256;    // and the producer warpgroup
constexpr float kMaskedBW = -1e30f;
constexpr float kLog2eBW = 1.4426950408889634f;
constexpr int kProducerRegsBW = 24;
constexpr int kConsumerRegsBW = 232;  // 128 (24 + 232) = 256 threads x 128 registers

// Shapes of one instantiation; byte offsets from the 1024-aligned base of
// the dynamic shared memory.
template <int DH>
struct Bw {
  static constexpr int kBox = DH < 64 ? DH : 64;       // columns of one TMA box
  static constexpr int kSwizzle = kBox * 2;            // its row, bytes: 32, 64, 128
  static constexpr int kBoxes = DH / kBox;             // 2 at dh 128, else 1
  static constexpr int kBoxBytes = kRowsBW * kBox * 2;
  static constexpr int kTileBytes = kRowsBW * DH * 2;  // a Q, K, V or dO tile
  static constexpr int kRing = 2 * kTileBytes;         // after the CTA's own two tiles
  // dK/dV: queries of a tile each product step takes (S^T and dP^T columns)
  static constexpr int kChunk = DH == 128 ? 32 : 64;
  // dK/dV: K, V, then a ring of stages: Q, dO, then log l, di, m and the
  // row max's share t (float [64] each)
  static constexpr int kStagesKV = DH == 128 ? 2 : 4;
  static constexpr int kStatBytes = 1024;
  static constexpr int kStageKV = 2 * kTileBytes + kStatBytes;
  static constexpr int kBarsKV = kRing + kStagesKV * kStageKV;
  static constexpr int kBytesKV = kBarsKV + (2 * kStagesKV + 1) * 8 + 1024;
  // dQ: Q, dO, then a ring of stages (K, V), then di of the CTA's rows,
  // the tie slots (each lane of a row's quad keeps up to kTieSub ties, key
  // and bf16(P (dP - di))), each lane's sum of g a row, a flag, and the
  // barriers (the ring's, Q and dO's, the second pass's)
  static constexpr int kStagesQ = DH == 128 ? 3 : 4;
  static constexpr int kStageQ = 2 * kTileBytes;
  static constexpr int kDiQ = kRing + kStagesQ * kStageQ;
  static constexpr int kTieSub = 4;
  static constexpr int kTieKeyQ = kDiQ + kRowsBW * 4;
  static constexpr int kTieGQ = kTieKeyQ + kRowsBW * 4 * kTieSub * 4;
  static constexpr int kDmQ = kTieGQ + kRowsBW * 4 * kTieSub * 4;  // a lane's sum of g a row
  static constexpr int kFlagQ = kDmQ + kRowsBW * 4 * 4;
  static constexpr int kBarsQ = kFlagQ + 8;
  static constexpr int kBytesQ = kBarsQ + (2 * kStagesQ + 2) * 8 + 1024;
};

struct BwArgs {
  const float* bias;    // null, or float32 [B, 1|H, Lq, Lk]
  const bf16* out;      // dQ: O and dO, for di
  const bf16* dout;
  const bf16* k;        // dQ: K, for the ties' share of dQ
  const float* lse;     // log l
  const float* rowmax;  // m
  float* di;            // written by dQ, read by dK/dV
  float* tie;           // t = bf16(dm / c) of each row: written by dQ, read by dK/dV
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int H, Lq, Lk;
  int64_t bias_b_stride, bias_h_stride;
  float scale;
  int causal;
};

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

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 0xffff in each half of a bf16 pair that is 0 (x - m of a score tied at m)
__device__ __forceinline__ uint32_t zero_halves(uint32_t w) {
  return __heq2_mask(*reinterpret_cast<const __nv_bfloat162*>(&w), __float2bfloat162_rn(0.f));
}

__device__ __forceinline__ uint32_t add2(uint32_t w, uint32_t t) {
  const __nv_bfloat162 d = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&w),
                                   *reinterpret_cast<const __nv_bfloat162*>(&t));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// the consumer warpgroup's own barrier (the producer warpgroup has left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumersBW) : "memory");
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (h::smem_u32(p) & 1023)) & 1023);
}

// wgmma matrix descriptors of a swizzled tile at `addr` (rows of `swizzle`
// bytes, 8-row groups 8 rows apart), read K-major or MN-major (B of the
// register-form products: one swizzle row spans the product's N, so the
// leading offset is never stepped over).
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int swizzle) {
  return h::matrix_desc(addr, 16, 8 * swizzle, swizzle);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, int swizzle) {
  return h::matrix_desc(addr, 8 * swizzle, 8 * swizzle, swizzle);
}

// acc[64 x DH] += A[64 x 16 kSteps] B, A the fragments `frag` (word 4 k + i
// of k-step k), B rows row0 .. row0 + 16 kSteps of the [64][DH] tile at
// b_addr, MN-major (dh contiguous), one commit group.
template <int DH, int kSteps>
__device__ __forceinline__ void rs_issue(float (&acc)[Bw<DH>::kBoxes][Bw<DH>::kBox / 2],
                                         const uint32_t (&frag)[4 * kSteps], uint32_t b_addr,
                                         int row0) {
  using T = Bw<DH>;
#pragma unroll
  for (int b = 0; b < T::kBoxes; ++b) h::fence_regs(acc[b]);
  h::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const uint32_t f[4] = {frag[4 * kk], frag[4 * kk + 1], frag[4 * kk + 2], frag[4 * kk + 3]};
#pragma unroll
    for (int b = 0; b < T::kBoxes; ++b) {
      const uint64_t d =
          desc_mn(b_addr + b * T::kBoxBytes + (row0 + 16 * kk) * T::kSwizzle, T::kSwizzle);
      if constexpr (T::kBox == 64) h::wgmma_rs_n64_tb(acc[b], f, d);
      else if constexpr (T::kBox == 32) h::wgmma_rs_n32_tb(acc[b], f, d);
      else h::wgmma_rs_n16_tb(acc[b], f, d);
    }
  }
  h::wgmma_commit();
}

// d[64 x N] = A B^T over dh, A the [64][DH] tile at a_addr, B rows row0 ..
// row0 + N of the [64][DH] tile at b_addr, both K-major; no commit.
template <int DH, int N>
__device__ __forceinline__ void ss_issue(float (&d)[N / 2], uint32_t a_addr, uint32_t b_addr,
                                         int row0) {
  using T = Bw<DH>;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t at = (kk * 16 / T::kBox) * T::kBoxBytes + (kk * 16 % T::kBox) * 2;
    const uint64_t da = desc_k(a_addr + at, T::kSwizzle);
    const uint64_t db = desc_k(b_addr + at + row0 * T::kSwizzle, T::kSwizzle);
    if constexpr (N == 64) h::wgmma_ss_n64(d, da, db, kk > 0);
    else h::wgmma_ss_n32(d, da, db, kk > 0);
  }
}

// Run unit(u, buffer, issue_next) for u = 0 .. units - 1: `buffer` is a
// compile-time 0 or 1 that alternates (a unit writes the A fragments of its
// buffer while the previous unit's products still read the other's), and
// the last unit is told there is no next one to issue.
template <class Unit>
__device__ __forceinline__ void run_units(int units, Unit&& unit) {
  const std::integral_constant<int, 0> b0;
  const std::integral_constant<int, 1> b1;
  int u = 0;
  for (; u + 2 < units; u += 2) {
    unit(u, b0, true);
    unit(u + 1, b1, true);
  }
  if (u + 1 < units) {
    unit(u, b0, true);
    unit(u + 1, b1, false);
  } else {
    unit(u, b0, false);
  }
}

// Store a warpgroup's 64 x DH float32 accumulator, rounded, to rows [0,
// valid) of the [rows][DH] bf16 block at dst (element 4 j + e of box b is
// row r0 + 8 (e / 2), column b kBox + 8 j + c2 + e % 2).
template <int DH>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[Bw<DH>::kBoxes][Bw<DH>::kBox / 2],
                                          int r0, int c2, int valid) {
  constexpr int kGroups = Bw<DH>::kBox / 8;  // column groups of 8 a box
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const float* v = &acc[j / kGroups][4 * (j % kGroups)];
    uint32_t packed[2] = {pack2(v[0], v[1]), pack2(v[2], v[3])};
    h::fence_regs(packed);  // rounded here, outside the row test
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row < valid)
        *reinterpret_cast<uint32_t*>(dst + static_cast<int64_t>(row) * DH + 8 * j + c2) = packed[hh];
    }
  }
}

// dK and dV of 64 keys from the forward's log l and m and the dQ kernel's
// di.  Threads 0-127 are the consumer warpgroup, 128-159 the producer warp.
template <int DH>
__global__ void __launch_bounds__(kThreadsBW, 2)
    attention_bwd_dkv_bf16_scores_kernel(const __grid_constant__ CUtensorMap tm_q,
                                         const __grid_constant__ CUtensorMap tm_k,
                                         const __grid_constant__ CUtensorMap tm_v,
                                         const __grid_constant__ CUtensorMap tm_do,
                                         const BwArgs a) {
  using T = Bw<DH>;
  constexpr int NC = T::kChunk, kParts = kRowsBW / NC, S = T::kStagesKV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* ring = base + T::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + T::kBarsKV);
  uint64_t* empty = full + S;
  uint64_t* kv_full = empty + S;

  const int bh = blockIdx.y, k0 = blockIdx.x * kRowsBW;
  const int k_rows = min(kRowsBW, a.Lk - k0);
  const int off = a.Lk - a.Lq;
  // with Lq <= Lk, queries before k0 - (Lk - Lq) see none of these keys
  // (t_begin < t_end, since k0 - (Lk - Lq) < Lq)
  int t_begin = 0;
  if (a.causal && a.Lk >= a.Lq && k0 - off > 0) t_begin = (k0 - off) / kRowsBW;
  const int n = (a.Lq + kRowsBW - 1) / kRowsBW - t_begin;  // query tiles, >= 1

  if (threadIdx.x == kConsumersBW) {  // barriers, then K and V at once
    h::prefetch_tensor_map(&tm_q);
    h::prefetch_tensor_map(&tm_k);
    h::prefetch_tensor_map(&tm_v);
    h::prefetch_tensor_map(&tm_do);
    for (int s = 0; s < S; ++s) {
      h::mbar_init(&full[s], 33);  // the TMA's bytes, and each producer lane's copies
      h::mbar_init(&empty[s], kConsumersBW / 32);
    }
    h::mbar_init(kv_full, 1);
    h::fence_barrier_init();
    h::mbar_arrive_expect_tx(kv_full, 2 * T::kTileBytes);
    for (int b = 0; b < T::kBoxes; ++b) {
      h::tma_load_3d(base + b * T::kBoxBytes, &tm_k, kv_full, b * T::kBox, k0, bh);
      h::tma_load_3d(base + T::kTileBytes + b * T::kBoxBytes, &tm_v, kv_full, b * T::kBox, k0, bh);
    }
  }
  __syncthreads();

  if (threadIdx.x >= kConsumersBW) {  // the producer warpgroup: its first warp streams
    h::reg_dealloc<kProducerRegsBW>();
    if (threadIdx.x < kConsumersBW + 32) {
      const int lane = threadIdx.x & 31;
      const int64_t qrow0 = static_cast<int64_t>(bh) * a.Lq;
      for (int i = 0; i < n; ++i) {
        const int st = i % S, q0 = (t_begin + i) * kRowsBW;
        h::mbar_wait(&empty[st], ((i / S) & 1) ^ 1);
        unsigned char* stage = ring + st * T::kStageKV;
        float* lse_s = reinterpret_cast<float*>(stage + 2 * T::kTileBytes);
        for (int r = lane; r < kRowsBW; r += 32) {  // zeros past the end of the queries
          const bool in = q0 + r < a.Lq;
          const int64_t at = qrow0 + q0 + (in ? r : 0);
          ptt::cp_async_4(lse_s + r, a.lse + at, in);
          ptt::cp_async_4(lse_s + kRowsBW + r, a.di + at, in);
          ptt::cp_async_4(lse_s + 2 * kRowsBW + r, a.rowmax + at, in);
          ptt::cp_async_4(lse_s + 3 * kRowsBW + r, a.tie + at, in);
        }
        h::cp_async_mbar_arrive(&full[st]);
        if (lane == 0) {
          h::mbar_arrive_expect_tx(&full[st], 2 * T::kTileBytes);
          for (int b = 0; b < T::kBoxes; ++b) {
            h::tma_load_3d(stage + b * T::kBoxBytes, &tm_q, &full[st], b * T::kBox, q0, bh);
            h::tma_load_3d(stage + T::kTileBytes + b * T::kBoxBytes, &tm_do, &full[st],
                           b * T::kBox, q0, bh);
          }
        }
      }
    }
    return;
  }
  h::reg_alloc<kConsumerRegsBW>();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), c2 = 2 * (lane & 3);  // key rows r0, r0 + 8
  const float* bias_bh =
      a.bias == nullptr ? nullptr : a.bias + (bh / a.H) * a.bias_b_stride + (bh % a.H) * a.bias_h_stride;
  const uint32_t k_addr = h::smem_u32(base), v_addr = k_addr + T::kTileBytes;
  const uint32_t ring_addr = h::smem_u32(ring);
  // query tile i is in stage i % S, its round (i / S) & 1
  auto take = [&](int i) { h::mbar_wait(&full[i % S], (i / S) & 1); };
  auto give_back = [&](int i) {  // after the warp's wgmma on tile i completed
    if (lane == 0) h::mbar_arrive(&empty[i % S]);
  };

  float dk[T::kBoxes][T::kBox / 2], dv[T::kBoxes][T::kBox / 2];
#pragma unroll
  for (int b = 0; b < T::kBoxes; ++b)
#pragma unroll
    for (int i = 0; i < T::kBox / 2; ++i) dk[b][i] = dv[b][i] = 0.f;
  float s[NC / 2], dp[NC / 2];  // S^T and dP^T of a chunk: element 4 j + e is key
#pragma unroll                  // r0 + 8 (e / 2), query 8 j + c2 + e % 2 of the chunk
  for (int i = 0; i < NC / 2; ++i) s[i] = dp[i] = 0.f;
  // bf16(P^T) and dS^T, the A fragments of dV and dK, twice (run_units)
  uint32_t pas[2][NC / 4], dss[2][NC / 4];
#pragma unroll
  for (int i = 0; i < NC / 4; ++i) pas[0][i] = dss[0][i] = pas[1][i] = dss[1][i] = 0u;

  // S^T = K Q^T and dP^T = V dO^T of chunk c of query tile i: two commit
  // groups
  auto scores_issue = [&](int i, int c) {
    const uint32_t q_addr = ring_addr + (i % S) * T::kStageKV;
    h::fence_regs(s);
    h::fence_regs(dp);
    h::wgmma_fence();
    ss_issue<DH, NC>(s, k_addr, q_addr, c * NC);
    h::wgmma_commit();
    ss_issue<DH, NC>(dp, v_addr, q_addr + T::kTileBytes, c * NC);
    h::wgmma_commit();
  };

  h::mbar_wait(kv_full, 0);
  take(0);
  scores_issue(0, 0);
  h::wgmma_commit();  // two empty groups: every unit finds its S^T and dP^T
  h::wgmma_commit();  // two groups before its predecessor's dV and dK
  // unit u: chunk c of query tile i.  On entry S^T and dP^T of it are in
  // flight, then the previous unit's dV and dK; the per-score work of this
  // unit overlaps those, and its own dV and dK go behind the next unit's S^T
  // and dP^T.
  run_units(n * kParts, [&](int u, auto buffer, bool issue_next) {
    uint32_t(&pa)[NC / 4] = pas[decltype(buffer)::value];
    uint32_t(&ds)[NC / 4] = dss[decltype(buffer)::value];
    const int i = u / kParts, c = u % kParts, q0 = (t_begin + i) * kRowsBW;
    const int q_rows = min(kRowsBW, a.Lq - q0);
    const bool edge = bias_bh != nullptr || q_rows < kRowsBW || k_rows < kRowsBW ||
                      (a.causal && k0 + kRowsBW - 1 > q0 + off);
    const float* lse_s =
        reinterpret_cast<const float*>(ring + (i % S) * T::kStageKV + 2 * T::kTileBytes);
    const float* di_s = lse_s + kRowsBW;
    const float* m_s = di_s + kRowsBW;
    const float* t_s = m_s + kRowsBW;
    h::wgmma_wait<2>();  // S^T and dP^T are done, and all but the last unit's products
    h::fence_regs(s);
    h::fence_regs(dp);
    h::fence_regs(pa);
    h::fence_regs(ds);
    // the products of unit u - 2 are done: the last of its tile frees the stage
    if (u >= 2 && (u - 2) % kParts == kParts - 1) give_back((u - 2) / kParts);
    // a pair of scores at a time (key r0 + 8 hh, queries qi and qi + 1):
    // x = s * scale (+ bias), kMaskedBW where causal masks it; P^T =
    // 2^(bf16(bf16(x) - m) log2 e - log l log2 e), 0 past the queries; g =
    // bf16(P^T (dP^T - di)), and bf16(g + t) where the score is tied at its
    // row max (x - m is 0: the row max's share of its cotangent, t = 0 past
    // the queries); dS^T = that * scale, 0 where masked.  Interior tiles
    // take a copy without the edge tests: one basic block, whose pairs the
    // scheduler interleaves.
    auto pairs = [&](auto edge_tile) {
      constexpr bool edge = decltype(edge_tile)::value;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int col = c * NC + 8 * j + c2, qi = q0 + col;
        const float2 mf = *reinterpret_cast<const float2*>(m_s + col);
        const uint32_t m2 = pack2(mf.x, mf.y);  // bf16 values: exact
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float l2x = l2.x * kLog2eBW, l2y = l2.y * kLog2eBW;
        const float2 d2 = *reinterpret_cast<const float2*>(di_s + col);
        const float2 tf = *reinterpret_cast<const float2*>(t_s + col);
        const uint32_t t2 = pack2(tf.x, tf.y);  // bf16 values: exact
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int k = 4 * j + 2 * hh, kc = k0 + r0 + 8 * hh;
          float x0 = s[k] * a.scale, x1 = s[k + 1] * a.scale;
          if constexpr (edge) {
            if (bias_bh != nullptr && kc < a.Lk) {
              const float* brow = bias_bh + static_cast<int64_t>(qi) * a.Lk + kc;
              if (qi < a.Lq) x0 += brow[0];
              if (qi + 1 < a.Lq) x1 += brow[a.Lk];
            }
            x0 = a.causal && kc > qi + off ? kMaskedBW : x0;
            x1 = a.causal && kc > qi + 1 + off ? kMaskedBW : x1;
          }
          const uint32_t dw = sub2(pack2(x0, x1), m2);
          const float2 d = unpack2(dw);
          float p0 = ptt::exp2_approx(fmaf(d.x, kLog2eBW, -l2x));
          float p1 = ptt::exp2_approx(fmaf(d.y, kLog2eBW, -l2y));
          if constexpr (edge) {
            p0 = qi < a.Lq ? p0 : 0.f;
            p1 = qi + 1 < a.Lq ? p1 : 0.f;
          }
          pa[2 * j + hh] = pack2(p0, p1);
          const uint32_t g = pack2(p0 * (dp[k] - d2.x), p1 * (dp[k + 1] - d2.y));
          const uint32_t tie = zero_halves(dw);
          const float2 y = unpack2((add2(g, t2) & tie) | (g & ~tie));
          float v0 = y.x * a.scale, v1 = y.y * a.scale;
          if constexpr (edge) {
            v0 = a.causal && kc > qi + off ? 0.f : v0;
            v1 = a.causal && kc > qi + 1 + off ? 0.f : v1;
          }
          ds[2 * j + hh] = pack2(v0, v1);
        }
      }
    };
    if (edge)
      pairs(std::true_type{});
    else
      pairs(std::false_type{});
    if (issue_next) {
      const int nc = (c + 1) % kParts, ni = nc == 0 ? i + 1 : i;
      if (nc == 0) take(ni);
      scores_issue(ni, nc);
    }
    const uint32_t q_addr = ring_addr + (i % S) * T::kStageKV;
    rs_issue<DH, NC / 16>(dv, pa, q_addr + T::kTileBytes, c * NC);  // dV += bf16(P^T) dO
    rs_issue<DH, NC / 16>(dk, ds, q_addr, c * NC);                  // dK += dS^T Q
  });
  h::wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    h::fence_regs(pas[b]);
    h::fence_regs(dss[b]);
  }
#pragma unroll
  for (int b = 0; b < T::kBoxes; ++b) {
    h::fence_regs(dk[b]);
    h::fence_regs(dv[b]);
  }
  const int64_t key0 = static_cast<int64_t>(bh) * a.Lk + k0;
  store_acc<DH>(a.dk + key0 * DH, dk, r0, c2, k_rows);
  store_acc<DH>(a.dv + key0 * DH, dv, r0, c2, k_rows);
}

// dQ of 64 queries, and di = rowsum(dO * O), which the dK/dV kernel reads
// after it.  Threads 0-127 are the consumer warpgroup, thread 128 the
// producer.
template <int DH>
__global__ void __launch_bounds__(kThreadsBW, 2)
    attention_bwd_dq_bf16_scores_kernel(const __grid_constant__ CUtensorMap tm_q,
                                        const __grid_constant__ CUtensorMap tm_k,
                                        const __grid_constant__ CUtensorMap tm_v,
                                        const __grid_constant__ CUtensorMap tm_do,
                                        const BwArgs a) {
  using T = Bw<DH>;
  constexpr int S = T::kStagesQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* ring = base + T::kRing;
  float* di_s = reinterpret_cast<float*>(base + T::kDiQ);
  int* tie_key_s = reinterpret_cast<int*>(base + T::kTieKeyQ);
  float* tie_g_s = reinterpret_cast<float*>(base + T::kTieGQ);
  float* dm_s = reinterpret_cast<float*>(base + T::kDmQ);
  int* flag_s = reinterpret_cast<int*>(base + T::kFlagQ);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + T::kBarsQ);
  uint64_t* empty = full + S;
  uint64_t* qd_full = empty + S;
  uint64_t* fix_full = qd_full + 1;

  const int bh = blockIdx.y, q0 = blockIdx.x * kRowsBW;
  const int q_rows = min(kRowsBW, a.Lq - q0);
  const int off = a.Lk - a.Lq;
  // key tiles the rows need: with Lq <= Lk every row sees key 0, so causal
  // tiles past the block's last visible key are skipped (>= 1)
  int keys = a.Lk;
  if (a.causal && a.Lk >= a.Lq) keys = min(a.Lk, q0 + q_rows + off);
  const int n = (keys + kRowsBW - 1) / kRowsBW;

  if (threadIdx.x == kConsumersBW) {  // the producer thread: barriers, then Q and dO at once
    h::prefetch_tensor_map(&tm_q);
    h::prefetch_tensor_map(&tm_k);
    h::prefetch_tensor_map(&tm_v);
    h::prefetch_tensor_map(&tm_do);
    for (int s = 0; s < S; ++s) {
      h::mbar_init(&full[s], 1);
      h::mbar_init(&empty[s], kConsumersBW / 32);
    }
    h::mbar_init(qd_full, 1);
    h::mbar_init(fix_full, 1);
    *flag_s = 0;
    h::fence_barrier_init();
    h::mbar_arrive_expect_tx(qd_full, 2 * T::kTileBytes);
    for (int b = 0; b < T::kBoxes; ++b) {
      h::tma_load_3d(base + b * T::kBoxBytes, &tm_q, qd_full, b * T::kBox, q0, bh);
      h::tma_load_3d(base + T::kTileBytes + b * T::kBoxBytes, &tm_do, qd_full, b * T::kBox, q0,
                     bh);
    }
  }
  __syncthreads();

  if (threadIdx.x >= kConsumersBW) {  // the producer warpgroup: one thread issues
    h::reg_dealloc<kProducerRegsBW>();
    if (threadIdx.x == kConsumersBW) {
      for (int t = 0; t < n; ++t) {
        const int st = t % S;
        h::mbar_wait(&empty[st], ((t / S) & 1) ^ 1);
        h::mbar_arrive_expect_tx(&full[st], 2 * T::kTileBytes);
        unsigned char* stage = ring + st * T::kStageQ;
        for (int b = 0; b < T::kBoxes; ++b) {
          h::tma_load_3d(stage + b * T::kBoxBytes, &tm_k, &full[st], b * T::kBox, t * kRowsBW, bh);
          h::tma_load_3d(stage + T::kTileBytes + b * T::kBoxBytes, &tm_v, &full[st], b * T::kBox,
                         t * kRowsBW, bh);
        }
      }
    }
    return;
  }
  h::reg_alloc<kConsumerRegsBW>();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), c2 = 2 * (lane & 3);  // query rows r0, r0 + 8
  const int64_t row0 = static_cast<int64_t>(bh) * a.Lq + q0;
  const float* bias_bh =
      a.bias == nullptr ? nullptr : a.bias + (bh / a.H) * a.bias_b_stride + (bh % a.H) * a.bias_h_stride;

  // di of the warp's 16 rows from O and dO in device memory, while the
  // copies fly: DH / 8 lanes a row, 16 bytes a lane
  {
    constexpr int kLanes = DH / 8, kPerPass = 32 / kLanes;
    for (int rr = 0; rr < 16; rr += kPerPass) {
      const int row = 16 * warp + rr + lane / kLanes, c = lane % kLanes * 8;
      float acc = 0.f;
      if (row < q_rows) {
        const uint4 o = *reinterpret_cast<const uint4*>(a.out + (row0 + row) * DH + c);
        const uint4 d = *reinterpret_cast<const uint4*>(a.dout + (row0 + row) * DH + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 of = __bfloat1622float2(o2[i]), df = __bfloat1622float2(d2[i]);
          acc += of.x * df.x + of.y * df.y;
        }
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane % kLanes == 0) {
        di_s[row] = acc;
        if (row < q_rows) a.di[row0 + row] = acc;
      }
    }
  }
  __syncwarp();
  float l2[2], di_r[2];  // rows r0 and r0 + 8: log l * log2 e, di, and m as a bf16 pair
  uint32_t m2[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 8 * hh;
    const bool in = row < q_rows;
    l2[hh] = in ? a.lse[row0 + row] * kLog2eBW : 0.f;
    const float m = in ? a.rowmax[row0 + row] : 0.f;
    m2[hh] = pack2(m, m);
    di_r[hh] = di_s[row];
  }

  const uint32_t q_addr = h::smem_u32(base), do_addr = q_addr + T::kTileBytes;
  const uint32_t ring_addr = h::smem_u32(ring);
  // key tile t is in stage t % S, its round (t / S) & 1
  auto take = [&](int t) { h::mbar_wait(&full[t % S], (t / S) & 1); };
  auto give_back = [&](int t) {
    if (lane == 0) h::mbar_arrive(&empty[t % S]);
  };

  float dq[T::kBoxes][T::kBox / 2];
#pragma unroll
  for (int b = 0; b < T::kBoxes; ++b)
#pragma unroll
    for (int i = 0; i < T::kBox / 2; ++i) dq[b][i] = 0.f;
  float s[32], dp[32];  // S and dP: element 4 j + e is row r0 + 8 (e / 2), key 8 j + c2 + e % 2
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  uint32_t dss[2][16];  // dS, the A fragments of dQ += dS K, twice (run_units)
#pragma unroll
  for (int i = 0; i < 16; ++i) dss[0][i] = dss[1][i] = 0u;

  auto scores_issue = [&](int t) {  // S = Q K^T, dP = dO V^T: two commit groups
    const uint32_t k_addr = ring_addr + (t % S) * T::kStageQ;
    h::fence_regs(s);
    h::fence_regs(dp);
    h::wgmma_fence();
    ss_issue<DH, 64>(s, q_addr, k_addr, 0);
    h::wgmma_commit();
    ss_issue<DH, 64>(dp, do_addr, k_addr + T::kTileBytes, 0);
    h::wgmma_commit();
  };

  // pair k of key tile k0 (query r0 + 8 (k % 2), keys kc and kc + 1): g =
  // bf16(P (dP - di)) as a bf16 pair from S and dP, x = s * scale (+ bias),
  // kMaskedBW where causal masks it, P = 2^(bf16(bf16(x) - m) log2 e - log l
  // log2 e); 0 where masked or past the keys.  `tie` gets 0xffff in each
  // half whose score is tied at the row max (x - m is 0) and counts.
  auto pair = [&](int k, int k0, auto edge_tile, uint32_t& tie) {
    constexpr bool edge = decltype(edge_tile)::value;
    const int hh = k & 1, qi = q0 + r0 + 8 * hh, kc = k0 + 8 * (k >> 1) + c2;
    float x0 = s[2 * k] * a.scale, x1 = s[2 * k + 1] * a.scale;
    if constexpr (edge) {
      if (bias_bh != nullptr && qi < a.Lq) {
        const float* brow = bias_bh + static_cast<int64_t>(qi) * a.Lk + kc;
        if (kc < a.Lk) x0 += brow[0];
        if (kc + 1 < a.Lk) x1 += brow[1];
      }
      x0 = a.causal && kc > qi + off ? kMaskedBW : x0;
      x1 = a.causal && kc + 1 > qi + off ? kMaskedBW : x1;
    }
    const uint32_t dw = sub2(pack2(x0, x1), m2[hh]);
    const float2 d = unpack2(dw);
    const float p0 = ptt::exp2_approx(fmaf(d.x, kLog2eBW, -l2[hh]));
    const float p1 = ptt::exp2_approx(fmaf(d.y, kLog2eBW, -l2[hh]));
    uint32_t g = pack2(p0 * (dp[2 * k] - di_r[hh]), p1 * (dp[2 * k + 1] - di_r[hh]));
    tie = zero_halves(dw);
    if constexpr (edge) {
      const uint32_t keep = (kc >= a.Lk || (a.causal && kc > qi + off) ? 0u : 0xffffu) |
                            (kc + 1 >= a.Lk || (a.causal && kc + 1 > qi + off) ? 0u : 0xffff0000u);
      g &= keep;
      tie &= keep;
    }
    return g;
  };

  // the row max's cotangent: each lane sums g over its keys of rows r0 and
  // r0 + 8 in float32, a tile's sum into its own word of shared memory (a
  // sum carried in registers across the products made ptxas serialize
  // every wgmma: C7515), and counts their ties, keeping them in its slots
  // (key, g)
  float* dm_own = dm_s + r0 * 4 + (lane & 3);  // row r0; row r0 + 8 is 32 words on
  dm_own[0] = dm_own[32] = 0.f;
  int tcnt[2] = {0, 0}, nslot[2] = {0, 0};  // a lane's ties of rows r0, r0 + 8, its slots
  bool ovf[2] = {false, false};             // a tie the slots could not keep
  h::mbar_wait(qd_full, 0);
  take(0);
  scores_issue(0);
  h::wgmma_commit();  // an empty group: every tile finds its S and dP one group
                      // before its predecessor's dQ
  // key tile t: on entry its S and dP are in flight, then the previous
  // tile's dQ, which the per-score work of this tile overlaps
  run_units(n, [&](int t, auto buffer, bool issue_next) {
    uint32_t(&ds)[16] = dss[decltype(buffer)::value];
    const int k0 = t * kRowsBW, kv_rows = min(kRowsBW, a.Lk - k0);
    const bool edge = bias_bh != nullptr || q_rows < kRowsBW || kv_rows < kRowsBW ||
                      (a.causal && k0 + kRowsBW - 1 > q0 + off);
    h::wgmma_wait<1>();  // S and dP are done, and all but the last tile's dQ
    h::fence_regs(s);
    h::fence_regs(dp);
    h::fence_regs(ds);
    if (t >= 2) give_back(t - 2);  // its dQ is done
    // dS / scale = g, the A fragment of dQ += dS K (scaled once at the end;
    // interior tiles: no tests, as dK/dV's); the pair's g summed into the
    // row's dm, its ties marked in tb (bit k, and 16 + k for the second key)
    uint32_t tb = 0u;
    float part[2] = {0.f, 0.f};
    auto pairs = [&](auto edge_tile) {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        uint32_t tie;
        ds[k] = pair(k, k0, edge_tile, tie);
        const float2 y = unpack2(ds[k]);
        part[k & 1] += y.x + y.y;
        tb |= (tie & 0x00010001u) << k;
      }
    };
    if (edge)
      pairs(std::true_type{});
    else
      pairs(std::false_type{});
    // the tile's ties into the slots, while ds is this unit's A fragment:
    // a row's one tie in this tile (its g picked out of ds by a select
    // chain), every tile, with no branch; two in one tile, or slots full,
    // send the row to the second pass.  This block is most of what the
    // repair costs dQ (tools/port_bs_bwd_variants.py without_tie_block; a
    // warp-wide branch around it, or its counts in shared memory, cost more)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint32_t mine = tb & (hh ? 0xAAAAAAAAu : 0x55555555u);
      const int n = __popc(mine), bit = __ffs(mine) - 1, k = bit & 15, e = (bit >> 4) & 1;
      uint32_t w = 0u;
#pragma unroll
      for (int kk = hh; kk < 16; kk += 2) w = k == kk ? ds[kk] : w;
      const float2 y = unpack2(w);
      const bool keep_it = n == 1 && nslot[hh] < T::kTieSub;
      if (keep_it) {
        const int at = ((r0 + 8 * hh) * 4 + (lane & 3)) * T::kTieSub + nslot[hh];
        tie_key_s[at] = k0 + 8 * (k >> 1) + c2 + e;
        tie_g_s[at] = e ? y.y : y.x;
      }
      nslot[hh] += keep_it ? 1 : 0;
      ovf[hh] = ovf[hh] || (n > 0 && !keep_it);
      tcnt[hh] += n;
    }
    dm_own[0] += part[0];
    dm_own[32] += part[1];
    if (issue_next) {
      take(t + 1);
      scores_issue(t + 1);
    }
    rs_issue<DH, 4>(dq, ds, ring_addr + (t % S) * T::kStageQ, 0);  // dQ += dS K
  });
  h::wgmma_wait<0>();
  h::fence_regs(dss[0]);
  h::fence_regs(dss[1]);
#pragma unroll
  for (int b = 0; b < T::kBoxes; ++b) h::fence_regs(dq[b]);

  // each row's dm = -bf16(sum of g) over the quad (lanes 4 r .. 4 r + 3, one
  // order for all four), c ties, t = bf16(dm / c), written for dK/dV; a row
  // with a tie its slots did not keep overflows
  float t_r[2];
  int cs[2][4];  // the quad's lanes' slots
  bool over[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = dm_own[32 * hh];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    int c = tcnt[hh];
    c += __shfl_xor_sync(0xffffffffu, c, 1);
    c += __shfl_xor_sync(0xffffffffu, c, 2);
#pragma unroll
    for (int x = 0; x < 4; ++x) cs[hh][x] = __shfl_sync(0xffffffffu, nslot[hh], (lane & ~3) | x);
    over[hh] = ((__ballot_sync(0xffffffffu, ovf[hh]) >> (lane & ~3)) & 0xfu) != 0u;
    t_r[hh] = c > 0 ? round_bf16(round_bf16(-sum) / static_cast<float>(c)) : 0.f;
    const int row = r0 + 8 * hh;
    if ((lane & 3) == 0 && row < q_rows) a.tie[row0 + row] = t_r[hh];
  }
  // rows that overflowed take their ties' share in a second pass over the
  // key tiles (the same S, dP and g; one stage, loaded by a consumer):
  // dQ += (bf16(g + t) - g) K at each tie
  if (over[0] || over[1]) *flag_s = 1;
  consumers_sync();
  if (*flag_s != 0) {
    uint32_t fx[16];
    for (int t = 0; t < n; ++t) {
      if (tid == 0) {
        h::mbar_arrive_expect_tx(fix_full, 2 * T::kTileBytes);
        for (int b = 0; b < T::kBoxes; ++b) {
          h::tma_load_3d(ring + b * T::kBoxBytes, &tm_k, fix_full, b * T::kBox, t * kRowsBW, bh);
          h::tma_load_3d(ring + T::kTileBytes + b * T::kBoxBytes, &tm_v, fix_full, b * T::kBox,
                         t * kRowsBW, bh);
        }
      }
      h::mbar_wait(fix_full, t & 1);
      h::fence_regs(s);
      h::fence_regs(dp);
      h::wgmma_fence();
      ss_issue<DH, 64>(s, q_addr, ring_addr, 0);
      h::wgmma_commit();
      ss_issue<DH, 64>(dp, do_addr, ring_addr + T::kTileBytes, 0);
      h::wgmma_commit();
      h::wgmma_wait<0>();
      h::fence_regs(s);
      h::fence_regs(dp);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int hh = k & 1;
        uint32_t tie;
        const float2 y = unpack2(pair(k, t * kRowsBW, std::true_type{}, tie));
        tie = over[hh] ? tie : 0u;
        fx[k] = pack2((tie & 1u) ? round_bf16(y.x + t_r[hh]) - y.x : 0.f,
                      (tie >> 16) ? round_bf16(y.y + t_r[hh]) - y.y : 0.f);
      }
      rs_issue<DH, 4>(dq, fx, ring_addr, 0);
      h::wgmma_wait<0>();
      h::fence_regs(fx);
#pragma unroll
      for (int b = 0; b < T::kBoxes; ++b) h::fence_regs(dq[b]);
      consumers_sync();  // every warp's products read the stage before its next load
    }
  }
  // the other rows' ties, from the slots in lane order: (bf16(g + t) - g)
  // K_key into `cor` (the accumulator takes only wgmma writes), K read from
  // device memory at the lane's columns; a loop as long as the warp's most
  // ties, no branch on a lane's own count
  float cor[T::kBoxes][T::kBox / 2];
#pragma unroll
  for (int b = 0; b < T::kBoxes; ++b)
#pragma unroll
    for (int i = 0; i < T::kBox / 2; ++i) cor[b][i] = 0.f;
  int most = 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    if (!over[hh]) most = max(most, cs[hh][0] + cs[hh][1] + cs[hh][2] + cs[hh][3]);
  most = __reduce_max_sync(0xffffffffu, most);
  __syncwarp();
  const bf16* k_bh = a.k + static_cast<int64_t>(bh) * a.Lk * DH;
  constexpr int kGroups = T::kBox / 8;
  for (int e = 0; e < most; ++e) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      int at = -1, rest = e;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int nx = cs[hh][x];
        if (at < 0 && rest < nx) at = ((r0 + 8 * hh) * 4 + x) * T::kTieSub + rest;
        if (at < 0) rest -= nx;
      }
      const bool live = at >= 0 && !over[hh];
      at = live ? at : 0;
      const float g = tie_g_s[at];
      const float corr = live ? round_bf16(g + t_r[hh]) - g : 0.f;
      const bf16* krow = k_bh + static_cast<int64_t>(live ? tie_key_s[at] : 0) * DH + c2;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const float2 kf = unpack2(*reinterpret_cast<const uint32_t*>(krow + 8 * j));
        float* v = &cor[j / kGroups][4 * (j % kGroups) + 2 * hh];
        v[0] = fmaf(corr, kf.x, v[0]);
        v[1] = fmaf(corr, kf.y, v[1]);
      }
    }
  }
  float fin[T::kBoxes][T::kBox / 2];
#pragma unroll
  for (int b = 0; b < T::kBoxes; ++b)
#pragma unroll
    for (int i = 0; i < T::kBox / 2; ++i) fin[b][i] = (dq[b][i] + cor[b][i]) * a.scale;
  store_acc<DH>(a.dq + row0 * DH, fin, r0, c2, q_rows);
}

template <int DH>
cudaError_t prepare_bw() {
  static const cudaError_t set[2] = {
      cudaFuncSetAttribute(attention_bwd_dq_bf16_scores_kernel<DH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, Bw<DH>::kBytesQ),
      cudaFuncSetAttribute(attention_bwd_dkv_bf16_scores_kernel<DH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, Bw<DH>::kBytesKV)};
  return set[0] != cudaSuccess ? set[0] : set[1];
}

template <int DH>
cudaError_t launch_bw(bool dkv, const void* q, const void* k, const void* v, const void* dout,
                      const BwArgs& a, int B, cudaStream_t stream) {
  cudaError_t e = prepare_bw<DH>();
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tk, tv, tdo;
  const int BH = B * a.H;
  constexpr int kBox = Bw<DH>::kBox;
  if ((e = h::tensor_map_rows(&tq, q, DH, a.Lq, BH, kBox, kRowsBW)) != cudaSuccess ||
      (e = h::tensor_map_rows(&tk, k, DH, a.Lk, BH, kBox, kRowsBW)) != cudaSuccess ||
      (e = h::tensor_map_rows(&tv, v, DH, a.Lk, BH, kBox, kRowsBW)) != cudaSuccess ||
      (e = h::tensor_map_rows(&tdo, dout, DH, a.Lq, BH, kBox, kRowsBW)) != cudaSuccess)
    return e;
  const int own = dkv ? a.Lk : a.Lq;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((own + kRowsBW - 1) / kRowsBW), static_cast<unsigned>(BH));
  cfg.blockDim = dim3(kThreadsBW);
  cfg.dynamicSmemBytes = dkv ? Bw<DH>::kBytesKV : Bw<DH>::kBytesQ;
  cfg.stream = stream;
  if (dkv) return cudaLaunchKernelEx(&cfg, attention_bwd_dkv_bf16_scores_kernel<DH>, tq, tk, tv, tdo, a);
  return cudaLaunchKernelEx(&cfg, attention_bwd_dq_bf16_scores_kernel<DH>, tq, tk, tv, tdo, a);
}

template <int DH>
cudaError_t occupancy_bw(bool dkv, int* out) {
  cudaError_t e = prepare_bw<DH>();
  if (e != cudaSuccess) return e;
  const void* kern = dkv ? reinterpret_cast<const void*>(attention_bwd_dkv_bf16_scores_kernel<DH>)
                         : reinterpret_cast<const void*>(attention_bwd_dq_bf16_scores_kernel<DH>);
  const int bytes = dkv ? Bw<DH>::kBytesKV : Bw<DH>::kBytesQ;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kern, kThreadsBW, bytes);
  out[1] = attr.numRegs;
  out[2] = bytes;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return e;
}

cudaError_t dispatch_bw(bool dkv, const void* q, const void* k, const void* v, const void* dout,
                        const BwArgs& a, int B, int dh, cudaStream_t stream, int* occ) {
  switch (dh) {
#define PTT_BW_CASE(D) \
  case D:              \
    return occ != nullptr ? occupancy_bw<D>(dkv, occ) : launch_bw<D>(dkv, q, k, v, dout, a, B, stream);
    PTT_BW_CASE(16)
    PTT_BW_CASE(32)
    PTT_BW_CASE(64)
    PTT_BW_CASE(128)
#undef PTT_BW_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

BwArgs args_of(const void* bias, const float* lse, const float* rowmax, int H, int Lq, int Lk,
               int64_t bias_b_stride, int64_t bias_h_stride, float scale, int causal) {
  BwArgs a = {};
  a.bias = static_cast<const float*>(bias);
  a.lse = lse;
  a.rowmax = rowmax;
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  a.bias_b_stride = bias_b_stride;
  a.bias_h_stride = bias_h_stride;
  a.scale = scale;
  a.causal = causal;
  return a;
}

}  // namespace

namespace ptt {

// The bf16-score backward of bf16 q, k, v, out, dout ([B, H, L, dh],
// contiguous, 16-byte aligned; the checks are flash_attention.cu's run())
// and a float32 bias (null, or batch and head strides in elements), from the
// forward's lse = log l and rowmax = m.  di is float32 [2, B, H, Lq]: dQ
// writes dq, di[0] = rowsum(dout * out) and di[1] = t, the share of the row
// max's cotangent each tie takes; dK/dV reads both.  occ != null: the occupancy query instead
// (out[0..3] as ptt_attention_occupancy's).
cudaError_t attention_bwd_dq_bf16_scores(const void* q, const void* k, const void* v,
                                         const void* bias, const void* out, const void* dout,
                                         const float* lse, const float* rowmax, float* di,
                                         void* dq, int B, int H, int Lq, int Lk, int dh,
                                         int64_t bias_b_stride, int64_t bias_h_stride,
                                         float scale, int causal, cudaStream_t stream, int* occ) {
  BwArgs a = args_of(bias, lse, rowmax, H, Lq, Lk, bias_b_stride, bias_h_stride, scale, causal);
  a.out = static_cast<const bf16*>(out);
  a.dout = static_cast<const bf16*>(dout);
  a.k = static_cast<const bf16*>(k);
  a.di = di;
  a.tie = di + static_cast<int64_t>(B) * H * Lq;
  a.dq = static_cast<bf16*>(dq);
  return dispatch_bw(false, q, k, v, dout, a, B, dh, stream, occ);
}

cudaError_t attention_bwd_dkv_bf16_scores(const void* q, const void* k, const void* v,
                                          const void* bias, const void* dout, const float* lse,
                                          const float* rowmax, const float* di, void* dk, void* dv,
                                          int B, int H, int Lq, int Lk, int dh,
                                          int64_t bias_b_stride, int64_t bias_h_stride,
                                          float scale, int causal, cudaStream_t stream, int* occ) {
  BwArgs a = args_of(bias, lse, rowmax, H, Lq, Lk, bias_b_stride, bias_h_stride, scale, causal);
  a.di = const_cast<float*>(di);
  a.tie = a.di + static_cast<int64_t>(B) * H * Lq;
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  return dispatch_bw(true, q, k, v, dout, a, B, dh, stream, occ);
}

}  // namespace ptt
