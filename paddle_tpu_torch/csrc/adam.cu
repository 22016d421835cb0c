// Adam update of one parameter, in place:
//   m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g*g;  p = p - lr_t*m / (sqrt(v) + eps)
// with lr_t = lr*sqrt(1-b2^t)/(1-b1^t) computed by the caller on the device
// and read here through a pointer, so no launch waits on the host.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py fused_adam (_adam_kernel, the
// pl.pallas_call at :368).  The TPU kernel aliases p, m and v to its outputs
// (input_output_aliases); here the kernel writes p, m and v where it read
// them, which is the same contract.
//
// Bound on the H100: memory.  Each element reads p, m, v and g and writes
// p, m and v: 28 bytes in float32 against ~10 float operations.  For
// BERT-base's largest parameter (the 30522 x 768 token embedding, 23.4M
// elements) that is 656 MB, 196 us at 3.35 TB/s; 3.70 GB and 1.10 ms for
// all 198 parameters of a step.
//
// AMP (contrib/mixed_precision): `found_inf`, when not null, points to one
// bool on the device, the decorator's overflow flag.  When it is set the
// step is skipped: every thread reads it before any other load and returns,
// so p, m and v keep their bits.  The flag is read on the device, never on
// the host, so a step that carries it can be captured in a CUDA graph (the
// replay launches the kernel whatever the flag says).  The JAX package
// selects old against new after its update (paddle_tpu/ops/optimizer_ops.py
// register_opt); here p, m and v are written in place, so a select after
// the kernel would see only the updated values: the kernel applies the
// flag itself.
//
// Design: one grid-stride pass.  Each thread moves 4 elements of every array
// per load (16 bytes in float32, 8 in bfloat16 and float16) and a scalar loop takes the
// last n % 4 elements, so any n works: the TPU kernel's lane rule
// (n % 256 == 0, else the composite) has no counterpart.  Vectors need every
// pointer 16-byte aligned; otherwise the whole pass is scalar.  p, m/v and g
// are each float32, bfloat16 or float16 (m and v share a type); the math is
// float32.
#include "common.cuh"

namespace {

// The EMA weights come in pairs: b and 1 - b, the latter rounded once from
// the double difference as the JAX package's weakly typed `1.0 - beta` is
// (1 - 0.999f in float would be off by 1.3e-5 relative).
struct Betas {
  float b1, omb1, b2, omb2, eps;
};

template <typename TP, typename TM, typename TG>
__device__ __forceinline__ void adam_one(TP& p, TM& m, TM& v, TG g, float lr, const Betas& k) {
  const float gf = ptt::to_f32(g);
  const float mf = k.b1 * ptt::to_f32(m) + k.omb1 * gf;
  const float vf = k.b2 * ptt::to_f32(v) + k.omb2 * (gf * gf);
  p = ptt::from_f32<TP>(ptt::to_f32(p) - lr * mf / (sqrtf(vf) + k.eps));
  m = ptt::from_f32<TM>(mf);
  v = ptt::from_f32<TM>(vf);
}

template <typename TP, typename TM, typename TG, int VEC>
__global__ void adam_kernel(TP* __restrict__ p, const TG* __restrict__ g, TM* __restrict__ m,
                            TM* __restrict__ v, const float* __restrict__ lr_t,
                            const bool* __restrict__ found_inf, int64_t n, Betas k) {
  if (found_inf != nullptr && *found_inf) return;  // an overflowed step: nothing moves
  const float lr = *lr_t;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n_vec = n / VEC;
  for (int64_t i = tid; i < n_vec; i += step) {
    ptt::Vec<TP, VEC> pv = reinterpret_cast<ptt::Vec<TP, VEC>*>(p)[i];
    ptt::Vec<TM, VEC> mv = reinterpret_cast<ptt::Vec<TM, VEC>*>(m)[i];
    ptt::Vec<TM, VEC> vv = reinterpret_cast<ptt::Vec<TM, VEC>*>(v)[i];
    const ptt::Vec<TG, VEC> gv = reinterpret_cast<const ptt::Vec<TG, VEC>*>(g)[i];
#pragma unroll
    for (int e = 0; e < VEC; ++e) adam_one(pv.v[e], mv.v[e], vv.v[e], gv.v[e], lr, k);
    reinterpret_cast<ptt::Vec<TP, VEC>*>(p)[i] = pv;
    reinterpret_cast<ptt::Vec<TM, VEC>*>(m)[i] = mv;
    reinterpret_cast<ptt::Vec<TM, VEC>*>(v)[i] = vv;
  }
  for (int64_t j = n_vec * VEC + tid; j < n; j += step) adam_one(p[j], m[j], v[j], g[j], lr, k);
}

template <typename TP, typename TM, typename TG>
cudaError_t launch(void* p, const void* g, void* m, void* v, const void* lr_t,
                   const bool* found_inf, int64_t n, const Betas& k, cudaStream_t stream) {
  constexpr int kThreads = 256;
  constexpr int kVec = 4;
  const bool vec = ptt::aligned16(p) && ptt::aligned16(g) && ptt::aligned16(m) &&
                   ptt::aligned16(v);
  const int64_t work = vec ? (n + kVec - 1) / kVec : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 8;  // a few blocks per SM; the loop covers the rest
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  auto* pp = static_cast<TP*>(p);
  auto* gp = static_cast<const TG*>(g);
  auto* mp = static_cast<TM*>(m);
  auto* vp = static_cast<TM*>(v);
  auto* lp = static_cast<const float*>(lr_t);
  if (vec)
    adam_kernel<TP, TM, TG, kVec><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        pp, gp, mp, vp, lp, found_inf, n, k);
  else
    adam_kernel<TP, TM, TG, 1><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        pp, gp, mp, vp, lp, found_inf, n, k);
  return cudaGetLastError();
}

template <typename TP, typename TM>
cudaError_t dispatch_g(int g_dtype, void* p, const void* g, void* m, void* v, const void* lr_t,
                       const bool* fi, int64_t n, const Betas& k, cudaStream_t s) {
  if (g_dtype == ptt::kFloat32) return launch<TP, TM, float>(p, g, m, v, lr_t, fi, n, k, s);
  if (g_dtype == ptt::kBFloat16)
    return launch<TP, TM, __nv_bfloat16>(p, g, m, v, lr_t, fi, n, k, s);
  if (g_dtype == ptt::kFloat16) return launch<TP, TM, __half>(p, g, m, v, lr_t, fi, n, k, s);
  return cudaErrorInvalidValue;
}

template <typename TP>
cudaError_t dispatch_m(int m_dtype, int g_dtype, void* p, const void* g, void* m, void* v,
                       const void* lr_t, const bool* fi, int64_t n, const Betas& k,
                       cudaStream_t s) {
  if (m_dtype == ptt::kFloat32)
    return dispatch_g<TP, float>(g_dtype, p, g, m, v, lr_t, fi, n, k, s);
  if (m_dtype == ptt::kBFloat16)
    return dispatch_g<TP, __nv_bfloat16>(g_dtype, p, g, m, v, lr_t, fi, n, k, s);
  if (m_dtype == ptt::kFloat16)
    return dispatch_g<TP, __half>(g_dtype, p, g, m, v, lr_t, fi, n, k, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// p: [n] dtype p_dtype; g: [n] dtype g_dtype; m, v: [n] dtype m_dtype (all
// contiguous); lr_t: one float32 on the device; found_inf: null, or one bool
// on the device that skips the step when set.  Updates p, m and v in place.
// beta1 and beta2 come as doubles: 1 - beta is taken in double, then rounded once.
extern "C" int ptt_adam(void* p, const void* g, void* m, void* v, const void* lr_t,
                        const void* found_inf, int64_t n, double beta1, double beta2, float eps,
                        int p_dtype, int g_dtype, int m_dtype, void* stream) {
  if (n == 0) return 0;
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const Betas k{static_cast<float>(beta1), static_cast<float>(1.0 - beta1),
                static_cast<float>(beta2), static_cast<float>(1.0 - beta2), eps};
  const auto* fi = static_cast<const bool*>(found_inf);
  if (p_dtype == ptt::kFloat32)
    return dispatch_m<float>(m_dtype, g_dtype, p, g, m, v, lr_t, fi, n, k, s);
  if (p_dtype == ptt::kBFloat16)
    return dispatch_m<__nv_bfloat16>(m_dtype, g_dtype, p, g, m, v, lr_t, fi, n, k, s);
  if (p_dtype == ptt::kFloat16)
    return dispatch_m<__half>(m_dtype, g_dtype, p, g, m, v, lr_t, fi, n, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
