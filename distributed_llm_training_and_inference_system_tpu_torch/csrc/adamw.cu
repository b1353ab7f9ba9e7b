// Fused AdamW update of one parameter leaf, in place, for Hopper (sm_90a).
//
// Replaces the TPU kernel _adamw_kernel of the JAX package's
// exec/fused_update.py: one pass reads (p, g, mu, nu) and writes
// (p', mu', nu'), with the global-norm clip folded in. The four scalars
// (lr, 1 - b1^t, 1 - b2^t, clip scale) are read from a device fp32[4], so
// nothing waits for the host.
//
// What bounds it on an H100: bytes. Per element it reads 16 B and writes
// 12 B at fp32 p/g/mu/nu (28 B over 3.35 TB/s) for ~20 flops, far below
// the ridge. The design is one grid-stride elementwise pass with 16-byte
// vector loads where a leaf's pointers allow them.
//
// Every operation is rounded on its own, in the order of the plain
// PyTorch version (exec/fused_update._leaf_math, optax's order): the
// __f*_rn intrinsics keep nvcc from contracting a*b + c into an FMA, so
// the kernel is bitwise equal to eager PyTorch on the card. b1 * mu is
// rounded to mu's dtype before the add, as PyTorch and optax do for a
// bf16 mu; the caller passes b1 already rounded to mu's dtype (optax
// multiplies by a weak-typed scalar).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;
};

template <typename TM, typename TN>
__device__ __forceinline__ void update_one(float& p, float g, TM& mu, TN& nu,
                                           float lr, float om1, float om2,
                                           float clip, const Hyper& h) {
  const float g32 = __fmul_rn(g, clip);
  // b1 * mu in mu's own dtype
  const float b1mu = to_f(from_f<TM>(__fmul_rn(h.b1, to_f(mu))));
  const float mu32 = __fadd_rn(__fmul_rn(h.omb1, g32), b1mu);
  const float nu32 = __fadd_rn(__fmul_rn(h.omb2, __fmul_rn(g32, g32)),
                               __fmul_rn(h.b2, to_f(nu)));
  const float mu_hat = __fdiv_rn(mu32, om1);
  const float nu_hat = __fdiv_rn(nu32, om2);
  float upd = __fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(nu_hat), h.eps));
  if (h.wd != 0.f) upd = __fadd_rn(upd, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, upd));
  mu = from_f<TM>(mu32);
  nu = from_f<TN>(nu32);
}

template <typename TM, typename TN>
__global__ void __launch_bounds__(256) adamw_kernel(
    float* __restrict__ p, const float* __restrict__ g, TM* __restrict__ mu,
    TN* __restrict__ nu, const float* __restrict__ scalars, long long n,
    Hyper h, int vec4) {
  const float lr = scalars[0], om1 = scalars[1], om2 = scalars[2],
              clip = scalars[3];
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec4) {           // 4 elements a thread: 16-byte loads of p and g
    const long long n4 = n / 4;
    for (; i < n4; i += stride) {
      float4 pv = reinterpret_cast<float4*>(p)[i];
      const float4 gv = reinterpret_cast<const float4*>(g)[i];
      const long long b = 4 * i;
      update_one(pv.x, gv.x, mu[b], nu[b], lr, om1, om2, clip, h);
      update_one(pv.y, gv.y, mu[b + 1], nu[b + 1], lr, om1, om2, clip, h);
      update_one(pv.z, gv.z, mu[b + 2], nu[b + 2], lr, om1, om2, clip, h);
      update_one(pv.w, gv.w, mu[b + 3], nu[b + 3], lr, om1, om2, clip, h);
      reinterpret_cast<float4*>(p)[i] = pv;
    }
    // the tail past the last full vector
    i = 4 * n4 + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  }
  for (; i < n; i += stride)
    update_one(p[i], g[i], mu[i], nu[i], lr, om1, om2, clip, h);
}

template <typename TM, typename TN>
int launch(void* p, const void* g, void* mu, void* nu, const void* scalars,
           long long n, Hyper h, cudaStream_t st) {
  const int threads = 256;
  const int vec4 = ((uintptr_t)p % 16 == 0 && (uintptr_t)g % 16 == 0) ? 1 : 0;
  long long work = vec4 ? (n + 3) / 4 : n;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;     // grid-stride past this
  if (blocks < 1) blocks = 1;
  adamw_kernel<TM, TN><<<(unsigned)blocks, threads, 0, st>>>(
      (float*)p, (const float*)g, (TM*)mu, (TN*)nu, (const float*)scalars, n,
      h, vec4);
  return (int)cudaGetLastError();
}

}  // namespace

// p, g fp32; mu fp32 (mu_bf16 = 0) or bf16 (1); nu likewise. scalars is a
// device fp32[4] = (lr, 1 - b1^t, 1 - b2^t, clip scale). b1 is rounded to
// mu's dtype; omb1/omb2 are 1 - b1 and 1 - b2 (of the unrounded b1, b2) as
// the caller rounds them. Returns the launch's CUDA
// error code (0 = launched).
extern "C" int adamw_update(void* p, const void* g, void* mu, void* nu,
                            const void* scalars, long long n, float b1,
                            float omb1, float b2, float omb2, float eps,
                            float wd, int mu_bf16, int nu_bf16, void* stream) {
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  cudaStream_t st = (cudaStream_t)stream;
  if (!mu_bf16 && !nu_bf16)
    return launch<float, float>(p, g, mu, nu, scalars, n, h, st);
  if (mu_bf16 && !nu_bf16)
    return launch<bf16, float>(p, g, mu, nu, scalars, n, h, st);
  if (!mu_bf16 && nu_bf16)
    return launch<float, bf16>(p, g, mu, nu, scalars, n, h, st);
  return launch<bf16, bf16>(p, g, mu, nu, scalars, n, h, st);
}
