// Fused RMSNorm forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of the JAX package's
// distributed_llm_training_and_inference_system_tpu/ops/rmsnorm.py:
// per row of x [rows, H], the fp32 mean of squares, rsqrt(var + eps), the
// row times that and times (1 + scale), cast back to x's dtype. Forward
// only, as the TPU kernel.
//
// What bounds it: bytes (one read and one write of x; a handful of flops
// per element). One block of 256 threads per row. The row is read once
// from device memory with 16-byte loads and kept in registers (up to
// kMaxVecs vectors a thread, H <= 8192 in bf16) between the reduction and
// the scaling; a longer row is read a second time. The sum of squares is
// reduced by warp shuffles, then across the 8 warps through shared
// memory, in a fixed order.
//
// Launch rules: the caller's stream, no allocation, no synchronisation;
// the launcher returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVecs = 4;     // 16-byte vectors a thread keeps

template <typename T> struct Vec;
template <> struct Vec<float> {
    static constexpr int kN = 4;
    static __device__ __forceinline__ void load(const float* p, float* v) {
        const float4 r = *reinterpret_cast<const float4*>(p);
        v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
    }
    static __device__ __forceinline__ void store(float* p, const float* v) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
};
template <> struct Vec<__nv_bfloat16> {
    static constexpr int kN = 8;
    static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                                float* v) {
        const uint4 raw = *reinterpret_cast<const uint4*>(p);
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            v[2 * i] = f.x;
            v[2 * i + 1] = f.y;
        }
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                                 const float* v) {
        uint4 raw;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i)     // round to nearest even
            h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        *reinterpret_cast<uint4*>(p) = raw;
    }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x,          // [rows, H]
               const float* __restrict__ scale,  // [H]
               T* __restrict__ out, int H, float eps) {
    constexpr int V = Vec<T>::kN;
    __shared__ float warp_sums[kWarps];
    const int tid = threadIdx.x;
    const T* xr = x + (size_t)blockIdx.x * H;
    T* orow = out + (size_t)blockIdx.x * H;
    const int vecs = H / V;
    float keep[kMaxVecs][V];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxVecs; ++i) {
        const int v = tid + i * kThreads;
        if (v < vecs) {
            Vec<T>::load(xr + v * V, keep[i]);
#pragma unroll
            for (int e = 0; e < V; ++e) sum += keep[i][e] * keep[i][e];
        }
    }
    for (int v = tid + kMaxVecs * kThreads; v < vecs; v += kThreads) {
        float t[V];
        Vec<T>::load(xr + v * V, t);
#pragma unroll
        for (int e = 0; e < V; ++e) sum += t[e] * t[e];
    }
    for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (tid % 32 == 0) warp_sums[tid / 32] = sum;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    const float inv = rsqrtf(total / (float)H + eps);

    auto emit = [&](int v, const float* xv) {
        float s[V], o[V];
        if constexpr (V == 4) {
            Vec<float>::load(scale + v * V, s);
        } else {
            Vec<float>::load(scale + v * V, s);
            Vec<float>::load(scale + v * V + 4, s + 4);
        }
#pragma unroll
        for (int e = 0; e < V; ++e) o[e] = (xv[e] * inv) * (1.f + s[e]);
        Vec<T>::store(orow + v * V, o);
    };
#pragma unroll
    for (int i = 0; i < kMaxVecs; ++i) {
        const int v = tid + i * kThreads;
        if (v < vecs) emit(v, keep[i]);
    }
    for (int v = tid + kMaxVecs * kThreads; v < vecs; v += kThreads) {
        float t[V];
        Vec<T>::load(xr + v * V, t);
        emit(v, t);
    }
}

}  // namespace

// x, out: [rows, H] in dtype (0 = float32, 1 = bfloat16), 16-byte aligned
// rows (H a multiple of 8); scale: fp32 [H]. Returns a cudaError_t.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           int rows, int H, float eps, int dtype,
                           void* stream) {
    if (rows <= 0) return cudaSuccess;
    if (H <= 0 || H % 8 != 0) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        rmsnorm_kernel<float><<<rows, kThreads, 0, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(scale),
            static_cast<float*>(out), H, eps);
    else if (dtype == 1)
        rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const float*>(scale),
            static_cast<__nv_bfloat16*>(out), H, eps);
    else
        return cudaErrorInvalidValue;
    return cudaGetLastError();
}
