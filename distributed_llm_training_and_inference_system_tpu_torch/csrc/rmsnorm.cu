// Fused RMSNorm forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of the JAX package's
// distributed_llm_training_and_inference_system_tpu/ops/rmsnorm.py:
// per row of x [rows, H], the fp32 mean of squares, rsqrt(var + eps), the
// row times that and times (1 + scale), cast back to x's dtype. Forward
// only, as the TPU kernel.
//
// What bounds it: bytes (one read and one write of x; a handful of flops
// per element), and at the entry forward's [1024, 2048] the latency of one
// short launch. The design:
//
// - One launch a call. The scale is read in its own dtype (fp32 or bf16)
//   and widened in registers: no conversion kernel ahead of the norm.
// - A warp owns a whole row where the row fits its registers (up to
//   kMaxLaneVecs 16-byte vectors a lane: bf16 H <= 4096, fp32 H <= 2048).
//   The row stays packed in registers between the sum of squares and the
//   scaling and is reduced by shuffles alone, with no barrier.
// - A warp walks rows r, r + warps, r + 2 warps, ... It loads its lane's
//   part of the scale once, before its first row, and keeps it in
//   registers across its rows; with at most 8 vectors a lane it issues the
//   next row's loads before it reduces the current one.
// - Longer rows take a block of 256 threads a row: the row kept in
//   registers (up to 4 vectors a thread), the scale of those vectors
//   loaded before the reduction, one barrier for the cross-warp sum.
// - x is loaded and the output stored as 16-byte vectors with streaming
//   (evict-first) hints: each byte is touched once. The launch shape
//   (vectors a lane, warps, warps a block, grid) comes from the wrapper's
//   plan (ops/rmsnorm.py, launch_plan).
//
// Numerics: the sum of squares in fp32, each lane over its vectors in
// order, then a butterfly of shuffles (every lane ends with the same bits),
// so repeated calls give identical bits; rsqrtf as before.
//
// Launch rules: the caller's stream, no allocation, no synchronisation;
// the launcher returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlockThreads = 256;      // the block-per-row path
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kBlockKeep = 4;           // vectors a thread keeps there
constexpr int kMaxLaneVecs = 16;        // the warp-per-row path's limit
constexpr int kMaxWarpsPerBlock = 8;

// x's dtype: a 16-byte vector holds kN elements
template <typename T> struct XT;
template <> struct XT<float> {
    static constexpr int kN = 4;
    static __device__ __forceinline__ void widen(const uint4& r, float* v) {
        v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
        v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
    }
    static __device__ __forceinline__ uint4 narrow(const float* v) {
        return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                          __float_as_uint(v[2]), __float_as_uint(v[3]));
    }
};
template <> struct XT<bf16> {
    static constexpr int kN = 8;
    static __device__ __forceinline__ void widen(const uint4& r, float* v) {
        const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {       // exact: a bf16 is an fp32's top
            v[2 * i] = __uint_as_float(w[i] << 16);
            v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
    static __device__ __forceinline__ uint4 narrow(const float* v) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {       // round to nearest even
            const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i],
                                                           v[2 * i + 1]);
            w[i] = *reinterpret_cast<const uint32_t*>(&h);
        }
        return make_uint4(w[0], w[1], w[2], w[3]);
    }
};

// The scale of one x vector (N elements of S), kept as raw 32-bit words
// and widened where it is used.
template <typename S, int N> struct ScaleVec {
    static constexpr int kWords = N * (int)sizeof(S) / 4;   // 2, 4 or 8
    uint32_t w[kWords];

    __device__ __forceinline__ void load(const S* p) {   // cached: all warps
        if constexpr (kWords == 2) {
            const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
            w[0] = r.x; w[1] = r.y;
        } else {
#pragma unroll
            for (int i = 0; i < kWords / 4; ++i) {
                const uint4 r = __ldg(reinterpret_cast<const uint4*>(p) + i);
                w[4 * i] = r.x; w[4 * i + 1] = r.y;
                w[4 * i + 2] = r.z; w[4 * i + 3] = r.w;
            }
        }
    }
    __device__ __forceinline__ float at(int e) const {
        if constexpr (sizeof(S) == 4) return __uint_as_float(w[e]);
        else return __uint_as_float(e % 2 ? (w[e / 2] & 0xffff0000u)
                                          : (w[e / 2] << 16));
    }
};

template <typename T>
__device__ __forceinline__ float sum_squares(const uint4& raw) {
    float v[XT<T>::kN];
    XT<T>::widen(raw, v);
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < XT<T>::kN; ++e) s += v[e] * v[e];
    return s;
}

template <typename T, typename S>
__device__ __forceinline__ uint4 scaled(const uint4& raw,
                                        const ScaleVec<S, XT<T>::kN>& s,
                                        float inv) {
    constexpr int V = XT<T>::kN;
    float v[V], o[V];
    XT<T>::widen(raw, v);
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = (v[e] * inv) * (1.f + s.at(e));
    return XT<T>::narrow(o);
}

// One warp a row, VPL 16-byte vectors a lane (lane l holds vectors l,
// l + 32, ...). Warp w of the grid takes rows w, w + warps, ...
template <typename T, typename S, int VPL>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
rmsnorm_warp_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                    T* __restrict__ out, int rows, int H, int warps,
                    float eps) {
    constexpr int V = XT<T>::kN;
    constexpr bool kPrefetch = VPL <= 8;    // registers for a second row
    const int lane = threadIdx.x & 31;
    const int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (w >= warps) return;
    const int vecs = H / V;
    ScaleVec<S, V> sc[VPL];
    uint4 cur[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {         // the scale's loads first
        const int v = lane + 32 * i;
        if (v < vecs) sc[i].load(scale + (size_t)v * V);
    }
    auto load_row = [&](uint4* dst, int r) {
        const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)r * H);
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
            const int v = lane + 32 * i;
            if (v < vecs) dst[i] = __ldcs(src + v);
        }
    };
    load_row(cur, w);
    for (int r = w; r < rows; r += warps) {
        uint4 nxt[VPL];
        if constexpr (kPrefetch) {
            if (r + warps < rows) load_row(nxt, r + warps);
        }
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < VPL; ++i)
            if (lane + 32 * i < vecs) sum += sum_squares<T>(cur[i]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float inv = rsqrtf(sum / (float)H + eps);
        uint4* dst = reinterpret_cast<uint4*>(out + (size_t)r * H);
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
            const int v = lane + 32 * i;
            if (v < vecs) __stcs(dst + v, scaled<T, S>(cur[i], sc[i], inv));
        }
        if constexpr (kPrefetch) {
#pragma unroll
            for (int i = 0; i < VPL; ++i) cur[i] = nxt[i];
        } else if (r + warps < rows) {
            load_row(cur, r + warps);
        }
    }
}

// One block of 256 threads a row, for rows longer than a warp holds.
template <typename T, typename S>
__global__ void __launch_bounds__(kBlockThreads)
rmsnorm_block_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                     T* __restrict__ out, int H, float eps) {
    constexpr int V = XT<T>::kN;
    __shared__ float warp_sums[kBlockWarps];
    const int tid = threadIdx.x;
    const uint4* xr = reinterpret_cast<const uint4*>(
        x + (size_t)blockIdx.x * H);
    uint4* orow = reinterpret_cast<uint4*>(out + (size_t)blockIdx.x * H);
    const int vecs = H / V;
    uint4 keep[kBlockKeep];
    ScaleVec<S, V> sc[kBlockKeep];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kBlockKeep; ++i) {
        const int v = tid + i * kBlockThreads;
        if (v < vecs) {
            keep[i] = __ldcs(xr + v);
            sc[i].load(scale + (size_t)v * V);
        }
    }
#pragma unroll
    for (int i = 0; i < kBlockKeep; ++i)
        if (tid + i * kBlockThreads < vecs) sum += sum_squares<T>(keep[i]);
    for (int v = tid + kBlockKeep * kBlockThreads; v < vecs;
         v += kBlockThreads)
        sum += sum_squares<T>(__ldg(xr + v));
    for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (tid % 32 == 0) warp_sums[tid / 32] = sum;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kBlockWarps; ++w) total += warp_sums[w];
    const float inv = rsqrtf(total / (float)H + eps);
#pragma unroll
    for (int i = 0; i < kBlockKeep; ++i) {
        const int v = tid + i * kBlockThreads;
        if (v < vecs) __stcs(orow + v, scaled<T, S>(keep[i], sc[i], inv));
    }
    for (int v = tid + kBlockKeep * kBlockThreads; v < vecs;
         v += kBlockThreads) {
        ScaleVec<S, V> s;
        s.load(scale + (size_t)v * V);
        __stcs(orow + v, scaled<T, S>(__ldcs(xr + v), s, inv));
    }
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, int rows, int H,
           float eps, int vpl, int warps, int warps_per_block, int grid,
           cudaStream_t st) {
    const T* xp = static_cast<const T*>(x);
    const S* sp = static_cast<const S*>(scale);
    T* op = static_cast<T*>(out);
    if (vpl == 0) {
        rmsnorm_block_kernel<T, S><<<rows, kBlockThreads, 0, st>>>(
            xp, sp, op, H, eps);
        return cudaGetLastError();
    }
    const int vecs = H / XT<T>::kN;
    if (vpl > kMaxLaneVecs || vecs > 32 * vpl || warps <= 0
        || warps_per_block <= 0 || warps_per_block > kMaxWarpsPerBlock
        || (long long)grid * warps_per_block < warps)
        return cudaErrorInvalidValue;
    const dim3 block(32 * warps_per_block);
#define RMSNORM_WARP(N)                                                    \
    case N:                                                                \
        rmsnorm_warp_kernel<T, S, N><<<grid, block, 0, st>>>(              \
            xp, sp, op, rows, H, warps, eps);                              \
        break;
    switch (vpl) {
        RMSNORM_WARP(1) RMSNORM_WARP(2) RMSNORM_WARP(4) RMSNORM_WARP(8)
        RMSNORM_WARP(16)
        default: return cudaErrorInvalidValue;
    }
#undef RMSNORM_WARP
    return cudaGetLastError();
}

}  // namespace

// x, out: [rows, H] in x_dtype (0 = float32, 1 = bfloat16), 16-byte
// aligned rows (H a multiple of 8); scale: [H] in s_dtype (same codes),
// 16-byte aligned. vpl = 16-byte vectors a lane (1, 2, 4, 8 or 16) for a
// warp a row, walked by ``warps`` warps of ``warps_per_block`` a block in
// ``grid`` blocks; vpl = 0 for a block a row (the rest ignored). Returns a
// cudaError_t.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           int rows, int H, float eps, int x_dtype,
                           int s_dtype, int vpl, int warps,
                           int warps_per_block, int grid, void* stream) {
    if (rows <= 0) return cudaSuccess;
    if (H <= 0 || H % 8 != 0) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int code = 2 * x_dtype + s_dtype;
    if (x_dtype < 0 || x_dtype > 1 || s_dtype < 0 || s_dtype > 1)
        return cudaErrorInvalidValue;
    switch (code) {
        case 0: return launch<float, float>(x, scale, out, rows, H, eps, vpl,
                                            warps, warps_per_block, grid, s);
        case 1: return launch<float, bf16>(x, scale, out, rows, H, eps, vpl,
                                           warps, warps_per_block, grid, s);
        case 2: return launch<bf16, float>(x, scale, out, rows, H, eps, vpl,
                                           warps, warps_per_block, grid, s);
        default: return launch<bf16, bf16>(x, scale, out, rows, H, eps, vpl,
                                           warps, warps_per_block, grid, s);
    }
}
