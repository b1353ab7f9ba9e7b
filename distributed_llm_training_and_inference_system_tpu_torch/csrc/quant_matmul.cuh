// Frame of the W8A16 decode matmuls (int8_matmul.cu) on CUDA cores: y[B,
// out] = x[B, in] . W[in, out] for B <= 64 rows of activations rounded to
// bf16 and int8 weights, fp32 accumulation. The W4A16 kernel
// (int4_matmul.cu) no longer uses it: it runs on the tensor cores
// (tensor_core.cuh). The per-input-channel row scale of W8 is folded into
// the activations as they are staged, in fp32 and rounded to bf16 once,
// which is what the JAX wrapper does before its kernel.
//
// What bounds it: weight bytes. At decode (a few rows) every weight is
// used once per row, far below the card's ~295 flop/byte ridge, so the
// design reads each stored weight byte from device memory exactly once,
// with 4-byte loads that a half-warp joins into one 64-byte row segment,
// expands it in registers, and never writes a bf16 weight anywhere.
//
// Tiling: a block of 256 threads owns 64 output columns and a range of the
// reduction. Thread (tx, ty): tx = 4 adjacent columns; ty picks a group of
// 8 rows (rg) and a slice of the reduction (ks), so every thread holds an
// 8 x 4 fp32 accumulator whatever the row count: BT = 8 padded rows gives
// 16 k-slices, BT = 64 gives 2. The activations of a chunk of the
// reduction sit in shared memory as fp32, [k][row], read as broadcast
// float4s; a chunk is 8192 / BT input channels, 64 per k-slice. At the end
// the k-slices' partial sums meet in shared memory and are added in slice
// order, so the result does not depend on scheduling.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace qmm {

constexpr int kThreads = 256;
constexpr int kTileCols = 64;          // 16 threads x 4 columns
constexpr int kRowsPerThread = 8;
constexpr int kSlice = 64;             // input channels per thread and chunk
constexpr int kSmemFloats = 8192;      // 32 KB: x chunk, later the partials
constexpr int kMaxRows = 64;

template <int BT> struct Tiling {
    static constexpr int kRowGroups = BT / kRowsPerThread;
    static constexpr int kSlices = 16 / kRowGroups;      // k-slices a block
    static constexpr int kChunk = kSmemFloats / BT;      // channels a chunk
    static_assert(kChunk == kSlices * kSlice, "chunk = slices x slice");
};

__device__ __forceinline__ float load_in(const float* p) { return *p; }
__device__ __forceinline__ float load_in(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}

// x[r, k0 .. k0 + chunk) -> xs[k][r]: bf16(x * scale[k]) widened to fp32
// again; rows >= B and channels >= k_end are zero, so whatever weight
// meets them adds nothing
template <int BT, typename XT>
__device__ __forceinline__ void load_x_chunk(
        const XT* __restrict__ x, const float* __restrict__ scale, int B,
        int n_in, int k0, int k_end, float* xs) {
    constexpr int KC = Tiling<BT>::kChunk;
    for (int idx = threadIdx.x; idx < KC * BT; idx += kThreads) {
        const int r = idx / KC, kk = idx % KC;
        const int k = k0 + kk;
        float v = 0.f;
        if (r < B && k < k_end) {
            const float xv = load_in(x + (size_t)r * n_in + k);
            v = __bfloat162float(__float2bfloat16(
                __fmul_rn(xv, __ldg(scale + k))));
        }
        xs[kk * BT + r] = v;
    }
}

// 8 activations (this thread's rows) of channel kk of the chunk
template <int BT>
__device__ __forceinline__ void load_x_rows(const float* xs, int kk, int rg,
                                            float* xr) {
    const float4* p =
        reinterpret_cast<const float4*>(xs + kk * BT + rg * kRowsPerThread);
    const float4 a = p[0], b = p[1];
    xr[0] = a.x; xr[1] = a.y; xr[2] = a.z; xr[3] = a.w;
    xr[4] = b.x; xr[5] = b.y; xr[6] = b.z; xr[7] = b.w;
}

__device__ __forceinline__ void fma_8x4(float (&acc)[8][4], const float* xr,
                                        const float* wc) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xr[r], wc[c], acc[r][c]);
}

// every thread's accumulator -> red[ks][row][col] in shared memory (the x
// chunk's region, free after the barrier)
template <int BT>
__device__ __forceinline__ void store_partials(const float (&acc)[8][4],
                                               float* red) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int rg = ty % Tiling<BT>::kRowGroups;
    const int ks = ty / Tiling<BT>::kRowGroups;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
        float4* dst = reinterpret_cast<float4*>(
            red + ((size_t)(ks * BT + rg * kRowsPerThread + r)) * kTileCols
            + tx * 4);
        *dst = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    __syncthreads();
}

__device__ __forceinline__ void store_out(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* dst, float v) {
    *dst = __float2bfloat16(v);         // round to nearest even
}

// the k-slices' sums, in slice order, to out[r, col0 + c] for r < B
template <int BT, typename OutT>
__device__ __forceinline__ void write_tile(const float* red, OutT* out,
                                           int B, int n_out, int col0) {
    for (int idx = threadIdx.x; idx < BT * kTileCols; idx += kThreads) {
        const int r = idx / kTileCols, c = idx % kTileCols;
        if (r >= B) continue;
        float s = 0.f;
#pragma unroll
        for (int ks = 0; ks < Tiling<BT>::kSlices; ++ks)
            s += red[(size_t)(ks * BT + r) * kTileCols + c];
        store_out(out + (size_t)r * n_out + col0 + c, s);
    }
}

inline int padded_rows(int B) {
    return B <= 8 ? 8 : B <= 16 ? 16 : B <= 32 ? 32 : 64;
}

}  // namespace qmm
