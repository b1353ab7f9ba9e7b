// W4A16 decode matmul with in-kernel dequantization, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_kernel` of the JAX package's
// distributed_llm_training_and_inference_system_tpu/ops/
// int4_matmul_pallas.py: y = x_even . W_lo + x_odd . W_hi, where byte
// [i, o] of packed[in/2, out] holds input channels 2i (low nibble) and
// 2i + 1 (high nibble) of output column o as 4-bit two's complement, and
// input channels [g * group, (g + 1) * group) share scale[g, o]. A weight
// is float(nibble) * scale in fp32, ROUNDED TO BF16 as the TPU kernel
// rounds it, and meets a bf16 activation (x / chan in fp32, rounded once,
// as it is staged in shared memory) in an fp32 accumulator.
//
// Grid (out / 64): a block walks the whole reduction and writes its 64
// columns of y in x's dtype. A thread's 4-byte load carries 8 weights (2
// channels x 4 columns); the group's four scales are one float4 load,
// repeated only when the group changes. What bounds it, and the tiling:
// quant_matmul.cuh. The nibbles cross device memory once, half a byte
// each; nothing wider is ever written.
//
// Launch rules: the caller's stream, no allocation, no synchronisation;
// the launcher returns cudaGetLastError().

#include "quant_matmul.cuh"

namespace {

using namespace qmm;

// bf16(float(nibble as 4-bit two's complement) * scale), widened again
__device__ __forceinline__ float w4_weight(unsigned nibble, float scale) {
    const float v = (float)((int)(nibble ^ 8u) - 8) * scale;
    return __bfloat162float(__float2bfloat16(v));
}

template <int BT, typename OutT>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const OutT* __restrict__ x,             // [B, n_in]
                   const float* __restrict__ chan,         // [n_in]
                   const unsigned char* __restrict__ packed,  // [n_in/2, out]
                   const float* __restrict__ scale,        // [n_in/group, out]
                   OutT* __restrict__ y, int B, int n_in, int n_out,
                   int group) {
    __shared__ __align__(16) float smem[kSmemFloats];
    using Tl = Tiling<BT>;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int rg = ty % Tl::kRowGroups, ks = ty / Tl::kRowGroups;
    const int col0 = blockIdx.x * kTileCols;
    const int col = col0 + tx * 4;
    const int n_pairs = n_in / 2;
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    int g_cur = -1;
    float4 sc = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int k0 = 0; k0 < n_in; k0 += Tl::kChunk) {
        __syncthreads();                 // the last chunk has been read
        load_x_chunk<BT, true>(x, chan, B, n_in, k0, n_in, smem);
        __syncthreads();
        const int pbase = (k0 + ks * kSlice) / 2;      // first packed row
        for (int i0 = 0; i0 < kSlice / 2; i0 += 8) {
            unsigned wv[8];              // 8 loads in flight per thread
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                // past the end: any valid row, its activations are zero
                const int p = min(pbase + i0 + j, n_pairs - 1);
                wv[j] = __ldg(reinterpret_cast<const unsigned*>(
                    packed + (size_t)p * n_out + col));
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int p = min(pbase + i0 + j, n_pairs - 1);
                const int g = (2 * p) / group;
                if (g != g_cur) {
                    sc = __ldg(reinterpret_cast<const float4*>(
                        scale + (size_t)g * n_out + col));
                    g_cur = g;
                }
                const float s4[4] = {sc.x, sc.y, sc.z, sc.w};
                float xe[8], xo[8], wlo[4], whi[4];
                const int kk = ks * kSlice + 2 * (i0 + j);
                load_x_rows<BT>(smem, kk, rg, xe);
                load_x_rows<BT>(smem, kk + 1, rg, xo);
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const unsigned b = (wv[j] >> (8 * c)) & 0xffu;
                    wlo[c] = w4_weight(b & 0xfu, s4[c]);
                    whi[c] = w4_weight(b >> 4, s4[c]);
                }
                fma_8x4(acc, xe, wlo);
                fma_8x4(acc, xo, whi);
            }
        }
    }
    store_partials<BT>(acc, smem);
    write_tile<BT>(smem, y, B, n_out, col0);
}

template <int BT, typename OutT>
cudaError_t launch(const void* x, const void* chan, const void* packed,
                   const void* scale, void* y, int B, int n_in, int n_out,
                   int group, cudaStream_t s) {
    int4_matmul_kernel<BT, OutT><<<n_out / kTileCols, kThreads, 0, s>>>(
        static_cast<const OutT*>(x), static_cast<const float*>(chan),
        static_cast<const unsigned char*>(packed),
        static_cast<const float*>(scale), static_cast<OutT*>(y), B, n_in,
        n_out, group);
    return cudaGetLastError();
}

#define W4_ARGS x, chan, packed, scale, y, B, n_in, n_out, group, s

template <typename OutT>
cudaError_t launch_rows(const void* x, const void* chan, const void* packed,
                        const void* scale, void* y, int B, int n_in,
                        int n_out, int group, cudaStream_t s) {
    switch (padded_rows(B)) {
        case 8: return launch<8, OutT>(W4_ARGS);
        case 16: return launch<16, OutT>(W4_ARGS);
        case 32: return launch<32, OutT>(W4_ARGS);
        default: return launch<64, OutT>(W4_ARGS);
    }
}

}  // namespace

// x: [B, n_in] in dtype (0 = float32, 1 = bfloat16); chan: fp32 [n_in];
// packed: uint8 [n_in / 2, n_out]; scale: fp32 [n_in / group, n_out]; y:
// [B, n_out] in dtype. Returns a cudaError_t (0 = success).
extern "C" int int4_matmul(const void* x, const void* chan,
                           const void* packed, const void* scale, void* y,
                           int B, int n_in, int n_out, int group, int dtype,
                           void* stream) {
    if (B <= 0 || B > kMaxRows || n_in <= 0 || n_in % 2 != 0 || n_out <= 0
        || n_out % kTileCols != 0 || group <= 0 || group % 2 != 0
        || n_in % group != 0)
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_rows<float>(W4_ARGS);
    if (dtype == 1) return launch_rows<__nv_bfloat16>(W4_ARGS);
    return cudaErrorInvalidValue;
}
