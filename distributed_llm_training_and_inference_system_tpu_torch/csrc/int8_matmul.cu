// W8A16 decode matmul with in-kernel dequantization, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of the JAX package's
// distributed_llm_training_and_inference_system_tpu/ops/
// int8_matmul_pallas.py: `_make_kernel` (the whole reduction per output
// tile) and `_make_ksplit_kernel` (the reduction cut into k tiles, for
// wide reductions). Both compute y = bf16(x * scale) . bf16(values) with
// fp32 accumulation: the per-input-row scale is folded into the
// activations as they are staged in shared memory (fp32 product, rounded
// to bf16 once), so the inner loop is a convert-and-dot. An int8 value
// converts to fp32 exactly, and a bf16 x bf16 product is exact in fp32.
//
// - int8_matmul_whole_k: grid (out / 64); a block walks the whole
//   reduction and writes its 64 columns of y in x's dtype.
// - int8_matmul_ksplit: grid (out / 64, splits); block (c, s) walks
//   reduction rows [s * split_len, (s + 1) * split_len) and writes fp32
//   partial sums to a workspace [splits, B, out]; a second small kernel
//   adds the splits in order and writes y. No atomics, so the same inputs
//   give the same bits on every call. Any reduction length is handled (a
//   short last split, a short last chunk).
//
// What bounds them, and the tiling: quant_matmul.cuh. The values cross
// device memory once, one byte each; nothing wider is ever written.
//
// Launch rules: the caller's stream, no allocation, no synchronisation;
// each launcher returns cudaGetLastError().

#include "quant_matmul.cuh"

namespace {

using namespace qmm;

// four int8 values of one 32-bit word -> fp32, exactly: the byte plus 128
// becomes the low mantissa byte of 2^23, and 2^23 + 128 is subtracted
__device__ __forceinline__ void int8x4_to_float(unsigned w, float* dst) {
    const unsigned u = w ^ 0x80808080u;
    dst[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
    dst[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
    dst[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
    dst[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// this block's 64 columns over reduction rows [k_begin, k_end): leaves the
// k-slices' partial sums in smem as red[ks][row][col]
template <int BT, typename XT>
__device__ __forceinline__ void w8_tile(
        const XT* __restrict__ x,                 // [B, n_in]
        const float* __restrict__ scale,          // [n_in]
        const signed char* __restrict__ w,        // [n_in, n_out]
        int B, int n_in, int n_out, int k_begin, int k_end, int col0,
        float* smem) {
    using Tl = Tiling<BT>;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int rg = ty % Tl::kRowGroups, ks = ty / Tl::kRowGroups;
    const int col = col0 + tx * 4;
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

    for (int k0 = k_begin; k0 < k_end; k0 += Tl::kChunk) {
        __syncthreads();                 // the last chunk has been read
        load_x_chunk<BT>(x, scale, B, n_in, k0, k_end, smem);
        __syncthreads();
        const int kbase = k0 + ks * kSlice;
        for (int i0 = 0; i0 < kSlice; i0 += 8) {
            unsigned wv[8];              // 8 loads in flight per thread
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                // past the end: any valid row, its activations are zero
                const int k = min(kbase + i0 + j, n_in - 1);
                wv[j] = __ldg(reinterpret_cast<const unsigned*>(
                    w + (size_t)k * n_out + col));
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                float xr[8], wc[4];
                load_x_rows<BT>(smem, ks * kSlice + i0 + j, rg, xr);
                int8x4_to_float(wv[j], wc);
                fma_8x4(acc, xr, wc);
            }
        }
    }
    store_partials<BT>(acc, smem);
}

template <int BT, typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_whole_k_kernel(const OutT* __restrict__ x,
                           const float* __restrict__ scale,
                           const signed char* __restrict__ w,
                           OutT* __restrict__ y, int B, int n_in,
                           int n_out) {
    __shared__ __align__(16) float smem[kSmemFloats];
    const int col0 = blockIdx.x * kTileCols;
    w8_tile<BT>(x, scale, w, B, n_in, n_out, 0, n_in, col0, smem);
    write_tile<BT>(smem, y, B, n_out, col0);
}

template <int BT, typename XT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_ksplit_kernel(const XT* __restrict__ x,
                          const float* __restrict__ scale,
                          const signed char* __restrict__ w,
                          float* __restrict__ partial,   // [splits, B, out]
                          int B, int n_in, int n_out, int split_len) {
    __shared__ __align__(16) float smem[kSmemFloats];
    const int col0 = blockIdx.x * kTileCols;
    const int k_begin = blockIdx.y * split_len;
    const int k_end = min(n_in, k_begin + split_len);
    w8_tile<BT>(x, scale, w, B, n_in, n_out, k_begin, k_end, col0, smem);
    write_tile<BT>(smem, partial + (size_t)blockIdx.y * B * n_out, B, n_out,
                   col0);
}

// y[i] = partial[0][i] + partial[1][i] + ... in split order
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_ksplit_reduce_kernel(const float* __restrict__ partial,
                                 OutT* __restrict__ y, int n, int splits) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partial[(size_t)k * n + i];
    store_out(y + i, s);
}

template <int BT, typename OutT>
cudaError_t launch_whole_k(const void* x, const void* scale, const void* w,
                           void* y, int B, int n_in, int n_out,
                           cudaStream_t s) {
    int8_matmul_whole_k_kernel<BT, OutT><<<n_out / kTileCols, kThreads, 0,
                                           s>>>(
        static_cast<const OutT*>(x), static_cast<const float*>(scale),
        static_cast<const signed char*>(w), static_cast<OutT*>(y), B, n_in,
        n_out);
    return cudaGetLastError();
}

template <typename OutT>
cudaError_t whole_k_rows(const void* x, const void* scale, const void* w,
                         void* y, int B, int n_in, int n_out,
                         cudaStream_t s) {
    switch (padded_rows(B)) {
        case 8:
            return launch_whole_k<8, OutT>(x, scale, w, y, B, n_in, n_out, s);
        case 16:
            return launch_whole_k<16, OutT>(x, scale, w, y, B, n_in, n_out,
                                            s);
        case 32:
            return launch_whole_k<32, OutT>(x, scale, w, y, B, n_in, n_out,
                                            s);
        default:
            return launch_whole_k<64, OutT>(x, scale, w, y, B, n_in, n_out,
                                            s);
    }
}

template <int BT, typename XT>
cudaError_t launch_ksplit(const void* x, const void* scale, const void* w,
                          void* partial, int B, int n_in, int n_out,
                          int split_len, int splits, cudaStream_t s) {
    const dim3 grid(n_out / kTileCols, splits);
    int8_matmul_ksplit_kernel<BT, XT><<<grid, kThreads, 0, s>>>(
        static_cast<const XT*>(x), static_cast<const float*>(scale),
        static_cast<const signed char*>(w), static_cast<float*>(partial), B,
        n_in, n_out, split_len);
    return cudaGetLastError();
}

template <typename XT>
cudaError_t ksplit_rows(const void* x, const void* scale, const void* w,
                        void* partial, int B, int n_in, int n_out,
                        int split_len, int splits, cudaStream_t s) {
    switch (padded_rows(B)) {
        case 8:
            return launch_ksplit<8, XT>(x, scale, w, partial, B, n_in, n_out,
                                        split_len, splits, s);
        case 16:
            return launch_ksplit<16, XT>(x, scale, w, partial, B, n_in, n_out,
                                         split_len, splits, s);
        case 32:
            return launch_ksplit<32, XT>(x, scale, w, partial, B, n_in, n_out,
                                         split_len, splits, s);
        default:
            return launch_ksplit<64, XT>(x, scale, w, partial, B, n_in, n_out,
                                         split_len, splits, s);
    }
}

bool bad_shape(int B, int n_in, int n_out) {
    return B <= 0 || B > kMaxRows || n_in <= 0 || n_out <= 0
           || n_out % kTileCols != 0;
}

}  // namespace

// x: [B, n_in] in dtype (0 = float32, 1 = bfloat16); scale: fp32 [n_in],
// one per input row of w; w: int8 [n_in, n_out]; y: [B, n_out] in dtype.
// Returns a cudaError_t (0 = success).
extern "C" int int8_matmul_whole_k(const void* x, const void* scale,
                                   const void* w, void* y, int B, int n_in,
                                   int n_out, int dtype, void* stream) {
    if (bad_shape(B, n_in, n_out)) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return whole_k_rows<float>(x, scale, w, y, B, n_in, n_out, s);
    if (dtype == 1)
        return whole_k_rows<__nv_bfloat16>(x, scale, w, y, B, n_in, n_out, s);
    return cudaErrorInvalidValue;
}

// The same product with the reduction cut into ceil(n_in / split_len)
// splits; partial: fp32 workspace [splits, B, n_out].
extern "C" int int8_matmul_ksplit(const void* x, const void* scale,
                                  const void* w, void* partial, void* y,
                                  int B, int n_in, int n_out, int split_len,
                                  int dtype, void* stream) {
    if (bad_shape(B, n_in, n_out) || split_len <= 0
        || (dtype != 0 && dtype != 1))
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int splits = (n_in + split_len - 1) / split_len;
    const cudaError_t err =
        dtype == 0 ? ksplit_rows<float>(x, scale, w, partial, B, n_in, n_out,
                                        split_len, splits, s)
                   : ksplit_rows<__nv_bfloat16>(x, scale, w, partial, B, n_in,
                                                n_out, split_len, splits, s);
    if (err != cudaSuccess) return err;
    const int n = B * n_out;
    const int blocks = (n + kThreads - 1) / kThreads;
    if (dtype == 0)
        int8_matmul_ksplit_reduce_kernel<float><<<blocks, kThreads, 0, s>>>(
            static_cast<const float*>(partial), static_cast<float*>(y), n,
            splits);
    else
        int8_matmul_ksplit_reduce_kernel<__nv_bfloat16>
            <<<blocks, kThreads, 0, s>>>(
                static_cast<const float*>(partial),
                static_cast<__nv_bfloat16*>(y), n, splits);
    return cudaGetLastError();
}
