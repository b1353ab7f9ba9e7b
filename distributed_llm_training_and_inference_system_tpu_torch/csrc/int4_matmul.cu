// W4A16 decode matmul on the tensor cores, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_kernel` of the JAX package's
// distributed_llm_training_and_inference_system_tpu/ops/
// int4_matmul_pallas.py: y = x_even . W_lo + x_odd . W_hi, where byte
// [i, o] of packed[in/2, out] holds input channels 2i (low nibble) and
// 2i + 1 (high nibble) of output column o as 4-bit two's complement, and
// input channels [g * group, (g + 1) * group) share scale[g, o]. A weight
// is float(nibble) * scale in fp32, ROUNDED TO BF16 as the TPU kernel
// rounds it; an activation is x / chan in fp32 (IEEE division), rounded
// to bf16 once; the products meet in fp32 accumulators.
//
// What bounds it: weight bytes. At decode (8 rows) a weight byte feeds 32
// flops, far below the card's ~295 flop/byte ridge, so the nibbles cross
// device memory once, half a byte each, and no wider weight is ever
// written. What is left to make small is the instruction count around each
// byte.
//
// Design ("swap AB"): y^T = W^T . x^T with mma.sync m16n8k16 bf16 -> fp32.
// The m16 rows are output columns, n8 the decode rows (8 rows: one n-tile,
// no padding; up to 64: 8 n-tiles, each A fragment feeding them all), k16
// 16 input channels. A register a0 of lane (g = lane / 4, t = lane % 4)
// holds channels 2t and 2t + 1 of one m-row: exactly one packed byte, low
// nibble then high. A warp's two m-tiles cover 32 columns, and lane g owns
// columns 4g .. 4g + 3 (m-rows g and g + 8 of tile 0, then of tile 1), so
// one 4-byte load of packed row k0/2 + t gives a0 and a1 of both tiles and
// row k0/2 + t + 4 gives a2 and a3. A byte becomes one bf16x2 register
// without I2F: with the word's nibbles xor 8, one LOP3 makes the float
// 2^23 + v 2^SH of the nibble v at shift SH, an FADD takes away 2^23 + 8
// 2^SH (exact), an FMUL by the fp32 scale times 2^-SH gives n * scale
// rounded once, and one cvt.rn.bf16x2.f32 rounds the pair: bit for bit the
// plain version's weight.
//
// Tiling: a block owns 32 output columns (4096 columns: 128 blocks); its
// 8 or 16 warps split the reduction into contiguous ranges of k-steps and
// walk them in chunks (CS k-steps, 1024 activations a chunk). A warp's x
// rows and chan for a chunk reach its own two-stage region of shared
// memory by 16-byte cp.async copies (rows past B stay zero), and its
// packed words for the chunk reach registers by 4-byte loads; both are
// requested one chunk ahead. The B fragments are built from the staged x:
// bf16(x / chan) by IEEE division (every (row, channel) once a block),
// packed as bf16x2. With group a multiple of 16 a k-step's channels share
// one scale row: a lane's four scales are one float4, loaded one group
// ahead; smaller groups look the scale up for each packed row. At the end
// the warps' fp32 partials meet in shared memory and are added in warp
// order, so two calls give identical bits. No pass across blocks.
//
// Launch rules: the caller's stream, no allocation, no synchronisation;
// the launcher returns cudaGetLastError().

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

using namespace tc;

constexpr int kBlockCols = 32;         // two m16 tiles
constexpr int kOutMultiple = 64;       // the ABI's column multiple
constexpr int kMaxRows = 64;

// Per padded row count BT: k-steps a chunk (CS; BT x 16 CS = 1024
// activations, 2048 at 64 rows) and the padded row of a warp's raw x tile
// (KC + 8 elements: the rows that a B-fragment load reads fall in
// distinct banks). A warp holds two stages of [BT][KC + 8] x in x's dtype
// and [KC] channel scales.
template <int BT, typename XT> struct Tiling {
    static constexpr int kMaxWarps = BT <= 16 ? 16 : 8;   // <= 128 registers
    static constexpr int CS = 64 / BT > 2 ? 64 / BT : 2;
    static constexpr int KC = 16 * CS;
    static constexpr int LD = KC + 8;
    static constexpr int kStage = BT * LD * (int)sizeof(XT) + KC * 4;
    // a block of `warps` warps: its stages, later its partials
    static constexpr int smem(int warps) {
        return warps * (2 * kStage > BT * kBlockCols * 4
                        ? 2 * kStage : BT * kBlockCols * 4);
    }
};

// a packed word, read-only path; L2 fetches the 128 bytes around it (the
// neighbouring blocks' columns of the same rows, read at about the same
// time: 3% faster than 32-byte sectors on an H100)
__device__ __forceinline__ uint32_t ldg32(const unsigned char* p) {
    uint32_t v;
    asm("ld.global.nc.L2::128B.u32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}

// float(v - 8) * 2^SH for the nibble v at bits [SH, SH + 4) of u: the bits
// 0x4B000000 | (v << SH) are the float 2^23 + v 2^SH (exact for SH <= 12),
// made by one LOP3, minus 2^23 + 8 * 2^SH (exact)
template <int SH>
__device__ __forceinline__ float nibble_f(uint32_t u) {
    uint32_t r;
    asm("lop3.b32 %0, %1, %2, %3, 0xEA;"          // (u & mask) | magic
        : "=r"(r) : "r"(u), "n"(0xFu << SH), "r"(0x4B000000u));
    return __uint_as_float(r) - (8388608.f + 8.f * (1 << SH));
}

// A lane's four column scales, each times 2^-SH for the shift its low and
// high nibble sit at in a half-word (byte 0: SH 0 and 4, byte 1: 8 and
// 12). Powers of two are exact, so (v - 8) 2^SH * s 2^-SH rounds as
// (v - 8) * s does: bit for bit the plain version's weight.
struct Scales {
    float v[8];
};
__device__ __forceinline__ Scales shifted(const float4& s) {
    return {{s.x, s.x * 0x1p-4f, s.y * 0x1p-8f, s.y * 0x1p-12f,
             s.z, s.z * 0x1p-4f, s.w * 0x1p-8f, s.w * 0x1p-12f}};
}

// bytes 0 and 1 of half-word u (columns c, c + 1) -> two bf16x2 registers
__device__ __forceinline__ void dequant_half(uint32_t u, const float* s,
                                             uint32_t& r0, uint32_t& r1) {
    r0 = pack_bf16(nibble_f<0>(u) * s[0], nibble_f<4>(u) * s[1]);
    r1 = pack_bf16(nibble_f<8>(u) * s[2], nibble_f<12>(u) * s[3]);
}

// A fragments of both m-tiles from the words of packed rows p (w0) and
// p + 4 (w1), with the shifted scales of the lane's columns for each row
__device__ __forceinline__ void dequant_a(uint32_t (&a)[2][4], uint32_t w0,
                                          uint32_t w1, const Scales& s0,
                                          const Scales& s1) {
    w0 ^= 0x88888888u;                  // v = nibble ^ 8: n = v - 8
    w1 ^= 0x88888888u;
    dequant_half(w0, s0.v, a[0][0], a[0][1]);
    dequant_half(w1, s1.v, a[0][2], a[0][3]);
    dequant_half(w0 >> 16, s0.v + 4, a[1][0], a[1][1]);
    dequant_half(w1 >> 16, s1.v + 4, a[1][2], a[1][3]);
}

// packed words of k-steps [s0, s0 + n) (n <= CS) of this lane
template <int CS>
__device__ __forceinline__ void load_chunk(uint32_t (&w)[CS][2],
                                           const unsigned char* packed,
                                           int s0, int n, int t, int n_pairs,
                                           int n_out) {
    if (8 * (s0 + n) <= n_pairs) {      // whole k-steps: no row past the end
        const unsigned char* p = packed + (size_t)(8 * s0 + t) * n_out;
        const size_t four = (size_t)4 * n_out;        // 4 packed rows
#pragma unroll
        for (int j = 0; j < CS; ++j) {
            if (j < n) {
                w[j][0] = ldg32(p + 2 * j * four);
                w[j][1] = ldg32(p + (2 * j + 1) * four);
            }
        }
        return;
    }
#pragma unroll
    for (int j = 0; j < CS; ++j) {      // the last k-step is half: clamp
        if (j < n) {
            const int p = 8 * (s0 + j) + t;
            w[j][0] = ldg32(packed + (size_t)min(p, n_pairs - 1) * n_out);
            w[j][1] = ldg32(packed + (size_t)min(p + 4, n_pairs - 1) * n_out);
        }
    }
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

// two adjacent activations (an even channel and the next) as floats
__device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    return make_float2(__uint_as_float(u << 16),
                       __uint_as_float(u & 0xFFFF0000u));
}

// x (rows < B) and chan of the chunk's k-steps [s0, s0 + n) into a stage
// of the warp: 16-byte cp.async copies where x's rows and chan are 16-byte
// aligned (channels >= n_in zero-filled), else element loads
template <int BT, typename XT>
__device__ __forceinline__ void copy_x(unsigned char* stage, const XT* x,
                                       const float* chan, int B, int n_in,
                                       int s0, int n, bool async, int lane) {
    using Tl = Tiling<BT, XT>;
    XT* xr = reinterpret_cast<XT*>(stage);
    float* cs = reinterpret_cast<float*>(stage + BT * Tl::LD * sizeof(XT));
    const int k0 = 16 * s0, kn = 16 * n;
    if (async) {
        constexpr int V = 16 / sizeof(XT), ROW = Tl::KC / V;  // copies
        for (int i = lane; i < B * ROW; i += 32) {
            const int r = i / ROW, kk = (i % ROW) * V;
            if (kk >= kn) continue;
            const int k = k0 + kk;
            const bool ok = k < n_in;
            cp_async16(xr + r * Tl::LD + kk,
                       x + (ok ? (size_t)r * n_in + k : 0), ok);
        }
        for (int i = lane; 4 * i < kn; i += 32) {
            const int k = k0 + 4 * i;
            cp_async16(cs + 4 * i, chan + (k < n_in ? k : 0), k < n_in);
        }
        cp_async_commit();
        return;
    }
    for (int i = lane; i < B * Tl::KC; i += 32) {
        const int r = i / Tl::KC, kk = i % Tl::KC;
        if (kk >= kn) continue;
        const int k = k0 + kk;
        if (k < n_in)
            xr[r * Tl::LD + kk] = x[(size_t)r * n_in + k];
        else
            put(xr + r * Tl::LD + kk, 0.f);
    }
    for (int i = lane; i < kn; i += 32)
        cs[i] = k0 + i < n_in ? chan[k0 + i] : 1.f;
}

template <int BT, bool kG16, typename XT>
struct Warp {
    using Tl = Tiling<BT, XT>;
    static constexpr int CS = Tl::CS, LD = Tl::LD;
    static constexpr int NT = BT / 8;         // n-tiles

    float acc[2][NT][4];
    // group % 16 == 0: the scales of the current k-step, the next row
    Scales sc;
    float4 sc_next;
    int g_cur, g_pos, g_steps, n_groups;

    // the next group row's scales become the current ones
    __device__ __forceinline__ void next_group(const float* scale,
                                               int n_out) {
        g_pos = 0;
        sc = shifted(sc_next);
        ++g_cur;
        sc_next = scale_row(scale, min(g_cur + 1, n_groups - 1), n_out);
    }

    // k-steps [s0, s0 + n) of the chunk whose x and chan are in stage,
    // whose packed words are in w; kOneGroup: all of them in the current
    // group row (group % 16 == 0), so no scale changes inside
    template <bool kOneGroup>
    __device__ __forceinline__ void compute(
            const uint32_t (&w)[CS][2], const unsigned char* stage, int s0,
            int n, int B, int n_in, const float* scale, int n_out, int group,
            int n_pairs, int lane) {
        const int g = lane >> 2, t = lane & 3;
        const XT* xr = reinterpret_cast<const XT*>(stage) + g * LD + 2 * t;
        const float* cs = reinterpret_cast<const float*>(
            stage + BT * LD * sizeof(XT)) + 2 * t;
#pragma unroll
        for (int j = 0; j < CS; ++j) {
            if (j >= n) break;
            // B fragments: bf16(x / chan) of row nt * 8 + g, channels 2t,
            // 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of the k-step
            const float2 c0 = load2(cs + 16 * j), c1 = load2(cs + 16 * j + 8);
            bool keep0 = true, keep1 = true;  // channels < n_in
            if constexpr (!kG16) {
                keep0 = 16 * (s0 + j) + 2 * t < n_in;
                keep1 = 16 * (s0 + j) + 2 * t + 8 < n_in;
            }
            uint32_t b[NT][2];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                if (nt * 8 >= B) break;           // rows past B: no product
                // a zero row is not divided: 0 / c takes __fdiv_rn's slow path
                const bool live = nt * 8 + g < B;
                const float2 x0 = load2(xr + nt * 8 * LD + 16 * j);
                const float2 x1 = load2(xr + nt * 8 * LD + 16 * j + 8);
                b[nt][0] = live && keep0 ? pack_bf16(__fdiv_rn(x0.x, c0.x),
                                             __fdiv_rn(x0.y, c0.y)) : 0u;
                b[nt][1] = live && keep1 ? pack_bf16(__fdiv_rn(x1.x, c1.x),
                                             __fdiv_rn(x1.y, c1.y)) : 0u;
            }
            uint32_t a[2][4];
            if constexpr (kG16) {
                dequant_a(a, w[j][0], w[j][1], sc, sc);
                if (!kOneGroup && ++g_pos == g_steps)  // uniform
                    next_group(scale, n_out);
            } else {
                const int p = 8 * (s0 + j) + t;
                const float4 s0v = scale_row(
                    scale, 2 * min(p, n_pairs - 1) / group, n_out);
                const float4 s1v = scale_row(
                    scale, 2 * min(p + 4, n_pairs - 1) / group, n_out);
                dequant_a(a, w[j][0], w[j][1], shifted(s0v),
                          shifted(s1v));
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                if (nt * 8 >= B) break;
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
                    mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
            }
        }
    }

    // the lane's four scales of group row g (scale already offset to them)
    __device__ __forceinline__ static float4 scale_row(const float* scale,
                                                       int g, int n_out) {
        return __ldg(reinterpret_cast<const float4*>(scale
                                                     + (size_t)g * n_out));
    }
};

template <int BT, bool kG16, typename OutT>
__global__ void __launch_bounds__(32 * Tiling<BT, OutT>::kMaxWarps)
int4_matmul_kernel(const OutT* __restrict__ x,             // [B, n_in]
                   const float* __restrict__ chan,         // [n_in]
                   const unsigned char* __restrict__ packed,  // [n_in/2, out]
                   const float* __restrict__ scale,        // [n_in/group, out]
                   OutT* __restrict__ y, int B, int n_in, int n_out,
                   int group, int async) {
    using Tl = Tiling<BT, OutT>;
    constexpr int CS = Tl::CS, NT = BT / 8;
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int warps = blockDim.x / 32;
    const int g = lane >> 2, t = lane & 3;
    const int col0 = blockIdx.x * kBlockCols;
    const int n_pairs = n_in / 2;
    // the lane's four columns: its packed words and scales start there
    packed += col0 + 4 * g;
    scale += col0 + 4 * g;
    unsigned char* stages = smem + warp * 2 * Tl::kStage;
    for (int s = 0; s < 2; ++s) {                  // rows past B are zero
        OutT* xr = reinterpret_cast<OutT*>(stages + s * Tl::kStage);
        for (int i = B * Tl::LD + lane; i < BT * Tl::LD; i += 32)
            put(xr + i, 0.f);
    }

    // this warp's contiguous range of k-steps
    const int steps = (n_in + 15) / 16;
    const int s_begin = warp * steps / warps;
    const int s_end = (warp + 1) * steps / warps;

    Warp<BT, kG16, OutT> st;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) st.acc[mt][nt][i] = 0.f;
    if constexpr (kG16) {
        st.g_steps = group / 16;
        st.n_groups = n_in / group;
        st.g_cur = min(s_begin / st.g_steps, st.n_groups - 1);
        st.g_pos = s_begin % st.g_steps;
        st.sc = shifted(st.scale_row(scale, st.g_cur, n_out));
        st.sc_next = st.scale_row(scale, min(st.g_cur + 1, st.n_groups - 1),
                                  n_out);
    }

    // chunks of CS k-steps through two stages: the x, chan and packed words
    // of chunk c + 1 are in flight while chunk c is computed
    uint32_t wa[CS][2], wb[CS][2];
    auto run = [&](int s0, int stage, uint32_t (&cur)[CS][2],
                   uint32_t (&nxt)[CS][2]) {
        cp_async_wait_all();
        __syncwarp();                   // chunk s0's x is in for every lane
        const int s1 = s0 + CS;
        if (s1 < s_end) {
            const int n1 = min(CS, s_end - s1);
            copy_x<BT>(stages + (stage ^ 1) * Tl::kStage, x, chan, B, n_in,
                       s1, n1, async, lane);
            load_chunk<CS>(nxt, packed, s1, n1, t, n_pairs, n_out);
        }
        const int n = min(CS, s_end - s0);
        const unsigned char* xs = stages + stage * Tl::kStage;
        if (kG16 && st.g_pos + n <= st.g_steps) {
            st.template compute<true>(cur, xs, s0, n, B, n_in, scale, n_out,
                                      group, n_pairs, lane);
            st.g_pos += n;
            if (st.g_pos == st.g_steps) st.next_group(scale, n_out);
        } else {
            st.template compute<false>(cur, xs, s0, n, B, n_in, scale, n_out,
                                       group, n_pairs, lane);
        }
        __syncwarp();                   // every lane is done with the stage
    };
    if (s_begin < s_end) {
        const int n0 = min(CS, s_end - s_begin);
        copy_x<BT>(stages, x, chan, B, n_in, s_begin, n0, async, lane);
        load_chunk<CS>(wa, packed, s_begin, n0, t, n_pairs, n_out);
    }
    for (int s0 = s_begin; s0 < s_end; s0 += 2 * CS) {
        run(s0, 0, wa, wb);
        if (s0 + CS < s_end) run(s0 + CS, 1, wb, wa);
    }

    // partials -> red[warp][row][col], the columns in their true order
    __syncthreads();                    // every warp is done with its x
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            const int n = nt * 8 + 2 * t, c = 4 * g + 2 * mt;
            float* dst = red + (warp * BT + n) * kBlockCols + c;
            *reinterpret_cast<float2*>(dst) =
                make_float2(st.acc[mt][nt][0], st.acc[mt][nt][2]);
            *reinterpret_cast<float2*>(dst + kBlockCols) =
                make_float2(st.acc[mt][nt][1], st.acc[mt][nt][3]);
        }
    __syncthreads();
    for (int i = threadIdx.x; i < B * kBlockCols; i += blockDim.x) {
        const int r = i / kBlockCols, c = i % kBlockCols;
        float s = 0.f;
        for (int w = 0; w < warps; ++w)
            s += red[(w * BT + r) * kBlockCols + c];
        put(y + (size_t)r * n_out + col0 + c, s);
    }
}

// Warps a block: every SM holds 16 warps (<= 128 registers a thread), so
// 16 where one wave of such blocks covers the columns, else 8: more warps
// a block split the reduction finer, fewer give each warp a longer run of
// k-steps to pipeline (4096 -> 14336: 0.0513 ms at 4 warps, 0.0493 at 8,
// 0.0547 at 16 on an H100).
inline int block_warps(int blocks, int max_warps) {
    static const int sms = [] {
        int dev = 0, n = 132;
        if (cudaGetDevice(&dev) == cudaSuccess)
            cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        return n;
    }();
    int warps = max_warps;
    while (warps > 8 && blocks * warps > sms * 16) warps /= 2;
    return warps;
}

template <int BT, bool kG16, typename OutT>
cudaError_t launch(const void* x, const void* chan, const void* packed,
                   const void* scale, void* y, int B, int n_in, int n_out,
                   int group, cudaStream_t s) {
    using Tl = Tiling<BT, OutT>;
    // cp.async copies x's rows and chan 16 bytes at a time where aligned
    const int async = reinterpret_cast<uintptr_t>(x) % 16 == 0
                      && reinterpret_cast<uintptr_t>(chan) % 16 == 0
                      && (size_t)n_in * sizeof(OutT) % 16 == 0;
    auto kernel = int4_matmul_kernel<BT, kG16, OutT>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tl::smem(Tl::kMaxWarps));
    if (attr != cudaSuccess) return attr;
    const int blocks = n_out / kBlockCols;
    const int warps = block_warps(blocks, Tl::kMaxWarps);
    kernel<<<blocks, 32 * warps, Tl::smem(warps), s>>>(
        static_cast<const OutT*>(x), static_cast<const float*>(chan),
        static_cast<const unsigned char*>(packed),
        static_cast<const float*>(scale), static_cast<OutT*>(y), B, n_in,
        n_out, group, async);
    return cudaGetLastError();
}

#define W4_ARGS x, chan, packed, scale, y, B, n_in, n_out, group, s

template <int BT, typename OutT>
cudaError_t launch_group(const void* x, const void* chan, const void* packed,
                         const void* scale, void* y, int B, int n_in,
                         int n_out, int group, cudaStream_t s) {
    if (group % 16 == 0) return launch<BT, true, OutT>(W4_ARGS);
    return launch<BT, false, OutT>(W4_ARGS);
}

template <typename OutT>
cudaError_t launch_rows(const void* x, const void* chan, const void* packed,
                        const void* scale, void* y, int B, int n_in,
                        int n_out, int group, cudaStream_t s) {
    if (B <= 8) return launch_group<8, OutT>(W4_ARGS);
    if (B <= 16) return launch_group<16, OutT>(W4_ARGS);
    if (B <= 32) return launch_group<32, OutT>(W4_ARGS);
    return launch_group<64, OutT>(W4_ARGS);
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
        || n_out % kOutMultiple != 0 || group <= 0 || group % 2 != 0
        || n_in % group != 0)
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_rows<float>(W4_ARGS);
    if (dtype == 1) return launch_rows<__nv_bfloat16>(W4_ARGS);
    return cudaErrorInvalidValue;
}
