// W8A16 decode matmul on the tensor cores, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of the JAX package's
// distributed_llm_training_and_inference_system_tpu/ops/
// int8_matmul_pallas.py: `_make_kernel` (the whole reduction per output
// tile) and `_make_ksplit_kernel` (the reduction cut into k tiles). Both
// compute y = bf16(x * scale[k]) . bf16(values) with fp32 accumulation and
// y in x's dtype: the per-input-row scale is folded into the activations
// in fp32 and rounded to bf16 once, an int8 value is exact in bf16, and
// the products meet in fp32 accumulators. Both C entry points run the one
// body below; their names keep the JAX package's two routes.
//
// What bounds it: weight bytes. At decode (a few rows) a weight byte
// feeds 2 flops a row, far below the card's ~295 flop/byte ridge, so the
// int8 values cross device memory once, one byte each, and no wider weight
// is ever written. What the design has to supply is enough bytes in
// flight, and few enough instructions a byte to keep up with them.
//
// Design ("swap AB"): y^T = W^T . x^T with mma.sync m16n8k16 bf16 -> fp32.
// The m16 rows are output columns, k16 is 16 input channels and n8 the
// activation rows (up to 64 rows: 8 n-tiles, each A fragment feeding them
// all).
// - A block owns 128 output columns: every weight row it reads is one
//   whole 128-byte line. Its [k, 128] int8 tile reaches shared memory in
//   stages of 64 rows through a ring of three, by 16-byte cp.async
//   copies requested two stages ahead: 16 KB in flight a block, and every
//   block of the grid resident at once, so 4-7 MB in flight at the large
//   projections, past the ~3.4 MB that 3.35 TB/s needs at ~1 us (one
//   stage more in flight was 7% slower at 14336 -> 4096). A staged row is
//   padded to 144 bytes, so the eight rows an 8x8 ldmatrix reads fall in
//   distinct banks.
// - A fragments from bytes: an ldmatrix.trans of the tile viewed as b16
//   gives lane (g, t) the bytes of weight rows 2t and 2t + 1 of byte
//   columns 2g and 2g + 1. Byte column 2g is m-row g and 2g + 1 is m-row
//   g + 8, so one such register holds a1 beside a0. Bytes 0 and 2 become
//   one bf16x2 register by two LOP3 and one HADD2 (widen_pair), bytes 1
//   and 3 the same after a shift: 7 instructions for 4 weights, no I2F.
//   The epilogue undoes the column mapping.
// - Activations are folded once a block, for its own k-range (in windows
//   of kXBytes when the range is long): bf16(x * scale[k]) into a [row][k]
//   tile padded by 8, read as B fragments by ldmatrix. Rows past B and
//   channels past the block's range are zero, and weight rows past the
//   range are zero-filled, never read.
// - Eight warps: four across the columns (32 each, two m-tiles) times two
//   across a stage's rows (two k-steps each), one block barrier a stage.
//   The two row halves' partials are added in a fixed order at the end.
// - The reduction is split over the blocks of one thread block cluster
//   (ops/int8_matmul.py split_plan: whole k-steps a split, at most 8
//   splits, from the shapes alone). Each block leaves its fp32 partial
//   [rows, 128] in shared memory; after a cluster barrier, each block
//   takes a share of the tile and adds every split's partial in split
//   order through distributed shared memory, so one launch computes y, no
//   workspace touches device memory, and the same inputs give the same
//   bits on every call.
//
// Launch rules: the caller's stream, no allocation, no synchronisation;
// each launcher returns cudaGetLastError().

#include <stdint.h>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tc;

constexpr int kBlockCols = 128;         // one 128-byte line of a weight row
constexpr int kWarpsN = kBlockCols / 32;   // warps across the columns
constexpr int kWarpsK = 2;              // ... and across a stage's rows
constexpr int kThreads = 32 * kWarpsN * kWarpsK;
constexpr int kOutMultiple = 64;        // the ABI's column multiple
constexpr int kMaxRows = 64;
constexpr int kMaxSplits = 8;           // one portable cluster
constexpr int kStepK = 16;              // channels of an mma k-step
constexpr int kStageK = 64;             // weight rows a stage
constexpr int kStages = 3;
constexpr int kPieces = kBlockCols / 16;           // 16-byte copies a row
constexpr int kPitch = kBlockCols + 16;            // bytes a staged row
constexpr int kStageBytes = kStageK * kPitch;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kXBytes = 65536;          // folded activations, at most
constexpr int kPartialLd = kBlockCols + 4;         // floats a partial row
static_assert(kStageK % (2 * kStepK * kWarpsK) == 0,
              "a warp takes pairs of k-steps of a stage");
static_assert(kStageK * kPieces % kThreads == 0, "whole copies a thread");

template <int BT> struct Tiling {
    static constexpr int NT = BT / 8;                     // n-tiles
    static constexpr int kWindow = kXBytes / (2 * BT);    // channels
    static constexpr int kMinBlocks = BT <= 8 ? 4 : BT <= 16 ? 3
                                      : BT <= 32 ? 2 : 1;   // an SM
    // the ring, later the partials; the folded activations after it
    static constexpr int kPartBytes = BT * kPartialLd * 4;
    static constexpr int kRegion = kRingBytes > kPartBytes ? kRingBytes
                                                           : kPartBytes;
    static_assert(kWindow % kStageK == 0, "a stage never straddles");
};

// bf16x2 of the int8 values in bytes 0 and 2 of r, exactly: with b a
// byte, M = bf16(128 + (b & 127)) and C = bf16(-128 - (b & 128)) are one
// LOP3 each (b & 127 fills the mantissa of 128, bit 7 of b the exponent's
// low bit of -128), and M + C = v, an integer that bf16 holds.
__device__ __forceinline__ uint32_t widen_pair(uint32_t r) {
    uint32_t m, c, v;
    asm("lop3.b32 %0, %1, %2, %3, 0xEA;"              // (r & a) | b
        : "=r"(m) : "r"(r), "r"(0x007F007Fu), "r"(0x43004300u));
    asm("lop3.b32 %0, %1, %2, %3, 0xEA;"
        : "=r"(c) : "r"(r), "r"(0x00800080u), "r"(0xC300C300u));
    asm("fma.rn.bf16x2 %0, %1, %2, %3;"
        : "=r"(v) : "r"(m), "r"(0x3F803F80u), "r"(c));   // M * 1 + C
    return v;
}

// the bytes of r are the weights (k, c), (k, c + 1), (k + 1, c), (k + 1,
// c + 1) of byte columns c, c + 1 and rows k, k + 1: lo gets column c,
// hi column c + 1, each as the bf16x2 of rows k, k + 1
__device__ __forceinline__ void widen(uint32_t r, uint32_t& lo,
                                      uint32_t& hi) {
    lo = widen_pair(r);
    hi = widen_pair(r >> 8);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
// 8 activations from their raw 16-byte words: one of bf16, two of fp32
__device__ __forceinline__ void widen8(const uint4* u, float* v,
                                       const __nv_bfloat16*) {
    const uint32_t w[4] = {u[0].x, u[0].y, u[0].z, u[0].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
}
__device__ __forceinline__ void widen8(const uint4* u, float* v,
                                       const float*) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        v[4 * q] = __uint_as_float(u[q].x);
        v[4 * q + 1] = __uint_as_float(u[q].y);
        v[4 * q + 2] = __uint_as_float(u[q].z);
        v[4 * q + 3] = __uint_as_float(u[q].w);
    }
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}

// bf16(v * s) of 8 channels into dst, or zeros for a row past B
__device__ __forceinline__ void store8(bf16_t* dst, const float* v,
                                       const float* s, bool live) {
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (live)
        o = make_uint4(
            pack_bf16(__fmul_rn(v[0], s[0]), __fmul_rn(v[1], s[1])),
            pack_bf16(__fmul_rn(v[2], s[2]), __fmul_rn(v[3], s[3])),
            pack_bf16(__fmul_rn(v[4], s[4]), __fmul_rn(v[5], s[5])),
            pack_bf16(__fmul_rn(v[6], s[6]), __fmul_rn(v[7], s[7])));
    *reinterpret_cast<uint4*>(dst) = o;
}

// Channels [k0, k0 + len) (len a multiple of 8) of the rows [0, BT) into
// xs[row][k - k0]: bf16(x * scale[k]), zero for rows >= B and channels >=
// k_end. A thread takes 8 channels of RG rows (64 bytes of x), so their
// scales are loaded once for the rows, and loads all of them, as raw
// words and without a branch between, before its first store: a load and
// a store a row would wait out a memory latency a row. vec: x's rows and
// scale are 16-byte aligned.
template <int BT, typename XT>
__device__ __forceinline__ void fold(bf16_t* xs, int ldx, const XT* x,
                                     const float* scale, int B, int n_in,
                                     int k0, int len, int k_end, bool vec) {
    constexpr int kWords = sizeof(XT) / 2;    // 16-byte words of 8 values
    constexpr int RG = 4 / kWords;            // rows a thread
    const int chunks = len / 8;
    for (int i = threadIdx.x; i < chunks * (BT / RG); i += kThreads) {
        const int kk = (i % chunks) * 8, r0 = (i / chunks) * RG;
        const int k = k0 + kk;
        float s[8], v[8];
        if (vec && k + 8 <= k_end) {
            uint4 raw[RG][kWords];
#pragma unroll
            for (int rr = 0; rr < RG; ++rr) {   // a row < B, read in any case
                const uint4* p = reinterpret_cast<const uint4*>(
                    x + (size_t)min(r0 + rr, B - 1) * n_in + k);
#pragma unroll
                for (int q = 0; q < kWords; ++q) raw[rr][q] = p[q];
            }
            load8(scale + k, s);
#pragma unroll
            for (int rr = 0; rr < RG; ++rr) {
                widen8(raw[rr], v, x);
                store8(xs + (size_t)(r0 + rr) * ldx + kk, v, s, r0 + rr < B);
            }
        } else {
#pragma unroll
            for (int j = 0; j < 8; ++j)
                s[j] = k + j < k_end ? scale[k + j] : 0.f;
#pragma unroll
            for (int rr = 0; rr < RG; ++rr) {
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    v[j] = k + j < k_end
                        ? load1(x + (size_t)min(r0 + rr, B - 1) * n_in + k + j)
                        : 0.f;
                store8(xs + (size_t)(r0 + rr) * ldx + kk, v, s, r0 + rr < B);
            }
        }
    }
}

// A warp's share of one stage: 2 * J2 k-steps of weight rows of the 32
// columns [32 wn, 32 wn + 32) (two m-tiles) in wt, against the folded
// activations of the same channels (xs, row stride ldx).
template <int NT, int J2>
__device__ __forceinline__ void stage_mma(float (&acc)[2][NT][4],
                                          const unsigned char* wt,
                                          const bf16_t* xs, int ldx,
                                          int wn, int lane) {
    // ldmatrix.x4.trans of a k-step: matrix i = lane >> 3 holds weight
    // rows 8 (i & 1) .. + 8 of byte columns 16 (i >> 1) .. + 16
    const unsigned char* wa = wt + (((lane >> 3) & 1) * 8 + (lane & 7))
                                       * kPitch
                              + wn * 32 + (lane >> 4) * 16;
    // ldmatrix.x4 of two k-steps of one n-tile: matrix i holds channels
    // 8i .. 8i + 8 of its 8 rows
    const bf16_t* xb = xs + (lane & 7) * ldx + (lane >> 3) * 8;
#pragma unroll
    for (int j2 = 0; j2 < J2; ++j2) {
        uint32_t b[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
            ldsm_x4(b[nt], xb + nt * 8 * ldx + 2 * kStepK * j2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            uint32_t r[4];
            ldsm_x4_trans(r, reinterpret_cast<const bf16_t*>(
                                 wa + (2 * j2 + h) * kStepK * kPitch));
            uint32_t a[2][4];
            widen(r[0], a[0][0], a[0][1]);
            widen(r[1], a[0][2], a[0][3]);
            widen(r[2], a[1][0], a[1][1]);
            widen(r[3], a[1][2], a[1][3]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
                    mma_bf16(acc[mt][nt], a[mt], b[nt][2 * h],
                             b[nt][2 * h + 1]);
        }
    }
}

__device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y),
                                              pack_bf16(v.z, v.w));
}

// Grid: (column tiles x splits); a cluster is the `splits` blocks of one
// column tile, rank = split, each over reduction rows [split *
// k_per_split, +k_per_split) clamped to n_in.
template <int BT, typename XT>
__global__ void __launch_bounds__(kThreads, Tiling<BT>::kMinBlocks)
int8_matmul_kernel(const XT* __restrict__ x,              // [B, n_in]
                   const float* __restrict__ scale,       // [n_in]
                   const signed char* __restrict__ w,     // [n_in, n_out]
                   XT* __restrict__ y,                    // [B, n_out]
                   int B, int n_in, int n_out, int k_per_split, int splits,
                   int window, int vec) {
    constexpr int NT = Tiling<BT>::NT;
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* ring = smem;
    bf16_t* xs = reinterpret_cast<bf16_t*>(smem + Tiling<BT>::kRegion);
    const int ldx = window + 8;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wn = warp % kWarpsN, wk = warp / kWarpsN;
    cg::cluster_group cluster = cg::this_cluster();
    const int split = splits > 1 ? (int)cluster.block_rank() : 0;
    const int col0 = (blockIdx.x / splits) * kBlockCols;
    const int k_begin = split * k_per_split;
    const int k_end = min(n_in, k_begin + k_per_split);
    const int n_stages = (k_end - k_begin + kStageK - 1) / kStageK;

    // Stage s: weight rows [k_begin + 64 s, +64) of the block's columns
    // into ring slot s % kStages. A thread copies kCopies 16-byte pieces,
    // rows kRowsApart apart, of one column piece; rows past k_end and
    // columns past n_out are zero-filled. One commit group a stage, empty
    // past the end.
    constexpr int kCopies = kStageK * kPieces / kThreads;
    constexpr int kRowsApart = kThreads / kPieces;
    const int row0 = threadIdx.x / kPieces;
    const int piece = (threadIdx.x % kPieces) * 16;
    const bool col_ok = col0 + piece < n_out;
    const signed char* src = w + (size_t)(k_begin + row0) * n_out + col0
                             + piece;
    const size_t apart = (size_t)kRowsApart * n_out;
    auto copy_stage = [&](int s) {
        if (s < n_stages) {
            unsigned char* dst = ring + (s % kStages) * kStageBytes
                                 + row0 * kPitch + piece;
            const int k = k_begin + s * kStageK + row0;
            const signed char* p = src + (size_t)s * kStageK * n_out;
#pragma unroll
            for (int i = 0; i < kCopies; ++i) {
                const bool ok = col_ok && k + i * kRowsApart < k_end;
                cp_async16(dst + i * kRowsApart * kPitch, ok ? p : w, ok);
                p += apart;
            }
        }
        cp_async_commit();
    };

    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) copy_stage(s);
    int xoff = window;                          // into the window
    for (int s = 0; s < n_stages; ++s) {
        if (xoff == window) {                   // a window of activations
            const int kk = s * kStageK;
            __syncthreads();                    // the last one is read
            fold<BT>(xs, ldx, x, scale, B, n_in, k_begin + kk,
                     min(window, n_stages * kStageK - kk), k_end, vec != 0);
            xoff = 0;
        }
        cp_async_wait<kStages - 2>();           // stage s has landed
        __syncthreads();                        // for every thread; slot
        copy_stage(s + kStages - 1);            // s - 1 is free again
        constexpr int kRows = kStageK / kWarpsK;   // a warp's rows
        stage_mma<NT, kRows / (2 * kStepK)>(
            acc, ring + (s % kStages) * kStageBytes + wk * kRows * kPitch,
            xs + xoff + wk * kRows, ldx, wn, lane);
        xoff += kStageK;
    }
    cp_async_wait<0>();
    __syncthreads();                            // the ring is free

    // partials -> part[row][col], the columns in their true order: m-row
    // g of m-tile mt is byte column 32 wn + 16 mt + 2g, m-row g + 8 the
    // next; c0, c2 are row 2t of n-tile nt, c1, c3 row 2t + 1. The warps
    // of the last rows of each stage write theirs first, and each group
    // before them adds its own: acc_0 + (acc_1 + (...)), a fixed order.
    float* part = reinterpret_cast<float*>(smem);
    {
        const int g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int pass = kWarpsK - 1; pass >= 0; --pass) {
            if (wk == pass) {
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt) {
                        float2* p = reinterpret_cast<float2*>(
                            part + (nt * 8 + 2 * t) * kPartialLd + wn * 32
                            + mt * 16 + 2 * g);
                        float2* q = p + kPartialLd / 2;
                        float2 u = make_float2(acc[mt][nt][0],
                                               acc[mt][nt][2]);
                        float2 v = make_float2(acc[mt][nt][1],
                                               acc[mt][nt][3]);
                        if (pass < kWarpsK - 1) {
                            u.x += p->x; u.y += p->y;
                            v.x += q->x; v.y += q->y;
                        }
                        *p = u;
                        *q = v;
                    }
            }
            __syncthreads();
        }
    }
    if (splits > 1) cluster.sync();             // every split's partial
    // this block's share of the tile's float4s, each the splits' partials
    // added in split order
    const int n4 = B * (kBlockCols / 4);
    const int e1 = (split + 1) * n4 / splits;
    for (int e = split * n4 / splits + threadIdx.x; e < e1; e += kThreads) {
        const int r = e / (kBlockCols / 4), c = (e % (kBlockCols / 4)) * 4;
        if (col0 + c >= n_out) continue;        // the half tile's end
        float4* mine = reinterpret_cast<float4*>(part + r * kPartialLd + c);
        float4 v[kMaxSplits];
#pragma unroll
        for (int k = 0; k < kMaxSplits; ++k)
            if (k < splits)
                v[k] = splits > 1 ? *cluster.map_shared_rank(mine, k) : *mine;
        float4 s = v[0];
#pragma unroll
        for (int k = 1; k < kMaxSplits; ++k)
            if (k < splits) {
                s.x += v[k].x; s.y += v[k].y; s.z += v[k].z; s.w += v[k].w;
            }
        store4(y + (size_t)r * n_out + col0 + c, s);
    }
    if (splits > 1) cluster.sync();             // read before any exits
}

template <int BT, typename XT>
cudaError_t launch(const void* x, const void* scale, const void* w, void* y,
                   int B, int n_in, int n_out, int k_per_split, int splits,
                   cudaStream_t s) {
    using Tl = Tiling<BT>;
    auto kernel = int8_matmul_kernel<BT, XT>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tl::kRegion + BT * (Tl::kWindow + 8) * 2);
    if (attr != cudaSuccess) return attr;
    const int range = (k_per_split + kStageK - 1) / kStageK * kStageK;
    const int window = range < Tl::kWindow ? range : Tl::kWindow;
    const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0
                    && reinterpret_cast<uintptr_t>(scale) % 16 == 0
                    && n_in % 8 == 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((n_out + kBlockCols - 1) / kBlockCols * splits);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = Tl::kRegion + (size_t)BT * (window + 8) * 2;
    cfg.stream = s;
    cudaLaunchAttribute la[1];
    la[0].id = cudaLaunchAttributeClusterDimension;
    la[0].val.clusterDim.x = splits;
    la[0].val.clusterDim.y = 1;
    la[0].val.clusterDim.z = 1;
    cfg.attrs = la;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const XT*>(x),
        static_cast<const float*>(scale), static_cast<const signed char*>(w),
        static_cast<XT*>(y), B, n_in, n_out, k_per_split, splits, window,
        vec);
    return err != cudaSuccess ? err : cudaGetLastError();
}

#define W8_ARGS x, scale, w, y, B, n_in, n_out, k_per_split, splits, s

template <typename XT>
cudaError_t launch_rows(const void* x, const void* scale, const void* w,
                        void* y, int B, int n_in, int n_out, int k_per_split,
                        int splits, cudaStream_t s) {
    if (B <= 8) return launch<8, XT>(W8_ARGS);
    if (B <= 16) return launch<16, XT>(W8_ARGS);
    if (B <= 32) return launch<32, XT>(W8_ARGS);
    return launch<64, XT>(W8_ARGS);
}

int run(const void* x, const void* scale, const void* w, void* y, int B,
        int n_in, int n_out, int k_per_split, int splits, int dtype,
        void* stream) {
    // every split non-empty, whole k-steps, the splits covering n_in
    if (B <= 0 || B > kMaxRows || n_in <= 0 || n_out <= 0
        || n_out % kOutMultiple != 0 || splits <= 0 || splits > kMaxSplits
        || k_per_split <= 0 || k_per_split % kStepK != 0
        || (long long)k_per_split * (splits - 1) >= n_in
        || (long long)k_per_split * splits < n_in)
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_rows<float>(W8_ARGS);
    if (dtype == 1) return launch_rows<__nv_bfloat16>(W8_ARGS);
    return cudaErrorInvalidValue;
}

}  // namespace

// x: [B, n_in] in dtype (0 = float32, 1 = bfloat16); scale: fp32 [n_in],
// one per input row of w; w: int8 [n_in, n_out], 16-byte aligned; y: [B,
// n_out] in dtype. The split plan (ops/int8_matmul.py split_plan): the
// reduction in `splits` ranges of k_per_split rows (a multiple of 16), at
// most 8, one cluster. Returns a cudaError_t (0 = success).
extern "C" int int8_matmul_whole_k(const void* x, const void* scale,
                                   const void* w, void* y, int B, int n_in,
                                   int n_out, int k_per_split, int splits,
                                   int dtype, void* stream) {
    return run(x, scale, w, y, B, n_in, n_out, k_per_split, splits, dtype,
               stream);
}

// The JAX package's k-split route: the same body and arguments.
extern "C" int int8_matmul_ksplit(const void* x, const void* scale,
                                  const void* w, void* y, int B, int n_in,
                                  int n_out, int k_per_split, int splits,
                                  int dtype, void* stream) {
    return run(x, scale, w, y, B, n_in, n_out, k_per_split, splits, dtype,
               stream);
}
