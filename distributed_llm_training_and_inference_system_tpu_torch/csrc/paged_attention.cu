// Paged attention over a block-table-indexed KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_extend_kernel` of the JAX package
// (distributed_llm_training_and_inference_system_tpu/ops/
// paged_attention_pallas.py), all three page kinds: T consecutive query
// tokens per slot; query token j of slot b sits at position starts[b] + j
// and attends causally over positions [0, starts[b] + j] of the slot's
// pages, found through its row of the block table. Online softmax in fp32
// (running max m, running sum l, accumulator acc), with the TPU kernel's
// guards: a row whose running max is still NEG_INF contributes p = 0 and
// rescales by 1, and the output divides by l only where l > 0. Output is
// in q's dtype.
//
// Page kinds (template parameter KIND): fp pages in q's dtype; int8 pages
// (values int8 [NP, Nkv, PS, D], scale fp32 [NP, Nkv, PS]); int4 pages
// (values uint8 [NP, Nkv, PS/2, D], two page slots per byte, slot 2i in
// the low nibble as 4-bit two's complement, the same scale tile). A
// quantized K or V row crosses device memory and shared memory at its
// stored width and is dequantized in registers, float(value) * scale[row]
// in fp32, right before the dot; its scale is read through the same table
// entry as its page.
//
// Design (not carried over block by block):
// - No head folding. The TPU kernel folds every kv head into one masked
//   [Nkv*T*G, Nkv*PS] product only to cut per-grid-step overhead; on a GPU
//   that would multiply the work by Nkv.
// - Grid (ceil(T*G / kRows), Nkv, B): one block per (slot, kv head, tile of
//   that head's T*G query rows). Row r of a head is query token r / G and
//   q head kvh*G + r % G, so the G q heads that share a kv head read each
//   K/V row once, from shared memory.
// - The block walks keys [0, min(start + j_last + 1, maxP*PS)) in tiles of
//   kKeys positions (one page when PS == 64), reads each page id from the
//   table itself, and copies that kv head's K and V rows (and, for
//   quantized pages, their scales) into shared memory with cp.async, as
//   they are stored: the copy of tile t+1 is in
//   flight while tile t is computed (two stages where shared memory allows,
//   one otherwise). Pages past the live length are never touched.
// - Per tile: scores with one thread per key; the online-softmax update
//   with one warp per row; then p @ v with each warp over an eighth of the
//   tile's keys and each lane over CW adjacent head-dim columns (vector
//   loads of V, kRows*CW accumulators in registers). The warps' partial
//   sums share the softmax statistics, so they are added once, at the end.
//
// What bounds it: KV bytes. Every live page is read once per (kv head,
// row tile): at decode (T = 1) that is once in total, and the arithmetic
// is ~4*G flops per K/V element pair, far below the card's ~295 flop/byte
// ridge. A block walks its slot's tiles one after another, and B*Nkv
// blocks (64 at B = 8, Nkv = 8) underfill the 132 SMs at small batch, so
// the longest slot sets the time and the kernel stays far from the 3.35
// TB/s bound. The first thing a later change should do is split a slot's
// key range over several blocks (flash-decoding, with a combine pass).
//
// Launch rules: runs on the caller's stream, allocates nothing, does not
// synchronise; the launcher returns cudaGetLastError().

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;        // query rows per block
constexpr int kKeys = 64;       // key positions per shared-memory tile
constexpr int kQPad = 4;        // fp32 pad per q row (keeps 16-B rows)
constexpr int kPadBytes = 16;   // pad per K/V row: spreads the banks of the
                                // per-key 16-B reads, keeps 16-B alignment
constexpr int kMaxD = 256;
constexpr int kRowGroups = kThreads / kKeys;           // 4
constexpr int kRowsPerThread = kRows / kRowGroups;     // 2
constexpr int kMaxSmem = 232448;                       // per block, sm_90
constexpr float kNegInf = -0.7f * FLT_MAX;             // layers.NEG_INF
static_assert(kKeys == 64, "the softmax pass gives each lane two keys");
static_assert(kThreads % kKeys == 0 && kRows % kRowGroups == 0, "tiling");

// 16 bytes of K or V (4 fp32 or 8 bf16 values) widened to fp32
template <typename T> struct Vec;

template <> struct Vec<float> {
    static constexpr int kN = 4;
    static __device__ void widen(const float* src, float* dst) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
    }
    static __device__ float one(float x) { return x; }
    static __device__ float out(float x) { return x; }
};

template <> struct Vec<__nv_bfloat16> {
    static constexpr int kN = 8;
    static __device__ void widen(const __nv_bfloat16* src, float* dst) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src);
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            dst[2 * i] = f.x;
            dst[2 * i + 1] = f.y;
        }
    }
    static __device__ float one(__nv_bfloat16 x) {
        return __bfloat162float(x);
    }
    static __device__ __nv_bfloat16 out(float x) {
        return __float2bfloat16(x);     // round to nearest even
    }
};

// CW adjacent values of one V row (a lane's head-dim columns), widened
template <typename T, int CW>
__device__ __forceinline__ void load_cols(const T* src, float* dst) {
    if constexpr (std::is_same<T, float>::value) {
        if constexpr (CW == 1) {
            dst[0] = src[0];
        } else if constexpr (CW == 2) {
            const float2 v = *reinterpret_cast<const float2*>(src);
            dst[0] = v.x; dst[1] = v.y;
        } else {
#pragma unroll
            for (int i = 0; i < CW; i += 4) {
                const float4 v = *reinterpret_cast<const float4*>(src + i);
                dst[i] = v.x; dst[i + 1] = v.y;
                dst[i + 2] = v.z; dst[i + 3] = v.w;
            }
        }
    } else {
        if constexpr (CW == 1) {
            dst[0] = __bfloat162float(src[0]);
        } else {
#pragma unroll
            for (int i = 0; i < CW; i += 2) {
                const float2 f = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(src + i));
                dst[i] = f.x; dst[i + 1] = f.y;
            }
        }
    }
}

constexpr int kFp = 0, kInt8 = 1, kInt4 = 2;     // page kinds

// How one kind of page stores a K/V row. kVec: values per 16 stored bytes;
// kSlots: page slots per stored row (int4 packs two); widen: 16 stored
// bytes -> kVec dequantized fp32 values; cols: CW adjacent head-dim
// columns of a row. `hi` picks the high nibble (odd slot) of int4 bytes.
template <typename T, int KIND> struct Page;

template <typename T> struct Page<T, kFp> {
    static constexpr int kVec = Vec<T>::kN;
    static constexpr int kSlots = 1;
    static constexpr int kElem = (int)sizeof(T);
    static __device__ __forceinline__ void widen(const unsigned char* src,
                                                 int, float, float* dst) {
        Vec<T>::widen(reinterpret_cast<const T*>(src), dst);
    }
    template <int CW>
    static __device__ __forceinline__ void cols(const unsigned char* row,
                                                int col, int, float,
                                                float* dst) {
        load_cols<T, CW>(reinterpret_cast<const T*>(row) + col, dst);
    }
};

__device__ __forceinline__ float int8_value(unsigned b) {
    return (float)(int)(signed char)(b & 0xffu);
}
// 4-bit two's complement: (n ^ 8) - 8 maps 0..7 -> 0..7 and 8..15 -> -8..-1
__device__ __forceinline__ float int4_value(unsigned b, int hi) {
    const int n = (int)((b >> (4 * hi)) & 0xfu);
    return (float)((n ^ 8) - 8);
}

template <typename T, int KIND> struct PageQ {      // int8 and int4
    static constexpr int kVec = 16;
    static constexpr int kSlots = KIND == kInt4 ? 2 : 1;
    static constexpr int kElem = 1;
    static __device__ __forceinline__ float value(unsigned b, int hi) {
        return KIND == kInt4 ? int4_value(b, hi) : int8_value(b);
    }
    static __device__ __forceinline__ void widen(const unsigned char* src,
                                                 int hi, float scale,
                                                 float* dst) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src);
        const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                dst[4 * i + j] = value(w[i] >> (8 * j), hi) * scale;
    }
    template <int CW>
    static __device__ __forceinline__ void cols(const unsigned char* row,
                                                int col, int hi, float scale,
                                                float* dst) {
#pragma unroll
        for (int e = 0; e < CW; ++e)
            dst[e] = value(row[col + e], hi) * scale;
    }
};
template <typename T> struct Page<T, kInt8> : PageQ<T, kInt8> {};
template <typename T> struct Page<T, kInt4> : PageQ<T, kInt4> {};

// 16-byte global->shared copy that bypasses registers; src_bytes = 0 fills
// the destination with zeros (the tail of the last tile)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes));
}
// 4-byte copy (one fp32 scale); src_bytes = 0 fills with zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// fp32 part: q rows, scores/p, m, l, alpha; then nstage x (K, V) tiles of
// kKeys / slots stored rows (never less than the final [kWarps][kRows][D]
// fp32 reduction that reuses the region), then nstage x (K, V) x kKeys
// scales
__host__ __device__ inline size_t tile_bytes(int D, int elem, int slots,
                                             int nstage) {
    const size_t ld = (size_t)D * elem + kPadBytes;
    const size_t tiles = (size_t)nstage * 2 * (kKeys / slots) * ld;
    const size_t red = sizeof(float) * kWarps * kRows * D;
    return tiles > red ? tiles : red;
}
size_t smem_bytes(int D, int elem, int slots, int nstage) {
    const size_t f32 = (size_t)kRows * (D + kQPad) + kRows * kKeys + 3 * kRows;
    return sizeof(float) * f32 + tile_bytes(D, elem, slots, nstage)
           + sizeof(float) * nstage * 2 * kKeys;
}

template <typename T, int KIND, int CW>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q,        // [B, T, Nq, D]
                       const unsigned char* __restrict__ k_pages,
                       const unsigned char* __restrict__ v_pages,
                       const float* __restrict__ k_scale,  // [NP, Nkv, PS]
                       const float* __restrict__ v_scale,  // (quantized)
                       const int* __restrict__ tables, // [B, maxP]
                       const int* __restrict__ starts, // [B]
                       T* __restrict__ out,            // [B, T, Nq, D]
                       int Tq, int Nq, int Nkv, int D, int PS, int maxP,
                       float scale, int nstage) {
    extern __shared__ __align__(16) float smem[];
    using P = Page<T, KIND>;
    constexpr int V = P::kVec;
    constexpr int kSlots = P::kSlots;
    constexpr int kTileRows = kKeys / kSlots;   // stored rows per tile
    constexpr bool kQuant = KIND != kFp;
    const int G = Nq / Nkv;
    const int row0 = blockIdx.x * kRows;
    const int kvh = blockIdx.y;
    const int b = blockIdx.z;
    const int R = min(kRows, Tq * G - row0);
    const int ldq = D + kQPad;
    const int ldr = D * P::kElem + kPadBytes;   // bytes per stored row
    const size_t stage_bytes = (size_t)2 * kTileRows * ldr;
    float* q_s = smem;                      // [kRows][ldq]
    float* p_s = q_s + kRows * ldq;         // [kRows][kKeys] scores, then p
    float* m_s = p_s + kRows * kKeys;       // [kRows] running max
    float* l_s = m_s + kRows;               // [kRows] running sum
    float* a_s = l_s + kRows;               // [kRows] this tile's rescale
    // [nstage][2][kTileRows][ldr] bytes, then [nstage][2][kKeys] scales
    unsigned char* tiles = reinterpret_cast<unsigned char*>(a_s + kRows);
    float* scales = reinterpret_cast<float*>(
        tiles + tile_bytes(D, P::kElem, kSlots, nstage));
    const int tid = threadIdx.x;
    const int start = starts[b];
    const int j_last = (row0 + R - 1) / G;  // last query token of the tile
    const int n_keys = min(start + j_last + 1, maxP * PS);
    const int n_tiles = (n_keys + kKeys - 1) / kKeys;
    const int* table = tables + (size_t)b * maxP;
    const int vecs = D / V;                 // 16-byte pieces per stored row

    // copy tile t's K and V rows (and scales) into stage buf; page ids
    // come from the table. Stored row sr holds page slots sr * kSlots ..;
    // PS and kKeys are multiples of kSlots, so a stored row never spans
    // two pages or two tiles.
    auto issue = [&](int t, int buf) {
        const int t0 = t * kKeys;
        const int nk = min(kKeys, n_keys - t0);
        unsigned char* kb = tiles + (size_t)buf * stage_bytes;
        unsigned char* vb = kb + (size_t)kTileRows * ldr;
        for (int i = tid; i < kTileRows * vecs; i += kThreads) {
            const int sr = i / vecs, c = (i % vecs) * 16;   // c in bytes
            const int kk = sr * kSlots;
            size_t off = 0;
            if (kk < nk) {
                const int pos = t0 + kk;
                const int phys = __ldg(table + pos / PS);
                off = (((size_t)phys * Nkv + kvh) * (PS / kSlots)
                       + (pos % PS) / kSlots) * ((size_t)D * P::kElem) + c;
            }
            const int bytes = kk < nk ? 16 : 0;
            cp_async16(kb + sr * ldr + c, k_pages + off, bytes);
            cp_async16(vb + sr * ldr + c, v_pages + off, bytes);
        }
        if (kQuant) {
            float* ks = scales + (size_t)buf * 2 * kKeys;
            float* vs = ks + kKeys;
            for (int kk = tid; kk < kKeys; kk += kThreads) {
                size_t off = 0;
                if (kk < nk) {
                    const int pos = t0 + kk;
                    const int phys = __ldg(table + pos / PS);
                    off = ((size_t)phys * Nkv + kvh) * PS + pos % PS;
                }
                const int bytes = kk < nk ? 4 : 0;
                cp_async4(ks + kk, k_scale + off, bytes);
                cp_async4(vs + kk, v_scale + off, bytes);
            }
        }
        cp_async_commit();
    };

    if (n_tiles > 0) issue(0, 0);
    for (int i = tid; i < R * (D / 4); i += kThreads) {
        const int r = i / (D / 4), c = (i % (D / 4)) * 4;
        const int row = row0 + r;
        const int j = row / G, h = kvh * G + row % G;
        const T* src = q + (((size_t)b * Tq + j) * Nq + h) * D + c;
#pragma unroll
        for (int e = 0; e < 4; ++e) q_s[r * ldq + c + e] = Vec<T>::one(src[e]);
    }
    if (tid < kRows) {
        m_s[tid] = kNegInf;
        l_s[tid] = 0.f;
    }
    const int warp = tid / 32, lane = tid % 32;
    const bool cols_ok = lane * CW < D;     // lane's columns [lane*CW, +CW)
    float acc[kRows][CW];                   // this warp's keys only
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int e = 0; e < CW; ++e) acc[r][e] = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
        const int t0 = t * kKeys;
        const int nk = min(kKeys, n_keys - t0);
        int buf = 0;
        if (nstage == 2) {
            buf = t & 1;
            if (t + 1 < n_tiles) issue(t + 1, buf ^ 1);
            else cp_async_commit();          // keep one group per step
            cp_async_wait<1>();              // tile t has landed
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const unsigned char* kb = tiles + (size_t)buf * stage_bytes;
        const unsigned char* vb = kb + (size_t)kTileRows * ldr;
        const float* ks = scales + (size_t)buf * 2 * kKeys;
        const float* vs = ks + kKeys;

        // scores: thread -> one key, every kRowGroups-th row
        {
            const int kk = tid % kKeys, rg = tid / kKeys;
            float s[kRowsPerThread];
#pragma unroll
            for (int i = 0; i < kRowsPerThread; ++i) s[i] = 0.f;
            const unsigned char* krow = kb + (kk / kSlots) * ldr;
            const float kscale = kQuant ? ks[kk] : 1.f;
            for (int c = 0; c < D; c += V) {
                float kf[V];
                P::widen(krow + c * P::kElem, kk % kSlots, kscale, kf);
#pragma unroll
                for (int i = 0; i < kRowsPerThread; ++i) {
                    const int r = rg + kRowGroups * i;
                    if (r < R) {
                        const float* qr = q_s + r * ldq + c;
#pragma unroll
                        for (int e = 0; e < V; e += 4) {
                            const float4 q4 =
                                *reinterpret_cast<const float4*>(qr + e);
                            s[i] += q4.x * kf[e] + q4.y * kf[e + 1]
                                    + q4.z * kf[e + 2] + q4.w * kf[e + 3];
                        }
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < kRowsPerThread; ++i) {
                const int r = rg + kRowGroups * i;
                if (r < R) {
                    const int j = (row0 + r) / G;
                    const bool ok = kk < nk && t0 + kk <= start + j;
                    p_s[r * kKeys + kk] = ok ? s[i] * scale : kNegInf;
                }
            }
        }
        __syncthreads();

        // online softmax: one warp per row, two keys per lane
        {
            for (int r = warp; r < R; r += kWarps) {
                float* pr = p_s + r * kKeys;
                const float s0 = pr[lane], s1 = pr[lane + 32];
                const float m_prev = m_s[r];
                const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
                const bool live = m_new > kNegInf / 2;
                const float p0 = expf(live ? s0 - m_new : kNegInf);
                const float p1 = expf(live ? s1 - m_new : kNegInf);
                const float alpha = expf(live ? m_prev - m_new : 0.f);
                pr[lane] = p0;
                pr[lane + 32] = p1;
                const float sum = warp_sum(p0 + p1);
                if (lane == 0) {
                    l_s[r] = alpha * l_s[r] + sum;
                    m_s[r] = m_new;
                    a_s[r] = alpha;
                }
            }
        }
        __syncthreads();

        // acc = acc * alpha + p @ v over this warp's keys
        if (cols_ok) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                if (r < R) {
                    const float a = a_s[r];
#pragma unroll
                    for (int e = 0; e < CW; ++e) acc[r][e] *= a;
                }
            }
            for (int kk = warp; kk < nk; kk += kWarps) {
                float v[CW];
                P::template cols<CW>(vb + (kk / kSlots) * ldr, lane * CW,
                                     kk % kSlots, kQuant ? vs[kk] : 1.f, v);
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    if (r < R) {
                        const float p = p_s[r * kKeys + kk];
#pragma unroll
                        for (int e = 0; e < CW; ++e) acc[r][e] += p * v[e];
                    }
                }
            }
        }
        __syncthreads();    // p_s and this stage are rewritten next
        if (nstage == 1 && t + 1 < n_tiles) issue(t + 1, 0);
    }

    // add the warps' partial sums (fixed order) and normalise; the tile
    // region is free now and holds [kWarps][kRows][D] fp32
    float* red = reinterpret_cast<float*>(tiles);
    if (cols_ok) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
            if (r < R)
#pragma unroll
                for (int e = 0; e < CW; ++e)
                    red[(warp * kRows + r) * D + lane * CW + e] = acc[r][e];
    }
    __syncthreads();
    for (int i = tid; i < R * D; i += kThreads) {
        const int r = i / D, d = i % D;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += red[(w * kRows + r) * D + d];
        const int row = row0 + r;
        const int j = row / G, h = kvh * G + row % G;
        const float l = l_s[r];
        out[(((size_t)b * Tq + j) * Nq + h) * D + d] =
            Vec<T>::out(sum / (l > 0.f ? l : 1.f));
    }
}

template <typename T, int KIND, int CW>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scale, const void* v_scale,
                   const void* tables, const void* starts, void* out,
                   int B, int Tq, int Nq, int Nkv, int D, int PS, int maxP,
                   float scale, cudaStream_t stream) {
    using P = Page<T, KIND>;
    const int nstage =
        smem_bytes(D, P::kElem, P::kSlots, 2) <= (size_t)kMaxSmem ? 2 : 1;
    const size_t smem = smem_bytes(D, P::kElem, P::kSlots, nstage);
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, KIND, CW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int G = Nq / Nkv;
    const dim3 grid((Tq * G + kRows - 1) / kRows, Nkv, B);
    paged_attention_kernel<T, KIND, CW><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q),
        static_cast<const unsigned char*>(k_pages),
        static_cast<const unsigned char*>(v_pages),
        static_cast<const float*>(k_scale),
        static_cast<const float*>(v_scale), static_cast<const int*>(tables),
        static_cast<const int*>(starts), static_cast<T*>(out),
        Tq, Nq, Nkv, D, PS, maxP, scale, nstage);
    return cudaGetLastError();
}

#define PAGED_ARGS q, k_pages, v_pages, k_scale, v_scale, tables, starts, \
                   out, B, Tq, Nq, Nkv, D, PS, maxP, scale, s

// a lane's head-dim columns: the power of two CW with 32 * CW >= D
template <typename T, int KIND>
cudaError_t launch_d(const void* q, const void* k_pages, const void* v_pages,
                     const void* k_scale, const void* v_scale,
                     const void* tables, const void* starts, void* out,
                     int B, int Tq, int Nq, int Nkv, int D, int PS, int maxP,
                     float scale, cudaStream_t s) {
    if (D <= 32) return launch<T, KIND, 1>(PAGED_ARGS);
    if (D <= 64) return launch<T, KIND, 2>(PAGED_ARGS);
    if (D <= 128) return launch<T, KIND, 4>(PAGED_ARGS);
    return launch<T, KIND, 8>(PAGED_ARGS);
}

template <typename T>
cudaError_t launch_kind(int kind, const void* q, const void* k_pages,
                        const void* v_pages, const void* k_scale,
                        const void* v_scale, const void* tables,
                        const void* starts, void* out, int B, int Tq, int Nq,
                        int Nkv, int D, int PS, int maxP, float scale,
                        cudaStream_t s) {
    if (kind == kFp) return launch_d<T, kFp>(PAGED_ARGS);
    if (kind == kInt8) return launch_d<T, kInt8>(PAGED_ARGS);
    return launch_d<T, kInt4>(PAGED_ARGS);
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16. kind: 0 = pages in q's
// dtype (k_scale, v_scale unused), 1 = int8 pages, 2 = packed int4 pages.
// Returns a cudaError_t (0 = success).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* starts, void* out, int B,
                                   int Tq, int Nq, int Nkv, int D, int PS,
                                   int maxP, float scale, int dtype, int kind,
                                   void* stream) {
    if (B <= 0 || Tq <= 0) return cudaSuccess;
    if (D % 8 != 0 || D > kMaxD || Nkv <= 0 || Nq % Nkv != 0 || PS <= 0
        || maxP <= 0 || kind < kFp || kind > kInt4)
        return cudaErrorInvalidValue;
    if (kind != kFp && (D % 16 != 0 || k_scale == nullptr
                        || v_scale == nullptr))
        return cudaErrorInvalidValue;
    if (kind == kInt4 && PS % 2 != 0) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_kind<float>(kind, PAGED_ARGS);
    if (dtype == 1) return launch_kind<__nv_bfloat16>(kind, PAGED_ARGS);
    return cudaErrorInvalidValue;
}
