// Paged attention over a block-table-indexed KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_extend_kernel` of the JAX package
// (distributed_llm_training_and_inference_system_tpu/ops/
// paged_attention_pallas.py), all three page kinds: T consecutive query
// tokens per slot; query token j of slot b sits at position starts[b] + j
// and attends causally over positions [0, starts[b] + j] of the slot's
// pages, found through its row of the block table, clamped to maxP*PS.
// Online softmax in fp32 (running max m, running sum l, accumulator acc),
// with the TPU kernel's guards: a row whose running max is still NEG_INF
// contributes p = 0 and rescales by 1, and the output divides by l only
// where l > 0. Output is in q's dtype.
//
// Page kinds (template parameter KIND): fp pages in q's dtype; int8 pages
// (values int8 [NP, Nkv, PS, D], scale fp32 [NP, Nkv, PS]); int4 pages
// (values uint8 [NP, Nkv, PS/2, D], two page slots per byte, slot 2i in
// the low nibble as 4-bit two's complement, the same scale tile). A
// quantized K or V row crosses device memory at its stored width and is
// dequantized on the chip, float(value) * scale[row] in fp32; its scale is
// read through the same table entry as its page.
//
// Design (not carried over block by block):
// - No head folding. The TPU kernel folds every kv head into one masked
//   [Nkv*T*G, Nkv*PS] product only to cut per-grid-step overhead; on a GPU
//   that would multiply the work by Nkv.
// - Split keys (flash-decoding). Grid (row tiles x splits, Nkv, B): one
//   block per (slot, kv head, tile of kRows of that head's T*G query rows,
//   split of the keys). Row r of a head is query token r / G and q head
//   kvh*G + r % G, so the G q heads that share a kv head read each K/V row
//   once. The host fixes the plan from the table's width maxP*PS alone (no
//   sync; ops/paged_attention_cuda.py split_plan): kps keys a split, a
//   whole number of kKeys tiles, at most 8 splits, so that a small decode
//   batch still puts a few blocks on every SM while a long window (whose
//   T*G rows fill the grid by themselves) keeps one split. A row tile's
//   keys end at n_keys = min(start + j_last + 1, maxP*PS); a split that
//   starts past them exits before it touches a page.
// - A row tile with one live split writes its output. Otherwise its
//   splits, launched as one thread block cluster (at most 8 blocks), keep
//   their (m, l, unnormalised acc) in shared memory and combine them
//   through distributed shared memory: rescaled by exp(m_s - max m) and
//   added in split order, so the same inputs give the same bits. One
//   launch a call, no workspace, no pass through device memory.
// - bf16 q (paged_attention_tc_kernel): 4 warps, each an online softmax of
//   its own over 16 keys of every 64-key tile, so the tile loop has no
//   block barrier. A warp copies its K/V rows with cp.async into a ring of
//   kStages slices of its own. Swapped products on tensor cores (mma.sync
//   m16n8k16 with the 8 query rows as n): S^T = K Q^T, Q^T fragments held
//   in registers, K through ldmatrix; p rounded to bf16 (as the plain
//   version rounds its probabilities) and transposed in registers
//   (movmatrix) into the B fragments of O^T += V^T P^T, V through
//   ldmatrix.trans. The four warps' (m, l, acc) are combined in warp order
//   at the end. Quantized pages arrive as stored (values and scales) and
//   the warp widens the values with a magic-number add (no I2F) into one
//   16-bit slice: K's to bf16 and V's to fp16, both exact. K's scale
//   multiplies the fp32 score, V's multiplies p before it is rounded to
//   fp16 for an fp16 product: float(value) * scale, as the plain version
//   dequantizes, with one fp16 rounding of p * scale the only change.
// - fp32 q (paged_attention_kernel, the verification path): fp32 on CUDA
//   cores, 8 warps a block over 64-key tiles copied with cp.async: scores
//   with one thread per key, the online-softmax update with one warp per
//   row, then p @ v with each warp over an eighth of the tile's keys and
//   each lane over CW adjacent head-dim columns.
//
// What bounds it: KV bytes. Every live page is read once per (kv head,
// row tile): at decode (T = 1) that is once in total, and the arithmetic
// is ~4*G flops per K/V element pair, far below the card's ~295 flop/byte
// ridge. The splits let every SM stream pages at once instead of leaving
// the longest slot's walk to one block while most of the card idles; the
// bf16 body spends few instructions and no block barrier a tile. What is
// left at decode is latency: a block's chain of dependent reads (start,
// page ids, each slice) and its end (reduction, cluster combine), which
// the longest slot's splits pay one after another.
//
// Launch rules: runs on the caller's stream, allocates nothing, does not
// synchronise; the launcher returns cudaGetLastError().

#include <cfloat>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

namespace cg = cooperative_groups;

using tc::bf16_t;
using tc::cp_async16;
using tc::cp_async4;
using tc::cp_async_commit;
using tc::cp_async_wait;

constexpr int kRows = 8;        // query rows per block
constexpr int kKeys = 64;       // key positions per tile
constexpr int kPadBytes = 16;   // pad per stored K/V row: spreads the banks
                                // of 16-B reads, keeps 16-B alignment
constexpr int kMaxD = 256;
constexpr int kMaxSmem = 232448;                       // per block, sm_90
constexpr int kMaxSplits = 8;   // a row tile's splits form one cluster:
                                // at most the portable cluster size
constexpr float kNegInf = -0.7f * FLT_MAX;             // layers.NEG_INF
constexpr int kFp = 0, kInt8 = 1, kInt4 = 2;           // page kinds

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

// The split plan, as ops/paged_attention_cuda.py's split_plan fixes it on
// the host: a row tile's keys [0, n_keys) fall in splits of kps keys (a
// multiple of kKeys); the splits that hold a key are live, at least one.
struct Plan {
    int kps, n_splits, row_tiles;
};
__device__ __forceinline__ int tile_keys(int start, int j_last, int maxP,
                                         int PS) {
    return min(start + j_last + 1, maxP * PS);
}
__device__ __forceinline__ int live_splits(int n_keys, int kps) {
    return max(1, (n_keys + kps - 1) / kps);
}

// Byte offset of page slot `pos` of a slot's keys in a page tensor whose
// stored rows hold `slots` page slots in `row_bytes` bytes
__device__ __forceinline__ size_t page_row(const int* table, int pos, int PS,
                                           int Nkv, int kvh, int slots,
                                           int row_bytes) {
    const int phys = __ldg(table + pos / PS);
    return (((size_t)phys * Nkv + kvh) * (PS / slots) + (pos % PS) / slots)
           * (size_t)row_bytes;
}

template <typename T> __device__ __forceinline__ T to_out(float x);
template <> __device__ __forceinline__ float to_out<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ bf16_t to_out<bf16_t>(float x) {
    return __float2bfloat16(x);         // round to nearest even
}

// The end of a block, shared by both bodies: acc holds the block's rows
// [0, R), unnormalised fp32 (row stride lda), m and l their running max
// and sum, all in shared memory. With one live split they are the output.
// Otherwise the row tile's cluster (its n_splits blocks, rank = split)
// combines them on the chip: after a cluster barrier each live block takes
// a share of the tile's elements and, for each, reads every live split's
// (m, l, acc) from that block's shared memory (distributed shared memory),
// rescales them by exp(m_s - max m) and adds them in split order, so the
// same inputs give the same bits. A second barrier keeps every block's
// shared memory alive until the others have read it.
template <typename T>
__device__ __forceinline__ void finish_tile(
    const float* acc, int lda, const float* m, const float* l, int R, int D,
    int n_live, int split, int row0, int kvh, int b, int Tq, int Nq, int G,
    T* out, int tid, int nthreads) {
    auto out_at = [&](int r, int d) -> T& {
        const int row = row0 + r;
        return out[(((size_t)b * Tq + row / G) * Nq + kvh * G + row % G) * D
                   + d];
    };
    if (n_live == 1) {
        for (int x = tid; x < R * D; x += nthreads) {
            const int r = x / D, d = x % D;
            const float lr = l[r];
            out_at(r, d) = to_out<T>(acc[r * lda + d]
                                     / (lr > 0.f ? lr : 1.f));
        }
        return;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                         // every split's partial is set
    const int E = R * D;
    const int e1 = (split + 1) * E / n_live;
    for (int x = split * E / n_live + tid; x < e1; x += nthreads) {
        const int r = x / D, d = x % D;
        float mk[kMaxSplits], lk[kMaxSplits], vk[kMaxSplits];
#pragma unroll
        for (int k = 0; k < kMaxSplits; ++k) {
            const bool ok = k < n_live;
            mk[k] = ok ? *cluster.map_shared_rank(m + r, k) : kNegInf;
            lk[k] = ok ? *cluster.map_shared_rank(l + r, k) : 0.f;
            vk[k] = ok ? *cluster.map_shared_rank(acc + r * lda + d, k) : 0.f;
        }
        float mm = kNegInf;
#pragma unroll
        for (int k = 0; k < kMaxSplits; ++k) mm = fmaxf(mm, mk[k]);
        float ls = 0.f, v = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxSplits; ++k) {
            const float w = mk[k] > kNegInf / 2 ? expf(mk[k] - mm) : 0.f;
            ls += w * lk[k];
            v += w * vk[k];
        }
        out_at(r, d) = to_out<T>(v / (ls > 0.f ? ls : 1.f));
    }
    cluster.sync();                         // read before any block exits
}

// ---------------------------------------------------------------------------
// bf16 q: the tensor-core body
// ---------------------------------------------------------------------------

constexpr int kWarpsTc = 4;
constexpr int kThreadsTc = 32 * kWarpsTc;
constexpr int kWarpKeys = kKeys / kWarpsTc;   // keys a warp takes a tile
constexpr int kStages = 2;                    // slices a warp keeps
static_assert(kWarpKeys == 16, "a warp's slice is one m16 tile of keys");

// A fragment of the 16 x 16 block of V^T (rows d, columns keys) from V
// stored [key][d]: matrix j covers keys (j >> 1) * 8, columns (j & 1) * 8
__device__ __forceinline__ void ldsm_a_trans(uint32_t a[4],
                                             const bf16_t* tile, int ld,
                                             int lane) {
    tc::ldsm_x4_trans(a, tile + ((lane >> 4) * 8 + (lane & 7)) * ld
                             + ((lane >> 3) & 1) * 8);
}

// the transpose of an 8 x 8 b16 matrix held a row pair a lane
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
    uint32_t y;
    asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
                 : "=r"(y) : "r"(x));
    return y;
}

// fp32 8388608 + u, where u (0..255) is byte i of w
__device__ __forceinline__ float magic_byte(uint32_t w, int i) {
    return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7440u + i));
}

// the values of 16 stored bytes of one quantized row, exact as bf16 (K)
// or fp16 (V): int8, 16 columns into dst[0..16); int4, the low nibbles
// (page slot 2r) into dst[0..16) and the high ones (slot 2r + 1) into
// dst_hi[0..16)
template <int KIND>
__device__ __forceinline__ void widen16(uint4 raw, bool f16, bf16_t* dst,
                                        bf16_t* dst_hi) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    auto pack = [f16](float a, float b) -> uint32_t {
        if (!f16) return tc::pack_bf16(a, b);
        const __half2 h = __floats2half2_rn(a, b);
        return *reinterpret_cast<const uint32_t*>(&h);
    };
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        float f[4], fh[4];
        if constexpr (KIND == kInt8) {
            const uint32_t u = w[k] ^ 0x80808080u;      // x + 128
#pragma unroll
            for (int e = 0; e < 4; ++e) f[e] = magic_byte(u, e) - 8388736.f;
        } else {
            const uint32_t ul = (w[k] & 0x0F0F0F0Fu) ^ 0x08080808u;
            const uint32_t uh = ((w[k] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
            for (int e = 0; e < 4; ++e) {               // n + 8, 0..15
                f[e] = magic_byte(ul, e) - 8388616.f;
                fh[e] = magic_byte(uh, e) - 8388616.f;
            }
            hi[2 * k] = pack(fh[0], fh[1]);
            hi[2 * k + 1] = pack(fh[2], fh[3]);
        }
        lo[2 * k] = pack(f[0], f[1]);
        lo[2 * k + 1] = pack(f[2], f[3]);
    }
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    d[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    if constexpr (KIND == kInt4) {
        uint4* dh = reinterpret_cast<uint4*>(dst_hi);
        dh[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        dh[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
}

// fp16 operands, fp32 accumulators (the quantized V path)
__device__ __forceinline__ void mma_f16(float c[4], const uint32_t a[4],
                                        uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// Per-warp shared memory of the bf16 body. ldk: bf16 elements a row of a
// bf16 slice (DP + 8 puts the ldmatrix rows on distinct bank groups).
// fp pages: kStages x (K, V) bf16 slices of kWarpKeys rows, copied as
// stored. Quantized: kStages x ((K, V) stored slices of kWarpKeys / slots
// rows of ldr bytes, then (K, V) x kWarpKeys scales), then one 16-bit (K
// in bf16, V in fp16) slice that the warp widens the values into.
template <int KIND>
struct TcLayout {
    static constexpr int kSlots = KIND == kInt4 ? 2 : 1;
    int ldk, ldr;
    size_t bf16_slice, raw_slice, warp_bytes, block_bytes;
    __host__ __device__ TcLayout(int D, int DP)
        : ldk(DP + 8), ldr(D + kPadBytes) {
        bf16_slice = (size_t)2 * kWarpKeys * ldk * sizeof(bf16_t);
        raw_slice = KIND == kFp ? bf16_slice
                    : (size_t)2 * (kWarpKeys / kSlots) * ldr
                      + 2 * kWarpKeys * sizeof(float);
        warp_bytes = kStages * raw_slice + (KIND == kFp ? 0 : bf16_slice);
        // the final reduction: [4 warps][kRows] m and l, the block's
        // [kRows] m and l, [4][kRows][DP] acc (fp32)
        const size_t red = sizeof(float)
            * ((size_t)kWarpsTc * kRows * (DP + 2) + 2 * kRows);
        const size_t tiles = kWarpsTc * warp_bytes;
        block_bytes = tiles > red ? tiles : red;
    }
};

template <int KIND, int NT>
__global__ void __launch_bounds__(kThreadsTc)
paged_attention_tc_kernel(const bf16_t* __restrict__ q,   // [B, T, Nq, D]
                          const unsigned char* __restrict__ k_pages,
                          const unsigned char* __restrict__ v_pages,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ tables,   // [B, maxP]
                          const int* __restrict__ starts,   // [B]
                          bf16_t* __restrict__ out,         // [B, T, Nq, D]
                          int Tq, int Nq, int Nkv, int D, int PS, int maxP,
                          float scale, Plan plan) {
    extern __shared__ __align__(16) unsigned char smem_tc[];
    constexpr int DP = 16 * NT;                 // D padded to whole k-steps
    constexpr bool kQuant = KIND != kFp;
    constexpr int kSlots = TcLayout<KIND>::kSlots;
    constexpr int kRawRows = kWarpKeys / kSlots;    // stored rows a slice
    const TcLayout<KIND> lay(D, DP);
    const int G = Nq / Nkv;
    const int rt = blockIdx.x / plan.n_splits;
    const int split = blockIdx.x % plan.n_splits;
    const int row0 = rt * kRows;
    const int kvh = blockIdx.y;
    const int b = blockIdx.z;
    const int R = min(kRows, Tq * G - row0);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;   // mma fragment coordinates
    const int* table = tables + (size_t)b * maxP;
    const int k_begin = split * plan.kps;
    // With PS a multiple of 16 one page holds a warp's slice, and lane i
    // holds the page id of the warp's slice of tile c32 + i, for 32 tiles
    // at a time: a slice's copy then waits on no table read. The first
    // ids are read before the liveness test, beside starts[b] (an id past
    // the live keys is still an entry of the table).
    const bool one_page = PS % kWarpKeys == 0;
    int phys_lane = 0, c32 = 0;
    auto load_ids = [&](int first) {
        c32 = first;
        const int pos = k_begin + (first + lane) * kKeys + warp * kWarpKeys;
        phys_lane = one_page && pos < maxP * PS ? __ldg(table + pos / PS)
                                                : 0;
    };
    load_ids(0);
    const int start = starts[b];
    const int j_last = (row0 + R - 1) / G;
    const int n_keys = tile_keys(start, j_last, maxP, PS);
    const int n_live = live_splits(n_keys, plan.kps);
    // a split with no key exits: a cluster barrier waits only for the
    // threads that have not exited, and no block reads its shared memory
    if (split >= n_live) return;
    const int k_end = min(k_begin + plan.kps, n_keys);
    const int n_tiles = max(0, (k_end - k_begin + kKeys - 1) / kKeys);
    unsigned char* wsm = smem_tc + warp * lay.warp_bytes;
    const int ldk = lay.ldk, ldr = lay.ldr;

    // the warp's slice of tile i: keys k0 .. k0 + 16 (nk of them live)
    // into stage i % kStages (called by the whole warp, i ascending)
    auto issue = [&](int i) {
        const int k0 = k_begin + i * kKeys + warp * kWarpKeys;
        const int nk = min(kWarpKeys, k_end - k0);
        unsigned char* st = wsm + (size_t)(i % kStages) * lay.raw_slice;
        if (i - c32 >= 32) load_ids(i);
        const int phys = __shfl_sync(0xffffffffu, phys_lane, i - c32);
        // the stored-row index of the slice's first row, in one page
        const size_t base = (((size_t)phys * Nkv + kvh) * (PS / kSlots)
                             + (k0 % PS) / kSlots);
        // the stored-row index of the slice's stored row r
        auto srow = [&](int r) -> size_t {
            return one_page ? base + r
                            : page_row(table, k0 + r * kSlots, PS, Nkv, kvh,
                                       kSlots, 1);
        };
        if constexpr (!kQuant) {
            // rows of D bf16, zeros up to DP, into [16][ldk]
            bf16_t* kb = reinterpret_cast<bf16_t*>(st);
            bf16_t* vb = kb + kWarpKeys * ldk;
            constexpr int vecs = DP / 8;     // 16-byte pieces a row
            for (int x = lane; x < kWarpKeys * vecs; x += 32) {
                const int r = x / vecs, c = x % vecs;
                const bool ok = r < nk && c * 8 < D;
                const size_t off = ok ? srow(r) * (2 * D) + 16 * c : 0;
                cp_async16(kb + r * ldk + c * 8, k_pages + off, ok);
                cp_async16(vb + r * ldk + c * 8, v_pages + off, ok);
            }
        } else {
            constexpr int vecs = DP / 16;    // 16-byte pieces, up to DP
            unsigned char* kb = st;
            unsigned char* vb = kb + kRawRows * ldr;
            for (int x = lane; x < kRawRows * vecs; x += 32) {
                const int r = x / vecs, c = x % vecs;
                if (c * 16 >= D) continue;
                const bool ok = r * kSlots < nk;
                const size_t off = ok ? srow(r) * D + 16 * c : 0;
                cp_async16(kb + r * ldr + 16 * c, k_pages + off, ok);
                cp_async16(vb + r * ldr + 16 * c, v_pages + off, ok);
            }
            float* ks = reinterpret_cast<float*>(vb + kRawRows * ldr);
            if (lane < kWarpKeys) {
                const bool ok = lane < nk;
                size_t off = 0;
                if (ok && one_page) {
                    off = base * kSlots + lane;
                } else if (ok) {
                    const int pos = k0 + lane;
                    off = ((size_t)__ldg(table + pos / PS) * Nkv + kvh) * PS
                          + pos % PS;
                }
                cp_async4(ks + lane, k_scale + off, ok);
                cp_async4(ks + kWarpKeys + lane, v_scale + off, ok);
            }
        }
        cp_async_commit();
    };

    for (int i = 0; i < kStages - 1; ++i) {
        if (i < n_tiles) issue(i);
        else cp_async_commit();             // one group a slice, always
    }

    // Q^T as B fragments of S^T = K Q^T: n = query row g, k = 16 columns
    uint32_t qf[NT][2];
    {
        const bool ok = g < R;
        const int row = row0 + (ok ? g : 0);
        const int j = row / G, h = kvh * G + row % G;
        const bf16_t* qr = q + (((size_t)b * Tq + j) * Nq + h) * D;
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
            const int c0 = 16 * kk + 2 * t, c1 = c0 + 8;
            qf[kk][0] = ok && c0 < D
                ? *reinterpret_cast<const uint32_t*>(qr + c0) : 0u;
            qf[kk][1] = ok && c1 < D
                ? *reinterpret_cast<const uint32_t*>(qr + c1) : 0u;
        }
    }
    // the rows (r0, r1) = (2t, 2t + 1) this lane holds in the S^T and O^T
    // fragments, and the last key each sees (-1: a padding row)
    const int r0 = 2 * t, r1 = 2 * t + 1;
    const int lim0 = r0 < R ? start + (row0 + r0) / G : -1;
    const int lim1 = r1 < R ? start + (row0 + r1) / G : -1;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    float acc[NT][4];
#pragma unroll
    for (int x = 0; x < NT; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[x][e] = 0.f;

    bf16_t* dq = nullptr;                   // the dequantized (K, V) slice
    if constexpr (kQuant) {
        dq = reinterpret_cast<bf16_t*>(wsm + kStages * lay.raw_slice);
        // columns D .. DP stay zero: only [0, D) is rewritten below
        const int pad = (DP - D) / 8;        // 16-byte pieces a row
        for (int x = lane; x < 2 * kWarpKeys * pad; x += 32)
            *reinterpret_cast<uint4*>(dq + (x / pad) * ldk + D
                                      + (x % pad) * 8) =
                make_uint4(0u, 0u, 0u, 0u);
    }

    for (int i = 0; i < n_tiles; ++i) {
        if (i + kStages - 1 < n_tiles) issue(i + kStages - 1);
        else cp_async_commit();
        cp_async_wait<kStages - 1>();       // slice i has landed
        __syncwarp();
        const int k0 = k_begin + i * kKeys + warp * kWarpKeys;
        const unsigned char* st = wsm + (size_t)(i % kStages) * lay.raw_slice;
        const bf16_t* kb;
        const bf16_t* vb;
        // quantized pages: the scales of keys g and g + 8 (K's on the
        // score, V's on p); the values themselves are exact in 16 bits
        float ksg = 1.f, ksg8 = 1.f, vsg = 1.f, vsg8 = 1.f;
        if constexpr (!kQuant) {
            kb = reinterpret_cast<const bf16_t*>(st);
            vb = kb + kWarpKeys * ldk;
        } else {
            constexpr int vecs = DP / 16;
            const float* sc = reinterpret_cast<const float*>(
                st + 2 * kRawRows * ldr);        // K scales, then V's
            for (int x = lane; x < 2 * kRawRows * vecs; x += 32) {
                const int kv = x / (kRawRows * vecs);     // 0: K, 1: V
                const int r = (x / vecs) % kRawRows, c = x % vecs;
                if (c * 16 >= D) continue;
                const uint4 raw = *reinterpret_cast<const uint4*>(
                    st + (kv * kRawRows + r) * ldr + 16 * c);
                bf16_t* dst = dq + (kv * kWarpKeys + r * kSlots) * ldk
                              + 16 * c;
                widen16<KIND>(raw, kv == 1, dst, dst + ldk);
            }
            __syncwarp();
            kb = dq;
            vb = dq + kWarpKeys * ldk;
            ksg = sc[g];
            ksg8 = sc[g + 8];
            vsg = sc[kWarpKeys + g];
            vsg8 = sc[kWarpKeys + g + 8];
        }

        // S^T (16 keys x 8 rows) = K Q^T
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
            uint32_t a[4];
            tc::ldsm_a(a, kb + kk * 16, ldk, lane);
            tc::mma_bf16(s, a, qf[kk][0], qf[kk][1]);
        }
        // s[0] = (key g, row r0), s[1] = (g, r1), s[2] = (g + 8, r0),
        // s[3] = (g + 8, r1); a key past the split's end or the row's
        // causal limit is masked
        const int pg = k0 + g, pg8 = k0 + g + 8;
        const bool in_g = pg < k_end, in_g8 = pg8 < k_end;
        const float sg = scale * ksg, sg8 = scale * ksg8;
        s[0] = in_g && pg <= lim0 ? s[0] * sg : kNegInf;
        s[1] = in_g && pg <= lim1 ? s[1] * sg : kNegInf;
        s[2] = in_g8 && pg8 <= lim0 ? s[2] * sg8 : kNegInf;
        s[3] = in_g8 && pg8 <= lim1 ? s[3] * sg8 : kNegInf;
        // row maxima over the warp's 16 keys: the 8 lanes of one t
        float mx0 = fmaxf(s[0], s[2]), mx1 = fmaxf(s[1], s[3]);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const bool live0 = mn0 > kNegInf / 2, live1 = mn1 > kNegInf / 2;
        const float p0 = expf(live0 ? s[0] - mn0 : kNegInf);
        const float p1 = expf(live1 ? s[1] - mn1 : kNegInf);
        const float p2 = expf(live0 ? s[2] - mn0 : kNegInf);
        const float p3 = expf(live1 ? s[3] - mn1 : kNegInf);
        const float a0 = expf(live0 ? m0 - mn0 : 0.f);
        const float a1 = expf(live1 ? m1 - mn1 : 0.f);
        l0 = a0 * l0 + p0 + p2;             // this lane's keys; summed later
        l1 = a1 * l1 + p1 + p3;
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int x = 0; x < NT; ++x) {
            acc[x][0] *= a0;
            acc[x][1] *= a1;
            acc[x][2] *= a0;
            acc[x][3] *= a1;
        }
        // P^T as B fragments (k = keys, n = rows): the two 8 x 8 blocks of
        // p (keys g and g + 8), transposed; bf16 over fp pages (as the
        // plain version rounds p), fp16 of p * V's scale over quantized
        // pages, whose values fp16 holds exactly
        uint32_t b0, b1;
        if constexpr (!kQuant) {
            b0 = movmatrix_trans(tc::pack_bf16(p0, p1));
            b1 = movmatrix_trans(tc::pack_bf16(p2, p3));
        } else {
            b0 = movmatrix_trans(pack_f16(p0 * vsg, p1 * vsg));
            b1 = movmatrix_trans(pack_f16(p2 * vsg8, p3 * vsg8));
        }
        // O^T (DP x 8 rows) += V^T P^T
#pragma unroll
        for (int x = 0; x < NT; ++x) {
            uint32_t a[4];
            ldsm_a_trans(a, vb + x * 16, ldk, lane);
            if constexpr (!kQuant) tc::mma_bf16(acc[x], a, b0, b1);
            else mma_f16(acc[x], a, b0, b1);
        }
        __syncwarp();                       // the slices are rewritten next
    }
    cp_async_wait<0>();

    // a row's sum over the warp's keys: the 8 lanes of one t
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, o);
        l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    __syncthreads();                        // every warp is off its slices
    float* red_m = reinterpret_cast<float*>(smem_tc);   // [4][kRows]
    float* red_l = red_m + kWarpsTc * kRows;            // [4][kRows]
    float* blk_m = red_l + kWarpsTc * kRows;            // [kRows]
    float* blk_l = blk_m + kRows;                       // [kRows]
    float* red_acc = blk_l + kRows;                     // [4][kRows][DP]
    if (g == 0) {
        red_m[warp * kRows + r0] = m0;
        red_m[warp * kRows + r1] = m1;
        red_l[warp * kRows + r0] = l0;
        red_l[warp * kRows + r1] = l1;
    }
#pragma unroll
    for (int x = 0; x < NT; ++x) {
        float* a = red_acc + (size_t)warp * kRows * DP + 16 * x + g;
        a[r0 * DP] = acc[x][0];
        a[r1 * DP] = acc[x][1];
        a[r0 * DP + 8] = acc[x][2];
        a[r1 * DP + 8] = acc[x][3];
    }
    __syncthreads();
    // the four warps in warp order, weighted by exp(m_w - max m): each
    // element's sum replaces warp 0's, by the one thread that reads it
    for (int x = tid; x < R * D; x += kThreadsTc) {
        const int r = x / D, d = x % D;
        float mm = kNegInf;
#pragma unroll
        for (int w = 0; w < kWarpsTc; ++w)
            mm = fmaxf(mm, red_m[w * kRows + r]);
        float l = 0.f, v = 0.f;
#pragma unroll
        for (int w = 0; w < kWarpsTc; ++w) {
            const float mw = red_m[w * kRows + r];
            const float wt = mw > kNegInf / 2 ? expf(mw - mm) : 0.f;
            l += wt * red_l[w * kRows + r];
            v += wt * red_acc[((size_t)w * kRows + r) * DP + d];
        }
        red_acc[r * DP + d] = v;
        if (d == 0) {
            blk_m[r] = mm;
            blk_l[r] = l;
        }
    }
    __syncthreads();
    finish_tile<bf16_t>(red_acc, DP, blk_m, blk_l, R, D, n_live, split, row0,
                        kvh, b, Tq, Nq, G, out, tid, kThreadsTc);
}

// ---------------------------------------------------------------------------
// fp32 q: the CUDA-core body
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kQPad = 4;        // fp32 pad per q row (keeps 16-B rows)
constexpr int kRowGroups = kThreads / kKeys;           // 4
constexpr int kRowsPerThread = kRows / kRowGroups;     // 2
static_assert(kKeys == 64, "the softmax pass gives each lane two keys");
static_assert(kThreads % kKeys == 0 && kRows % kRowGroups == 0, "tiling");

// CW adjacent fp32 values of one V row (a lane's head-dim columns)
template <int CW>
__device__ __forceinline__ void load_cols(const float* src, float* dst) {
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
}

// How one kind of page stores a K/V row. kVec: values per 16 stored bytes;
// kSlots: page slots per stored row (int4 packs two); widen: 16 stored
// bytes -> kVec dequantized fp32 values; cols: CW adjacent head-dim
// columns of a row. `hi` picks the high nibble (odd slot) of int4 bytes.
template <int KIND> struct Page;

template <> struct Page<kFp> {
    static constexpr int kVec = 4;
    static constexpr int kSlots = 1;
    static constexpr int kElem = 4;
    static __device__ __forceinline__ void widen(const unsigned char* src,
                                                 int, float, float* dst) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
    }
    template <int CW>
    static __device__ __forceinline__ void cols(const unsigned char* row,
                                                int col, int, float,
                                                float* dst) {
        load_cols<CW>(reinterpret_cast<const float*>(row) + col, dst);
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

template <int KIND> struct PageQ {      // int8 and int4
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
template <> struct Page<kInt8> : PageQ<kInt8> {};
template <> struct Page<kInt4> : PageQ<kInt4> {};

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

template <int KIND, int CW>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,    // [B, T, Nq, D]
                       const unsigned char* __restrict__ k_pages,
                       const unsigned char* __restrict__ v_pages,
                       const float* __restrict__ k_scale,  // [NP, Nkv, PS]
                       const float* __restrict__ v_scale,  // (quantized)
                       const int* __restrict__ tables, // [B, maxP]
                       const int* __restrict__ starts, // [B]
                       float* __restrict__ out,        // [B, T, Nq, D]
                       int Tq, int Nq, int Nkv, int D, int PS, int maxP,
                       float scale, int nstage, Plan plan) {
    extern __shared__ __align__(16) float smem[];
    using P = Page<KIND>;
    constexpr int V = P::kVec;
    constexpr int kSlots = P::kSlots;
    constexpr int kTileRows = kKeys / kSlots;   // stored rows per tile
    constexpr bool kQuant = KIND != kFp;
    const int G = Nq / Nkv;
    const int rt = blockIdx.x / plan.n_splits;
    const int split = blockIdx.x % plan.n_splits;
    const int row0 = rt * kRows;
    const int kvh = blockIdx.y;
    const int b = blockIdx.z;
    const int R = min(kRows, Tq * G - row0);
    const int start = starts[b];
    const int j_last = (row0 + R - 1) / G;  // last query token of the tile
    const int n_keys = tile_keys(start, j_last, maxP, PS);
    const int n_live = live_splits(n_keys, plan.kps);
    // a split with no key exits: a cluster barrier waits only for the
    // threads that have not exited, and no block reads its shared memory
    if (split >= n_live) return;
    const int k_begin = split * plan.kps;
    const int k_end = min(k_begin + plan.kps, n_keys);
    const int n_tiles = max(0, (k_end - k_begin + kKeys - 1) / kKeys);
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
    const int* table = tables + (size_t)b * maxP;
    const int vecs = D / V;                 // 16-byte pieces per stored row

    // copy tile t's K and V rows (and scales) into stage buf; page ids
    // come from the table. Stored row sr holds page slots sr * kSlots ..;
    // PS and kKeys are multiples of kSlots, so a stored row never spans
    // two pages or two tiles.
    auto issue = [&](int t, int buf) {
        const int t0 = k_begin + t * kKeys;
        const int nk = min(kKeys, k_end - t0);
        unsigned char* kb = tiles + (size_t)buf * stage_bytes;
        unsigned char* vb = kb + (size_t)kTileRows * ldr;
        for (int i = tid; i < kTileRows * vecs; i += kThreads) {
            const int sr = i / vecs, c = (i % vecs) * 16;   // c in bytes
            const int kk = sr * kSlots;
            const size_t off = kk < nk
                ? page_row(table, t0 + kk, PS, Nkv, kvh, kSlots,
                           D * P::kElem) + c
                : 0;
            cp_async16(kb + sr * ldr + c, k_pages + off, kk < nk);
            cp_async16(vb + sr * ldr + c, v_pages + off, kk < nk);
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
                cp_async4(ks + kk, k_scale + off, kk < nk);
                cp_async4(vs + kk, v_scale + off, kk < nk);
            }
        }
        cp_async_commit();
    };

    if (n_tiles > 0) issue(0, 0);
    for (int i = tid; i < R * (D / 4); i += kThreads) {
        const int r = i / (D / 4), c = (i % (D / 4)) * 4;
        const int row = row0 + r;
        const int j = row / G, h = kvh * G + row % G;
        const float* src = q + (((size_t)b * Tq + j) * Nq + h) * D + c;
#pragma unroll
        for (int e = 0; e < 4; ++e) q_s[r * ldq + c + e] = src[e];
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
        const int t0 = k_begin + t * kKeys;
        const int nk = min(kKeys, k_end - t0);
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

    // add the warps' partial sums (fixed order); the tile region is free
    // now and holds [kWarps][kRows][D] fp32
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
    // each element's sum replaces warp 0's, by the one thread that reads it
    for (int i = tid; i < R * D; i += kThreads) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += red[w * kRows * D + i];
        red[i] = sum;
    }
    __syncthreads();
    finish_tile<float>(red, D, m_s, l_s, R, D, n_live, split, row0, kvh, b,
                       Tq, Nq, G, out, tid, kThreads);
}

// ---------------------------------------------------------------------------
// the launchers
// ---------------------------------------------------------------------------

struct Args {
    const void *q, *k_pages, *v_pages, *k_scale, *v_scale;
    const int *tables, *starts;
    void* out;
    int B, Tq, Nq, Nkv, D, PS, maxP;
    float scale;
    Plan plan;
    cudaStream_t stream;
};

// one launch, a cluster of a row tile's n_splits blocks
template <typename... Params, typename... Actual>
cudaError_t launch_clusters(void (*kernel)(Params...), const Args& a,
                            int threads, size_t smem, Actual... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.plan.row_tiles * a.plan.n_splits, a.Nkv, a.B);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = a.stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.plan.n_splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    return err != cudaSuccess ? err : cudaGetLastError();
}

template <int KIND, int NT>
cudaError_t launch_tc(const Args& a) {
    const size_t smem = TcLayout<KIND>(a.D, 16 * NT).block_bytes;
    if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
    return launch_clusters(
        paged_attention_tc_kernel<KIND, NT>, a, kThreadsTc, smem,
        static_cast<const bf16_t*>(a.q),
        static_cast<const unsigned char*>(a.k_pages),
        static_cast<const unsigned char*>(a.v_pages),
        static_cast<const float*>(a.k_scale),
        static_cast<const float*>(a.v_scale), a.tables, a.starts,
        static_cast<bf16_t*>(a.out), a.Tq, a.Nq, a.Nkv, a.D, a.PS, a.maxP,
        a.scale, a.plan);
}

// the bf16 body's k-steps: D padded to 16, 32, 64, 128 or 256
template <int KIND>
cudaError_t launch_tc_d(const Args& a) {
    if (a.D <= 16) return launch_tc<KIND, 1>(a);
    if (a.D <= 32) return launch_tc<KIND, 2>(a);
    if (a.D <= 64) return launch_tc<KIND, 4>(a);
    if (a.D <= 128) return launch_tc<KIND, 8>(a);
    return launch_tc<KIND, 16>(a);
}

template <int KIND, int CW>
cudaError_t launch_f32(const Args& a) {
    using P = Page<KIND>;
    const int nstage =
        smem_bytes(a.D, P::kElem, P::kSlots, 2) <= (size_t)kMaxSmem ? 2 : 1;
    return launch_clusters(
        paged_attention_kernel<KIND, CW>, a, kThreads,
        smem_bytes(a.D, P::kElem, P::kSlots, nstage),
        static_cast<const float*>(a.q),
        static_cast<const unsigned char*>(a.k_pages),
        static_cast<const unsigned char*>(a.v_pages),
        static_cast<const float*>(a.k_scale),
        static_cast<const float*>(a.v_scale), a.tables, a.starts,
        static_cast<float*>(a.out), a.Tq, a.Nq, a.Nkv, a.D, a.PS, a.maxP,
        a.scale, nstage, a.plan);
}

// a lane's head-dim columns: the power of two CW with 32 * CW >= D
template <int KIND>
cudaError_t launch_f32_d(const Args& a) {
    if (a.D <= 32) return launch_f32<KIND, 1>(a);
    if (a.D <= 64) return launch_f32<KIND, 2>(a);
    if (a.D <= 128) return launch_f32<KIND, 4>(a);
    return launch_f32<KIND, 8>(a);
}

// the dtype alone picks the body: fp32 on CUDA cores, bf16 on tensor cores
template <int KIND>
cudaError_t launch_kind(int dtype, const Args& a) {
    return dtype == 0 ? launch_f32_d<KIND>(a) : launch_tc_d<KIND>(a);
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16. kind: 0 = pages in q's
// dtype (k_scale, v_scale unused), 1 = int8 pages, 2 = packed int4 pages.
// The split plan (ops/paged_attention_cuda.py split_plan): keys_per_split
// (a multiple of 64) and n_splits (at most 8, one cluster), over row tiles
// of 8 query rows. Returns a cudaError_t (0 = success).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* starts, void* out, int B,
                                   int Tq, int Nq, int Nkv, int D, int PS,
                                   int maxP, float scale, int dtype, int kind,
                                   int keys_per_split, int n_splits,
                                   void* stream) {
    if (B <= 0 || Tq <= 0) return cudaSuccess;
    if (D % 8 != 0 || D > kMaxD || Nkv <= 0 || Nq % Nkv != 0 || PS <= 0
        || maxP <= 0 || kind < kFp || kind > kInt4 || dtype < 0 || dtype > 1)
        return cudaErrorInvalidValue;
    if (kind != kFp && (D % 16 != 0 || k_scale == nullptr
                        || v_scale == nullptr))
        return cudaErrorInvalidValue;
    if (kind == kInt4 && PS % 2 != 0) return cudaErrorInvalidValue;
    if (keys_per_split <= 0 || keys_per_split % kKeys != 0 || n_splits <= 0
        || n_splits > kMaxSplits
        || (long long)keys_per_split * n_splits < (long long)maxP * PS)
        return cudaErrorInvalidValue;
    Args a;
    a.q = q; a.k_pages = k_pages; a.v_pages = v_pages;
    a.k_scale = k_scale; a.v_scale = v_scale;
    a.tables = static_cast<const int*>(tables);
    a.starts = static_cast<const int*>(starts);
    a.out = out;
    a.B = B; a.Tq = Tq; a.Nq = Nq; a.Nkv = Nkv; a.D = D; a.PS = PS;
    a.maxP = maxP; a.scale = scale;
    a.plan = Plan{keys_per_split, n_splits,
                  (Tq * (Nq / Nkv) + kRows - 1) / kRows};
    a.stream = static_cast<cudaStream_t>(stream);
    if (kind == kFp) return launch_kind<kFp>(dtype, a);
    if (kind == kInt8) return launch_kind<kInt8>(dtype, a);
    return launch_kind<kInt4>(dtype, a);
}
