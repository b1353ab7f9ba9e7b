// Flash attention forward and backward for Hopper (sm_90a), bf16 or fp32.
//
// Replaces the TPU kernels of the JAX package's ops/attention.py:
//   flash_fwd      <- _fwd_kernel      (online softmax over kv tiles)
//   flash_bwd_dq   <- _bwd_dq_kernel   (dq over kv tiles)
//   flash_bwd_dkv  <- _bwd_dkv_kernel  (dk, dv over q tiles)
//
// Layout (the JAX raw entry points'): q [BH, Sq, D], k/v [BH, Skv, D]
// contiguous, heads folded into BH (GQA query groups folded into the q
// rows); segments/positions [BH, S] int32; lse/delta [BH, Sq] fp32. The mask
// is taken from the segment and position arrays, never from the grid:
// (qseg == kseg) && kseg != 0 && (!causal || qpos >= kpos). Segment ids
// are non-negative (0 = padding).
//
// What bounds it on an H100: at gpt-1b training shapes (S=2048, D=128)
// the work is operations (S^2 D per head, intensity far above the 295
// FLOP/byte ridge): 2 D flops a live (q, key) pair for each product, three
// products in dq (s, dp, ds.k) and four in dk/dv (s, dp, p^T.dO, ds^T.q),
// against 989 TF/s of bf16 tensor cores. The design keeps the S x S matrix
// out of device memory and runs the bf16 products on the tensor cores with
// mma.sync m16n8k16 and fp32 accumulation.
//
// bf16 forward (flash_fwd_bf16_kernel): a block of 4 warps owns 128 q
// rows, 32 a warp (two m16 tiles, so every K and V fragment that ldmatrix
// brings feeds two mma), and the online-softmax statistics of a row live
// in the 4 lanes that hold it. The Q tile is copied once by cp.async; a
// warp reads its A fragments from it by ldmatrix at each k-step (with 16
// rows a warp they fit in registers for the whole walk, but that design
// ran at 0.36 ms against this one's 0.31). K, V and the keys' positions
// and segments stream through the backward's two-stage cp.async ring
// below, one block barrier a tile, each kv tile classified before the
// walk (skip: never loaded; all-live: no mask; mixed: the per-element
// mask, with the block's q positions and segments kept in shared memory).
// A 64-key tile is taken in two steps of 32 keys, so s needs 32
// accumulator registers, not 64, and nothing spills. A row's running max
// m is kept raw (the max commutes with the positive scale, so lse = m *
// scale + log l is the plain version's m), and p = 2^(s c - m c), c =
// scale * log2(e), is one fma and one ex2.approx (a masked score is
// NEG_INF, so s c is at most -inf and p is 0; liveness is tested on the
// raw m, m > NEG_INF / 2). l sums the fp32 p per lane and once over the
// quad at the end; p, rounded to bf16 once, is the A fragment of p.v,
// whose B fragments come from V by ldmatrix.trans. out leaves by 4-byte
// bf16x2 stores, lse from lane t = 0 of each row quad.
//
// bf16 backward (flash_bwd_*_bf16_kernel): a block of 4 warps keeps 64
// resident rows (q and dO for dq, K and V for dk/dv, 16 rows a warp) and
// walks 64-row tiles of the other operand (K, V and their positions and
// segments for dq; Q, dO, positions, segments, lse and delta for dk/dv)
// through a two-stage cp.async ring (16-byte copies; 4-byte ones for the
// per-row arrays): right after a tile's one block barrier the next live
// tile's copies are issued, and they land while this tile's products run.
// Every operand reaches the tensor cores by ldmatrix.x4 (.trans for the
// operands stored [k][n]: K in ds.k, dO in p^T.dO, Q in ds^T.q) from
// tiles padded to D + 8 elements a row, which ldmatrix reads without bank
// conflicts. The s and dp accumulators become p and ds in registers: two
// adjacent m16n8 accumulator tiles, rounded to bf16, are an m16n8k16 A
// fragment, so p and ds never touch shared memory. Before the walk the
// warps classify every streamed tile against the block's rows from true
// position and segment min/max (positions restart inside packed rows and
// inside the GQA fold, so first/last elements are no bound), one byte a
// tile in shared memory, behind the barrier the walk needs anyway: skip
// (no live pair: not even loaded), all-live (both tiles full, one segment,
// every key at or before every q: no mask) or mixed (the per-element mask
// from the segment and position arrays). dk/dv blocks own their 64 keys
// and dq blocks their 64 q rows, so every output element is written by one
// block, with no atomics: repeated calls give equal bits. exp2 with
// log2(e) folded into the scale.
//
// ptxas -v (sm_90a), 0 spill bytes in all six; shared memory per block at
// S = 2048 (the backward: 6 tiles of 64 x (D + 8) bf16, two stages of the
// per-row arrays, a class byte a tile; the forward: a Q tile of 128 rows,
// 4 tiles of 64, the row arrays); resident blocks an SM, registers and
// shared memory both allowing 2 (8 warps):
//   fwd  D=128: 255 registers, 106,528 B    fwd  D=64: 215, 57,376 B
//   dq   D=128: 236 registers, 105,504 B    dq   D=64: 194, 56,352 B
//   dkv  D=128: 255 registers, 106,528 B    dkv  D=64: 221, 57,376 B
// On an H100 80GB HBM3 at 700 W, B=4 x 2048, 16/16 heads, D=128, causal:
// fwd 0.31 ms (22% of its 0.0695 ms bound), dq 0.50 ms (21% of its 0.104
// ms bound), dk/dv 0.65 ms (21% of 0.139). What holds them: mma.sync with
// a barrier a tile and 8 warps an SM leaves the tensor cores waiting on
// each warp's chain (products, then the softmax, then the next product).
// What comes next: wgmma with TMA-fed tiles and warp specialisation (one
// warpgroup's softmax under another's products), and for the backward the
// two-pass recompute of s and dp (seven products where one fused pass with
// dq by atomics would take five).
//
// fp32 (a verification path, not a fast one) keeps the first design for
// all three (one block of 4 warps per 64 q rows or keys, tiles loaded
// synchronously, p and ds through shared memory): the same fragment
// layout computed with scalar fp32 FMAs, 32 q rows a dk/dv tile. A block
// skips a tile pair only when causal and the true minimum kv position of
// the tile exceeds the true maximum q position of the block.
//
// Numerics follow the TPU kernels: scores are (q.k)*scale in fp32; masked
// scores are NEG_INF = -0.7 * FLT_MAX; p = exp(s - m) is 0 while the
// running max is NEG_INF (empty rows); the output divides by l only where
// l > 0 and lse = NEG_INF on empty rows; p is rounded to v's dtype before
// p.v and dO^T p, and ds = p * (dp - delta) * scale is rounded to the
// input dtype before ds.k and ds^T q.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = (float)(-0.7 * 3.4028234663852886e38);
constexpr int kThreads = 128;     // 4 warps
constexpr int kRows = 64;         // q rows (fwd, dq) or keys (dkv) per block
                                  // (fwd and the fp32 backward)
constexpr int kKeys = 64;         // keys per kv tile (fwd, dq)
constexpr int kQDkv = 32;         // q rows per q tile in the fp32 dkv kernel

typedef __nv_bfloat16 bf16;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// Warp-level C[16x8] += A[16x16] * B[16x8] in the mma.sync m16n8k16
// fragment layout: lane = 4*g + t holds C rows g and g+8, columns 2t and
// 2t+1 (c0: (g,2t) c1: (g,2t+1) c2: (g+8,2t) c3: (g+8,2t+1)). A is
// row-major in shared memory (lda elements per row). B is given either as
// B[n][k] (KN = false, rows of a row-major [n, k] tile) or as B[k][n]
// (KN = true).
template <typename T> struct Mma;

template <> struct Mma<float> {
  struct A { const float* p; int lda; };
  __device__ __forceinline__ static void load_a(A& f, const float* p, int lda,
                                                int, int) {
    f.p = p;
    f.lda = lda;
  }
  template <bool KN>
  __device__ __forceinline__ static void mma(float c[4], const A& f,
                                             const float* b, int ldb, int g,
                                             int t) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float a0 = f.p[g * f.lda + k], a1 = f.p[(g + 8) * f.lda + k];
      const float b0 = KN ? b[k * ldb + 2 * t] : b[(2 * t) * ldb + k];
      const float b1 = KN ? b[k * ldb + 2 * t + 1] : b[(2 * t + 1) * ldb + k];
      c[0] = fmaf(a0, b0, c[0]);
      c[1] = fmaf(a0, b1, c[1]);
      c[2] = fmaf(a1, b0, c[2]);
      c[3] = fmaf(a1, b1, c[3]);
    }
  }
};

// Fragment helpers (ldmatrix, mma.sync, cp.async): tensor_core.cuh.
using namespace tc;

// rows [row0, row0 + R) of a [nrows, D] bf16 tensor into a padded shared
// tile by cp.async; rows past the end are zero
template <int D, int R>
__device__ __forceinline__ void copy_rows(bf16* s, const bf16* src, int row0,
                                          int nrows) {
  constexpr int VPR = D / 8, LD = D + 8;
  static_assert(R * VPR % kThreads == 0, "whole 16-byte chunks per thread");
#pragma unroll
  for (int it = 0; it < R * VPR / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool ok = row0 + r < nrows;
    cp_async16(s + r * LD + c, src + (ok ? (size_t)(row0 + r) * D + c : 0),
               ok);
  }
}

// [n] values of a [len] 4-byte array from element i0 into shared memory by
// the threads [t0, t0 + n); zero past the end
template <typename V>
__device__ __forceinline__ void copy_vals(V* s, const V* src, int i0, int len,
                                          int t0, int n) {
  const int i = threadIdx.x - t0;
  if (i >= 0 && i < n) {
    const bool ok = i0 + i < len;
    cp_async4(s + i, src + (ok ? i0 + i : 0), ok);
  }
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// True position and segment min/max of the valid rows [r0, min(r0 + n,
// len)) of one head's arrays, reduced by one warp with shuffles (every lane
// gets the result). Positions restart inside packed rows and inside the
// GQA fold, so first/last elements are no bound.
struct Span {
  int pmin, pmax, smin, smax;
};
__device__ __forceinline__ Span warp_span(const int* pos, const int* seg,
                                          int r0, int n, int len, int lane) {
  Span sp{INT_MAX, INT_MIN, INT_MAX, INT_MIN};
  for (int r = r0 + lane; r < r0 + n && r < len; r += 32) {
    const int p = pos[r], s = seg[r];
    sp.pmin = min(sp.pmin, p);
    sp.pmax = max(sp.pmax, p);
    sp.smin = min(sp.smin, s);
    sp.smax = max(sp.smax, s);
  }
  return Span{warp_min(sp.pmin), warp_max(sp.pmax), warp_min(sp.smin),
              warp_max(sp.smax)};
}

// A (q rows, keys) tile pair is skipped when no pair can be live, all-live
// when every pair is (both tiles full, one nonzero segment, and under a
// causal mask every key position <= every q position), else mixed (the
// per-element mask).
enum : unsigned char { kSkip = 0, kLive = 1, kMixed = 2 };
__device__ __forceinline__ unsigned char tile_class(const Span& q,
                                                    const Span& k, bool full,
                                                    int causal) {
  if (causal && k.pmin > q.pmax) return kSkip;
  if (max(max(q.smin, k.smin), 1) > min(q.smax, k.smax)) return kSkip;
  if (full && q.smin == q.smax && k.smin == k.smax && q.smin == k.smin
      && (!causal || q.pmin >= k.pmax))
    return kLive;
  return kMixed;
}

// Classes of the streamed tiles [0, nt) of one head against the block's
// span (the q rows' when mine_is_q, else the keys'), the tiles dealt to
// the warps round robin; one byte each into cls. The caller's next
// __syncthreads makes them visible.
__device__ __forceinline__ void classify_tiles(
    unsigned char* cls, const int* pos, const int* seg, int len, int tile,
    const Span& mine, bool mine_is_q, bool mine_full, int causal, int warp,
    int lane) {
  const int nt = (len + tile - 1) / tile;
  for (int j = warp; j < nt; j += kThreads / 32) {
    const Span sp = warp_span(pos, seg, j * tile, tile, len, lane);
    const bool full = mine_full && (j + 1) * tile <= len;
    const unsigned char c = mine_is_q ? tile_class(mine, sp, full, causal)
                                      : tile_class(sp, mine, full, causal);
    if (lane == 0) cls[j] = c;
  }
}

__device__ __forceinline__ int next_live(const unsigned char* cls, int j,
                                         int nt) {
  while (j < nt && cls[j] == kSkip) ++j;
  return j;
}

constexpr float kLog2e = 1.4426950408889634f;

// lse in base 2 for exp2; an empty row's NEG_INF (which would overflow) is
// never used unmasked, so it becomes 0
__device__ __forceinline__ float lse_log2(float l) {
  return l > kNegInf * 0.5f ? l * kLog2e : 0.f;
}

// C[16 x 8*NT] += A[16 x K] * B over K in steps of 16 (A and B in shared
// memory; see Mma for the B layouts).
template <typename T, int NT, int K, bool KN>
__device__ __forceinline__ void warp_gemm(float (*c)[4], const T* a, int lda,
                                          const T* b, int ldb, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    typename Mma<T>::A f;
    Mma<T>::load_a(f, a + kk, lda, g, t);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const T* bp = KN ? b + kk * ldb + n * 8 : b + n * 8 * ldb + kk;
      Mma<T>::template mma<KN>(c[n], f, bp, ldb, g, t);
    }
  }
}

// rows [row0, row0 + R) of a [nrows, D] global tensor into a padded shared
// tile (ld elements per row); rows past the end are zero.
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(T* s, int ld, const T* src, int row0,
                                          int nrows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < R * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(s + r * ld + c) = val;
  }
}

// block-wide min/max of one int per thread (threads past the values pass
// the identity); red is 4 ints of shared memory
__device__ __forceinline__ int block_reduce(int v, bool is_max, int* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int o = __shfl_xor_sync(0xffffffffu, v, off);
    v = is_max ? max(v, o) : min(v, o);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) r = is_max ? max(r, red[w]) : min(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// Forward: one block per (head, 64 q rows); loop over kv tiles of 64 keys.
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ qseg, const int* __restrict__ kseg,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    T* __restrict__ out, float* __restrict__ lse, int Sq, int Skv, int causal,
    float scale) {
  constexpr int LD = D + 8, LDP = kKeys + 8, NK = kKeys / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kRows * LD;
  T* sV = sK + kKeys * LD;
  T* sP = sV + kKeys * LD;
  int* sKpos = reinterpret_cast<int*>(sP + kRows * LDP);
  int* sKseg = sKpos + kKeys;
  int* sRed = sKseg + kKeys;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // heavy tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)bh * Skv * D;
  const T* vb = v + (size_t)bh * Skv * D;

  load_rows<T, D, kRows>(sQ, LD, qb, q0, Sq);
  int row[2], qp[2], qs[2];
  bool ok_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + warp * 16 + g + 8 * i;
    ok_row[i] = row[i] < Sq;
    qp[i] = ok_row[i] ? qpos[(size_t)bh * Sq + row[i]] : 0;
    qs[i] = ok_row[i] ? qseg[(size_t)bh * Sq + row[i]] : -1;
  }
  int mine = INT_MIN;
  if (threadIdx.x < kRows && q0 + threadIdx.x < Sq)
    mine = qpos[(size_t)bh * Sq + q0 + threadIdx.x];
  const int qmax = block_reduce(mine, true, sRed);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int k0 = 0; k0 < Skv; k0 += kKeys) {
    int kp = INT_MAX;
    if (threadIdx.x < kKeys) {
      const int c = k0 + threadIdx.x;
      int ks = 0;
      if (c < Skv) {
        kp = kpos[(size_t)bh * Skv + c];
        ks = kseg[(size_t)bh * Skv + c];
      }
      sKpos[threadIdx.x] = kp;
      sKseg[threadIdx.x] = ks;
    }
    const int kmin = block_reduce(kp, false, sRed);
    if (causal && kmin > qmax) continue;        // no live (q, k) pair
    load_rows<T, D, kKeys>(sK, LD, kb, k0, Skv);
    load_rows<T, D, kKeys>(sV, LD, vb, k0, Skv);
    __syncthreads();

    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    warp_gemm<T, NK, D, false>(s, sQ + warp * 16 * LD, LD, sK, LD, g, t);

    float mcur[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = n * 8 + 2 * t + (e & 1);
        const int ks = sKseg[c];
        const bool ok = ok_row[i] && qs[i] == ks && ks != 0
                        && (!causal || qp[i] >= sKpos[c]);
        s[n][e] = ok ? s[n][e] * scale : kNegInf;
        mcur[i] = fmaxf(mcur[i], s[n][e]);
      }
    }
    float alpha[2], mnew[2], rs[2] = {0.f, 0.f};
    bool live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mnew[i] = fmaxf(m[i], quad_max(mcur[i]));
      live[i] = mnew[i] > kNegInf * 0.5f;
      alpha[i] = expf(live[i] ? m[i] - mnew[i] : 0.f);
    }
    T* pw = sP + warp * 16 * LDP;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = expf(live[i] ? s[n][e] - mnew[i] : kNegInf);
        rs[i] += p;
        pw[(g + 8 * i) * LDP + n * 8 + 2 * t + (e & 1)] = from_f<T>(p);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = alpha[i] * l[i] + quad_sum(rs[i]);
      m[i] = mnew[i];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    __syncwarp();
    warp_gemm<T, ND, kKeys, true>(o, pw, LDP, sV, LD, g, t);
    __syncthreads();     // sK/sV/sP/sKpos are rewritten by the next tile
  }

  T* ob = out + (size_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!ok_row[i]) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      T* dst = ob + (size_t)row[i] * D + n * 8 + 2 * t;
      dst[0] = from_f<T>(o[n][2 * i] / safe_l);
      dst[1] = from_f<T>(o[n][2 * i + 1] / safe_l);
    }
    if (t == 0)
      lse[(size_t)bh * Sq + row[i]] =
          l[i] > 0.f ? m[i] + logf(safe_l) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// Backward dq: one block per (head, 64 q rows); loop over kv tiles.
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ qseg, const int* __restrict__ kseg,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Skv,
    int causal, float scale) {
  constexpr int LD = D + 8, LDP = kKeys + 8, NK = kKeys / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + kRows * LD;          // dO
  T* sK = sO + kRows * LD;
  T* sV = sK + kKeys * LD;
  T* sS = sV + kKeys * LD;          // ds
  int* sKpos = reinterpret_cast<int*>(sS + kRows * LDP);
  int* sKseg = sKpos + kKeys;
  int* sRed = sKseg + kKeys;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Skv * D;

  load_rows<T, D, kRows>(sQ, LD, q + qoff, q0, Sq);
  load_rows<T, D, kRows>(sO, LD, dout + qoff, q0, Sq);
  int row[2], qp[2], qs[2];
  bool ok_row[2];
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + warp * 16 + g + 8 * i;
    ok_row[i] = row[i] < Sq;
    const size_t r = (size_t)bh * Sq + row[i];
    qp[i] = ok_row[i] ? qpos[r] : 0;
    qs[i] = ok_row[i] ? qseg[r] : -1;
    lr[i] = ok_row[i] ? lse[r] : 0.f;
    dr[i] = ok_row[i] ? delta[r] : 0.f;
  }
  int mine = INT_MIN;
  if (threadIdx.x < kRows && q0 + threadIdx.x < Sq)
    mine = qpos[(size_t)bh * Sq + q0 + threadIdx.x];
  const int qmax = block_reduce(mine, true, sRed);

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < Skv; k0 += kKeys) {
    int kp = INT_MAX;
    if (threadIdx.x < kKeys) {
      const int c = k0 + threadIdx.x;
      int ks = 0;
      if (c < Skv) {
        kp = kpos[(size_t)bh * Skv + c];
        ks = kseg[(size_t)bh * Skv + c];
      }
      sKpos[threadIdx.x] = kp;
      sKseg[threadIdx.x] = ks;
    }
    const int kmin = block_reduce(kp, false, sRed);
    if (causal && kmin > qmax) continue;
    load_rows<T, D, kKeys>(sK, LD, k + koff, k0, Skv);
    load_rows<T, D, kKeys>(sV, LD, v + koff, k0, Skv);
    __syncthreads();

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    warp_gemm<T, NK, D, false>(s, sQ + warp * 16 * LD, LD, sK, LD, g, t);
    warp_gemm<T, NK, D, false>(dp, sO + warp * 16 * LD, LD, sV, LD, g, t);

    T* dsw = sS + warp * 16 * LDP;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = n * 8 + 2 * t + (e & 1);
        const int ks = sKseg[c];
        const bool ok = ok_row[i] && qs[i] == ks && ks != 0
                        && (!causal || qp[i] >= sKpos[c]);
        const float p = ok ? expf(s[n][e] * scale - lr[i]) : 0.f;
        const float ds = p * (dp[n][e] - dr[i]) * scale;
        dsw[(g + 8 * i) * LDP + c] = from_f<T>(ds);
      }
    }
    __syncwarp();
    warp_gemm<T, ND, kKeys, true>(acc, dsw, LDP, sK, LD, g, t);
    __syncthreads();
  }

  T* db = dq + qoff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!ok_row[i]) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      T* dst = db + (size_t)row[i] * D + n * 8 + 2 * t;
      dst[0] = from_f<T>(acc[n][2 * i]);
      dst[1] = from_f<T>(acc[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward dk/dv: one block per (head, 64 keys); loop over q tiles of 32
// rows. Products are taken transposed (keys as rows): s^T = k q^T.
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ qseg, const int* __restrict__ kseg,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int Sq, int Skv, int causal, float scale) {
  constexpr int LD = D + 8, LDP = kQDkv + 8, NQ = kQDkv / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kRows * LD;
  T* sQ = sV + kRows * LD;
  T* sO = sQ + kQDkv * LD;          // dO
  T* sP = sO + kQDkv * LD;          // p^T  [keys][q]
  T* sS = sP + kRows * LDP;         // ds^T [keys][q]
  int* sQpos = reinterpret_cast<int*>(sS + kRows * LDP);
  int* sQseg = sQpos + kQDkv;
  float* sLse = reinterpret_cast<float*>(sQseg + kQDkv);
  float* sDelta = sLse + kQDkv;
  int* sRed = reinterpret_cast<int*>(sDelta + kQDkv);

  const int bh = blockIdx.x, k0 = blockIdx.y * kRows;   // early keys: most work
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Skv * D;

  load_rows<T, D, kRows>(sK, LD, k + koff, k0, Skv);
  load_rows<T, D, kRows>(sV, LD, v + koff, k0, Skv);
  int key[2], kp[2], ks[2];
  bool ok_key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + warp * 16 + g + 8 * i;
    ok_key[i] = key[i] < Skv;
    kp[i] = ok_key[i] ? kpos[(size_t)bh * Skv + key[i]] : 0;
    ks[i] = ok_key[i] ? kseg[(size_t)bh * Skv + key[i]] : 0;
  }
  int mine = INT_MAX;
  if (threadIdx.x < kRows && k0 + threadIdx.x < Skv)
    mine = kpos[(size_t)bh * Skv + k0 + threadIdx.x];
  const int kmin = block_reduce(mine, false, sRed);

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += kQDkv) {
    int qp = INT_MIN;
    if (threadIdx.x < kQDkv) {
      const int r = q0 + threadIdx.x;
      int qs = -1;
      float lv = 0.f, dl = 0.f;
      if (r < Sq) {
        const size_t idx = (size_t)bh * Sq + r;
        qp = qpos[idx];
        qs = qseg[idx];
        lv = lse[idx];
        dl = delta[idx];
      }
      sQpos[threadIdx.x] = qp;
      sQseg[threadIdx.x] = qs;
      sLse[threadIdx.x] = lv;
      sDelta[threadIdx.x] = dl;
    }
    const int qmax = block_reduce(qp, true, sRed);
    if (causal && kmin > qmax) continue;
    load_rows<T, D, kQDkv>(sQ, LD, q + qoff, q0, Sq);
    load_rows<T, D, kQDkv>(sO, LD, dout + qoff, q0, Sq);
    __syncthreads();

    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    warp_gemm<T, NQ, D, false>(s, sK + warp * 16 * LD, LD, sQ, LD, g, t);
    warp_gemm<T, NQ, D, false>(dp, sV + warp * 16 * LD, LD, sO, LD, g, t);

    T* pw = sP + warp * 16 * LDP;
    T* dsw = sS + warp * 16 * LDP;
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = n * 8 + 2 * t + (e & 1);
        const bool ok = ok_key[i] && sQseg[c] == ks[i] && ks[i] != 0
                        && (!causal || sQpos[c] >= kp[i]);
        const float p = ok ? expf(s[n][e] * scale - sLse[c]) : 0.f;
        const float ds = p * (dp[n][e] - sDelta[c]) * scale;
        pw[(g + 8 * i) * LDP + c] = from_f<T>(p);
        dsw[(g + 8 * i) * LDP + c] = from_f<T>(ds);
      }
    }
    __syncwarp();
    warp_gemm<T, ND, kQDkv, true>(dva, pw, LDP, sO, LD, g, t);
    warp_gemm<T, ND, kQDkv, true>(dka, dsw, LDP, sQ, LD, g, t);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!ok_key[i]) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const size_t off = koff + (size_t)key[i] * D + n * 8 + 2 * t;
      dk[off] = from_f<T>(dka[n][2 * i]);
      dk[off + 1] = from_f<T>(dka[n][2 * i + 1]);
      dv[off] = from_f<T>(dva[n][2 * i]);
      dv[off + 1] = from_f<T>(dva[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 backward pair. A block of 4 warps keeps 64 resident rows (q rows
// for dq, keys for dk/dv), 16 a warp, and walks the 64-row tiles of the
// other operand through a two-stage cp.async ring: the next live tile's
// copies are issued right after the one block barrier of a tile and land
// while its products run. Every operand reaches the tensor cores by
// ldmatrix; s/dp stay in registers and become p/ds A fragments without a
// trip through shared memory. Each tile was classified once, before the
// walk (skip / all-live / mixed); only mixed tiles read the mask.
// ---------------------------------------------------------------------------

constexpr int kTile = 64;

// shared memory: 2 resident tiles, 2 stages of 2 tiles and `ints` 4-byte
// values of 64, one class byte per streamed tile
template <int D>
size_t bwd_bf16_smem(int ints, int streamed_rows) {
  const int nt = (streamed_rows + kTile - 1) / kTile;
  return (size_t)6 * kTile * (D + 8) * sizeof(bf16)
         + (size_t)2 * ints * kTile * 4 + (size_t)(nt + 15) / 16 * 16;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ qseg,
    const int* __restrict__ kseg, const int* __restrict__ qpos,
    const int* __restrict__ kpos, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int Sq, int Skv, int causal, float scale) {
  constexpr int LD = D + 8, NK = kTile / 8, ND = D / 8, T = kTile * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + T;                  // dO
  bf16* sKV = sO + T;                 // stage s: K at 2 s T, V at (2 s + 1) T
  int* sKi = reinterpret_cast<int*>(sKV + 4 * T);   // stage s: kpos, kseg
  unsigned char* sCls = reinterpret_cast<unsigned char*>(sKi + 4 * kTile);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;   // heavy tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Skv * D;
  const int *qp_h = qpos + (size_t)bh * Sq, *qs_h = qseg + (size_t)bh * Sq;
  const int *kp_h = kpos + (size_t)bh * Skv, *ks_h = kseg + (size_t)bh * Skv;

  copy_rows<D, kTile>(sQ, q + qoff, q0, Sq);
  copy_rows<D, kTile>(sO, dout + qoff, q0, Sq);
  cp_async_commit();
  auto issue = [&](int j, int st) {
    bf16* dst = sKV + 2 * st * T;
    copy_rows<D, kTile>(dst, k + koff, j * kTile, Skv);
    copy_rows<D, kTile>(dst + T, v + koff, j * kTile, Skv);
    int* di = sKi + 2 * st * kTile;
    copy_vals(di, kp_h, j * kTile, Skv, 0, kTile);
    copy_vals(di + kTile, ks_h, j * kTile, Skv, kTile, kTile);
  };

  int row[2], qp[2], qs[2];
  bool ok_row[2];
  float l2[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + warp * 16 + g + 8 * i;
    ok_row[i] = row[i] < Sq;
    const size_t r = (size_t)bh * Sq + row[i];
    qp[i] = ok_row[i] ? qpos[r] : 0;
    qs[i] = ok_row[i] ? qseg[r] : -1;
    l2[i] = ok_row[i] ? lse_log2(lse[r]) : 0.f;
    dr[i] = ok_row[i] ? delta[r] : 0.f;
  }
  const Span mine = warp_span(qp_h, qs_h, q0, kTile, Sq, lane);
  const int nt = (Skv + kTile - 1) / kTile;
  classify_tiles(sCls, kp_h, ks_h, Skv, kTile, mine, true, q0 + kTile <= Sq,
                 causal, warp, lane);
  __syncthreads();                    // the classes
  int j = next_live(sCls, 0, nt);
  if (j < nt) issue(j, 0);
  cp_async_commit();

  const float sl2 = scale * kLog2e;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; j < nt; ++it) {
    cp_async_wait_all();
    // tile j is visible, and every warp is done with the other stage
    __syncthreads();
    const int jn = next_live(sCls, j + 1, nt);
    if (jn < nt) issue(jn, (it + 1) & 1);
    cp_async_commit();
    const bf16* sK = sKV + 2 * (it & 1) * T;
    const bf16* sV = sK + T;
    const int* sKp = sKi + 2 * (it & 1) * kTile;
    const int* sKs = sKp + kTile;

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t aq[4], ao[4];
      ldsm_a(aq, sQ + warp * 16 * LD + kc * 16, LD, lane);
      ldsm_a(ao, sO + warp * 16 * LD + kc * 16, LD, lane);
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t b[4];
        ldsm_b_nk(b, sK + np * 16 * LD + kc * 16, LD, lane);
        mma_bf16(s[2 * np], aq, b[0], b[1]);
        mma_bf16(s[2 * np + 1], aq, b[2], b[3]);
        ldsm_b_nk(b, sV + np * 16 * LD + kc * 16, LD, lane);
        mma_bf16(dp[2 * np], ao, b[0], b[1]);
        mma_bf16(dp[2 * np + 1], ao, b[2], b[3]);
      }
    }
    const bool mixed = sCls[j] == kMixed;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = n * 8 + 2 * t + (e & 1);
        float p = exp2f(fmaf(s[n][e], sl2, -l2[i]));
        if (mixed) {
          const int ks = sKs[c];
          const bool ok = qs[i] == ks && ks != 0
                          && (!causal || qp[i] >= sKp[c]);
          p = ok ? p : 0.f;
        }
        s[n][e] = p * (dp[n][e] - dr[i]) * scale;        // ds
      }
    }
    uint32_t ads[NK / 2][4];
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) acc_to_a(ads[kk], s[2 * kk], s[2 * kk + 1]);
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t b[4];
        ldsm_b_kn(b, sK + kk * 16 * LD + np * 16, LD, lane);
        mma_bf16(acc[2 * np], ads[kk], b[0], b[1]);
        mma_bf16(acc[2 * np + 1], ads[kk], b[2], b[3]);
      }
    }
    j = jn;
  }
  cp_async_wait_all();                // nothing in flight at exit

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!ok_row[i]) continue;
    bf16* dst = dq + qoff + (size_t)row[i] * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dkv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ qseg,
    const int* __restrict__ kseg, const int* __restrict__ qpos,
    const int* __restrict__ kpos, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv,
    int causal, float scale) {
  constexpr int LD = D + 8, NQ = kTile / 8, ND = D / 8, T = kTile * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + T;
  bf16* sQO = sV + T;                 // stage s: Q at 2 s T, dO at (2 s + 1) T
  int* sQi = reinterpret_cast<int*>(sQO + 4 * T);   // stage s: qpos, qseg, lse, delta
  unsigned char* sCls = reinterpret_cast<unsigned char*>(sQi + 8 * kTile);

  const int bh = blockIdx.x, k0 = blockIdx.y * kTile;   // early keys: most work
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Skv * D;
  const int *qp_h = qpos + (size_t)bh * Sq, *qs_h = qseg + (size_t)bh * Sq;
  const int *kp_h = kpos + (size_t)bh * Skv, *ks_h = kseg + (size_t)bh * Skv;
  const float *l_h = lse + (size_t)bh * Sq, *d_h = delta + (size_t)bh * Sq;

  copy_rows<D, kTile>(sK, k + koff, k0, Skv);
  copy_rows<D, kTile>(sV, v + koff, k0, Skv);
  cp_async_commit();
  auto issue = [&](int j, int st) {
    bf16* dst = sQO + 2 * st * T;
    copy_rows<D, kTile>(dst, q + qoff, j * kTile, Sq);
    copy_rows<D, kTile>(dst + T, dout + qoff, j * kTile, Sq);
    int* di = sQi + 4 * st * kTile;
    copy_vals(di, qp_h, j * kTile, Sq, 0, kTile);
    copy_vals(di + kTile, qs_h, j * kTile, Sq, kTile, kTile);
    float* df = reinterpret_cast<float*>(di + 2 * kTile);
    copy_vals(df, l_h, j * kTile, Sq, 0, kTile);
    copy_vals(df + kTile, d_h, j * kTile, Sq, kTile, kTile);
  };

  int key[2], kp[2], ks[2];
  bool ok_key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + warp * 16 + g + 8 * i;
    ok_key[i] = key[i] < Skv;
    kp[i] = ok_key[i] ? kp_h[key[i]] : 0;
    ks[i] = ok_key[i] ? ks_h[key[i]] : 0;       // 0: never live
  }
  const Span mine = warp_span(kp_h, ks_h, k0, kTile, Skv, lane);
  const int nt = (Sq + kTile - 1) / kTile;
  classify_tiles(sCls, qp_h, qs_h, Sq, kTile, mine, false, k0 + kTile <= Skv,
                 causal, warp, lane);
  __syncthreads();                    // the classes
  int j = next_live(sCls, 0, nt);
  if (j < nt) issue(j, 0);
  cp_async_commit();

  const float sl2 = scale * kLog2e;
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = 0; j < nt; ++it) {
    cp_async_wait_all();
    __syncthreads();                  // as in the dq kernel
    const int jn = next_live(sCls, j + 1, nt);
    if (jn < nt) issue(jn, (it + 1) & 1);
    cp_async_commit();
    const bf16* sQ = sQO + 2 * (it & 1) * T;
    const bf16* sO = sQ + T;
    const int* sQp = sQi + 4 * (it & 1) * kTile;
    const int* sQs = sQp + kTile;
    const float* sL = reinterpret_cast<const float*>(sQs + kTile);
    const float* sDl = sL + kTile;

    // s^T = K Q^T and dp^T = V dO^T (keys as rows)
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t ak[4], av[4];
      ldsm_a(ak, sK + warp * 16 * LD + kc * 16, LD, lane);
      ldsm_a(av, sV + warp * 16 * LD + kc * 16, LD, lane);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t b[4];
        ldsm_b_nk(b, sQ + np * 16 * LD + kc * 16, LD, lane);
        mma_bf16(s[2 * np], ak, b[0], b[1]);
        mma_bf16(s[2 * np + 1], ak, b[2], b[3]);
        ldsm_b_nk(b, sO + np * 16 * LD + kc * 16, LD, lane);
        mma_bf16(dp[2 * np], av, b[0], b[1]);
        mma_bf16(dp[2 * np + 1], av, b[2], b[3]);
      }
    }
    const bool mixed = sCls[j] == kMixed;
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = n * 8 + 2 * t + (e & 1);
        float p = exp2f(fmaf(s[n][e], sl2, -lse_log2(sL[c])));
        if (mixed) {
          const bool ok = sQs[c] == ks[i] && ks[i] != 0
                          && (!causal || sQp[c] >= kp[i]);
          p = ok ? p : 0.f;
        }
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - sDl[c]) * scale;      // ds^T
      }
    }
    uint32_t ap[NQ / 2][4], ads[NQ / 2][4];
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) {
      acc_to_a(ap[kk], s[2 * kk], s[2 * kk + 1]);
      acc_to_a(ads[kk], dp[2 * kk], dp[2 * kk + 1]);
    }
    // dv += p^T dO, dk += ds^T Q
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) {
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t b[4];
        ldsm_b_kn(b, sO + kk * 16 * LD + np * 16, LD, lane);
        mma_bf16(dva[2 * np], ap[kk], b[0], b[1]);
        mma_bf16(dva[2 * np + 1], ap[kk], b[2], b[3]);
        ldsm_b_kn(b, sQ + kk * 16 * LD + np * 16, LD, lane);
        mma_bf16(dka[2 * np], ads[kk], b[0], b[1]);
        mma_bf16(dka[2 * np + 1], ads[kk], b[2], b[3]);
      }
    }
    j = jn;
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!ok_key[i]) continue;
    const size_t off = koff + (size_t)key[i] * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
          __floats2bfloat162_rn(dka[n][2 * i], dka[n][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
          __floats2bfloat162_rn(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 forward. A block of 4 warps owns 128 q rows, 32 a warp (two
// m16 tiles, so each K and V fragment feeds two mma). The Q tile is copied
// once by cp.async; each warp reads its A fragments from it by ldmatrix at
// every k-step of q.k^T. K, V and the keys' positions and segments stream
// through the backward's two-stage ring, one block barrier a tile, the
// tiles classified before the walk. A 64-key tile is taken in two steps of
// 32 keys (s then needs 32 accumulator registers, not 64, and nothing
// spills): s stays in the mma accumulators, the online softmax runs on the
// row quads, and p, rounded once, is the A fragment of p.v.
// ---------------------------------------------------------------------------

constexpr int kFwdRows = 128;         // q rows a block
constexpr int kFwdStep = 32;          // keys a softmax step

// 2^x by the SFU (ex2.approx.ftz: 2 ulp; p is rounded to bf16 anyway)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// shared memory: the Q tile, 2 stages of K and V tiles and of kpos/kseg,
// the block's q positions and segments, one class byte per kv tile
template <int D>
size_t fwd_bf16_smem(int Skv) {
  const int nt = (Skv + kTile - 1) / kTile;
  return (size_t)(kFwdRows + 4 * kTile) * (D + 8) * sizeof(bf16)
         + (size_t)(4 * kTile + 2 * kFwdRows) * 4
         + (size_t)(nt + 15) / 16 * 16;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ qseg,
    const int* __restrict__ kseg, const int* __restrict__ qpos,
    const int* __restrict__ kpos, bf16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Skv, int causal, float scale) {
  constexpr int LD = D + 8, ND = D / 8, KS = D / 16, NS = kFwdStep;
  constexpr int T = kTile * LD, BR = kFwdRows, MT = BR / 64, WR = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = sQ + BR * LD;           // stage s: K at 2 s T, V at (2 s + 1) T
  int* sKi = reinterpret_cast<int*>(sKV + 4 * T);   // stage s: kpos, kseg
  int* sQr = sKi + 4 * kTile;                       // qpos, qseg of the rows
  unsigned char* sCls = reinterpret_cast<unsigned char*>(sQr + 2 * BR);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;      // heavy tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Skv * D;
  const int *qp_h = qpos + (size_t)bh * Sq, *qs_h = qseg + (size_t)bh * Sq;
  const int *kp_h = kpos + (size_t)bh * Skv, *ks_h = kseg + (size_t)bh * Skv;

  // the Q tile, and the rows' positions and segments, read by mixed tiles
  // only (rows past Sq get segment 0: never live)
  copy_rows<D, BR>(sQ, q + qoff, q0, Sq);
  copy_vals(sQr, qp_h, q0, Sq, 0, BR);
  copy_vals(sQr + BR, qs_h, q0, Sq, 0, BR);
  cp_async_commit();
  auto issue = [&](int j, int st) {
    bf16* dst = sKV + 2 * st * T;
    copy_rows<D, kTile>(dst, k + koff, j * kTile, Skv);
    copy_rows<D, kTile>(dst + T, v + koff, j * kTile, Skv);
    int* di = sKi + 2 * st * kTile;
    copy_vals(di, kp_h, j * kTile, Skv, 0, kTile);
    copy_vals(di + kTile, ks_h, j * kTile, Skv, kTile, kTile);
  };

  const Span mine = warp_span(qp_h, qs_h, q0, BR, Sq, lane);
  const int nt = (Skv + kTile - 1) / kTile;
  classify_tiles(sCls, kp_h, ks_h, Skv, kTile, mine, true, q0 + BR <= Sq,
                 causal, warp, lane);
  cp_async_wait_all();
  __syncthreads();                    // the classes, the Q tile, the rows
  int j = next_live(sCls, 0, nt);
  if (j < nt) issue(j, 0);
  cp_async_commit();

  const bf16* sQw = sQ + warp * WR * LD;
  const float sl2 = scale * kLog2e;
  float m[MT][2], l[MT][2], o[MT][ND][4];   // m raw; l per lane
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mt][i] = kNegInf;
      l[mt][i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
  }

  for (int it = 0; j < nt; ++it) {
    cp_async_wait_all();
    // tile j is visible, and every warp is done with the other stage
    __syncthreads();
    const int jn = next_live(sCls, j + 1, nt);
    if (jn < nt) issue(jn, (it + 1) & 1);
    cp_async_commit();
    const bf16* sK = sKV + 2 * (it & 1) * T;
    const bf16* sV = sK + T;
    const int* sKp = sKi + 2 * (it & 1) * kTile;
    const int* sKs = sKp + kTile;
    const bool mixed = sCls[j] == kMixed;

#pragma unroll
    for (int h = 0; h < kTile / NS; ++h) {
      const bf16* sKh = sK + h * NS * LD;
      const bf16* sVh = sV + h * NS * LD;
      // s = Q K^T over this step's keys
      float s[MT][NS / 8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NS / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KS; ++kc) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_a(a[mt], sQw + mt * 16 * LD + kc * 16, LD, lane);
#pragma unroll
        for (int np = 0; np < NS / 16; ++np) {
          uint32_t b[4];
          ldsm_b_nk(b, sKh + np * 16 * LD + kc * 16, LD, lane);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * np], a[mt], b[0], b[1]);
            mma_bf16(s[mt][2 * np + 1], a[mt], b[2], b[3]);
          }
        }
      }

      // online softmax: m is the raw max (max commutes with the positive
      // scale), p = 2^(s sl2 - m sl2) by one fma; a masked score is
      // NEG_INF, and NEG_INF * sl2 is at most -inf, whose exp2 is 0; p = 0
      // while a row's max is NEG_INF
      uint32_t ap[MT][NS / 16][4];    // p rounded to bf16: A fragments
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mixed) {
#pragma unroll
          for (int n = 0; n < NS / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = warp * WR + mt * 16 + g + 8 * (e >> 1);
              const int c = h * NS + n * 8 + 2 * t + (e & 1), ks = sKs[c];
              const bool ok = sQr[BR + r] == ks && ks != 0
                              && (!causal || sQr[r] >= sKp[c]);
              s[mt][n][e] = ok ? s[mt][n][e] : kNegInf;
            }
          }
        }
        float mcur[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int n = 0; n < NS / 8; ++n) {
          mcur[0] = fmaxf(mcur[0], fmaxf(s[mt][n][0], s[mt][n][1]));
          mcur[1] = fmaxf(mcur[1], fmaxf(s[mt][n][2], s[mt][n][3]));
        }
        float alpha[2], sub[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float mnew = fmaxf(m[mt][i], quad_max(mcur[i]));
          const bool live = mnew > kNegInf * 0.5f;
          alpha[i] = fast_exp2(live ? (m[mt][i] - mnew) * sl2 : 0.f);
          sub[i] = live ? mnew * sl2 : 0.f;
          m[mt][i] = mnew;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NS / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = fast_exp2(fmaf(s[mt][n][e], sl2, -sub[e >> 1]));
            rs[e >> 1] += p;
            s[mt][n][e] = p;
          }
        }
#pragma unroll
        for (int kk = 0; kk < NS / 16; ++kk)
          acc_to_a(ap[mt][kk], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) l[mt][i] = alpha[i] * l[mt][i] + rs[i];
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          o[mt][n][0] *= alpha[0];
          o[mt][n][1] *= alpha[0];
          o[mt][n][2] *= alpha[1];
          o[mt][n][3] *= alpha[1];
        }
      }

      // o += p V over this step's keys
#pragma unroll
      for (int kk = 0; kk < NS / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          uint32_t b[4];
          ldsm_b_kn(b, sVh + kk * 16 * LD + np * 16, LD, lane);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][2 * np], ap[mt][kk], b[0], b[1]);
            mma_bf16(o[mt][2 * np + 1], ap[mt][kk], b[2], b[3]);
          }
        }
      }
    }
    j = jn;
  }
  cp_async_wait_all();                // nothing in flight at exit

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float lt = quad_sum(l[mt][i]);    // every lane: a warp shuffle
      const int r = q0 + warp * WR + mt * 16 + g + 8 * i;
      if (r >= Sq) continue;
      const float inv = lt > 0.f ? 1.f / lt : 1.f;
      bf16* dst = out + qoff + (size_t)r * D + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
            __floats2bfloat162_rn(o[mt][n][2 * i] * inv,
                                  o[mt][n][2 * i + 1] * inv);
      if (t == 0)
        lse[(size_t)bh * Sq + r] =
            lt > 0.f ? m[mt][i] * scale + logf(lt) : kNegInf;
    }
  }
}

template <typename T, int D>
size_t fwd_smem() {
  return (size_t)(kRows + 2 * kKeys) * (D + 8) * sizeof(T)
         + (size_t)kRows * (kKeys + 8) * sizeof(T) + (2 * kKeys + 4) * 4;
}
template <typename T, int D>
size_t dq_smem() {
  return (size_t)(2 * kRows + 2 * kKeys) * (D + 8) * sizeof(T)
         + (size_t)kRows * (kKeys + 8) * sizeof(T) + (2 * kKeys + 4) * 4;
}
template <typename T, int D>
size_t dkv_smem() {
  return (size_t)(2 * kRows + 2 * kQDkv) * (D + 8) * sizeof(T)
         + (size_t)2 * kRows * (kQDkv + 8) * sizeof(T) + (4 * kQDkv + 4) * 4;
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const int* qseg,
               const int* kseg, const int* qpos, const int* kpos, void* out,
               float* lse, int BH, int Sq, int Skv, int causal, float scale,
               cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    const size_t smem = fwd_bf16_smem<D>(Skv);
    auto kern = flash_fwd_bf16_kernel<D>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    dim3 grid(BH, (Sq + kFwdRows - 1) / kFwdRows);
    kern<<<grid, kThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, qseg, kseg, qpos,
        kpos, (bf16*)out, lse, Sq, Skv, causal, scale);
    return (int)cudaGetLastError();
  } else {                            // fp32: the first design
    const size_t smem = fwd_smem<T, D>();
    auto kern = flash_fwd_kernel<T, D>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    dim3 grid(BH, (Sq + kRows - 1) / kRows);
    kern<<<grid, kThreads, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, qseg, kseg, qpos, kpos,
        (T*)out, lse, Sq, Skv, causal, scale);
    return (int)cudaGetLastError();
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const int* qseg,
              const int* kseg, const int* qpos, const int* kpos,
              const void* dout, const float* lse, const float* delta, void* dq,
              int BH, int Sq, int Skv, int causal, float scale,
              cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    const size_t smem = bwd_bf16_smem<D>(2, Skv);
    auto kern = flash_bwd_dq_bf16_kernel<D>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    dim3 grid(BH, (Sq + kTile - 1) / kTile);
    kern<<<grid, kThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, qseg, kseg, qpos,
        kpos, (const bf16*)dout, lse, delta, (bf16*)dq, Sq, Skv, causal,
        scale);
    return (int)cudaGetLastError();
  } else {                            // fp32: the first design
    const size_t smem = dq_smem<T, D>();
    auto kern = flash_bwd_dq_kernel<T, D>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    dim3 grid(BH, (Sq + kRows - 1) / kRows);
    kern<<<grid, kThreads, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, qseg, kseg, qpos, kpos,
        (const T*)dout, lse, delta, (T*)dq, Sq, Skv, causal, scale);
    return (int)cudaGetLastError();
  }
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const int* qseg,
               const int* kseg, const int* qpos, const int* kpos,
               const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int BH, int Sq, int Skv, int causal,
               float scale, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    const size_t smem = bwd_bf16_smem<D>(4, Sq);
    auto kern = flash_bwd_dkv_bf16_kernel<D>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    dim3 grid(BH, (Skv + kTile - 1) / kTile);
    kern<<<grid, kThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, qseg, kseg, qpos,
        kpos, (const bf16*)dout, lse, delta, (bf16*)dk, (bf16*)dv, Sq, Skv,
        causal, scale);
    return (int)cudaGetLastError();
  } else {                            // fp32: the first design
    const size_t smem = dkv_smem<T, D>();
    auto kern = flash_bwd_dkv_kernel<T, D>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    dim3 grid(BH, (Skv + kRows - 1) / kRows);
    kern<<<grid, kThreads, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, qseg, kseg, qpos, kpos,
        (const T*)dout, lse, delta, (T*)dk, (T*)dv, Sq, Skv, causal, scale);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Head dims 64 and 128. Returns the CUDA error
// code of the launch (0 = launched); cudaErrorInvalidValue for a head dim
// or dtype the kernels do not take.
#define FLASH_DISPATCH(FN, ...)                                             \
  do {                                                                      \
    if (dtype == 1) {                                                       \
      if (D == 64) return FN<bf16, 64>(__VA_ARGS__);                        \
      if (D == 128) return FN<bf16, 128>(__VA_ARGS__);                      \
    } else if (dtype == 0) {                                                \
      if (D == 64) return FN<float, 64>(__VA_ARGS__);                       \
      if (D == 128) return FN<float, 128>(__VA_ARGS__);                     \
    }                                                                       \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const int* qseg, const int* kseg, const int* qpos,
                         const int* kpos, void* out, float* lse, int BH,
                         int Sq, int Skv, int D, int causal, float scale,
                         int dtype, void* stream) {
  FLASH_DISPATCH(launch_fwd, q, k, v, qseg, kseg, qpos, kpos, out, lse, BH,
                 Sq, Skv, causal, scale, (cudaStream_t)stream);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const int* qseg, const int* kseg, const int* qpos,
                            const int* kpos, const void* dout,
                            const float* lse, const float* delta, void* dq,
                            int BH, int Sq, int Skv, int D, int causal,
                            float scale, int dtype, void* stream) {
  FLASH_DISPATCH(launch_dq, q, k, v, qseg, kseg, qpos, kpos, dout, lse, delta,
                 dq, BH, Sq, Skv, causal, scale, (cudaStream_t)stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const int* qseg, const int* kseg,
                             const int* qpos, const int* kpos,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int BH,
                             int Sq, int Skv, int D, int causal, float scale,
                             int dtype, void* stream) {
  FLASH_DISPATCH(launch_dkv, q, k, v, qseg, kseg, qpos, kpos, dout, lse,
                 delta, dk, dv, BH, Sq, Skv, causal, scale,
                 (cudaStream_t)stream);
}
