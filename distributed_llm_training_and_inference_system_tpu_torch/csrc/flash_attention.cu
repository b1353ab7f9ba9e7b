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
// FLOP/byte ridge). The design keeps the S x S matrix out of device memory
// (one 64 x 64 tile of scores per block at a time, in registers) and runs
// the bf16 products on the tensor cores with mma.sync m16n8k16 and fp32
// accumulation; fp32 inputs take the same fragment layout computed with
// scalar fp32 FMAs (a verification path, not a fast one). Each warp owns
// 16 rows of the 64-row tile, so the online-softmax statistics of a row
// live in the 4 lanes that hold it. No wgmma/TMA yet: that is the next
// step for speed.
//
// Tiles are stored in shared memory with padded rows. A block skips a
// tile pair only when causal and the true minimum kv position of the tile
// exceeds the true maximum q position of the block (positions may restart
// inside a packed row, so first/last elements are no bound). The dkv grid
// is the transpose: each block owns 64 keys, walks the q tiles and keeps
// dk/dv in registers, so no two blocks write the same output.
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

namespace {

constexpr float kNegInf = (float)(-0.7 * 3.4028234663852886e38);
constexpr int kThreads = 128;     // 4 warps
constexpr int kRows = 64;         // q rows (fwd, dq) or keys (dkv) per block
constexpr int kKeys = 64;         // keys per kv tile (fwd, dq)
constexpr int kQDkv = 32;         // q rows per q tile in the dkv kernel

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Warp-level C[16x8] += A[16x16] * B[16x8] in the mma.sync m16n8k16
// fragment layout: lane = 4*g + t holds C rows g and g+8, columns 2t and
// 2t+1 (c0: (g,2t) c1: (g,2t+1) c2: (g+8,2t) c3: (g+8,2t+1)). A is
// row-major in shared memory (lda elements per row). B is given either as
// B[n][k] (KN = false, rows of a row-major [n, k] tile) or as B[k][n]
// (KN = true).
template <typename T> struct Mma;

template <> struct Mma<bf16> {
  struct A { uint32_t a[4]; };
  __device__ __forceinline__ static void load_a(A& f, const bf16* p, int lda,
                                                int g, int t) {
    f.a[0] = *reinterpret_cast<const uint32_t*>(p + g * lda + 2 * t);
    f.a[1] = *reinterpret_cast<const uint32_t*>(p + (g + 8) * lda + 2 * t);
    f.a[2] = *reinterpret_cast<const uint32_t*>(p + g * lda + 8 + 2 * t);
    f.a[3] = *reinterpret_cast<const uint32_t*>(p + (g + 8) * lda + 8 + 2 * t);
  }
  __device__ __forceinline__ static uint32_t pack(bf16 lo, bf16 hi) {
    return (uint32_t)__bfloat16_as_ushort(lo)
           | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
  }
  template <bool KN>
  __device__ __forceinline__ static void mma(float c[4], const A& f,
                                             const bf16* b, int ldb, int g,
                                             int t) {
    uint32_t b0, b1;
    if (KN) {
      b0 = pack(b[(2 * t) * ldb + g], b[(2 * t + 1) * ldb + g]);
      b1 = pack(b[(2 * t + 8) * ldb + g], b[(2 * t + 9) * ldb + g]);
    } else {
      b0 = *reinterpret_cast<const uint32_t*>(b + g * ldb + 2 * t);
      b1 = *reinterpret_cast<const uint32_t*>(b + g * ldb + 8 + 2 * t);
    }
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(f.a[0]), "r"(f.a[1]), "r"(f.a[2]), "r"(f.a[3]), "r"(b0),
          "r"(b1));
  }
};

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
  const size_t smem = fwd_smem<T, D>();
  auto kern = flash_fwd_kernel<T, D>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(BH, (Sq + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, qseg, kseg, qpos, kpos, (T*)out,
      lse, Sq, Skv, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const int* qseg,
              const int* kseg, const int* qpos, const int* kpos,
              const void* dout, const float* lse, const float* delta, void* dq,
              int BH, int Sq, int Skv, int causal, float scale,
              cudaStream_t st) {
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

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const int* qseg,
               const int* kseg, const int* qpos, const int* kpos,
               const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int BH, int Sq, int Skv, int causal,
               float scale, cudaStream_t st) {
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
