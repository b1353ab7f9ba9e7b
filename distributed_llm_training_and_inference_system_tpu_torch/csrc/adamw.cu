// Fused AdamW update of many parameter leaves in one launch, in place,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel _adamw_kernel of the JAX package's
// exec/fused_update.py: one pass reads (p, g, mu, nu) and writes
// (p', mu', nu'), with the global-norm clip folded in. The four scalars
// (lr, 1 - b1^t, 1 - b2^t, clip scale) are read from a device fp32[4], so
// nothing waits for the host.
//
// What bounds it on an H100: bytes. Per element it reads 16 B and writes
// 12 B at fp32 p/g/mu/nu (28 B over 3.35 TB/s) for ~20 flops, far below
// the ridge. The design:
//
// - One launch for every leaf of one (mu dtype, nu dtype) pair, up to
//   kCapacity leaves. The leaf table (four pointers, n, wd and a vector
//   flag per leaf, and the prefix of each leaf's tiles) travels by value
//   in the kernel's parameters (__grid_constant__): no host-to-device copy
//   and nothing on the host waits.
// - A persistent grid walks the tiles of the concatenated leaves (kTile
//   elements each; a leaf's last tile may be short), tile t by block
//   t mod grid. A block finds a tile's leaf by a binary search of the
//   prefix table.
// - All four streams move as vectors of 4 elements: float4 (16 B) for
//   fp32, 4 x bf16 (8 B) for a bf16 moment. A thread loads its kVecs
//   vectors of all four streams before any arithmetic, so 4 x kVecs loads
//   are in flight across the divisions and square roots. Each byte is
//   touched once: loads and stores carry streaming (evict-first) hints.
// - A leaf's tail past its last whole vector, and every element of a leaf
//   whose pointers are not aligned for the vectors, take scalar accesses
//   in the same launch.
//
// Every operation is rounded on its own, in the order of the plain
// PyTorch version (exec/fused_update._leaf_math, optax's order): the
// __f*_rn intrinsics keep nvcc from contracting a*b + c into an FMA, so
// the kernel is bitwise equal to eager PyTorch on the card, and a
// division stays a division. b1 * mu is rounded to mu's dtype before the
// add, as PyTorch and optax do for a bf16 mu; the caller passes b1 already
// rounded to mu's dtype (optax multiplies by a weak-typed scalar).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kVecs = 4;                          // vectors a thread a tile
constexpr int kTile = kThreads * kVecs * 4;       // elements a tile
constexpr int kCapacity = 256;                    // leaves a launch

struct Leaf {                 // 48 bytes; the wrapper packs the same layout
  float* p;
  const float* g;
  void* mu;
  void* nu;
  long long n;
  float wd;
  int vec;                    // 1: every pointer aligned for the vectors
};

struct Table {
  Leaf leaf[kCapacity];
  int tile_start[kCapacity + 1];     // leaf i owns tiles [start[i], start[i+1])
  int leaves;
};
static_assert(sizeof(Leaf) == 48, "Leaf layout");
static_assert(sizeof(Table) == 48 * kCapacity + 4 * (kCapacity + 2),
              "Table layout");

struct Hyper {
  float b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// one element: p, mu, nu in and out (mu, nu as fp32 values of their dtype)
template <typename TM>
__device__ __forceinline__ void update_one(float& p, float g, float& mu,
                                           float& nu, float lr, float om1,
                                           float om2, float clip, float wd,
                                           const Hyper& h) {
  const float g32 = __fmul_rn(g, clip);
  // b1 * mu in mu's own dtype
  const float b1mu = to_f(from_f<TM>(__fmul_rn(h.b1, mu)));
  const float mu32 = __fadd_rn(__fmul_rn(h.omb1, g32), b1mu);
  const float nu32 = __fadd_rn(__fmul_rn(h.omb2, __fmul_rn(g32, g32)),
                               __fmul_rn(h.b2, nu));
  const float mu_hat = __fdiv_rn(mu32, om1);
  const float nu_hat = __fdiv_rn(nu32, om2);
  float upd = __fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(nu_hat), h.eps));
  if (wd != 0.f) upd = __fadd_rn(upd, __fmul_rn(wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, upd));
  mu = mu32;
  nu = nu32;
}

// a vector of 4 moment values in the moment's dtype
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  typedef float4 raw;
  static __device__ __forceinline__ raw load(const void* base, long long v) {
    return __ldcs(reinterpret_cast<const float4*>(base) + v);
  }
  static __device__ __forceinline__ void store(void* base, long long v,
                                               const float* f) {
    __stcs(reinterpret_cast<float4*>(base) + v,
           make_float4(f[0], f[1], f[2], f[3]));
  }
  static __device__ __forceinline__ void widen(const raw& r, float* f) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
};
template <> struct Vec4<bf16> {
  typedef uint2 raw;
  static __device__ __forceinline__ raw load(const void* base, long long v) {
    return __ldcs(reinterpret_cast<const uint2*>(base) + v);
  }
  static __device__ __forceinline__ void store(void* base, long long v,
                                               const float* f) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
    __stcs(reinterpret_cast<uint2*>(base) + v,
           make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                      *reinterpret_cast<const uint32_t*>(&b)));
  }
  static __device__ __forceinline__ void widen(const raw& r, float* f) {
    f[0] = __uint_as_float(r.x << 16);
    f[1] = __uint_as_float(r.x & 0xffff0000u);
    f[2] = __uint_as_float(r.y << 16);
    f[3] = __uint_as_float(r.y & 0xffff0000u);
  }
};

template <typename T>
__device__ __forceinline__ float load1(const void* base, long long i) {
  return to_f(__ldcs(reinterpret_cast<const T*>(base) + i));
}
template <>
__device__ __forceinline__ float load1<bf16>(const void* base, long long i) {
  const unsigned short u = __ldcs(
      reinterpret_cast<const unsigned short*>(base) + i);
  return __uint_as_float((uint32_t)u << 16);
}
template <typename T>
__device__ __forceinline__ void store1(void* base, long long i, float f) {
  reinterpret_cast<T*>(base)[i] = from_f<T>(f);
}

template <typename TM, typename TN>
__device__ __forceinline__ void scalar_update(const Leaf& L, long long i,
                                              float lr, float om1, float om2,
                                              float clip, const Hyper& h) {
  float p = __ldcs(L.p + i);
  const float g = __ldcs(L.g + i);
  float mu = load1<TM>(L.mu, i), nu = load1<TN>(L.nu, i);
  update_one<TM>(p, g, mu, nu, lr, om1, om2, clip, L.wd, h);
  __stcs(L.p + i, p);
  store1<TM>(L.mu, i, mu);
  store1<TN>(L.nu, i, nu);
}

template <typename TM, typename TN>
__global__ void __launch_bounds__(kThreads, 2) adamw_kernel(
    const __grid_constant__ Table t, const Hyper h,
    const float* __restrict__ scalars) {
  const float lr = scalars[0], om1 = scalars[1], om2 = scalars[2],
              clip = scalars[3];
  const int tiles = t.tile_start[t.leaves];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int lo = 0, hi = t.leaves - 1;         // the last leaf starting <= tile
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.tile_start[mid] <= tile) lo = mid; else hi = mid - 1;
    }
    const Leaf& L = t.leaf[lo];
    const long long n = L.n;
    const long long base = (long long)(tile - t.tile_start[lo]) * kTile;
    if (!L.vec) {
      for (int j = 0; j < kTile / kThreads; ++j) {
        const long long i = base + j * kThreads + threadIdx.x;
        if (i < n) scalar_update<TM, TN>(L, i, lr, om1, om2, clip, h);
      }
      continue;
    }
    const long long n4 = n >> 2;
    const long long v0 = (base >> 2) + threadIdx.x;
    float4 pv[kVecs], gv[kVecs];
    typename Vec4<TM>::raw mv[kVecs];
    typename Vec4<TN>::raw nv[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {       // every load before any math
      const long long v = v0 + j * kThreads;
      if (v < n4) {
        pv[j] = __ldcs(reinterpret_cast<const float4*>(L.p) + v);
        gv[j] = __ldcs(reinterpret_cast<const float4*>(L.g) + v);
        mv[j] = Vec4<TM>::load(L.mu, v);
        nv[j] = Vec4<TN>::load(L.nu, v);
      }
    }
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const long long v = v0 + j * kThreads;
      if (v < n4) {
        float p[4] = {pv[j].x, pv[j].y, pv[j].z, pv[j].w};
        const float g[4] = {gv[j].x, gv[j].y, gv[j].z, gv[j].w};
        float mu[4], nu[4];
        Vec4<TM>::widen(mv[j], mu);
        Vec4<TN>::widen(nv[j], nu);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          update_one<TM>(p[e], g[e], mu[e], nu[e], lr, om1, om2, clip, L.wd,
                         h);
        __stcs(reinterpret_cast<float4*>(L.p) + v,
               make_float4(p[0], p[1], p[2], p[3]));
        Vec4<TM>::store(L.mu, v, mu);
        Vec4<TN>::store(L.nu, v, nu);
      }
    }
    if (base + kTile >= n) {                // the leaf's last tile: its tail
      const long long i = 4 * n4 + threadIdx.x;
      if (i < n) scalar_update<TM, TN>(L, i, lr, om1, om2, clip, h);
    }
  }
}

template <typename TM, typename TN>
int launch(const Table& t, Hyper h, const float* scalars, int grid,
           cudaStream_t st) {
  adamw_kernel<TM, TN><<<grid, kThreads, 0, st>>>(t, h, scalars);
  return (int)cudaGetLastError();
}

}  // namespace

// The layout the wrapper packs: capacity, table bytes, tile elements.
extern "C" int adamw_capacity() { return kCapacity; }
extern "C" int adamw_table_bytes() { return (int)sizeof(Table); }
extern "C" int adamw_tile() { return kTile; }

// One launch over the leaves of ``table`` (the bytes of a Table: p, g
// fp32; mu fp32 (mu_bf16 = 0) or bf16 (1); nu likewise; leaf i owns tiles
// [tile_start[i], tile_start[i + 1]) of kTile elements). scalars is a
// device fp32[4] = (lr, 1 - b1^t, 1 - b2^t, clip scale). b1 is rounded to
// mu's dtype; omb1/omb2 are 1 - b1 and 1 - b2 (of the unrounded b1, b2) as
// the caller rounds them. Returns the launch's CUDA error code (0 =
// launched).
extern "C" int adamw_update_multi(const void* table, const void* scalars,
                                  float b1, float omb1, float b2, float omb2,
                                  float eps, int mu_bf16, int nu_bf16,
                                  int grid, void* stream) {
  Table t;
  memcpy(&t, table, sizeof(Table));
  if (t.leaves < 1 || t.leaves > kCapacity || t.tile_start[0] != 0
      || grid < 1)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < t.leaves; ++i) {
    const Leaf& L = t.leaf[i];
    const long long tiles = (L.n + kTile - 1) / kTile;
    if (L.n < 1 || t.tile_start[i + 1] - t.tile_start[i] != tiles)
      return (int)cudaErrorInvalidValue;
  }
  const Hyper h{b1, omb1, b2, omb2, eps};
  cudaStream_t st = (cudaStream_t)stream;
  const float* s = (const float*)scalars;
  if (!mu_bf16 && !nu_bf16) return launch<float, float>(t, h, s, grid, st);
  if (mu_bf16 && !nu_bf16) return launch<bf16, float>(t, h, s, grid, st);
  if (!mu_bf16 && nu_bf16) return launch<float, bf16>(t, h, s, grid, st);
  return launch<bf16, bf16>(t, h, s, grid, st);
}
