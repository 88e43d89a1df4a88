// Fused blind + aggregate (the paper's Eq. 6 + Eq. 7) for Hopper, sm_90a.
//
// blind_agg_fwd replaces the TPU kernel repro/kernels/blind_agg.py::_fwd_kernel:
//     out = (E_a + sum_k (E_k + r_k)) * (1 / (K + 1))
// over (N, d) outputs, reducing over the K passive parties with a float32
// accumulator; the output takes E_a's dtype. The blinded [E_k] never reach
// device memory.
//
// blind_agg_bwd replaces _bwd_kernel: from the cotangent g (N, d) it writes
// dE_a = g / C and every dE_k = g / C (and, when asked, the mask cotangent
// dr_k = g / C) in one pass; each output in its own dtype.
//
// What bounds them on the card: memory. Each output element costs 2K + 1
// loads and one store in the forward and one load and 1 + K (+ K) stores in
// the backward, against K adds: far below the H100's ~20 flops per byte of
// float32 balance. Neither has a product for the tensor cores or a tile
// that is read twice, so wgmma and TMA have nothing to do here. The design
// is about memory parallelism: 16-byte loads and stores with neighbouring
// threads on neighbouring addresses, many of them in flight on every SM,
// and, where the parties are many and the outputs few, no thread walking
// all K parties in turn.
//
//   * forward, G party groups a CTA, G chosen by the caller
//     (blind_agg.py::fwd_party_groups, which says why):
//     - G = 1 (fwd_walk): one thread per 8-element output vector walks the
//       K parties in ascending k. At K = 3 nothing timed on an H100 beat
//       it (chip_smoke.py --phase agg times every G): at a 2048-token
//       serving round the split below, and the walk with all of a
//       thread's loads issued before its adds, were slower.
//     - G > 1 (fwd_split): a CTA covers V consecutive output vectors x G
//       party groups (V * G <= 128 threads, V = 128 / G). Group g sums
//       the contiguous parties [g * kc, (g + 1) * kc), kc = ceil(K / G),
//       in ascending k into a float32 partial, issuing the loads of
//       kFwdBatch parties before their adds. The partials of groups
//       1..G-1 meet in shared memory; the group-0 thread of each output
//       vector then forms
//           acc = E_a + part[0] + part[1] + ... + part[G-1]
//       in that order, scales it by 1/C and stores it. No atomics: the
//       output is the same bits on every run. With kc = 8 the order is
//       the TPU kernel's (its block_k = 8 tiles added in turn into one
//       accumulator).
//   * backward (bwd_vec): one flat grid over every 16-byte output vector
//     asked for, dE_a's first, then the K dE_k copies, then the K dr_k
//     copies, a block inside one copy; each thread reads its slices of g
//     (from L2 after their first touch) and writes kBwdVecs 16-byte
//     vectors, so no CTA stores more than another.
//   * when N*d is not a multiple of 8 or a pointer is not 16-byte aligned,
//     the same arithmetic runs one element a thread (fwd_scalar, which takes
//     only G = 1, and bwd_scalar).
// Dtypes: float32, bfloat16 and float16 in any mix of E_a, E_k and r_k.
// Every entry point returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for an argument it does not take.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;
constexpr int kThreads = 128;       // a CTA's threads (the split forward's, at most)
constexpr int kFwdMaxGroups = kThreads / kVec;      // 16: V >= 8
constexpr int kFwdBatch = 4;        // parties whose loads a thread issues at once
constexpr int kBwdVecs = 2;         // 16-byte output vectors a backward thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// 8 consecutive elements as loaded: two float4 of float32 or one uint4 of
// 16-bit values. The forward widens them to float32 only where it adds
// them, so that all of a thread's loads are issued before the first one
// is waited for (a bfloat16 load widened at once would stall the thread
// on each load in turn).
template <typename T> struct Raw8 { uint4 u; };
template <> struct Raw8<float> { float4 a, b; };

template <typename T>
__device__ __forceinline__ void load_raw(const T* p, Raw8<T>& r) {
  r.u = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void load_raw(const float* p, Raw8<float>& r) {
  r.a = reinterpret_cast<const float4*>(p)[0];
  r.b = reinterpret_cast<const float4*>(p)[1];
}

template <int W>
__device__ __forceinline__ void unpack(const __nv_bfloat162* h, float (&v)[W]) {
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x; v[2 * i + 1] = f.y;
  }
}
template <int W>
__device__ __forceinline__ void unpack(const __half2* h, float (&v)[W]) {
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const float2 f = __half22float2(h[i]);
    v[2 * i] = f.x; v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void widen(const Raw8<float>& r, float (&v)[8]) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
}
__device__ __forceinline__ void widen(const Raw8<__nv_bfloat16>& r, float (&v)[8]) {
  unpack(reinterpret_cast<const __nv_bfloat162*>(&r.u), v);
}
__device__ __forceinline__ void widen(const Raw8<__half>& r, float (&v)[8]) {
  unpack(reinterpret_cast<const __half2*>(&r.u), v);
}

// n consecutive elements -> float[n]: 8 elements (one or two 16-byte
// memory instructions) or 4 (one 16-byte float4, or 8 bytes of 16-bit
// values).
template <typename T>
__device__ __forceinline__ void loadv(const T* p, float (&v)[8]) {
  Raw8<T> r;
  load_raw(p, r);
  widen(r, v);
}
__device__ __forceinline__ void loadv(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  unpack(reinterpret_cast<const __nv_bfloat162*>(&u), v);
}
__device__ __forceinline__ void loadv(const __half* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  unpack(reinterpret_cast<const __half2*>(&u), v);
}

__device__ __forceinline__ void storev(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void storev(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void storev(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void storev(__half* p, const float (&v)[8]) {
  uint4 u;
  __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// blockDim.x = V * G; thread t is output vector t % V of the CTA's V and
// party group t / V. kc = ceil(K / G) parties a group. Dynamic shared
// memory: 2 * (G - 1) * V float4.
template <typename TA, typename TP, typename TM>
__global__ void __launch_bounds__(kThreads)
fwd_split(const TA* __restrict__ ea, const TP* __restrict__ ep,
          const TM* __restrict__ mk, TA* __restrict__ out, int64_t nd, int K,
          int G, int kc, float inv_c) {
  // partials of groups 1..G-1 as two float4 planes (elements 0-3 and 4-7)
  // of (G - 1) * V each, so that neighbouring threads touch neighbouring 16
  // bytes. Dynamic, and none at G = 1: a kernel that asks for no shared
  // memory keeps the SM's whole L1, which serves the second 16 bytes of a
  // thread's float32 vector after the first load brought in its sector.
  extern __shared__ float4 part[];
  const int V = blockDim.x / G;
  const int plane = (G - 1) * V;
  const int g = threadIdx.x / V;
  const int lv = threadIdx.x - g * V;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * V + lv;
  const bool live = v < nd / kVec;
  const int64_t off = v * kVec;
  Raw8<TA> ra;
  if (live && g == 0) load_raw(ea + off, ra);
  float p[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) p[i] = 0.f;
  const int k1 = min(K, (g + 1) * kc);
  if (live) {
    for (int k = g * kc; k < k1; k += kFwdBatch) {
      Raw8<TP> e[kFwdBatch];
      Raw8<TM> r[kFwdBatch];
#pragma unroll
      for (int u = 0; u < kFwdBatch; ++u) {
        if (k + u < k1) {
          load_raw(ep + (k + u) * nd + off, e[u]);
          load_raw(mk + (k + u) * nd + off, r[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kFwdBatch; ++u) {
        if (k + u < k1) {
          float x[kVec], y[kVec];
          widen(e[u], x);
          widen(r[u], y);
#pragma unroll
          for (int i = 0; i < kVec; ++i) p[i] += x[i] + y[i];
        }
      }
    }
  }
  if (G > 1) {                       // uniform over the CTA
    if (live && g > 0) {
      part[threadIdx.x - V] = make_float4(p[0], p[1], p[2], p[3]);
      part[plane + threadIdx.x - V] = make_float4(p[4], p[5], p[6], p[7]);
    }
    __syncthreads();
  }
  if (!live || g > 0) return;
  float a[kVec];
  widen(ra, a);
#pragma unroll
  for (int i = 0; i < kVec; ++i) a[i] += p[i];
#pragma unroll 4
  for (int h = 1; h < G; ++h) {
    const float4 x = part[(h - 1) * V + lv];
    const float4 y = part[plane + (h - 1) * V + lv];
    a[0] += x.x; a[1] += x.y; a[2] += x.z; a[3] += x.w;
    a[4] += y.x; a[5] += y.y; a[6] += y.z; a[7] += y.w;
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) a[i] *= inv_c;
  storev(out + off, a);
}

// G = 1: one thread per output vector walks the K parties in ascending k,
// acc = ((E_a + (E_0 + r_0)) + (E_1 + r_1)) + ..., each party's loads
// issued after the previous party's adds.
template <typename TA, typename TP, typename TM>
__global__ void __launch_bounds__(kThreads)
fwd_walk(const TA* __restrict__ ea, const TP* __restrict__ ep,
         const TM* __restrict__ mk, TA* __restrict__ out, int64_t nd, int K,
         float inv_c) {
  const int64_t nvec = nd / kVec;
  for (int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; v < nvec;
       v += (int64_t)gridDim.x * blockDim.x) {
    const int64_t off = v * kVec;
    float acc[kVec];
    loadv(ea + off, acc);
    for (int k = 0; k < K; ++k) {
      float e[kVec], r[kVec];
      loadv(ep + k * nd + off, e);
      loadv(mk + k * nd + off, r);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] += e[i] + r[i];
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] *= inv_c;
    storev(out + off, acc);
  }
}

template <typename TA, typename TP, typename TM>
__global__ void __launch_bounds__(kThreads)
fwd_scalar(const TA* __restrict__ ea, const TP* __restrict__ ep,
           const TM* __restrict__ mk, TA* __restrict__ out, int64_t nd, int K,
           float inv_c) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < nd;
       i += (int64_t)gridDim.x * blockDim.x) {
    float acc = to_f32(ea[i]);
    for (int k = 0; k < K; ++k) acc += to_f32(ep[k * nd + i]) + to_f32(mk[k * nd + i]);
    out[i] = from_f32<TA>(acc * inv_c);
  }
}

// dst's 16-byte vectors w0 + j * kThreads, j < kBwdVecs (16 / sizeof(T)
// elements each) = g's same elements / C, for those below the copy's nvec.
template <typename TG, typename T>
__device__ __forceinline__ void scaled_vecs(const TG* __restrict__ g,
                                            T* __restrict__ dst, int64_t w0,
                                            int64_t nvec, float inv_c) {
  constexpr int n = 16 / sizeof(T);
  float s[kBwdVecs][n];
#pragma unroll
  for (int j = 0; j < kBwdVecs; ++j) {
    const int64_t w = w0 + j * kThreads;
    if (w < nvec) loadv(g + w * n, s[j]);
  }
#pragma unroll
  for (int j = 0; j < kBwdVecs; ++j) {
    const int64_t w = w0 + j * kThreads;
    if (w < nvec) {
#pragma unroll
      for (int i = 0; i < n; ++i) s[j][i] *= inv_c;
      storev(dst + w * n, s[j]);
    }
  }
}

// dea / dep / dmk may each be null: only the cotangents asked for are
// written. The grid is dea's nba blocks, then nbp blocks for each of dep's
// K copies, then nbm for each of dmk's (0 for an output not asked for): a
// block lies in one copy, found with one 32-bit division, and each of its
// threads writes one 16-byte vector of it.
template <typename TG, typename TP, typename TM>
__global__ void __launch_bounds__(kThreads)
bwd_vec(const TG* __restrict__ g, TG* __restrict__ dea, TP* __restrict__ dep,
        TM* __restrict__ dmk, int64_t nd, unsigned K, unsigned nba,
        unsigned nbp, unsigned nbm, float inv_c) {
  constexpr int64_t span = kThreads * kBwdVecs;   // vectors a block
  unsigned b = blockIdx.x;
  if (b < nba) {
    scaled_vecs(g, dea, b * span + threadIdx.x, nd / (16 / sizeof(TG)),
                inv_c);
    return;
  }
  b -= nba;
  if (b < K * nbp) {
    const unsigned k = b / nbp;
    scaled_vecs(g, dep + k * nd, (b - k * nbp) * span + threadIdx.x,
                nd / (16 / sizeof(TP)), inv_c);
    return;
  }
  b -= K * nbp;
  const unsigned k = b / nbm;
  scaled_vecs(g, dmk + k * nd, (b - k * nbm) * span + threadIdx.x,
              nd / (16 / sizeof(TM)), inv_c);
}

template <typename TG, typename TP, typename TM>
__global__ void __launch_bounds__(kThreads)
bwd_scalar(const TG* __restrict__ g, TG* __restrict__ dea, TP* __restrict__ dep,
           TM* __restrict__ dmk, int64_t nd, int K, float inv_c) {
  int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (dea) {
    if (t < nd) { dea[t] = from_f32<TG>(to_f32(g[t]) * inv_c); return; }
    t -= nd;
  }
  if (dep) {
    if (t < K * nd) { dep[t] = from_f32<TP>(to_f32(g[t % nd]) * inv_c); return; }
    t -= K * nd;
  }
  if (dmk && t < K * nd) dmk[t] = from_f32<TM>(to_f32(g[t % nd]) * inv_c);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Blocks of ``threads`` to cover ``work`` items, at least one.
int64_t blocks_for(int64_t work, int threads) {
  const int64_t blocks = (work + threads - 1) / threads;
  return blocks < 1 ? 1 : blocks;
}

// Enough blocks to cover the work, at most 16 resident per SM of 132.
unsigned grid_for(int64_t work) {
  const int64_t blocks = blocks_for(work, kThreads);
  return static_cast<unsigned>(blocks > 132 * 16 ? 132 * 16 : blocks);
}

// The output vectors of a split-forward CTA of G party groups.
int fwd_vectors(int G) { return kThreads / G / kVec * kVec; }

template <typename TA, typename TP, typename TM>
int launch_fwd(const void* ea, const void* ep, const void* mk, void* out,
               int64_t nd, int K, int G, cudaStream_t stream) {
  if (G < 1 || G > kFwdMaxGroups || G > (K > 1 ? K : 1)) return 1;
  const float inv_c = 1.0f / static_cast<float>(K + 1);
  const bool vec = nd % kVec == 0 && aligned16(ea) && aligned16(ep) &&
                   aligned16(mk) && aligned16(out);
  if (vec && G == 1) {
    fwd_walk<TA, TP, TM><<<grid_for(nd / kVec), kThreads, 0, stream>>>(
        static_cast<const TA*>(ea), static_cast<const TP*>(ep),
        static_cast<const TM*>(mk), static_cast<TA*>(out), nd, K, inv_c);
  } else if (vec) {
    const int V = fwd_vectors(G);
    const int kc = (K + G - 1) / G;
    const int64_t blocks = blocks_for(nd / kVec, V);
    if (blocks > INT32_MAX) return 1;
    const size_t smem = 2 * sizeof(float4) * (G - 1) * V;
    fwd_split<TA, TP, TM><<<static_cast<unsigned>(blocks), V * G, smem, stream>>>(
        static_cast<const TA*>(ea), static_cast<const TP*>(ep),
        static_cast<const TM*>(mk), static_cast<TA*>(out), nd, K, G, kc,
        inv_c);
  } else {
    if (G != 1) return 1;
    fwd_scalar<TA, TP, TM><<<grid_for(nd), kThreads, 0, stream>>>(
        static_cast<const TA*>(ea), static_cast<const TP*>(ep),
        static_cast<const TM*>(mk), static_cast<TA*>(out), nd, K, inv_c);
  }
  return 0;
}

template <typename TG, typename TP, typename TM>
int launch_bwd(const void* g, void* dea, void* dep, void* dmk, int64_t nd,
               int K, cudaStream_t stream) {
  const float inv_c = 1.0f / static_cast<float>(K + 1);
  const bool vec = nd % kVec == 0 && aligned16(g) && aligned16(dea) &&
                   aligned16(dep) && aligned16(dmk);
  int64_t blocks;
  if (vec) {        // blocks of one copy: its 16-byte vectors over a block's
    constexpr int span = kThreads * kBwdVecs;
    const int64_t nba = dea ? blocks_for(nd * sizeof(TG) / 16, span) : 0;
    const int64_t nbp = dep ? blocks_for(nd * sizeof(TP) / 16, span) : 0;
    const int64_t nbm = dmk ? blocks_for(nd * sizeof(TM) / 16, span) : 0;
    blocks = nba + K * (nbp + nbm);
    if (blocks > INT32_MAX) return 1;
    bwd_vec<TG, TP, TM><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const TG*>(g), static_cast<TG*>(dea), static_cast<TP*>(dep),
        static_cast<TM*>(dmk), nd, static_cast<unsigned>(K),
        static_cast<unsigned>(nba), static_cast<unsigned>(nbp),
        static_cast<unsigned>(nbm), inv_c);
  } else {          // every output element asked for, one a thread
    const int64_t work = ((dea ? 1 : 0) + (dep ? K : 0) + (dmk ? K : 0)) * nd;
    blocks = blocks_for(work, kThreads);
    if (blocks > INT32_MAX) return 1;
    bwd_scalar<TG, TP, TM><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const TG*>(g), static_cast<TG*>(dea), static_cast<TP*>(dep),
        static_cast<TM*>(dmk), nd, K, inv_c);
  }
  return 0;
}

// dtype codes shared with the Python wrapper: 0 float32, 1 bfloat16, 2 float16.
template <typename TA, typename TP>
int fwd_m(int tm, const void* ea, const void* ep, const void* mk, void* out,
          int64_t nd, int K, int G, cudaStream_t s) {
  switch (tm) {
    case 0: return launch_fwd<TA, TP, float>(ea, ep, mk, out, nd, K, G, s);
    case 1: return launch_fwd<TA, TP, __nv_bfloat16>(ea, ep, mk, out, nd, K, G, s);
    case 2: return launch_fwd<TA, TP, __half>(ea, ep, mk, out, nd, K, G, s);
  }
  return 1;
}

template <typename TA>
int fwd_p(int tp, int tm, const void* ea, const void* ep, const void* mk,
          void* out, int64_t nd, int K, int G, cudaStream_t s) {
  switch (tp) {
    case 0: return fwd_m<TA, float>(tm, ea, ep, mk, out, nd, K, G, s);
    case 1: return fwd_m<TA, __nv_bfloat16>(tm, ea, ep, mk, out, nd, K, G, s);
    case 2: return fwd_m<TA, __half>(tm, ea, ep, mk, out, nd, K, G, s);
  }
  return 1;
}

template <typename TG, typename TP>
int bwd_m(int tm, const void* g, void* dea, void* dep, void* dmk, int64_t nd,
          int K, cudaStream_t s) {
  switch (tm) {
    case 0: return launch_bwd<TG, TP, float>(g, dea, dep, dmk, nd, K, s);
    case 1: return launch_bwd<TG, TP, __nv_bfloat16>(g, dea, dep, dmk, nd, K, s);
    case 2: return launch_bwd<TG, TP, __half>(g, dea, dep, dmk, nd, K, s);
  }
  return 1;
}

template <typename TG>
int bwd_p(int tp, int tm, const void* g, void* dea, void* dep, void* dmk,
          int64_t nd, int K, cudaStream_t s) {
  switch (tp) {
    case 0: return bwd_m<TG, float>(tm, g, dea, dep, dmk, nd, K, s);
    case 1: return bwd_m<TG, __nv_bfloat16>(tm, g, dea, dep, dmk, nd, K, s);
    case 2: return bwd_m<TG, __half>(tm, g, dea, dep, dmk, nd, K, s);
  }
  return 1;
}

}  // namespace

extern "C" {

// ea (N*d), ep/mk (K, N*d) contiguous; out (N*d) in ea's dtype. G party
// groups a CTA: 1 <= G <= min(max(K, 1), 32), and 1 where the scalar path
// runs (N*d not a multiple of 8, or a pointer not 16-byte aligned).
int blind_agg_fwd(const void* ea, const void* ep, const void* mk, void* out,
                  int64_t nd, int K, int G, int ta, int tp, int tm,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int bad = 1;
  switch (ta) {
    case 0: bad = fwd_p<float>(tp, tm, ea, ep, mk, out, nd, K, G, s); break;
    case 1: bad = fwd_p<__nv_bfloat16>(tp, tm, ea, ep, mk, out, nd, K, G, s); break;
    case 2: bad = fwd_p<__half>(tp, tm, ea, ep, mk, out, nd, K, G, s); break;
  }
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// g (N*d); dea (N*d) in g's dtype, dep (K, N*d), dmk (K, N*d); any of the
// three outputs may be null.
int blind_agg_bwd(const void* g, void* dea, void* dep, void* dmk, int64_t nd,
                  int K, int tg, int tp, int tm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int bad = 1;
  switch (tg) {
    case 0: bad = bwd_p<float>(tp, tm, g, dea, dep, dmk, nd, K, s); break;
    case 1: bad = bwd_p<__nv_bfloat16>(tp, tm, g, dea, dep, dmk, nd, K, s); break;
    case 2: bad = bwd_p<__half>(tp, tm, g, dea, dep, dmk, nd, K, s); break;
  }
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* blind_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
