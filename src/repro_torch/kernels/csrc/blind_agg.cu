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
// float32 balance. So the design is about bytes only:
//   * forward: one thread owns 8 consecutive outputs of the flattened N*d
//     index and loops over K itself, so every input byte is read once and
//     every output byte written once, with no shared memory, no atomics, no
//     second pass (the TPU kernel's sequential K grid axis and VMEM
//     accumulator do not carry over: blocks run in no order here). With few
//     outputs and many parties (N*d = 8192, K = 63) that is 1,024 threads
//     on 8 SMs, latency-bound (unrolling the K loop by 4 measured no gain):
//     splitting K across threads with an in-block reduction is the next
//     step;
//   * backward: no reduction, so the K copies also spread over blockIdx.y;
//   * loads and stores are 16 bytes a thread (one uint4 of 8 bf16/fp16, two
//     float4 of fp32) with neighbouring threads on neighbouring addresses;
//     when N*d is not a multiple of 8 or a pointer is not 16-byte aligned
//     the same arithmetic runs one element a thread.
// Dtypes: float32, bfloat16 and float16 in any mix of E_a, E_k and r_k.
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;
constexpr int kThreads = 128;

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

// 8 consecutive elements <-> float[8], 16 bytes per memory instruction.
__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x; v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const __half* p, float (&v)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    v[2 * i] = f.x; v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(__half* p, const float (&v)[kVec]) {
  uint4 u;
  __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename TA, typename TP, typename TM>
__global__ void __launch_bounds__(kThreads)
fwd_vec(const TA* __restrict__ ea, const TP* __restrict__ ep,
        const TM* __restrict__ mk, TA* __restrict__ out, int64_t nd, int K,
        float inv_c) {
  const int64_t nvec = nd / kVec;
  for (int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; v < nvec;
       v += (int64_t)gridDim.x * blockDim.x) {
    const int64_t off = v * kVec;
    float acc[kVec];
    load8(ea + off, acc);
    for (int k = 0; k < K; ++k) {
      float e[kVec], r[kVec];
      load8(ep + k * nd + off, e);
      load8(mk + k * nd + off, r);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] += e[i] + r[i];
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] *= inv_c;
    store8(out + off, acc);
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

// dea / dep / dmk may each be null: only the cotangents asked for are written.
// blockIdx.y takes parties [y * kc, (y + 1) * kc): the backward has no
// reduction, so the K copies spread over more blocks than the N*d outputs
// alone would fill; g is read once from HBM and again from L2 per y.
template <typename TG, typename TP, typename TM>
__global__ void __launch_bounds__(kThreads)
bwd_vec(const TG* __restrict__ g, TG* __restrict__ dea, TP* __restrict__ dep,
        TM* __restrict__ dmk, int64_t nd, int K, int kc, float inv_c) {
  const int64_t nvec = nd / kVec;
  const int k0 = blockIdx.y * kc;
  const int k1 = min(K, k0 + kc);
  for (int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; v < nvec;
       v += (int64_t)gridDim.x * blockDim.x) {
    const int64_t off = v * kVec;
    float s[kVec];
    load8(g + off, s);
#pragma unroll
    for (int i = 0; i < kVec; ++i) s[i] *= inv_c;
    if (dea && blockIdx.y == 0) store8(dea + off, s);
    for (int k = k0; k < k1; ++k) {
      if (dep) store8(dep + k * nd + off, s);
      if (dmk) store8(dmk + k * nd + off, s);
    }
  }
}

template <typename TG, typename TP, typename TM>
__global__ void __launch_bounds__(kThreads)
bwd_scalar(const TG* __restrict__ g, TG* __restrict__ dea, TP* __restrict__ dep,
           TM* __restrict__ dmk, int64_t nd, int K, int kc, float inv_c) {
  const int k0 = blockIdx.y * kc;
  const int k1 = min(K, k0 + kc);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < nd;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float s = to_f32(g[i]) * inv_c;
    if (dea && blockIdx.y == 0) dea[i] = from_f32<TG>(s);
    for (int k = k0; k < k1; ++k) {
      if (dep) dep[k * nd + i] = from_f32<TP>(s);
      if (dmk) dmk[k * nd + i] = from_f32<TM>(s);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Enough blocks to cover the work, at most 16 resident per SM of 132.
unsigned grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return blocks < 1 ? 1u : static_cast<unsigned>(blocks);
}

template <typename TA, typename TP, typename TM>
void launch_fwd(const void* ea, const void* ep, const void* mk, void* out,
                int64_t nd, int K, cudaStream_t stream) {
  const float inv_c = 1.0f / static_cast<float>(K + 1);
  const bool vec = nd % kVec == 0 && aligned16(ea) && aligned16(ep) &&
                   aligned16(mk) && aligned16(out);
  if (vec) {
    fwd_vec<TA, TP, TM><<<grid_for(nd / kVec), kThreads, 0, stream>>>(
        static_cast<const TA*>(ea), static_cast<const TP*>(ep),
        static_cast<const TM*>(mk), static_cast<TA*>(out), nd, K, inv_c);
  } else {
    fwd_scalar<TA, TP, TM><<<grid_for(nd), kThreads, 0, stream>>>(
        static_cast<const TA*>(ea), static_cast<const TP*>(ep),
        static_cast<const TM*>(mk), static_cast<TA*>(out), nd, K, inv_c);
  }
}

// Split the K parties over gridDim.y so that x-blocks * y-blocks come
// near a full card (132 SMs x 16 blocks), kc parties per y-block.
void party_split(unsigned xblocks, int K, int* kc, unsigned* yblocks) {
  if (K <= 0) { *kc = 0; *yblocks = 1; return; }
  int64_t want = (132 * 16 + xblocks - 1) / xblocks;
  if (want > K) want = K;
  if (want > 65535) want = 65535;
  if (want < 1) want = 1;
  *kc = static_cast<int>((K + want - 1) / want);
  *yblocks = static_cast<unsigned>((K + *kc - 1) / *kc);
}

template <typename TG, typename TP, typename TM>
void launch_bwd(const void* g, void* dea, void* dep, void* dmk, int64_t nd,
                int K, cudaStream_t stream) {
  const float inv_c = 1.0f / static_cast<float>(K + 1);
  const bool vec = nd % kVec == 0 && aligned16(g) && aligned16(dea) &&
                   aligned16(dep) && aligned16(dmk);
  const unsigned xb = grid_for(vec ? nd / kVec : nd);
  int kc;
  unsigned yb;
  party_split(xb, K, &kc, &yb);
  if (vec) {
    bwd_vec<TG, TP, TM><<<dim3(xb, yb), kThreads, 0, stream>>>(
        static_cast<const TG*>(g), static_cast<TG*>(dea), static_cast<TP*>(dep),
        static_cast<TM*>(dmk), nd, K, kc, inv_c);
  } else {
    bwd_scalar<TG, TP, TM><<<dim3(xb, yb), kThreads, 0, stream>>>(
        static_cast<const TG*>(g), static_cast<TG*>(dea), static_cast<TP*>(dep),
        static_cast<TM*>(dmk), nd, K, kc, inv_c);
  }
}

// dtype codes shared with the Python wrapper: 0 float32, 1 bfloat16, 2 float16.
template <typename TA, typename TP>
int fwd_m(int tm, const void* ea, const void* ep, const void* mk, void* out,
          int64_t nd, int K, cudaStream_t s) {
  switch (tm) {
    case 0: launch_fwd<TA, TP, float>(ea, ep, mk, out, nd, K, s); return 0;
    case 1: launch_fwd<TA, TP, __nv_bfloat16>(ea, ep, mk, out, nd, K, s); return 0;
    case 2: launch_fwd<TA, TP, __half>(ea, ep, mk, out, nd, K, s); return 0;
  }
  return 1;
}

template <typename TA>
int fwd_p(int tp, int tm, const void* ea, const void* ep, const void* mk,
          void* out, int64_t nd, int K, cudaStream_t s) {
  switch (tp) {
    case 0: return fwd_m<TA, float>(tm, ea, ep, mk, out, nd, K, s);
    case 1: return fwd_m<TA, __nv_bfloat16>(tm, ea, ep, mk, out, nd, K, s);
    case 2: return fwd_m<TA, __half>(tm, ea, ep, mk, out, nd, K, s);
  }
  return 1;
}

template <typename TG, typename TP>
int bwd_m(int tm, const void* g, void* dea, void* dep, void* dmk, int64_t nd,
          int K, cudaStream_t s) {
  switch (tm) {
    case 0: launch_bwd<TG, TP, float>(g, dea, dep, dmk, nd, K, s); return 0;
    case 1: launch_bwd<TG, TP, __nv_bfloat16>(g, dea, dep, dmk, nd, K, s); return 0;
    case 2: launch_bwd<TG, TP, __half>(g, dea, dep, dmk, nd, K, s); return 0;
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

// ea (N*d), ep/mk (K, N*d) contiguous; out (N*d) in ea's dtype.
int blind_agg_fwd(const void* ea, const void* ep, const void* mk, void* out,
                  int64_t nd, int K, int ta, int tp, int tm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int bad = 1;
  switch (ta) {
    case 0: bad = fwd_p<float>(tp, tm, ea, ep, mk, out, nd, K, s); break;
    case 1: bad = fwd_p<__nv_bfloat16>(tp, tm, ea, ep, mk, out, nd, K, s); break;
    case 2: bad = fwd_p<__half>(tp, tm, ea, ep, mk, out, nd, K, s); break;
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
