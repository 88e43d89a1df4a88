// Fused blind + aggregate with the pair masks made inside the kernel, for
// Hopper, sm_90a.
//
// blind_agg_prng_fwd replaces the TPU kernel
// repro/kernels/blind_agg.py::_prng_fwd_kernel. It computes
//     out = (E_a + sum_k (E_k + r_k)) * (1 / (K + 1))
// over the N*d outputs with every mask r_k made from the MaskEngine's
// (K, K-1) seed tables and the round: no (K, N, d) mask tensor exists in
// device memory. The TPU kernel draws uniform masks from the TPU core PRNG,
// a bit-stream nothing off the TPU reproduces; this kernel computes what
// the reference computes off the TPU (kernels/ops.py::blind_agg_prng),
// element for element:
//   r_k[i] = mask_scale * fold_j (signs[k,j] * normal(threefry2x32(key_kj,
//            (i >> 32, i & 0xFFFFFFFF))))       left fold, ascending j,
//   key_kj = fold_in(fold_in((0, seed_hi[k,j]), seed_lo[k,j]), round),
//   normal = sqrt(2) * erfinv(uniform on [nextafter(-1, 0), 1)) from the
//            bits x1 ^ x2 by the mantissa trick, erfinv by Giles'
//            single-precision polynomial (the one XLA lowers erf_inv to),
// then r_k rounded to E_k's dtype and accumulated in float32 in k order.
// Every float step is one IEEE-rounded operation (__fadd_rn / __fmul_rn,
// which the compiler never contracts into an FMA), in the order of the
// plain torch version (core/blinding.py bits_to_normal, MaskEngine.masks),
// so on the card the masks equal the plain version's bit for bit where
// log1pf and sqrtf round as torch's CUDA log1p and sqrt do (both call the
// same CUDA math functions); only the order of the final float32 sum over
// parties differs.
//
// What bounds it: operations, not bytes. The function needs one normal
// per element and unordered pair of parties (K(K-1)/2 of them): one
// threefry2x32 (20 rounds of add, rotate, xor plus 5 key injections) and
// the bits-to-float step, 75 INT32 operations, and about 27 FP32 ones
// (the uniform, Giles' polynomial, the two signed adds). At K = 63,
// N*d = 8192 that is 16 M pair evaluations, 0.072 ms at the H100's INT32
// lane rate, against 4.2 MB of inputs and output (1.3 us at 3.35 TB/s);
// chip_smoke.py computes the bound. The design:
//   * the K(K-1) pair keys (two threefry calls each) are derived once per
//     launch by a first small kernel of this source into a (K, K-1, 2)
//     uint32 buffer the wrapper allocates (128 KB at K = 127, too much for
//     the default 48 KB of shared memory): not per thread, and not on the
//     host;
//   * a block of 256 threads takes `tile` consecutive outputs times `lanes`
//     parties (lanes = the power of two >= K, at most 16; tile = 256 /
//     lanes), so a small K does not leave threads idle and a large K
//     spreads its parties over the block;
//   * each (output, party) thread makes r_k over the K-1 pairs and writes
//     E_k + r_k to shared memory; one thread per output then adds the lanes
//     in k order into its float32 accumulator, keeping the plain version's
//     party order without atomics;
//   * each unordered pair's normal is drawn twice, once for each of its two
//     parties (2x the minimum work): sharing it across threads is the next
//     step.
// Dtypes: float32, bfloat16 and float16 for E_a and for E_k independently;
// the output takes E_a's dtype. Every entry point returns
// cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLanes = 16;

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

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds (Salmon et al. 2011), as jax.random uses it.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][r]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// Giles' erfinv coefficients as float32 (the values torch rounds the
// plain version's Python floats to), w < 5 and w >= 5.
__constant__ float kLt[9] = {
    0x1.e2cb1p-26f, 0x1.70966cp-22f, -0x1.d8e6aep-19f, -0x1.26b582p-18f,
    0x1.ca65b6p-13f, -0x1.48a81p-10f, -0x1.11c9dep-8f, 0x1.f91ec6p-3f,
    0x1.805c5ep+0f};
__constant__ float kGe[9] = {
    -0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f, -0x1.e17bcep-9f,
    0x1.7824f6p-8f, -0x1.f38baep-8f, 0x1.354afcp-7f, 0x1.006db6p+0f,
    0x1.6a9efcp+1f};
constexpr float kNormalLo = -0x1.fffffep-1f;     // nextafter(-1, 0)
constexpr float kSqrt2 = 0x1.6a09e6p+0f;

__device__ __forceinline__ float erfinv_f32(float x) {
  float w = -log1pf(-__fmul_rn(x, x));
  const bool small = w < 5.0f;
  w = small ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  float p = small ? kLt[0] : kGe[0];
#pragma unroll
  for (int t = 1; t < 9; ++t)
    p = __fadd_rn(small ? kLt[t] : kGe[t], __fmul_rn(p, w));
  return __fmul_rn(p, x);
}

__device__ __forceinline__ float bits_to_normal(uint32_t bits) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u);
  const float span = __fsub_rn(1.0f, kNormalLo);
  const float u = fmaxf(kNormalLo,
                        __fadd_rn(__fmul_rn(__fsub_rn(f, 1.0f), span), kNormalLo));
  return __fmul_rn(erfinv_f32(u), kSqrt2);
}

// keys[2 * (k * n_pairs + j) + {0, 1}] = fold_in(fold_in((0, hi), lo), round)
__global__ void derive_keys(const uint32_t* __restrict__ seed_hi,
                            const uint32_t* __restrict__ seed_lo, int width,
                            int K, int n_pairs, uint32_t round,
                            uint32_t* __restrict__ keys) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= K * n_pairs) return;
  const int k = idx / n_pairs, j = idx % n_pairs;
  uint32_t a = 0, b = seed_lo[k * width + j];
  threefry2x32(0u, seed_hi[k * width + j], a, b);
  uint32_t c = 0, d = round;
  threefry2x32(a, b, c, d);
  keys[2 * idx] = c;
  keys[2 * idx + 1] = d;
}

template <typename TA, typename TP>
__global__ void __launch_bounds__(kThreads)
prng_fwd(const TA* __restrict__ ea, const TP* __restrict__ ep,
         const uint2* __restrict__ keys, const int32_t* __restrict__ signs,
         int width, TA* __restrict__ out, int64_t nd, int K, int n_pairs,
         int lanes, float scale, float inv_c) {
  __shared__ float part[kThreads];
  const int tile = kThreads / lanes;
  const int e = threadIdx.x % tile;
  const int lane = threadIdx.x / tile;
  for (int64_t t0 = blockIdx.x * (int64_t)tile; t0 < nd;
       t0 += (int64_t)gridDim.x * tile) {
    const int64_t i = t0 + e;
    const bool valid = i < nd;
    const uint32_t c_hi = static_cast<uint32_t>(static_cast<uint64_t>(i) >> 32);
    const uint32_t c_lo = static_cast<uint32_t>(i);
    float acc = (valid && lane == 0) ? to_f32(ea[i]) : 0.0f;
    for (int k0 = 0; k0 < K; k0 += lanes) {
      const int k = k0 + lane;
      if (valid && k < K) {
        float r = 0.0f;
        for (int j = 0; j < n_pairs; ++j) {
          const uint2 key = keys[k * n_pairs + j];
          uint32_t x0 = c_hi, x1 = c_lo;
          threefry2x32(key.x, key.y, x0, x1);
          const float sgn = static_cast<float>(signs[k * width + j]);
          r = __fadd_rn(r, __fmul_rn(bits_to_normal(x0 ^ x1), sgn));
        }
        if (scale != 1.0f) r = __fmul_rn(r, scale);
        const float rq = to_f32(from_f32<TP>(r));       // r_k in E_k's dtype
        part[threadIdx.x] = __fadd_rn(to_f32(ep[k * nd + i]), rq);
      }
      __syncthreads();
      if (valid && lane == 0) {
        const int n = min(lanes, K - k0);
        for (int l = 0; l < n; ++l) acc = __fadd_rn(acc, part[l * tile + e]);
      }
      __syncthreads();
    }
    if (valid && lane == 0) out[i] = from_f32<TA>(__fmul_rn(acc, inv_c));
  }
}

template <typename TA, typename TP>
void launch(const void* ea, const void* ep, const void* keys,
            const void* signs, int width, void* out, int64_t nd, int K,
            int n_pairs, float scale, cudaStream_t s) {
  int lanes = 1;
  while (lanes < K && lanes < kMaxLanes) lanes *= 2;
  const int tile = kThreads / lanes;
  int64_t blocks = (nd + tile - 1) / tile;
  if (blocks > 132 * 8) blocks = 132 * 8;
  if (blocks < 1) blocks = 1;
  prng_fwd<TA, TP><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const TA*>(ea), static_cast<const TP*>(ep),
      static_cast<const uint2*>(keys), static_cast<const int32_t*>(signs),
      width, static_cast<TA*>(out), nd, K, n_pairs, lanes, scale,
      1.0f / static_cast<float>(K + 1));
}

// dtype codes shared with the Python wrapper: 0 float32, 1 bfloat16, 2 float16.
template <typename TA>
int launch_p(int tp, const void* ea, const void* ep, const void* keys,
             const void* signs, int width, void* out, int64_t nd, int K,
             int n_pairs, float scale, cudaStream_t s) {
  switch (tp) {
    case 0: launch<TA, float>(ea, ep, keys, signs, width, out, nd, K, n_pairs, scale, s); return 0;
    case 1: launch<TA, __nv_bfloat16>(ea, ep, keys, signs, width, out, nd, K, n_pairs, scale, s); return 0;
    case 2: launch<TA, __half>(ea, ep, keys, signs, width, out, nd, K, n_pairs, scale, s); return 0;
  }
  return 1;
}

}  // namespace

extern "C" {

// ea (N*d); ep (K, N*d); seed_hi / seed_lo / signs (K, width) with
// width >= K - 1; keys: scratch of 2 * K * (K - 1) uint32 (may be null when
// K < 2); out (N*d) in ea's dtype.
int blind_agg_prng_fwd(const void* ea, const void* ep, const void* seed_hi,
                       const void* seed_lo, const void* signs, int width,
                       void* keys, void* out, int64_t nd, int K,
                       uint32_t round, float scale, int ta, int tp,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pairs = K > 1 ? K - 1 : 0;
  if (n_pairs > 0) {
    const int n = K * n_pairs;
    derive_keys<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<const uint32_t*>(seed_hi),
        static_cast<const uint32_t*>(seed_lo), width, K, n_pairs, round,
        static_cast<uint32_t*>(keys));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int bad = 1;
  switch (ta) {
    case 0: bad = launch_p<float>(tp, ea, ep, keys, signs, width, out, nd, K, n_pairs, scale, s); break;
    case 1: bad = launch_p<__nv_bfloat16>(tp, ea, ep, keys, signs, width, out, nd, K, n_pairs, scale, s); break;
    case 2: bad = launch_p<__half>(tp, ea, ep, keys, signs, width, out, nd, K, n_pairs, scale, s); break;
  }
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* blind_agg_prng_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
