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
// chip_smoke.py computes the bound. The design draws each pair's normal
// once, as that count does:
//   * the K(K-1)/2 pair keys are derived once per launch by a first small
//     kernel of this source, pair (a, b), a < b, from row a's seed words
//     for partner b, into a buffer the wrapper allocates, in the order
//     p(a, b) = a (2K - a - 1) / 2 + (b - a - 1);
//   * a CTA of 256 threads owns a tile of T consecutive outputs (T a power
//     of two <= 64, the largest whose normals and partial sums fit in
//     72 KB, so that three CTAs share an SM: 64 at K <= 15, 8 at K = 63, 2
//     at K = 127). Draw phase: its threads draw the P = K(K-1)/2 normals
//     n_(a,b)[i] of the tile into shared memory, [pair][element], two
//     consecutive elements a thread (two independent threefry chains);
//   * fold phase: each (element, party k) thread folds r_k over its K-1
//     partners in ascending order from shared memory, exactly as the plain
//     version does, scales it, rounds it to E_k's dtype and writes E_k +
//     r_k to shared memory; one thread per element then adds the parties
//     in k order into its float32 accumulator, keeping the plain version's
//     party order without atomics.
// In a MaskEngine's tables pair (k, p) has the same seed words in row k
// and in row p, so each party's term is the same normal as drawn for its
// own row, times its own sign: the result is bit for bit that of drawing
// every (party, partner) term separately. The kernel takes the tables as a
// MaskEngine builds them.
// Dtypes: float32, bfloat16 and float16 for E_a and for E_k independently;
// the output takes E_a's dtype. Every entry point returns
// cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 64;                 // outputs a CTA at most
constexpr int kTileBytes = 72 * 1024;        // normals + partial sums a CTA
constexpr int kMaxSmem = 232448;             // the opt-in limit a CTA

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

// keys[p(a, b)] = fold_in(fold_in((0, hi), lo), round) with (hi, lo) row
// a's seed words for partner b (column b - 1), a < b
__global__ void derive_pair_keys(const uint32_t* __restrict__ seed_hi,
                                 const uint32_t* __restrict__ seed_lo,
                                 int width, int K, int n_pairs, uint32_t round,
                                 uint2* __restrict__ keys) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_pairs) return;
  int a = 0, rem = idx;
  while (rem >= K - 1 - a) {
    rem -= K - 1 - a;
    ++a;
  }
  const int col = a * width + a + rem;         // partner b = a + 1 + rem
  uint32_t x = 0, y = seed_lo[col];
  threefry2x32(0u, seed_hi[col], x, y);
  uint32_t c = 0, d = round;
  threefry2x32(x, y, c, d);
  keys[idx] = make_uint2(c, d);
}

template <typename TA, typename TP>
__global__ void __launch_bounds__(kThreads)
prng_fwd(const TA* __restrict__ ea, const TP* __restrict__ ep,
         const uint2* __restrict__ keys, const int32_t* __restrict__ signs,
         int width, TA* __restrict__ out, int64_t nd, int K, int tile,
         float scale, float inv_c) {
  extern __shared__ float smem[];
  const int n_pairs = K * (K - 1) / 2;
  float* nrm = smem;                           // [pair][element]
  float* part = smem + n_pairs * tile;         // [party][element]
  const int64_t i0 = blockIdx.x * (int64_t)tile;
  const int n = nd - i0 < tile ? static_cast<int>(nd - i0) : tile;  // valid

  // draw: item (pair, 2 consecutive elements); elements past nd are drawn
  // and never read
  const int per_pair = tile / 2;
  for (int it = threadIdx.x; it < n_pairs * per_pair; it += kThreads) {
    const int p = it / per_pair;
    const int e = 2 * (it - p * per_pair);
    const uint2 key = keys[p];
    const uint64_t i = static_cast<uint64_t>(i0 + e);
    uint32_t x0 = static_cast<uint32_t>(i >> 32), x1 = static_cast<uint32_t>(i);
    uint32_t y0 = static_cast<uint32_t>((i + 1) >> 32), y1 = static_cast<uint32_t>(i + 1);
    threefry2x32(key.x, key.y, x0, x1);
    threefry2x32(key.x, key.y, y0, y1);
    *reinterpret_cast<float2*>(nrm + p * tile + e) =
        make_float2(bits_to_normal(x0 ^ x1), bits_to_normal(y0 ^ y1));
  }
  __syncthreads();

  // fold: r_k over partners j ascending, pairs (j, k) then (k, j)
  for (int task = threadIdx.x; task < K * tile; task += kThreads) {
    const int k = task / tile, e = task - k * tile;
    if (e >= n) continue;
    const float ek = to_f32(ep[k * nd + i0 + e]);
    const int32_t* sg = signs + k * width;
    float r = 0.0f;
    int p = k - 1;                             // p(0, k)
    for (int j = 0; j < k; ++j) {
      r = __fadd_rn(r, __fmul_rn(nrm[p * tile + e], static_cast<float>(sg[j])));
      p += K - j - 2;                          // p(j + 1, k)
    }
    p = k * (2 * K - k - 1) / 2;               // p(k, k + 1)
    for (int j = k; j < K - 1; ++j, ++p)
      r = __fadd_rn(r, __fmul_rn(nrm[p * tile + e], static_cast<float>(sg[j])));
    if (scale != 1.0f) r = __fmul_rn(r, scale);
    const float rq = to_f32(from_f32<TP>(r));       // r_k in E_k's dtype
    part[k * tile + e] = __fadd_rn(ek, rq);
  }
  __syncthreads();

  if (threadIdx.x < n) {
    const int e = threadIdx.x;
    float acc = to_f32(ea[i0 + e]);
    for (int k = 0; k < K; ++k) acc = __fadd_rn(acc, part[k * tile + e]);
    out[i0 + e] = from_f32<TA>(__fmul_rn(acc, inv_c));
  }
}

// outputs a CTA: the largest power of two <= kMaxTile (at least 2) whose
// normals and partial sums fit in kTileBytes; 0 if even 2 exceed kMaxSmem
int tile_for(int K) {
  const long long per = 4LL * (K * (K - 1LL) / 2 + K);
  int tile = kMaxTile;
  while (tile > 2 && per * tile > kTileBytes) tile /= 2;
  return per * tile > kMaxSmem ? 0 : tile;
}

template <typename TA, typename TP>
int launch(const void* ea, const void* ep, const void* keys,
           const void* signs, int width, void* out, int64_t nd, int K,
           float scale, cudaStream_t s) {
  const int tile = tile_for(K);
  if (tile == 0) return cudaErrorInvalidValue;
  const int smem = 4 * (K * (K - 1) / 2 + K) * tile;
  auto kern = prng_fwd<TA, TP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return err;
  const int64_t blocks = (nd + tile - 1) / tile;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      static_cast<const TA*>(ea), static_cast<const TP*>(ep),
      static_cast<const uint2*>(keys), static_cast<const int32_t*>(signs),
      width, static_cast<TA*>(out), nd, K, tile, scale,
      1.0f / static_cast<float>(K + 1));
  return cudaGetLastError();
}

// dtype codes shared with the Python wrapper: 0 float32, 1 bfloat16, 2 float16.
template <typename TA>
int launch_p(int tp, const void* ea, const void* ep, const void* keys,
             const void* signs, int width, void* out, int64_t nd, int K,
             float scale, cudaStream_t s) {
  switch (tp) {
    case 0: return launch<TA, float>(ea, ep, keys, signs, width, out, nd, K, scale, s);
    case 1: return launch<TA, __nv_bfloat16>(ea, ep, keys, signs, width, out, nd, K, scale, s);
    case 2: return launch<TA, __half>(ea, ep, keys, signs, width, out, nd, K, scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// ea (N*d); ep (K, N*d); seed_hi / seed_lo / signs (K, width) with
// width >= K - 1, as a MaskEngine builds them; keys: scratch of at least
// K * (K - 1) uint32 (may be null when K < 2); out (N*d) in ea's dtype.
// K at most blind_agg_prng_max_parties().
int blind_agg_prng_fwd(const void* ea, const void* ep, const void* seed_hi,
                       const void* seed_lo, const void* signs, int width,
                       void* keys, void* out, int64_t nd, int K,
                       uint32_t round, float scale, int ta, int tp,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 0 || nd < 0 || tile_for(K) == 0) return cudaErrorInvalidValue;
  if (nd == 0) return cudaSuccess;
  const int n_pairs = K * (K - 1) / 2;
  if (n_pairs > 0) {
    derive_pair_keys<<<(n_pairs + 255) / 256, 256, 0, s>>>(
        static_cast<const uint32_t*>(seed_hi),
        static_cast<const uint32_t*>(seed_lo), width, K, n_pairs, round,
        static_cast<uint2*>(keys));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  switch (ta) {
    case 0: return launch_p<float>(tp, ea, ep, keys, signs, width, out, nd, K, scale, s);
    case 1: return launch_p<__nv_bfloat16>(tp, ea, ep, keys, signs, width, out, nd, K, scale, s);
    case 2: return launch_p<__half>(tp, ea, ep, keys, signs, width, out, nd, K, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// the largest K whose tile of 2 outputs fits in a CTA's shared memory
int blind_agg_prng_max_parties() {
  int K = 2;
  while (tile_for(K + 1) != 0) ++K;
  return K;
}

const char* blind_agg_prng_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
