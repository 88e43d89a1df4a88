// Flash attention forward (causal / sliding-window / GQA) for Hopper, sm_90a.
//
// flash_attention_fwd replaces the TPU kernel
// repro/kernels/flash_attention.py::_flash_kernel:
//     out = softmax(q k^T / sqrt(hd) + mask) v
// for q (B, S, Hq, hd) and k, v (B, T, Hkv, hd), all contiguous; query head
// h reads kv head h / (Hq / Hkv). The mask is causal (k_pos <= q_pos) and/or
// a window (k_pos > q_pos - window), positions counted from 0 in both q and
// k. The running max m, the running sum l and the accumulator are float32,
// with an online softmax across kv tiles; the output takes q's dtype.
//
// What bounds it on the card: operations. A causal prefill of S tokens does
// 4 hd Hq S(S+1)/2 flops on (2 Hkv + 2 Hq) S hd elements, far above the
// H100's ~295 flops per byte in bf16 at any S of the serving path, so the
// bound is the tensor cores' 989 TFLOP/s. This first version is a simple,
// correct design on the FP32 lanes and does not reach that bound: its
// products run as scalar FMAs from shared memory (wgmma and TMA are later
// work). The design:
//   * one CTA of 256 threads per (q tile of 64 rows, q head, batch); the
//     TPU kernel's sequential kv grid axis becomes a loop inside the CTA,
//     with m, l and the (64 x hd) accumulator held in registers: each
//     thread owns 4 rows and hd/16 interleaved output columns, and the 16
//     threads that share a row reduce its max and sum with shuffles;
//   * the q tile is scaled once in float32 (as the TPU kernel does) and
//     kept in shared memory; each 64-row K and V tile is staged in shared
//     memory as float32, rows padded by one word so that neither the score
//     loop nor the q reads collide on banks;
//   * kv tiles that lie wholly above the diagonal (causal) or wholly
//     outside the window are skipped. That is exact: such a tile adds
//     exp(-1e30 - m) = 0 and scales by corr = 1;
//   * masked entries (also columns past T) get p = 0 explicitly rather
//     than exp(-1e30 - m): a row whose first visited tile is fully masked
//     (a window, or S != T) then keeps m = -1e30, l = 0 and acc = 0, and
//     never carries the TPU kernel's transient p = exp(0) = 1. A row with
//     no unmasked entry at all (only possible when a window and S > T leave
//     it nothing) is written as 0;
//   * any S and T: rows past S are neither loaded nor written, columns past
//     T are masked, so ragged prompt lengths (S = 511, 1023, 7) need no
//     padding by the caller.
// Dtypes: float32 and bfloat16 (q, k, v and out share one);
// hd in {32, 64, 128, 256}. At hd = 256 (recurrentgemma's heads) the tiles
// take 213,760 B of shared memory, under the 232,448 B a block may opt into,
// so one CTA runs on an SM at a time. The entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kRows = 4;       // rows per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  // q tile and K tile rows padded to HD + 1, V tile unpadded, P tile
  // rows padded to kBK + 1
  return sizeof(float) * (size_t(kBQ) * (HD + 1) + size_t(kBK) * (HD + 1) +
                          size_t(kBK) * HD + size_t(kBQ) * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
                 int Hq, int Hkv, int causal, int window, float scale) {
  constexpr int QS = HD + 1;         // row stride of Qs and Ks
  constexpr int PS = kBK + 1;        // row stride of Ps
  constexpr int CD = HD / 16;        // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;
  float* Ps = Vs + kBK * HD;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 15;         // column lane within the row group
  const int r0 = (tid >> 4) * kRows; // first of this thread's rows

  // q tile, scaled in float32; rows past S are zeros and never written
  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    const int s = q0 + r;
    float x = 0.f;
    if (s < S) x = to_f32(q[((size_t(b) * S + s) * Hq + h) * HD + d]) * scale;
    Qs[r * QS + d] = x;
  }

  float m[kRows], l[kRows], acc[kRows][CD];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  for (int k0 = 0; k0 < Tk; k0 += kBK) {
    if (causal && k0 > q_last) break;                       // above the diagonal
    if (window > 0 && k0 + kBK - 1 <= q0 - window) continue; // left of the window
    __syncthreads();  // the previous tile's readers are done (and Qs is in)
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i - r * HD;
      const int t = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (t < Tk) {
        const size_t off = ((size_t(b) * Tk + t) * Hkv + hk) * HD + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      Ks[r * QS + d] = kx;
      Vs[r * HD + d] = vx;
    }
    __syncthreads();

    // scores of rows r0..r0+3 against columns lane + 16 c
    float sc[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(r0 + i) * QS + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(lane + 16 * c) * QS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
    }

    // mask, online softmax update, P to shared memory
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + r0 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + lane + 16 * c;
        ok[c] = kpos < Tk && (!causal || kpos <= qpos) &&
                (window <= 0 || kpos > qpos - window);
        if (ok[c]) mx = fmaxf(mx, sc[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(sc[i][c] - m_new) : 0.f;
        sum += p;
        Ps[(r0 + i) * PS + lane + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // P rows r0..r0+3 are written and read by these 16 lanes

    // acc += P V for rows r0..r0+3, columns lane + 16 j
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows], vv[CD];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(r0 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) vv[j] = Vs[c * HD + lane + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int s = q0 + r0 + i;
    if (s >= S) continue;
    const float lsum = fmaxf(l[i], 1e-30f);
    T* dst = o + ((size_t(b) * S + s) * Hq + h) * HD;
#pragma unroll
    for (int j = 0; j < CD; ++j) dst[lane + 16 * j] = from_f32<T>(acc[i][j] / lsum);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int Tk, int Hq, int Hkv, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, Hq, Hkv, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int Tk, int Hq, int Hkv, int hd,
                        int causal, int window, float scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, Tk, Hq, Hkv, causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, Tk, Hq, Hkv, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, Tk, Hq, Hkv, causal, window, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, S, Tk, Hq, Hkv, causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, S, Hq, hd), k/v (B, T, Hkv, hd), out (B, S, Hq, hd), contiguous;
// dtype 0 = float32, 1 = bfloat16 for all four.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T, int Hq, int Hkv, int hd,
                        int causal, int window, float scale, int dtype,
                        void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 ||
      B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_hd<float>(q, k, v, o, B, S, T, Hq, Hkv, hd, causal, window, scale, st);
    case 1:
      return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, T, Hq, Hkv, hd, causal, window,
                                        scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
