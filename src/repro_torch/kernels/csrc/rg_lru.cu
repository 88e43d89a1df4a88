// RG-LRU diagonal linear recurrence for Hopper, sm_90a.
//
// rglru_scan_fwd replaces the TPU kernel
// repro/kernels/rg_lru.py::_rglru_kernel:
//     h_t = a_t * h_{t-1} + b_t      (elementwise over the width W)
// for a, b (B, L, W) and h_{-1} = h0 (B, W), all contiguous. It writes
// h (B, L, W) and h_last (B, W) in float32, taking float32 or bfloat16 a
// and b (both of one dtype) and a float32 h0. Any B, L and W: nothing has
// to divide anything, whereas the TPU kernel shrinks its blocks until they
// divide the shape.
//
// What bounds it on the card: bytes. Each step of each column reads a_t and
// b_t and writes h_t, with one multiply and one add between them, so at the
// serving path's (1, 2047, 4096) float32 it moves 100.6 MB (30.0 us at
// 3.35 TB/s) for 16.8 M operations. The TPU kernel's sequential time-chunk
// grid axis becomes a loop inside each thread; its width tiles, which run
// in parallel, become the columns of the grid. The design:
//   * one thread per column (b, w), walking L in order with h in a
//     register; 32 columns per CTA (one warp), so that at B = 1 the 4096
//     columns of recurrentgemma spread over 128 of the 132 SMs. Loads and
//     stores of one step are coalesced across the warp's consecutive w;
//   * the time loop runs in blocks of kSteps steps, software-pipelined: the
//     next block's a and b are loaded into registers while the current
//     block's dependent chain runs, so each warp keeps 2 x kSteps loads in
//     flight instead of waiting out one memory latency per step. With only
//     B x W columns in all, this is the only source of memory parallelism;
//     a chunked scan across L (per-chunk products, a carry pass, a fix-up
//     pass) would add more, at the cost of reading a and b twice;
//   * each step is a multiply and then an add, each rounded (__fmul_rn,
//     __fadd_rn, never contracted to an FMA), which is exactly what the
//     plain PyTorch version (ref.reference_rglru) computes, so the two agree
//     bit for bit.
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;   // columns (threads) per CTA
constexpr int kSteps = 32;  // time steps per pipelined block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ void load_block(const T* __restrict__ a, const T* __restrict__ b,
                                           size_t base, int t0, int L, int W,
                                           float* ra, float* rb) {
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int t = t0 + u;
    if (t < L) {
      const size_t off = base + size_t(t) * W;
      ra[u] = to_f32(a[off]);
      rb[u] = to_f32(b[off]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kCols)
rglru_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 const float* __restrict__ h0, float* __restrict__ h,
                 float* __restrict__ h_last, int B, int L, int W) {
  const long long col = (long long)blockIdx.x * kCols + threadIdx.x;
  if (col >= (long long)B * W) return;
  const int bi = int(col / W);
  const int w = int(col - (long long)bi * W);
  const size_t base = size_t(bi) * L * W + w;   // element (bi, 0, w)

  float hv = h0[col];
  float ca[kSteps], cb[kSteps], na[kSteps], nb[kSteps];
  load_block(a, b, base, 0, L, W, ca, cb);
  for (int t0 = 0; t0 < L; t0 += kSteps) {
    // issue the next block's loads before the current block's chain
    load_block(a, b, base, t0 + kSteps, L, W, na, nb);
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int t = t0 + u;
      if (t < L) {
        hv = __fadd_rn(__fmul_rn(ca[u], hv), cb[u]);
        h[base + size_t(t) * W] = hv;
      }
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
  h_last[col] = hv;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const void* h0, void* h,
                   void* h_last, int B, int L, int W, cudaStream_t stream) {
  const long long cols = (long long)B * W;
  const long long blocks = (cols + kCols - 1) / kCols;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rglru_fwd_kernel<T><<<unsigned(blocks), kCols, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_last), B, L, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a, b (B, L, W) of dtype 0 = float32 or 1 = bfloat16; h0 (B, W) float32;
// h (B, L, W) and h_last (B, W) float32; all contiguous. L may be 0 (h_last
// is then h0).
int rglru_scan_fwd(const void* a, const void* b, const void* h0, void* h,
                   void* h_last, int B, int L, int W, int dtype, void* stream) {
  if (B <= 0 || L < 0 || W <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(a, b, h0, h, h_last, B, L, W, st);
    case 1:
      return launch<__nv_bfloat16>(a, b, h0, h, h_last, B, L, W, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* rglru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
