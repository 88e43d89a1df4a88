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
// grid axis becomes a loop over L inside each CTA; its width tiles, which
// run in parallel, become the CTAs of the grid. The dependent chain is not
// the limit: a multiply then an add, ~8 clocks a step, 2,047 steps ~9 us.
// What is scarce is memory parallelism: at B = 1 there are only 4,096
// columns, and HBM3 needs ~18 KB in flight on each SM to run at its rate.
// So the walk stays sequential (and bit for bit the plain version's) and
// is fed from a deep ring in shared memory.
//
// Two paths, chosen by shape in the Python wrapper (kernels/rg_lru.py
// rglru_scan_fwd), not by retrying after a failure:
//
//   * rglru_tma_kernel, when L > 0, B <= 65535 (the grid's y), a row of a
//     and b is a multiple of 16 bytes (W % 4 == 0 for float32, W % 8 == 0
//     for bfloat16) and a and b start 16-byte aligned, as TMA requires.
//     One CTA of one warp owns a tile of 128-byte rows (32 float32 or 64
//     bfloat16 columns) of one batch row and walks all of L. Lane 0 keeps
//     a ring of kStages stages of kTS steps x the tile of a and of b in
//     flight (cp.async.bulk.tensor on 3-D tensor maps over (B, L, W),
//     signalled by one mbarrier a stage): 8 stages of 8 KB, 64 KB a CTA.
//     The warp walks each stage from shared memory in order, one column
//     (two for bfloat16) a lane, stores h_t straight to device memory (128
//     or 256 contiguous bytes a step), and lane 0 refills the stage with
//     the steps kStages stages ahead. Three CTAs fit on an SM, so B = 3 at
//     W = 4096 (384 tiles) runs in one wave on 132 SMs. TMA zero-fills
//     columns past W and steps past L; neither is stored;
//   * rglru_cols_kernel, every other shape (the first design): one thread
//     per column (b, w) walking L with h in a register, 32 columns a CTA;
//     the time loop runs in blocks of kSteps steps, the next block's loads
//     issued into registers while the current block's chain runs.
//
// Both compute each step as a multiply and then an add, each rounded
// (__fmul_rn, __fadd_rn, never contracted to an FMA), which is exactly what
// the plain PyTorch version (ref.reference_rglru) computes, so the two
// agree bit for bit. The tensor maps are built on the host for each call
// with the CUDA driver's cuTensorMapEncodeTiled (the library links -lcuda)
// and passed as __grid_constant__ parameters. A wait that outlasts ~2 s of
// SM clock traps instead of hanging the card. Each entry point returns
// cudaGetLastError() after its launch, or kMapError + the CUDA driver's
// code when a tensor map cannot be built.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kMapError = 100000;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// the TMA ring
// ---------------------------------------------------------------------------

constexpr int kTS = 32;                                // steps a stage
constexpr int kStages = 8;                             // stages of the ring
constexpr int kRowBytes = 128;                         // one step of a tile
constexpr uint32_t kHalf = kTS * kRowBytes;            // a's (or b's) part
constexpr uint32_t kStageBytes = 2 * kHalf;            // 8 KB
constexpr uint32_t kRingBytes = kStages * kStageBytes; // 64 KB
constexpr uint32_t kSmem = 128 + kRingBytes + 8 * kStages;
constexpr long long kWaitLimit = 4000000000LL;         // SM clocks, ~2 s

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// wait for the phase of parity `parity` to complete; trap after kWaitLimit
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > kWaitLimit) __trap();
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2)
      : "memory");
}

// steps [kTS i, kTS i + kTS) of a and b into stage i % kStages (lane 0)
__device__ __forceinline__ void load_stage(const CUtensorMap* tm_a,
                                           const CUtensorMap* tm_b,
                                           uint32_t ring, uint32_t bars,
                                           int i, int w0, int bi) {
  const int st = i % kStages;
  const uint32_t bar = bars + 8 * st, dst = ring + st * kStageBytes;
  mbar_expect_tx(bar, kStageBytes);
  tma_load(dst, tm_a, bar, w0, i * kTS, bi);
  tma_load(dst + kHalf, tm_b, bar, w0, i * kTS, bi);
}

// one step of this lane's columns: float32 one column, bfloat16 two
__device__ __forceinline__ void walk_step(const float* sa, const float* sb,
                                          int lane, float* hv, float* dst,
                                          bool store) {
  hv[0] = __fadd_rn(__fmul_rn(sa[lane], hv[0]), sb[lane]);
  if (store) *dst = hv[0];
}

__device__ __forceinline__ void walk_step(const __nv_bfloat16* sa,
                                          const __nv_bfloat16* sb, int lane,
                                          float* hv, float* dst, bool store) {
  const float2 a = __bfloat1622float2(
      reinterpret_cast<const __nv_bfloat162*>(sa)[lane]);
  const float2 b = __bfloat1622float2(
      reinterpret_cast<const __nv_bfloat162*>(sb)[lane]);
  hv[0] = __fadd_rn(__fmul_rn(a.x, hv[0]), b.x);
  hv[1] = __fadd_rn(__fmul_rn(a.y, hv[1]), b.y);
  if (store) *reinterpret_cast<float2*>(dst) = make_float2(hv[0], hv[1]);
}

template <typename T>
__global__ void __launch_bounds__(32)
rglru_tma_kernel(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_b,
                 const float* __restrict__ h0, float* __restrict__ h,
                 float* __restrict__ h_last, int L, int W) {
  constexpr int CW = kRowBytes / sizeof(T);   // columns of the tile
  constexpr int PER = CW / 32;                // columns of a lane
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 127u) & ~127u;
  const uint8_t* ring_ptr = smem_raw + (ring - raw);
  const uint32_t bars = ring + kRingBytes;
  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * CW, bi = blockIdx.y;
  const int n_st = (L + kTS - 1) / kTS;

  if (lane == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kStages && i < n_st; ++i)
      load_stage(&tm_a, &tm_b, ring, bars, i, w0, bi);
  }
  __syncwarp();

  const int wc = w0 + PER * lane;             // this lane's first column
  const bool mine = wc < W;                   // W % PER == 0
  float hv[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) hv[p] = mine ? h0[size_t(bi) * W + wc + p] : 0.f;
  float* hrow = h + size_t(bi) * L * W + wc;

  for (int i = 0; i < n_st; ++i) {
    const int st = i % kStages;
    mbar_wait(bars + 8 * st, (i / kStages) & 1);
    const T* sa = reinterpret_cast<const T*>(ring_ptr + st * kStageBytes);
    const T* sb = reinterpret_cast<const T*>(ring_ptr + st * kStageBytes + kHalf);
    const int t0 = i * kTS;
    float* dst = hrow + size_t(t0) * W;
    if (t0 + kTS <= L) {
#pragma unroll
      for (int u = 0; u < kTS; ++u)
        walk_step(sa + u * CW, sb + u * CW, lane, hv, dst + size_t(u) * W,
                  mine);
    } else {
      for (int u = 0; u < L - t0; ++u)
        walk_step(sa + u * CW, sb + u * CW, lane, hv, dst + size_t(u) * W,
                  mine);
    }
    // every lane has consumed the stage: refill it kStages stages ahead
    __syncwarp();
    if (lane == 0 && i + kStages < n_st) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load_stage(&tm_a, &tm_b, ring, bars, i + kStages, w0, bi);
    }
  }
  if (mine) {
#pragma unroll
    for (int p = 0; p < PER; ++p) h_last[size_t(bi) * W + wc + p] = hv[p];
  }
}

// a (B, L, W) tensor of float32 or bfloat16, boxes of (1, kTS, 128 bytes)
CUresult encode_map(CUtensorMap* map, const void* ptr, int B, int L, int W,
                    int dtype) {
  const cuuint64_t es = dtype == 0 ? 4 : 2;
  const cuuint64_t dims[3] = {cuuint64_t(W), cuuint64_t(L), cuuint64_t(B)};
  const cuuint64_t strides[2] = {cuuint64_t(W) * es, cuuint64_t(L) * W * es};
  const cuuint32_t box[3] = {cuuint32_t(kRowBytes / es), cuuint32_t(kTS), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename T>
int launch_tma(const void* a, const void* b, const void* h0, void* h,
               void* h_last, int B, int L, int W, int dtype,
               cudaStream_t stream) {
  CUtensorMap ma, mb;
  CUresult r;
  if ((r = encode_map(&ma, a, B, L, W, dtype)) != CUDA_SUCCESS ||
      (r = encode_map(&mb, b, B, L, W, dtype)) != CUDA_SUCCESS)
    return kMapError + int(r);
  auto kern = rglru_tma_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return err;
  constexpr int CW = kRowBytes / sizeof(T);
  const dim3 grid((W + CW - 1) / CW, B);
  kern<<<grid, 32, kSmem, stream>>>(ma, mb, static_cast<const float*>(h0),
                                    static_cast<float*>(h),
                                    static_cast<float*>(h_last), L, W);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// one thread per column, for the shapes TMA does not take
// ---------------------------------------------------------------------------

constexpr int kCols = 32;   // columns (threads) per CTA
constexpr int kSteps = 32;  // time steps per pipelined block

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
rglru_cols_kernel(const T* __restrict__ a, const T* __restrict__ b,
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
int launch_cols(const void* a, const void* b, const void* h0, void* h,
                void* h_last, int B, int L, int W, cudaStream_t stream) {
  const long long cols = (long long)B * W;
  const long long blocks = (cols + kCols - 1) / kCols;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rglru_cols_kernel<T><<<unsigned(blocks), kCols, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_last), B, L, W);
  return cudaGetLastError();
}

template <typename T>
int tma_info(int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, rglru_tma_kernel<T>);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = int(attr.localSizeBytes);
  *smem_bytes = int(kSmem + attr.sharedSizeBytes);
  return 0;
}

}  // namespace

extern "C" {

// a, b (B, L, W) of dtype 0 = float32 or 1 = bfloat16; h0 (B, W) float32;
// h (B, L, W) and h_last (B, W) float32; all contiguous. L may be 0 (h_last
// is then h0). path 1 is the TMA ring, which takes L > 0, B <= 65535,
// W * sizeof(a) a multiple of 16 and 16-byte aligned a and b (refused
// otherwise, never replaced); path 0 the kernel of one thread per column,
// any shape.
int rglru_scan_fwd(const void* a, const void* b, const void* h0, void* h,
                   void* h_last, int B, int L, int W, int dtype, int path,
                   void* stream) {
  if (B <= 0 || L < 0 || W <= 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    const int es = dtype == 0 ? 4 : 2;
    if (L == 0 || (W * es) % 16 != 0 || B > 65535 ||
        reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(b) % 16 != 0)
      return cudaErrorInvalidValue;
    return dtype == 0
               ? launch_tma<float>(a, b, h0, h, h_last, B, L, W, dtype, st)
               : launch_tma<__nv_bfloat16>(a, b, h0, h, h_last, B, L, W,
                                           dtype, st);
  }
  if (path != 0) return cudaErrorInvalidValue;
  return dtype == 0
             ? launch_cols<float>(a, b, h0, h, h_last, B, L, W, st)
             : launch_cols<__nv_bfloat16>(a, b, h0, h, h_last, B, L, W, st);
}

// the TMA kernel's registers a thread, local memory a thread (spills) and
// shared memory a CTA, for a and b of dtype 0 = float32 or 1 = bfloat16
int rglru_tma_info(int dtype, int* regs, int* local_bytes, int* smem_bytes) {
  if (dtype == 0) return tma_info<float>(regs, local_bytes, smem_bytes);
  if (dtype == 1) return tma_info<__nv_bfloat16>(regs, local_bytes, smem_bytes);
  return cudaErrorInvalidValue;
}

const char* rglru_error_string(int code) {
  if (code >= kMapError) {
    static char buf[160];
    const char* msg = nullptr;
    if (cuGetErrorString(static_cast<CUresult>(code - kMapError), &msg) !=
            CUDA_SUCCESS || msg == nullptr)
      msg = "unknown CUDA driver error";
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed: %s", msg);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
