// Flash attention forward (causal / sliding-window / GQA) for Hopper, sm_90a.
//
// flash_attention_fwd replaces the TPU kernel
// repro/kernels/flash_attention.py::_flash_kernel:
//     out = softmax(q k^T / sqrt(hd) + mask) v
// for q (B, S, Hq, hd) and k, v (B, T, Hkv, hd), all contiguous; query head
// h reads kv head h / (Hq / Hkv). The mask is causal (k_pos <= q_pos) and/or
// a window (k_pos > q_pos - window), positions counted from 0 in both q and
// k. The running max m, the running sum l and the accumulator are float32,
// with an online softmax across kv tiles; the output takes q's dtype. Any S
// and T: rows past S are not written, columns past T are masked. Masked
// entries get p = 0 explicitly, so a row whose first visited tile is fully
// masked keeps m = -inf, l = 0 and acc = 0. Kv tiles wholly above the
// diagonal or wholly left of the window are skipped; that is exact, since
// such a tile adds p = 0 and scales by 1.
// Rows that see no key: with a window, query row q >= T + window - 1 has no
// unmasked key (causal or not). The TPU kernel scores every key of such a
// row -1e30, so its softmax is uniform and the row is the mean of v over
// the T keys. Both kernels leave such a row 0 (l = 0); when a launch has
// such rows, the entry point then runs fill_empty_rows over them alone: a
// float32 sum of v[b, t, h / G] over t < T (keys past T never enter it),
// divided by T, rounded once to the output's dtype. A launch whose rows
// all see a key (every serving shape: S = T) runs the attention kernel
// alone, as before. (Computing the mean in the bfloat16 kernel's epilogue
// instead cost 2.6-5% at head dim 128, measured on the H100, even where no
// row needed it: the kernel's register allocation changed.)
//
// What bounds it on the card: operations. A causal prefill of S tokens does
// 4 hd Hq S(S+1)/2 flops on (2 Hkv + 2 Hq) S hd elements, far above the
// H100's ~295 flops per byte in bf16 at any S of the serving path, so the
// bound is the tensor cores' 989 TFLOP/s, reachable only through wgmma.
//
// bfloat16: flash_fwd_wgmma. One CTA of two warpgroups (256 threads) per
// (128 query rows, q head, batch), each warpgroup owning 64 query rows:
//   * loads are TMA (cp.async.bulk.tensor), signalled by mbarriers: the Q
//     tile once, then K and V tiles through a two-stage ring in shared
//     memory, each stage with a "K full" and a "V full" barrier. Thread 0
//     issues Q and the first two stages; after that the last of the 8
//     warps to finish with a stage (a counter in shared memory) issues the
//     stage's next load, so no warp waits for the other warpgroup;
//   * S = Q K^T on wgmma (both operands K-major in shared memory), mask and
//     online softmax on S in registers, then O += P V on wgmma with P
//     converted to bfloat16 and kept in registers (the RS form: the
//     accumulator layout of S is the A-fragment layout of P) and V read
//     MN-major through the instruction's transpose bit;
//   * registers: at hd 256 the 64 x 256 float32 accumulator is 128
//     registers a thread and a warpgroup needs ~210. The register file is
//     split over the SM's four sub-partitions (16,384 registers each), so a
//     CTA of 9-12 warps is held to 168 registers a thread, and ptxas (CUDA
//     12.9) compiles every setmaxnreg region within that launch limit: a
//     separate producer warp or warpgroup would make the consumers spill
//     (measured: 496 B at hd 256, 28 B at hd 128, wgmma serialized). With 8
//     warps the limit is 255, and nothing spills at any hd;
//   * tiles: hd 32/64/128 take 128 kv rows a stage, hd 256 takes 64; shared
//     memory 161 KB at hd 128 and 193 KB at hd 256, under the 232,448 B
//     opt-in limit, so one CTA runs on an SM;
//   * layouts: TMA writes each tile as 64-column chunks (32 at hd 32) of
//     128-byte (64-byte) rows in the hardware's 128B (64B) swizzle, which
//     is the canonical layout the wgmma descriptors name; a K-major k-step
//     advances the descriptor 32 bytes inside the swizzle atom, an MN-major
//     (V) k-step 16 rows. Each k-step's offset is an immediate in the
//     instruction's asm, so no descriptor is held in registers;
//   * the scale is applied in float32 after the product, folded with
//     log2(e) into exp2 (1/sqrt(128) is not a power of two, so q is never
//     rounded to bfloat16 after scaling); the per-element mask runs only
//     on tiles that cross the diagonal, the window edge or T;
//   * the q tiles run heaviest first (the grid's slowest axis counts the
//     causal diagonal down), so the longest CTAs start in the first wave;
//   * TMA zero-fills rows past S and T; the epilogue stages O in the
//     warpgroup's own rows of the Q tile (swizzled as TMA expects) and
//     writes it with a TMA store, which clips rows past S.
// The tensor maps are built on the host for each call with
// cuTensorMapEncodeTiled over the 4-D (B, S|T, H, hd) tensors (a box of
// (1, rows, 1, chunk)) and passed as __grid_constant__ parameters: the
// library links -lcuda, and q, k, v and out must be 16-byte aligned (the
// wrapper checks). A wait that does not complete within ~2 s of SM clock
// traps rather than hanging the card.
// Numerics: P is rounded to bfloat16 for the PV product, which changes each
// term p_j v_j by at most 2^-9 relative, while l sums the float32 p. With
// the output's own rounding the bfloat16 result satisfies
//     |out - exact| <= ulp_bf16(exact) + 2^-8 A(q, k, |v|) + 1e-5,
// exact being float32 attention on the same bfloat16 inputs and A(q, k,
// |v|) float32 attention with |v| in place of v (the 2^-8 leaves a factor
// of two for the score product's float32 accumulation order and exp2).
//
// float32: flash_fwd_simt, the first design of this kernel, kept because
// float32 callers are the correctness paths (the float32 depth cuts with
// TF32 off, the sweep) and the tensor cores take float32 only as TF32,
// which keeps 10 bits of mantissa. One CTA of 256 threads per (64 query
// rows, q head, batch): the TPU kernel's sequential kv grid axis becomes a
// loop inside the CTA, with m, l and the (64 x hd) accumulator in
// registers; each thread owns 4 rows and hd/16 interleaved output columns,
// and the 16 threads that share a row reduce its max and sum with
// shuffles. The q tile is scaled once in float32 and kept in shared memory;
// each 64-row K and V tile is staged in shared memory, rows padded by one
// word against bank conflicts; the products are scalar FMAs. At hd 256 the
// tiles take 213,760 B of shared memory.
//
// hd in {32, 64, 128, 256}. The entry point returns cudaGetLastError()
// after its launch, or kMapError + the driver's code when a tensor map
// cannot be built.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMapError = 100000;

// ---------------------------------------------------------------------------
// float32: the SIMT kernel
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kRows = 4;       // rows per thread

template <int HD>
constexpr size_t simt_smem_bytes() {
  // q tile and K tile rows padded to HD + 1, V tile unpadded, P tile
  // rows padded to kBK + 1
  return sizeof(float) * (size_t(kBQ) * (HD + 1) + size_t(kBK) * (HD + 1) +
                          size_t(kBK) * HD + size_t(kBQ) * (kBK + 1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int S, int Tk,
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
    if (s < S) x = q[((size_t(b) * S + s) * Hq + h) * HD + d] * scale;
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
        kx = k[off];
        vx = v[off];
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
    float* dst = o + ((size_t(b) * S + s) * Hq + h) * HD;
#pragma unroll
    for (int j = 0; j < CD; ++j) dst[lane + 16 * j] = acc[i][j] / lsum;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the warp-specialized wgmma + TMA kernel
// ---------------------------------------------------------------------------

template <int HD>
struct Tile {
  static constexpr int BQ = 128;                   // query rows per CTA
  static constexpr int BK = HD == 256 ? 64 : 128;  // kv rows per stage
  static constexpr int ST = 2;                     // stages of the K/V ring
  static constexpr int CW = HD < 64 ? HD : 64;     // columns of a swizzle chunk
  static constexpr int NCH = HD / CW;              // chunks of a row
  static constexpr int ROWB = 2 * CW;              // bytes of a chunk row
  static constexpr int KPC = CW / 16;              // k16 steps in a chunk
  static constexpr uint32_t Q_CH = BQ * ROWB;      // one chunk of the Q tile
  static constexpr uint32_t KV_CH = BK * ROWB;     // one chunk of a K/V stage
  static constexpr uint32_t Q_BYTES = NCH * Q_CH;
  static constexpr uint32_t KV_BYTES = NCH * KV_CH;
  static constexpr uint32_t OFF_K = Q_BYTES;
  static constexpr uint32_t OFF_V = OFF_K + ST * KV_BYTES;
  static constexpr uint32_t OFF_BAR = OFF_V + ST * KV_BYTES;
  // 1024 B of slack to align the tiles to the 128B swizzle's 1024 B atom;
  // mbarriers: Q full, then K full and V full for each stage; then a
  // release counter for each stage
  static constexpr uint32_t OFF_REL = OFF_BAR + 8 * (1 + 2 * ST);
  static constexpr uint32_t SMEM = 1024 + OFF_REL + 4 * ST;
  // wgmma descriptors: the low word holds the start address and the
  // leading byte offset (16-byte units), the high word the stride byte
  // offset (8 rows of a chunk) and the swizzle mode (1 = 128B, 2 = 64B)
  static constexpr uint32_t SBO = 8 * ROWB;
  static constexpr uint32_t DESC_HI = (SBO >> 4) | ((ROWB == 128 ? 1u : 2u) << 30);
};

// a descriptor's low word at shared address addr: K-major operands (Q, K)
// leave the leading offset at 1, as swizzled K-major layouts ignore it;
// the MN-major V takes one atom (CW columns) an instruction, so its atom
// stride is never used, and both offsets name the 8-row group stride
__device__ __forceinline__ uint32_t desc_lo(uint32_t addr, uint32_t lbo) {
  return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16);
}

constexpr int kWgThreads = 256;  // two consumer warpgroups
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
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of wgmma registers across the
// asynchronous product's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 64) = A (64 x 16) B (16 x 64) [+ D], both K-major in shared
// memory; each descriptor is its low word (a base plus the immediate
// offset, in 16-byte units) and the high word HI
template <uint32_t AOFF, uint32_t BOFF, uint32_t HI>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint32_t a_lo,
                                              uint32_t b_lo, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 al, bl, hi;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %34, 0;\nadd.s32 al, %32, %35;\nadd.s32 bl, %33, %36;\n"
      "mov.b32 hi, %37;\nmov.b64 da, {al, hi};\nmov.b64 db, {bl, hi};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a_lo), "r"(b_lo), "r"(accumulate), "n"(AOFF), "n"(BOFF),
        "n"(HI));
}

// D (64 x 128) = A (64 x 16) B (16 x 128) [+ D], both K-major in shared
// memory; each descriptor is its low word (a base plus the immediate
// offset, in 16-byte units) and the high word HI
template <uint32_t AOFF, uint32_t BOFF, uint32_t HI>
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint32_t a_lo,
                                              uint32_t b_lo, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 al, bl, hi;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %66, 0;\nadd.s32 al, %64, %67;\nadd.s32 bl, %65, %68;\n"
      "mov.b32 hi, %69;\nmov.b64 da, {al, hi};\nmov.b64 db, {bl, hi};\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a_lo), "r"(b_lo), "r"(accumulate), "n"(AOFF), "n"(BOFF),
        "n"(HI));
}

// D (64 x 32) += A (64 x 16, registers) B (16 x 32, MN-major in shared
// memory, transposed by the instruction)
template <uint32_t BOFF, uint32_t HI>
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                              uint32_t b_lo) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 bl, hi;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %23, 0;\nadd.s32 bl, %20, %21;\nmov.b32 hi, %22;\nmov.b64 db, {bl, hi};\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b_lo), "n"(BOFF),
        "n"(HI), "r"(1));
}

// D (64 x 64) += A (64 x 16, registers) B (16 x 64, MN-major in shared
// memory, transposed by the instruction)
template <uint32_t BOFF, uint32_t HI>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint32_t b_lo) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 bl, hi;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %39, 0;\nadd.s32 bl, %36, %37;\nmov.b32 hi, %38;\nmov.b64 db, {bl, hi};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b_lo), "n"(BOFF),
        "n"(HI), "r"(1));
}


// S = Q K^T over hd / 16 k-steps, unrolled at compile time so that every
// descriptor offset is an immediate: a K-major k-step moves 32 B inside a
// chunk row, every KPC steps the next chunk
template <int HD, int J = 0>
__device__ __forceinline__ void qk_product(float* s, uint32_t q_lo,
                                           uint32_t k_lo) {
  using C = Tile<HD>;
  if constexpr (J < HD / 16) {
    constexpr uint32_t qoff = ((J / C::KPC) * C::Q_CH + (J % C::KPC) * 32) >> 4;
    constexpr uint32_t koff = ((J / C::KPC) * C::KV_CH + (J % C::KPC) * 32) >> 4;
    if constexpr (C::BK == 128)
      wgmma_ss_n128<qoff, koff, C::DESC_HI>(s, q_lo, k_lo, J > 0);
    else
      wgmma_ss_n64<qoff, koff, C::DESC_HI>(s, q_lo, k_lo, J > 0);
    qk_product<HD, J + 1>(s, q_lo, k_lo);
  }
}

// O += P V over BK / 16 k-steps x NCH column chunks: k-step j takes S's
// columns 16j..16j+15 of P and moves 16 rows of V; chunk c is the next
// CW output columns
template <int HD, int J = 0>
__device__ __forceinline__ void pv_product(float* o, const uint32_t* p,
                                           uint32_t v_lo) {
  using C = Tile<HD>;
  if constexpr (J < C::BK / 16 * C::NCH) {
    constexpr int j = J / C::NCH, c = J % C::NCH;
    constexpr uint32_t voff = (c * C::KV_CH + j * 16 * C::ROWB) >> 4;
    if constexpr (C::CW == 64)
      wgmma_rs_n64<voff, C::DESC_HI>(o + 32 * c, p + 4 * j, v_lo);
    else
      wgmma_rs_n32<voff, C::DESC_HI>(o + 16 * c, p + 4 * j, v_lo);
    pv_product<HD, J + 1>(o, p, v_lo);
  }
}

// the K and V tiles of kv tile t into stage st (one thread)
template <int HD>
__device__ __forceinline__ void load_kv(const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, uint32_t sk,
                                        uint32_t sv, uint32_t bar_k,
                                        uint32_t bar_v, int st, int k0, int hk,
                                        int b) {
  using C = Tile<HD>;
  mbar_expect_tx(bar_k + 8 * st, C::KV_BYTES);
#pragma unroll
  for (int c = 0; c < C::NCH; ++c)
    tma_load(sk + st * C::KV_BYTES + c * C::KV_CH, tm_k, bar_k + 8 * st,
             c * C::CW, hk, k0, b);
  mbar_expect_tx(bar_v + 8 * st, C::KV_BYTES);
#pragma unroll
  for (int c = 0; c < C::NCH; ++c)
    tma_load(sv + st * C::KV_BYTES + c * C::KV_CH, tm_v, bar_v + 8 * st,
             c * C::CW, hk, k0, b);
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_o, int S, int Tk,
                int Hq, int Hkv, int causal, int window, float scale_log2) {
  using C = Tile<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + C::OFF_K, sv = base + C::OFF_V;
  const uint32_t bar_q = base + C::OFF_BAR;
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * C::ST;
  // releases of each stage, counted by warp: the 8th of a round frees it
  uint32_t* const released = reinterpret_cast<uint32_t*>(
      smem_raw + (base - smem_u32(smem_raw)) + C::OFF_REL);

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::BQ;  // heaviest first
  const int hk = h / (Hq / Hkv);
  // the kv tiles some row of this CTA sees
  const int q_last = min(q0 + C::BQ, S) - 1;
  const int kv_hi = causal ? min(Tk, q_last + 1) : Tk;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t0 = kv_lo / C::BK;
  const int n_kv = max(0, (kv_hi + C::BK - 1) / C::BK - t0);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < C::ST; ++st) {
      mbar_init(bar_k + 8 * st, 1);
      mbar_init(bar_v + 8 * st, 1);
      released[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // the Q tile, and the first stages of the ring
    mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int c = 0; c < C::NCH; ++c)
        tma_load(sq + c * C::Q_CH + g * 64 * C::ROWB, &tm_q, bar_q, c * C::CW,
                 h, q0 + 64 * g, b);
    for (int i = 0; i < C::ST && i < n_kv; ++i)
      load_kv<HD>(&tm_k, &tm_v, sk, sv, bar_k, bar_v, i, (t0 + i) * C::BK, hk,
                  b);
  }
  __syncthreads();

  const int g = threadIdx.x / 128;               // 64 query rows each
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int qb = q0 + 64 * g;                    // first row of this warpgroup
  const int rloc = 16 * warp + (lane >> 2);      // rows rloc and rloc + 8
  const int row0 = qb + rloc;
  const int colq = 2 * (lane & 3);               // column pair in 8 columns
  const uint32_t q_lo = desc_lo(sq + g * 64 * C::ROWB, 16);

  float o[HD / 2];
  float s[C::BK / 2];
  uint32_t p[C::BK / 4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < C::BK / 2; ++i) s[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_kv; ++i) {
    const int st = i % C::ST;
    const uint32_t par = (i / C::ST) & 1;
    const int k0 = (t0 + i) * C::BK;
    // does any row of this warpgroup see a column of this tile?
    const bool live = qb < S && (!causal || k0 <= qb + 63) &&
                      (window <= 0 || k0 + C::BK - 1 > qb - window);
    mbar_wait(bar_k + 8 * st, par);
    if (live) {
      // S = Q K^T, both operands K-major
      fence_regs<C::BK / 2>(s);
      wgmma_fence();
      qk_product<HD>(s, q_lo, desc_lo(sk + st * C::KV_BYTES, 16));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<C::BK / 2>(s);

      // the mask, only on tiles that cross the diagonal, the window's edge
      // or T
      if (k0 + C::BK > Tk || (causal && k0 + C::BK - 1 > qb) ||
          (window > 0 && k0 <= qb + 63 - window)) {
#pragma unroll
        for (int c = 0; c < C::BK / 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * c + colq + (e & 1);
            const int row = row0 + 8 * (e >> 1);
            const bool ok = col < Tk && (!causal || col <= row) &&
                            (window <= 0 || col > row - window);
            if (!ok) s[4 * c + e] = -INFINITY;
          }
      }

      // online softmax in the log2 domain; rows rloc and rloc + 8 are
      // spread over the 4 threads of a quad
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int c = 0; c < C::BK / 8; ++c) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * c], s[4 * c + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * c + 2], s[4 * c + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * scale_log2);
      const float mn1 = fmaxf(m1, mx1 * scale_log2);
      // a row with nothing unmasked yet keeps p = 0 and corr = 0
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float corr0 = ex2(m0 - mu0), corr1 = ex2(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int c = 0; c < C::BK / 8; ++c) {
        const float p0 = ex2(fmaf(s[4 * c], scale_log2, -mu0));
        const float p1 = ex2(fmaf(s[4 * c + 1], scale_log2, -mu0));
        const float p2 = ex2(fmaf(s[4 * c + 2], scale_log2, -mu1));
        const float p3 = ex2(fmaf(s[4 * c + 3], scale_log2, -mu1));
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        p[2 * c] = pack_bf16(p0, p1);
        p[2 * c + 1] = pack_bf16(p2, p3);
      }
      l0 = l0 * corr0 + sum0;  // this thread's part of the row sum
      l1 = l1 * corr1 + sum1;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        o[4 * c] *= corr0;
        o[4 * c + 1] *= corr0;
        o[4 * c + 2] *= corr1;
        o[4 * c + 3] *= corr1;
      }

      // O += P V: P from registers, V MN-major
      mbar_wait(bar_v + 8 * st, par);
      fence_regs<HD / 2>(o);
      wgmma_fence();
      pv_product<HD>(o, p, desc_lo(sv + st * C::KV_BYTES, C::SBO));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<HD / 2>(o);
    } else {
      mbar_wait(bar_v + 8 * st, par);
    }
    // this warp is done with the stage; the last of the 8 warps to say so
    // loads kv tile i + ST into it
    if (lane == 0) {
      __threadfence_block();
      const uint32_t before = atomicAdd(released + st, 1u);
      if (before % 8 == 7 && i + C::ST < n_kv) {
        __threadfence_block();
        load_kv<HD>(&tm_k, &tm_v, sk, sv, bar_k, bar_v, st,
                    (t0 + i + C::ST) * C::BK, hk, b);
      }
    }
    __syncwarp();
  }

  // epilogue: O / l as bfloat16 into this warpgroup's rows of the Q tile
  // (its last product has completed), swizzled as TMA reads it, then one
  // TMA store per chunk, which clips rows past S
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  constexpr uint32_t SWZ = C::ROWB / 16 - 1;
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    const uint32_t chunk = sq + (8 * c / C::CW) * C::Q_CH + g * 64 * C::ROWB;
    const uint32_t cb = 2 * ((8 * c) % C::CW + colq);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t ofs = (rloc + 8 * half) * C::ROWB + cb;
      const uint32_t addr = chunk + (ofs ^ (((ofs >> 7) & SWZ) << 4));
      const float inv = half ? inv1 : inv0;
      const uint32_t val =
          pack_bf16(o[4 * c + 2 * half] * inv, o[4 * c + 2 * half + 1] * inv);
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(val)
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
  if (tid == 0 && qb < S) {
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
      tma_store(&tm_o, sq + c * C::Q_CH + g * 64 * C::ROWB, c * C::CW, h,
                qb, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// rows that see no key
// ---------------------------------------------------------------------------

__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows [first, S) of (b, h): the mean over t < Tk of v[b, t, h / G]; one
// CTA of hd threads per (h, b), one column a thread
template <typename T>
__global__ void fill_empty_rows(const T* __restrict__ v, T* __restrict__ o,
                                int S, int Tk, int Hq, int Hkv, int hd,
                                int first) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int hk = h / (Hq / Hkv);
  const T* col = v + (size_t(b) * Tk * Hkv + hk) * hd + d;
  float sum = 0.f;
#pragma unroll 8
  for (int t = 0; t < Tk; ++t) sum += as_f32(col[size_t(t) * Hkv * hd]);
  const float mean = sum / float(Tk);
  for (int s = first; s < S; ++s)
    store_f32(o + ((size_t(b) * S + s) * Hq + h) * hd + d, mean);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// a 4-D (B, L, H, hd) bfloat16 tensor, boxes of (1, rows, 1, chunk)
CUresult encode_map(CUtensorMap* map, const void* ptr, int hd, int H, int L,
                    int B, int rows) {
  const int cw = hd < 64 ? hd : 64;
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(H), cuuint64_t(L),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(hd) * 2, cuuint64_t(H) * hd * 2,
                                 cuuint64_t(L) * H * hd * 2};
  const cuuint32_t box[4] = {cuuint32_t(cw), 1, cuuint32_t(rows), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int Tk, int Hq, int Hkv, int causal, int window,
                 float scale, cudaStream_t stream) {
  using C = Tile<HD>;
  CUtensorMap mq, mk, mv, mo;
  CUresult r;
  if ((r = encode_map(&mq, q, HD, Hq, S, B, 64)) != CUDA_SUCCESS ||
      (r = encode_map(&mk, k, HD, Hkv, Tk, B, C::BK)) != CUDA_SUCCESS ||
      (r = encode_map(&mv, v, HD, Hkv, Tk, B, C::BK)) != CUDA_SUCCESS ||
      (r = encode_map(&mo, o, HD, Hq, S, B, 64)) != CUDA_SUCCESS)
    return kMapError + int(r);
  auto kern = flash_fwd_wgmma<HD>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(C::SMEM));
  if (err != cudaSuccess) return err;
  const int n_q = (S + C::BQ - 1) / C::BQ;
  if (n_q > 65535) return cudaErrorInvalidValue;
  const dim3 grid(Hq, B, n_q);
  kern<<<grid, kWgThreads, C::SMEM, stream>>>(mq, mk, mv, mo, S, Tk, Hq, Hkv,
                                              causal, window,
                                              scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int HD>
int launch_simt(const void* q, const void* k, const void* v, void* o, int B,
                int S, int Tk, int Hq, int Hkv, int causal, int window,
                float scale, cudaStream_t stream) {
  constexpr size_t smem = simt_smem_bytes<HD>();
  auto kern = flash_fwd_simt<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Tk, Hq, Hkv,
      causal, window, scale);
  return cudaGetLastError();
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tk, int Hq, int Hkv, int causal, int window, float scale,
           int dtype, cudaStream_t stream) {
  if (dtype == 1)
    return launch_wgmma<HD>(q, k, v, o, B, S, Tk, Hq, Hkv, causal, window,
                            scale, stream);
  return launch_simt<HD>(q, k, v, o, B, S, Tk, Hq, Hkv, causal, window, scale,
                         stream);
}

template <int HD>
int wgmma_info(int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, flash_fwd_wgmma<HD>);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = int(attr.localSizeBytes);
  *smem_bytes = int(Tile<HD>::SMEM + attr.sharedSizeBytes);
  return 0;
}

}  // namespace

extern "C" {

// q (B, S, Hq, hd), k/v (B, T, Hkv, hd), out (B, S, Hq, hd), contiguous;
// dtype 0 = float32, 1 = bfloat16 for all four (bfloat16: 16-byte aligned).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T, int Hq, int Hkv, int hd,
                        int causal, int window, float scale, int dtype,
                        void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 ||
      B > 65535 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (hd) {
    case 32:
      err = launch<32>(q, k, v, o, B, S, T, Hq, Hkv, causal, window, scale, dtype, st);
      break;
    case 64:
      err = launch<64>(q, k, v, o, B, S, T, Hq, Hkv, causal, window, scale, dtype, st);
      break;
    case 128:
      err = launch<128>(q, k, v, o, B, S, T, Hq, Hkv, causal, window, scale, dtype, st);
      break;
    case 256:
      err = launch<256>(q, k, v, o, B, S, T, Hq, Hkv, causal, window, scale, dtype, st);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  // the first row that sees no key
  const long long first = window > 0 ? (long long)T + window - 1 : S;
  if (err != 0 || first >= S) return err;
  const dim3 grid(Hq, B);
  if (dtype == 1)
    fill_empty_rows<__nv_bfloat16><<<grid, hd, 0, st>>>(
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        S, T, Hq, Hkv, hd, int(first));
  else
    fill_empty_rows<float><<<grid, hd, 0, st>>>(
        static_cast<const float*>(v), static_cast<float*>(o), S, T, Hq, Hkv,
        hd, int(first));
  return cudaGetLastError();
}

// the bfloat16 kernel's registers a thread, local memory a thread (spills)
// and shared memory a CTA, for head dim hd
int flash_attention_wgmma_info(int hd, int* regs, int* local_bytes,
                               int* smem_bytes) {
  switch (hd) {
    case 32: return wgmma_info<32>(regs, local_bytes, smem_bytes);
    case 64: return wgmma_info<64>(regs, local_bytes, smem_bytes);
    case 128: return wgmma_info<128>(regs, local_bytes, smem_bytes);
    case 256: return wgmma_info<256>(regs, local_bytes, smem_bytes);
    default: return cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int code) {
  if (code >= kMapError) {
    static char buf[160];
    const char* msg = nullptr;
    if (cuGetErrorString(static_cast<CUresult>(code - kMapError), &msg) !=
            CUDA_SUCCESS || msg == nullptr)
      msg = "unknown driver error";
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed: %s", msg);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
