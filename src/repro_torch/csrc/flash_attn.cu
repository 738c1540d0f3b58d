// Causal or full GQA flash attention forward for Hopper (sm_90a), bf16 on
// the tensor cores or fp32 on the CUDA cores, fp32 online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn/flash_attn.py:83
// flash_attn_pallas (_fa_kernel :28). The TPU grid (b, h, q block, kv block)
// walked the kv blocks sequentially with the running max, denominator and
// accumulator in VMEM scratch. Blocks of a CUDA grid run in no order, so the
// kv walk becomes a loop inside one block per (q tile, head, batch) that
// carries the state itself. The kv head of query head h is h / G; no K/V
// replication materializes.
//
// Semantics (the JAX kernel's, with its blocks free): scores are q.k times
// 1/sqrt(hd); with `causal`, kv position t is visible to query position s
// iff t <= s (and s - t < window when a window is set), and whole kv tiles
// that no row of the q tile can see are skipped; masked scores are the
// finite -1e30, so a tile that is fully masked for a row before any visible
// key leaves 1s that the first visible key's rescale (exp(-1e30 - m) = 0)
// wipes. kv positions >= T are never visible (the TPU wrapper's zero pad
// keys were visible to query rows >= T when S > T; this kernel follows the
// documented contract instead). A row that sees no key at all (only when
// S > T + window - 1) is written as zeros. Output acc / max(l, 1e-30) in
// q's dtype.
//
// What bounds it on the card: operations. At S = T = 4096, 32 heads of
// hd 128, causal, the work is ~1.4e11 flops against ~0.1 GB of q/k/v/out,
// far right of the H100's ridge, and the card's operations rate lives in
// the bf16 tensor cores, which only wgmma reaches. Two entry points, picked
// by the wrapper from dtype, hd, contiguity and alignment before the launch:
//
// flash_attn_tc (bf16, hd 128, contiguous, 16-byte aligned bases): one
// block per (128-row q tile, head, batch), q tiles longest-first under
// causality (all heads' longest tiles before any shorter one). A producer
// thread loads the block's q tile once and keeps a ring of kStages K/V
// stages full by TMA: 4-D tensor maps over (hd, head, position, batch), so a
// tile never crosses a batch, and 128-byte-swizzled boxes of 64 columns (two
// per hd 128); K and V of a stage complete on separate mbarriers, so QK^T
// starts before V lands. TMA fills positions past T (or S) with zeros, and
// keys at positions >= T are masked (a zero key would score 0, not -1e30).
// Two consumer warpgroups own 64 q rows each (registers rebalanced with
// setmaxnreg: 40 for the producer, 232 for them):
//   - S = Q K^T by wgmma.mma_async m64nBKVk16, both operands from shared
//     memory, K-major (K is [kv, hd], hd contiguous: B not transposed);
//   - the online softmax in fp32 on the accumulator fragment in registers:
//     row max over the 4 lanes that share a row by shuffles, exp2 with
//     1/sqrt(hd) * log2(e) folded into the scale, the mask applied only on
//     diagonal, window-edge and last-T tiles, tiles no row of the warpgroup
//     sees skipped (their stage still released), the denominator kept per
//     lane and summed over the row's lanes once, at the end;
//   - P rounded to bf16 (as SDPA's flash path rounds it) goes into wgmma as
//     the register A operand: the fp32 accumulator layout of S's columns
//     16j..16j+15 is the A-fragment layout of the j-th k16 step, so P never
//     touches shared memory; V ([kv, hd], hd contiguous) is the N-major
//     (transposed) B, as ragged_linear_tc reads w; O is rescaled by the
//     row's alpha before each PV;
//   - the epilogue writes O / max(l, 1e-30) in bf16, rows >= S not stored,
//     and a row that saw no key (m still -1e30) as exact zeros.
// Left for later work: overlapping one warpgroup's softmax with its next
// QK^T, ping-pong scheduling between the two warpgroups, and a persistent
// grid over the q tiles.
//
// flash_attn (fp32, where wgmma would compute in TF32; and bf16 at every
// head dim but 128, which the tensor-core entry does not take: stablelm-12b's
// 160, whisper-small's 64): every hd that is a multiple of 16 up to 256, one
// compile-time instance each, 64 x 64 tiles on the CUDA cores in fp32, 256
// threads each owning 4 query rows x 4 kv columns of the scores and 4 rows x
// 4 columns of each 64-column chunk of the output (where hd is no multiple
// of 64 the last chunk is partial, e.g. half wide at 160: only the threads
// whose columns exist own it), the max and
// denominator of each row in registers
// (replicated over the 16 threads that share the row), the probabilities
// through shared memory, 16-byte shared-memory reads on padded rows,
// 16-byte global loads, K and V sharing one buffer so two blocks fit an SM,
// q tiles issued longest-first under causality.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kBQ = 64, kBKV = 64, kThreads = 256;
constexpr int kLdP = kBKV + 4;  // probability rows, 16-byte aligned

template <typename T> struct Vec;  // elements in one 16-byte load
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void widen(const uint4& raw, float* out, float) {
  const float4 f = *reinterpret_cast<const float4*>(&raw);
  out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
}

__device__ __forceinline__ void widen(const uint4& raw, float* out, __nv_bfloat16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows x HD elements (row r at src + r * stride) into dst[r * (HD + 4)] as
// float; rows >= n_valid are zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t stride,
                                          int rows, int n_valid) {
  constexpr int N = Vec<T>::N, kPerRow = HD / N, kLd = HD + 4;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i - r * kPerRow) * N;
    float vals[N];
    if (r < n_valid) {
      widen(*reinterpret_cast<const uint4*>(src + r * stride + c), vals, T());
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; e += 4)
      *reinterpret_cast<float4*>(dst + r * kLd + c + e) =
          make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
  }
}

template <typename E, int HD>
__global__ void __launch_bounds__(kThreads) flash_attn_kernel(
    const E* __restrict__ q,  // [B, S, H, HD]
    const E* __restrict__ k,  // [B, T, K, HD]
    const E* __restrict__ v,  // [B, T, K, HD]
    E* __restrict__ out,      // [B, S, H, HD]
    int S, int T, int H, int K, int causal, int window, float scale) {
  // output column chunks of 64, each thread 4 adjacent columns of each; a
  // last partial chunk (HD 160: columns 128..159) is taken by the threads
  // whose columns exist
  constexpr int kLd = HD + 4, kOC = (HD + 63) / 64;
  static_assert(HD % 16 == 0, "rows of 16-byte loads and 4-column groups");
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [kBQ][kLd]
  float* kv_s = q_s + kBQ * kLd;     // [kBKV][kLd], K then V of each tile
  float* p_s = kv_s + kBKV * kLd;    // [kBQ][kLdP]
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / K);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  load_tile<E, HD>(q_s, q + (((size_t)b * S + q0) * H + h) * HD, (size_t)H * HD, kBQ,
                   min(kBQ, S - q0));
  float m[4], l[4], acc[4][kOC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }
  const E* kb = k + ((size_t)b * T * K + kh) * HD;
  const E* vb = v + ((size_t)b * T * K + kh) * HD;
  const size_t kv_stride = (size_t)K * HD;

  for (int t0 = 0; t0 < T; t0 += kBKV) {
    if (causal) {  // block pruning, uniform over the block
      if (t0 > q0 + kBQ - 1) break;
      if (window && t0 + kBKV <= q0 - window + 1) continue;
    }
    const int n_t = min(kBKV, T - t0);
    __syncthreads();  // q_s loaded / previous tile's V and p_s consumed
    load_tile<E, HD>(kv_s, kb + (size_t)t0 * kv_stride, kv_stride, kBKV, n_t);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(q_s + (ty * 4 + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(kv_s + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = t0 + tx + 16 * j;
        bool ok = kp < T;
        if (causal) ok = ok && qp >= kp && (window == 0 || qp - kp < window);
        s[i][j] = ok ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[(ty * 4 + i) * kLdP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();  // every thread is done with K
    load_tile<E, HD>(kv_s, vb + (size_t)t0 * kv_stride, kv_stride, kBKV, n_t);
    __syncthreads();

#pragma unroll 2
    for (int t = 0; t < kBKV; t += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(p_s + (ty * 4 + i) * kLdP + t);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < kOC; ++c) {
          if (HD % 64 && c == kOC - 1 && tx * 4 >= HD % 64) continue;  // past HD
          const float4 va =
              *reinterpret_cast<const float4*>(kv_s + (t + u) * kLd + c * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y : u == 2 ? pa[i].z : pa[i].w;
            acc[i][c][0] = fmaf(p, va.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p, va.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p, va.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p, va.w, acc[i][c][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const bool seen = m[i] != kNeg;  // some key was visible to this row
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    E* o = out + (((size_t)b * S + qp) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < kOC; ++c) {
      if (HD % 64 && c == kOC - 1 && tx * 4 >= HD % 64) continue;  // past HD
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[c * 64 + tx * 4 + e] = from_f<E>(seen ? acc[i][c][e] * inv : 0.f);
    }
  }
}

template <typename E, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int T,
           int H, int K, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(kBQ + kBKV) * (HD + 4) + kBQ * kLdP);
  auto kernel = flash_attn_kernel<E, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<E*>(out), S, T, H, K, causal, window, scale);
  return (int)cudaGetLastError();
}


namespace tc {

using namespace hopper;

constexpr int kBQ = 128;           // q rows per block: two warpgroups of 64
constexpr int kHd = 128;           // the one head dim built
constexpr int kBox = 64;           // columns per TMA box: 128 bytes, the swizzle span
constexpr int kConsumers = 2;      // warpgroups, 64 q rows each
constexpr int kThreads = (kConsumers + 1) * 128;
// kv rows per tile and stages of the K/V ring: kv 128 beats 64 by 10-15%
// and a third stage buys nothing (tools/kernel_sweeps.py)
constexpr int kBKV = 128, kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTensorMapError = 100001;

// shared-memory layout: the q tile (two boxes), then per stage K then V
// (two boxes each), then the barriers; every box starts on 1024 bytes, where
// the 128-byte swizzle pattern repeats
template <int BKV, int STAGES>
struct Layout {
  static constexpr int kQBox = kBQ * kBox * 2;   // 16 KB
  static constexpr int kKVBox = BKV * kBox * 2;
  static constexpr int kQ = 2 * kQBox;
  static constexpr int kKV = 2 * kKVBox;         // one K or V tile
  static constexpr int kStage = 2 * kKV;
  static constexpr int kBars = 1 + 3 * STAGES;   // q, then full K, full V, empty
  static constexpr int kBytes = kQ + STAGES * kStage + kBars * 8 + 1024;
};

// 4-D TMA load of the box at (c0 innermost, c1, c2, c3) into dst,
// completing on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// as fence_acc, for the P fragments wgmma reads from registers
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D[64 x BKV] (+)= A[64 x 16] * B[16 x BKV], both from shared memory, both
// K-major (B not transposed): S = Q K^T with K stored [kv, hd]
template <int BKV>
__device__ __forceinline__ void wgmma_ss(float (&d)[BKV / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (BKV == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63},"
        " %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    static_assert(BKV == 64, "kv tiles of 64 or 128 rows");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// D[64 x 128] += A[64 x 16] * B[16 x 128]: A from registers (four bf16x2
// per thread, the accumulator's layout), B from shared memory N-major
// (transposed): O += P V with V stored [kv, hd]
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <int BKV, int STAGES>
__global__ void __launch_bounds__(kThreads, 1) flash_attn_tc_kernel(
    const __grid_constant__ CUtensorMap map_q,  // q [B, S, H, hd], box 64 x 1 x kBQ x 1
    const __grid_constant__ CUtensorMap map_k,  // k [B, T, K, hd], box 64 x 1 x BKV x 1
    const __grid_constant__ CUtensorMap map_v,  // v, as k
    __nv_bfloat16* __restrict__ out,            // [B, S, H, hd]
    int S, int T, int H, int K, int causal, int window, float scale_log2) {
  using L = Layout<BKV, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* q_s = smem;
  uint8_t* kv_s = smem + L::kQ;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(kv_s + STAGES * L::kStage);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // longest causal rows first
  const int kh = h / (H / K);
  // the keys [t_lo, t_hi) some row of the tile may see, as whole kv tiles
  int t_lo = 0, t_hi = T;
  if (causal) {
    t_hi = min(T, q0 + kBQ);
    if (window) t_lo = max(0, q0 - window + 1);
  }
  const int first = t_lo / BKV;
  const int n_tiles = t_hi > t_lo ? (t_hi - 1) / BKV - first + 1 : 0;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      mbar_expect_tx(bar_q, L::kQ);  // out-of-bounds fill counts too
      tma_load_4d(q_s, &map_q, bar_q, 0, h, q0, b);
      tma_load_4d(q_s + L::kQBox, &map_q, bar_q, kBox, h, q0, b);
      int s = 0, ph = 0;
      for (int i = 0; i < n_tiles; ++i) {
        const int t0 = (first + i) * BKV;
        mbar_wait(&empty[s], ph ^ 1);
        uint8_t* st = kv_s + s * L::kStage;
        mbar_expect_tx(&full_k[s], L::kKV);
        tma_load_4d(st, &map_k, &full_k[s], 0, kh, t0, b);
        tma_load_4d(st + L::kKVBox, &map_k, &full_k[s], kBox, kh, t0, b);
        mbar_expect_tx(&full_v[s], L::kKV);
        tma_load_4d(st + L::kKV, &map_v, &full_v[s], 0, kh, t0, b);
        tma_load_4d(st + L::kKV + L::kKVBox, &map_v, &full_v[s], kBox, kh, t0, b);
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: q rows [q0 + 64 wg, q0 + 64 wg + 64). Thread
  // (warp, lane) holds rows r and r + 8 of the accumulators, columns
  // 8j + c + {0, 1}: element 4j + e is row r + 8 (e / 2), column 8j + c + e % 2
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = tid / 32, lane = tid % 32;
  const int wq_lo = q0 + wg * 64, wq_hi = wq_lo + 63;
  const int r = wq_lo + warp * 16 + lane / 4, c = 2 * (lane % 4);
  const uint8_t* qa = q_s + wg * 64 * (kBox * 2);  // this warpgroup's rows of each q box
  float o[kHd / 2], sc[BKV / 2];
#pragma unroll
  for (int i = 0; i < kHd / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // l: this lane's columns only
  mbar_wait(bar_q, 0);

  int s = 0, ph = 0;
  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = (first + i) * BKV;
    const uint8_t* st = kv_s + s * L::kStage;
    const bool skip = causal && (t0 > wq_hi || (window && t0 + BKV - 1 < wq_lo - window + 1));
    mbar_wait(&full_k[s], ph);
    uint32_t p[BKV / 4];
    if (!skip) {
      fence_acc(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk) {
        // +32 bytes per 16 columns inside the swizzled 128-byte rows, the
        // next 64 columns one box on; 8-row groups 1024 bytes apart
        const int box = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<BKV>(sc, desc(qa + box * L::kQBox + off, 16, 1024),
                      desc(st + box * L::kKVBox + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);

      // the mask only where the tile holds a key past T, past the
      // diagonal or past the window's edge for some row of the warpgroup
      const bool edge = t0 + BKV > T ||
                        (causal && (t0 + BKV - 1 > wq_lo || (window && t0 < wq_hi - window + 1)));
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (edge) {
            const int t = t0 + 8 * j + c + (e & 1), q = r + 8 * (e >> 1);
            const bool ok = t < T && (!causal || (t <= q && (window == 0 || q - t < window)));
            x = ok ? x : kNeg;
          }
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        alpha[hr] = ex2(m[hr] - mx[hr]);
        m[hr] = mx[hr];
        l[hr] *= alpha[hr];
      }
#pragma unroll
      for (int k2 = 0; k2 < BKV / 4; ++k2) {  // elements 2 k2, 2 k2 + 1: row r + 8 (k2 % 2)
        const float p0 = ex2(sc[2 * k2] - m[k2 % 2]), p1 = ex2(sc[2 * k2 + 1] - m[k2 % 2]);
        l[k2 % 2] += p0 + p1;
        p[k2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int j = 0; j < kHd / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
    }
    mbar_wait(&full_v[s], ph);
    if (!skip) {
      fence_acc(o);
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        // V rows 16 kk..16 kk + 15: +16 rows of 128 bytes per k16, 8-row
        // groups 1024 bytes apart, the next 64 columns one box on
        wgmma_rs_n128(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                      desc(st + L::kKV + kk * 16 * 128, L::kKVBox, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
    }
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == STAGES) {
      s = 0;
      ph ^= 1;
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int q = r + 8 * hr;
    if (q >= S) continue;
    const bool seen = m[hr] != kNeg;  // some key was visible to this row
    const float inv = 1.f / fmaxf(l[hr], 1e-30f);
    __nv_bfloat16* orow = out + (((size_t)b * S + q) * H + h) * kHd + c;
#pragma unroll
    for (int j = 0; j < kHd / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
          seen ? o[4 * j + 2 * hr] * inv : 0.f, seen ? o[4 * j + 2 * hr + 1] * inv : 0.f);
  }
}

// a bf16 [batch, len, heads, kHd] tensor as a 4-D tensor map over (hd, head,
// position, batch), boxes of kBox columns x 1 head x rows positions x 1
// batch, 128-byte swizzle, zeros out of bounds
bool encode(CUtensorMap* map, const void* base, int batch, int len, int heads, int rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)kHd, (cuuint64_t)heads, (cuuint64_t)len,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)kHd * 2, (cuuint64_t)heads * kHd * 2,
                                 (cuuint64_t)len * heads * kHd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estrides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BKV, int STAGES>
int run(const void* q, const void* k, const void* v, void* out, int B, int S, int T, int H,
        int K, int causal, int window, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!encode(&mq, q, B, S, H, kBQ) || !encode(&mk, k, B, T, K, BKV) ||
      !encode(&mv, v, B, T, K, BKV))
    return kTensorMapError;
  constexpr int smem = Layout<BKV, STAGES>::kBytes;
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(flash_attn_tc_kernel<BKV, STAGES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  dim3 grid(H, B, (S + kBQ - 1) / kBQ);
  flash_attn_tc_kernel<BKV, STAGES><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), S, T, H, K, causal, window,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace

namespace {

constexpr int kSimtMaxHd = 256;

// the instance for hd, walking HD = 16, 32, ..., kSimtMaxHd
template <typename E, int HD = 16>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* out, int B, int S,
              int T, int H, int K, int causal, int window, float scale, cudaStream_t s) {
  if (hd == HD) return launch<E, HD>(q, k, v, out, B, S, T, H, K, causal, window, scale, s);
  if constexpr (HD < kSimtMaxHd)
    return launch_hd<E, HD + 16>(hd, q, k, v, out, B, S, T, H, K, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The SIMT entry point: float32 (dtype 0) or bfloat16 (dtype 1) q/k/v/out at
// any hd that is a multiple of 16 up to 256 (bf16 at hd 128 is the
// tensor-core entry's, though this one takes it too); anything else is
// refused. Tensors contiguous and 16-byte aligned. Returns
// cudaGetLastError() of the launch.
extern "C" int flash_attn(const void* q, const void* k, const void* v, void* out, int B,
                          int S, int T, int H, int K, int hd, int causal, int window,
                          float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, out, B, S, T, H, K, causal, window, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, out, B, S, T, H, K, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core entry point: bf16 q [B, S, H, 128] and k/v [B, T, K, 128],
// contiguous, bases 16-byte aligned (what a tensor map needs; the wrapper
// checks). Returns cudaGetLastError() of the launch, or kTensorMapError if a
// tensor map could not be encoded.
extern "C" int flash_attn_tc(const void* q, const void* k, const void* v, void* out, int B,
                             int S, int T, int H, int K, int causal, int window, float scale,
                             void* stream) {
  if (B == 0 || S == 0) return 0;
  return tc::run<tc::kBKV, tc::kStages>(q, k, v, out, B, S, T, H, K, causal, window, scale,
                                        static_cast<cudaStream_t>(stream));
}

extern "C" const char* error_string(int err) {
  if (err == tc::kTensorMapError) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
