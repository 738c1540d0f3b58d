// Causal or full GQA flash attention forward for Hopper (sm_90a), fp32 or
// bf16 q/k/v, fp32 online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn/flash_attn.py:83
// flash_attn_pallas (_fa_kernel :28). The TPU grid (b, h, q block, kv block)
// walked the kv blocks sequentially with the running max, denominator and
// accumulator in VMEM scratch. Blocks of a CUDA grid run in no order, so the
// kv walk becomes a loop inside one block per (q tile, head, batch) that
// carries the state itself: the max and denominator of each row in
// registers (replicated over the 16 threads that share the row), the
// accumulator in registers, the probabilities through shared memory. The kv
// head of query head h is h / G; no K/V replication materializes.
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
// far right of the H100's ridge. What the design does about it, as a first
// kernel: 64 x 64 tiles on the CUDA cores in fp32 (fp32 inputs stay fp32,
// never TF32), 256 threads each owning 4 query rows x 4 kv columns of the
// scores and 4 rows x hd/16 columns of the output, 16-byte shared-memory
// reads on padded rows, 16-byte global loads, K and V sharing one buffer so
// two blocks fit an SM, and q tiles issued longest-first under causality.
// Left for later work: bf16 tensor cores (wgmma), TMA-fed double-buffered
// kv tiles, warp-specialized softmax.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
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
  constexpr int kLd = HD + 4, kOC = HD / 64;  // output column chunks of 64
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
    for (int c = 0; c < kOC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[c * 64 + tx * 4 + e] = from_f<E>(seen ? acc[i][c][e] * inv : 0.f);
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

}  // namespace

// dtype (of q, k, v and out): 0 = float32, 1 = bfloat16; hd 128 (the head
// dim of every configuration the port carries but stablelm-12b's 160);
// tensors contiguous and 16-byte aligned. Returns cudaGetLastError() of the
// launch.
extern "C" int flash_attn(const void* q, const void* k, const void* v, void* out, int B,
                          int S, int T, int H, int K, int hd, int causal, int window,
                          float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (hd != 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, 128>(q, k, v, out, B, S, T, H, K, causal, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 128>(q, k, v, out, B, S, T, H, K, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
