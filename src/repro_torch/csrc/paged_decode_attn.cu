// Paged single-query GQA decode attention over int8 pools with per-head
// f32 scales for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attn/decode_attn.py:274
// paged_decode_attn_quant_pallas (_paged_quant_kernel :204; its per-page math
// is _page_update :142, shared with the bf16/fp32 kernel, whose counterpart
// is the paged split in decode_attn.cu). The TPU grid (row b, table column c)
// walked the KV axis sequentially with the running softmax state in VMEM
// scratch. Blocks of a CUDA grid run in no order, so the column axis becomes
// a loop inside the block: one block per (row b, KV head k) carries the
// state from page to page itself.
//
// What bounds it on the card: bytes. Each live K/V element is read once and
// used by G query heads (2*G flops per element read, against the H100's
// ~295 flops per byte ridge), so the time floor is the live pages' K and V
// bytes and their scales over HBM bandwidth.
// What the design does about it: pages are read in place from the pool
// through the block table (no gathered dense view); pages outside
// [pos-window+1, pos] are skipped before any load; each K/V page is staged
// once in shared memory (its int8 entries as float, its blk K- and V-scales
// of head k beside them) and serves all G query heads of the group; the
// running max, denominator and accumulator stay in shared memory (fp32), so
// only the output is written back. The pool is never dequantized into a
// wider copy, so it moves half a bf16 pool's bytes. Left for later work:
// the bf16 kernel's split-KV across blocks, 16-byte vector loads.
//
// Semantics (the JAX kernel's, exactly): page ids are clamped into [0, P)
// before addressing (tables carry the 1<<30 sentinel plus per-layer offsets
// in unmapped entries); scores are q.k, times the k-scale, times
// 1/sqrt(hd); positions t > pos or outside the window get -1e30; the
// softmax denominator sums the raw exponentials and only the numerator
// weights them by the v-scale; the output is acc / max(l, 1e-30) in q's
// dtype. q in fp32 or bf16; any hd and G with the state fitting shared
// memory (granite: hd 128, G 4).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// TQ: q and out
template <typename TQ>
__global__ void __launch_bounds__(kThreads) paged_decode_attn_quant_kernel(
    const TQ* __restrict__ q,              // [B, K, G, hd]
    const int8_t* __restrict__ pool_k,     // [P, blk, K, hd]
    const float* __restrict__ pool_ks,     // [P, blk, K, 1]
    const int8_t* __restrict__ pool_v,     // [P, blk, K, hd]
    const float* __restrict__ pool_vs,     // [P, blk, K, 1]
    const int32_t* __restrict__ tbl,       // [B, nb]
    const int32_t* __restrict__ pos,       // [B] last valid position
    TQ* __restrict__ out,                  // [B, K, G, hd]
    int K, int G, int hd, int P, int blk, int nb, int window, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, k = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int GH = G * hd, ldk = hd + 1;   // +1: conflict-free column reads of K
  float* q_s = smem;                     // [G, hd]
  float* acc = q_s + GH;                 // [G, hd]
  float* k_s = acc + GH;                 // [blk, hd+1]
  float* v_s = k_s + blk * ldk;          // [blk, hd]
  float* s_s = v_s + blk * hd;           // [G, blk] scores, then probabilities
  float* m_s = s_s + G * blk;            // [G] running max
  float* l_s = m_s + G;                  // [G] running denominator
  float* a_s = l_s + G;                  // [G] this page's rescale factor
  float* ks_s = a_s + G;                 // [blk] this page's K-scales
  float* vs_s = ks_s + blk;              // [blk] this page's V-scales

  const TQ* qb = q + ((size_t)b * K + k) * GH;
  for (int i = tid; i < GH; i += nt) {
    q_s[i] = to_f(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += nt) {
    m_s[g] = kNeg;
    l_s[g] = 0.f;
  }
  const int p = pos[b];
  const int lo = window ? p - window + 1 : 0;
  const size_t tstride = (size_t)K * hd;  // distance between tokens of one head
  __syncthreads();

  for (int c = 0; c < nb; ++c) {
    const int t0 = c * blk;
    if (!(t0 <= p && t0 + blk > lo)) continue;  // dead page: never read
    int page = tbl[(size_t)b * nb + c];
    page = page < 0 ? 0 : (page >= P ? P - 1 : page);
    const size_t base = (size_t)page * blk * tstride + (size_t)k * hd;
    for (int i = tid; i < blk * hd; i += nt) {
      const int t = i / hd, d = i - t * hd;
      k_s[t * ldk + d] = to_f(pool_k[base + t * tstride + d]);
      v_s[t * hd + d] = to_f(pool_v[base + t * tstride + d]);
    }
    for (int t = tid; t < blk; t += nt) {
      const size_t si = ((size_t)page * blk + t) * K + k;
      ks_s[t] = pool_ks[si];
      vs_s[t] = pool_vs[si];
    }
    __syncthreads();
    for (int i = tid; i < G * blk; i += nt) {
      const int g = i / blk, t = i - g * blk;
      const float* qg = q_s + g * hd;
      const float* kt = k_s + t * ldk;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qg[d], kt[d], s);
      s *= ks_s[t];
      s *= scale;
      const int ta = t0 + t;
      const bool valid = ta <= p && (window == 0 || p - ta < window);
      s_s[i] = valid ? s : kNeg;
    }
    __syncthreads();
    for (int g = tid; g < G; g += nt) {
      float* sg = s_s + g * blk;
      const float m_prev = m_s[g];
      float mx = m_prev;
      for (int t = 0; t < blk; ++t) mx = fmaxf(mx, sg[t]);
      const float alpha = expf(m_prev - mx);
      float sum = 0.f;
      for (int t = 0; t < blk; ++t) {
        const float e = expf(sg[t] - mx);
        sum += e;  // the denominator takes the raw exponential
        sg[t] = e * vs_s[t];
      }
      l_s[g] = l_s[g] * alpha + sum;
      a_s[g] = alpha;
      m_s[g] = mx;
    }
    __syncthreads();
    for (int i = tid; i < GH; i += nt) {
      const int g = i / hd, d = i - g * hd;
      const float* pg = s_s + g * blk;
      float a = 0.f;
      for (int t = 0; t < blk; ++t) a = fmaf(pg[t], v_s[t * hd + d], a);
      acc[i] = acc[i] * a_s[g] + a;
    }
    __syncthreads();
  }
  TQ* ob = out + ((size_t)b * K + k) * GH;
  for (int i = tid; i < GH; i += nt)
    ob[i] = from_f<TQ>(acc[i] / fmaxf(l_s[i / hd], 1e-30f));
}

template <typename TQ>
int launch(const void* q, const void* pool_k, const void* pool_ks, const void* pool_v,
           const void* pool_vs, const void* tbl, const void* pos, void* out, int B,
           int K, int G, int hd, int P, int blk, int nb, int window, float scale,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)G * hd + (size_t)blk * (hd + 1) + (size_t)blk * hd +
                       (size_t)G * blk + 3 * (size_t)G + 2 * (size_t)blk);
  auto kernel = paged_decode_attn_quant_kernel<TQ>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, K);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const int8_t*>(pool_k),
      static_cast<const float*>(pool_ks), static_cast<const int8_t*>(pool_v),
      static_cast<const float*>(pool_vs), static_cast<const int32_t*>(tbl),
      static_cast<const int32_t*>(pos), static_cast<TQ*>(out), K, G, hd, P, blk, nb,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// int8 pools [P, blk, K, hd] with f32 scales [P, blk, K, 1]. dtype (of q
// and out): 0 = float32, 1 = bfloat16. Returns cudaGetLastError() of the
// launch.
extern "C" int paged_decode_attn_quant(const void* q, const void* pool_k,
                                       const void* pool_ks, const void* pool_v,
                                       const void* pool_vs, const void* tbl,
                                       const void* pos, void* out, int B, int K, int G,
                                       int hd, int P, int blk, int nb, int window,
                                       float scale, int dtype, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, pool_k, pool_ks, pool_v, pool_vs, tbl, pos, out, B, K, G, hd, P,
                         blk, nb, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, pool_k, pool_ks, pool_v, pool_vs, tbl, pos, out, B, K,
                                 G, hd, P, blk, nb, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
