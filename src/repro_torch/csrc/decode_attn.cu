// Single-query GQA decode attention over a dense [B, T, K, hd] cache for
// Hopper (sm_90a), split across blocks along T, then a combine.
//
// Replaces the TPU kernel src/repro/kernels/decode_attn/decode_attn.py:102
// decode_attn_pallas (_da_kernel :52). The TPU grid (row b, KV chunk c) walked
// the chunks of a row in order, the running softmax state in VMEM scratch,
// and skipped chunks outside [pos-window+1, pos] by scalar prefetch. Blocks of
// a CUDA grid run in no order, so here the T axis is cut into splits of
// `split` tokens, one block per (row b, KV head k with up to kGB of its query
// heads, split s), and a second kernel merges the splits' states.
//
// What bounds it on the card: bytes. Each live K/V element is read once and
// used by G query heads (2*G flops per element read, far left of the H100's
// ~295 flops-per-byte ridge), so the floor is the live tokens' K and V bytes
// over HBM bandwidth. What the design does about it:
//   - the grid (B, K * ceil(G/kGB), ceil(T/split)) is fixed from shapes, so
//     the host never reads pos; a split outside [pos-window+1, pos] returns
//     before any load, and a live one walks only its valid tokens (no mask);
//   - a token's K (or V) row of head k is read with 16-byte loads by a group of
//     LPT lanes (bf16 hd 128: 16 lanes, two tokens per warp per step; fp32:
//     32 lanes), several tokens in flight per lane;
//   - q of the group's heads stays in registers; a token's dot products are
//     reduced with shuffles, never with a barrier per token;
//   - pass 1 writes the split's scores to shared memory, one warp per head
//     takes their max and turns them into exponentials (one exp per score),
//     pass 2 streams V weighted by them; a split's partial state
//     (m, l, acc[hd]) goes to fp32 scratch [B, K, nsplit, G, *];
//   - the combine kernel, one block per (b, k), reads only the live splits
//     (computed from pos, as the split kernel does) and writes
//     sum_s e^(m_s-M) acc_s / max(sum_s e^(m_s-M) l_s, 1e-30).
// Every live split holds at least one valid token, so its m_s is a real score
// and a dead split is never read. pos < 0 leaves no live split: 0 / 1e-30,
// exact zeros, as the TPU kernel gives. Positions past T do not exist here.
// The split only needs its token range; a paged variant would swap the dense
// token address for a block-table lookup.
//
// Semantics (the JAX kernel's): scores q.k * scale (scale = 1/sqrt(hd)),
// positions t <= pos and, with a window, pos - t < window; fp32 softmax;
// output in q's dtype. q, k, v in fp32 or bf16 (one dtype), hd a multiple of
// 16 bytes' worth of elements and at most kMaxHd.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kGB = 4;         // query heads of one KV head per block
constexpr int kMaxSplit = 512;
constexpr int kMaxHd = 256;  // with kMaxSplit: 24 KB of shared memory at most
constexpr int kUnroll = 4;   // tokens per lane group and round
constexpr int kCombineThreads = 512;

static_assert(kGB <= kWarps, "the softmax step gives each head of the group one warp");

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes as floats: 4 fp32 or 8 bf16
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The valid positions of row b: [lo, hi] (empty when hi < lo).
__device__ __forceinline__ void live_range(int p, int T, int window, int& lo, int& hi) {
  lo = window ? max(p - window + 1, 0) : 0;
  hi = min(p, T - 1);
}

// One round of 16-byte loads: kUnroll tokens per lane group, token t of the
// round at base + u * step + slot; lanes past the valid range or the row's
// chunks load zeros.
template <typename TE, int NC>
__device__ __forceinline__ void load_round(uint4 (&r)[kUnroll][NC], const TE* row0, int base,
                                           int e, int step, int slot, int sub, int lpt,
                                           int chunks, size_t tok) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int t = base + u * step + slot;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int ch = sub + c * lpt;
      r[u][c] = (t <= e && ch < chunks) ? ld16(row0 + t * tok + ch * Vec<TE>::n)
                                        : make_uint4(0, 0, 0, 0);
    }
  }
}

template <int NC>
__device__ __forceinline__ void take(uint4 (&dst)[kUnroll][NC], const uint4 (&src)[kUnroll][NC]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
#pragma unroll
    for (int c = 0; c < NC; ++c) dst[u][c] = src[u][c];
}

// NC: 16-byte chunks per lane per token row (hd * sizeof(TE) / 16 / LPT,
// rounded up). LPT (lanes per token, a power of two <= 32) is a launch arg.
// Dynamic shared memory: scores [kGB][split], then the warps' partial
// accumulators [kWarps][kGB][hd], floats.
template <typename TE, int NC>
__global__ void __launch_bounds__(kThreads) dense_split_kernel(
    const TE* __restrict__ q,       // [B, K, G, hd]
    const TE* __restrict__ k,       // [B, T, K, hd]
    const TE* __restrict__ v,       // [B, T, K, hd]
    const int32_t* __restrict__ pos,
    float* __restrict__ part_acc,   // [B, K, nsplit, G, hd]
    float* __restrict__ part_ml,    // [B, K, nsplit, G, 2]
    int K, int G, int hd, int T, int split, int nsplit, int lpt, int window,
    float scale) {
  constexpr int E = Vec<TE>::n;
  extern __shared__ float smem[];
  float* s_s = smem;                   // [kGB][split]: scores, then exponentials
  float* red_s = smem + kGB * split;   // [kWarps][kGB][hd]
  __shared__ float l_s[kGB];

  const int b = blockIdx.x, s = blockIdx.z;
  const int ngrp = (G + kGB - 1) / kGB;
  const int kh = blockIdx.y / ngrp, g0 = (blockIdx.y % ngrp) * kGB;
  const int ng = min(kGB, G - g0);
  int lo, hi;
  live_range(pos[b], T, window, lo, hi);
  const int t0 = s * split;
  const int a = max(t0, lo), e = min(t0 + split - 1, hi);
  if (a > e) return;  // no valid token in this split: the combine skips it

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane % lpt;             // lane within the token's group
  const int tpw = 32 / lpt;               // tokens per warp per step
  const int slot = warp * tpw + lane / lpt;
  const int step = kWarps * tpw;          // tokens per block per step
  const int R = step * kUnroll;           // tokens per block per round
  const int chunks = hd / E;              // 16-byte chunks per token row
  const size_t tok = (size_t)K * hd;      // elements between tokens
  const TE* kb = k + (size_t)b * T * tok + (size_t)kh * hd;
  const TE* vb = v + (size_t)b * T * tok + (size_t)kh * hd;

  // two rounds in flight: the next round's loads are issued before the
  // current one is used
  uint4 cur[kUnroll][NC], nxt[kUnroll][NC];
  load_round<TE, NC>(cur, kb, a, e, step, slot, sub, lpt, chunks, tok);

  float qr[kGB][NC][E];
#pragma unroll
  for (int h = 0; h < kGB; ++h)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int ch = sub + c * lpt;
      if (h < ng && ch < chunks) {
        Vec<TE>::unpack(ld16(q + (((size_t)b * K + kh) * G + g0 + h) * hd + ch * E),
                        qr[h][c]);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) qr[h][c][i] = 0.f;
      }
    }

  // pass 1: scores of the valid tokens [a, e]; the loop bound is uniform
  // over the block, so every lane takes part in the shuffles
  for (int base = a; base <= e; base += R) {
    if (base + R <= e) load_round<TE, NC>(nxt, kb, base + R, e, step, slot, sub, lpt, chunks, tok);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot[kGB];
#pragma unroll
      for (int h = 0; h < kGB; ++h) dot[h] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float kf[E];
        Vec<TE>::unpack(cur[u][c], kf);
#pragma unroll
        for (int h = 0; h < kGB; ++h)
#pragma unroll
          for (int i = 0; i < E; ++i) dot[h] = fmaf(qr[h][c][i], kf[i], dot[h]);
      }
#pragma unroll
      for (int h = 0; h < kGB; ++h)
        for (int off = lpt / 2; off > 0; off /= 2)
          dot[h] += __shfl_xor_sync(0xffffffffu, dot[h], off);
      const int t = base + u * step + slot;
      if (sub == 0 && t <= e) {
#pragma unroll
        for (int h = 0; h < kGB; ++h) s_s[h * split + t - t0] = dot[h] * scale;
      }
    }
    take<NC>(cur, nxt);
  }
  // V's first round flies while the softmax step runs
  load_round<TE, NC>(cur, vb, a, e, step, slot, sub, lpt, chunks, tok);
  __syncthreads();

  // max and exponentials: warp h takes head h
  const int n = e - a + 1, i0 = a - t0;
  float m = -INFINITY;
  if (warp < ng) {
    float* sh = s_s + warp * split + i0;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, sh[i]);
    for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float x = expf(sh[i] - m);
      sh[i] = x;
      l += x;
    }
    for (int off = 16; off > 0; off /= 2) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) l_s[warp] = l;
  }
  __syncthreads();

  // pass 2: acc[h][d] = sum_t p[h][t] v[t][d] over this lane's tokens
  float acc[kGB][NC][E];
#pragma unroll
  for (int h = 0; h < kGB; ++h)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < E; ++i) acc[h][c][i] = 0.f;
  for (int base = a; base <= e; base += R) {
    if (base + R <= e) load_round<TE, NC>(nxt, vb, base + R, e, step, slot, sub, lpt, chunks, tok);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * step + slot;
      if (t > e) continue;
      float pr[kGB];
#pragma unroll
      for (int h = 0; h < kGB; ++h) pr[h] = s_s[h * split + t - t0];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float vf[E];
        Vec<TE>::unpack(cur[u][c], vf);
#pragma unroll
        for (int h = 0; h < kGB; ++h)
#pragma unroll
          for (int i = 0; i < E; ++i) acc[h][c][i] = fmaf(pr[h], vf[i], acc[h][c][i]);
      }
    }
    take<NC>(cur, nxt);
  }
  // the warp's token groups share lanes `sub`: sum them by shuffles, then the
  // warps' sums through shared memory
#pragma unroll
  for (int h = 0; h < kGB; ++h)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < E; ++i)
        for (int off = lpt; off < 32; off *= 2)
          acc[h][c][i] += __shfl_xor_sync(0xffffffffu, acc[h][c][i], off);
  if (lane < lpt) {
#pragma unroll
    for (int h = 0; h < kGB; ++h)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int ch = sub + c * lpt;
        if (ch < chunks) {
#pragma unroll
          for (int i = 0; i < E; ++i)
            red_s[(warp * kGB + h) * hd + ch * E + i] = acc[h][c][i];
        }
      }
  }
  if (warp < ng && lane == 0) {
    float* ml = part_ml + ((((size_t)b * K + kh) * nsplit + s) * G + g0 + warp) * 2;
    ml[0] = m;
    ml[1] = l_s[warp];
  }
  __syncthreads();
  float* pa = part_acc + (((size_t)b * K + kh) * nsplit + s) * G * hd;
  for (int i = tid; i < ng * hd; i += kThreads) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x += red_s[w * kGB * hd + i];
    pa[(size_t)g0 * hd + i] = x;
  }
}

// One block per (b, k). Dynamic shared memory: the live splits' weights
// e^(m_s - M) [G][n_live], then max(sum_s weight * l_s, 1e-30) [G].
template <typename TE>
__global__ void __launch_bounds__(kCombineThreads) dense_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int32_t* __restrict__ pos, TE* __restrict__ out, int K, int G, int hd, int T,
    int split, int nsplit, int window) {
  extern __shared__ float w_s[];
  const int b = blockIdx.x, kh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int lo, hi;
  live_range(pos[b], T, window, lo, hi);
  const int s_lo = lo / split, n = hi < lo ? 0 : hi / split - s_lo + 1;
  float* l_s = w_s + (size_t)G * n;
  const float* ml = part_ml + (((size_t)b * K + kh) * nsplit + s_lo) * G * 2;  // [n][G][2]
  const float* pa = part_acc + (((size_t)b * K + kh) * nsplit + s_lo) * G * hd;
  for (int g = warp; g < G; g += kCombineThreads / 32) {  // a warp per head
    float M = -INFINITY;
    for (int i = lane; i < n; i += 32) M = fmaxf(M, ml[((size_t)i * G + g) * 2]);
    for (int off = 16; off > 0; off /= 2) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float w = expf(ml[((size_t)i * G + g) * 2] - M);
      w_s[g * n + i] = w;
      l = fmaf(w, ml[((size_t)i * G + g) * 2 + 1], l);
    }
    for (int off = 16; off > 0; off /= 2) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) l_s[g] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  TE* ob = out + ((size_t)b * K + kh) * G * hd;
  for (int j = tid; j < G * hd; j += kCombineThreads) {
    const float* wg = w_s + (j / hd) * n;
    float a = 0.f;
#pragma unroll 8
    for (int i = 0; i < n; ++i) a = fmaf(wg[i], pa[(size_t)i * G * hd + j], a);
    ob[j] = from_f<TE>(a / l_s[j / hd]);  // no live split: 0 / 1e-30
  }
}

template <typename TE, int NC>
int launch(const void* q, const void* k, const void* v, const void* pos, float* part_acc,
           float* part_ml, void* out, int B, int K, int G, int hd, int T, int split,
           int lpt, int window, float scale, cudaStream_t stream) {
  const int nsplit = (T + split - 1) / split;
  dim3 grid(B, K * ((G + kGB - 1) / kGB), nsplit);
  const size_t smem = sizeof(float) * ((size_t)kGB * split + (size_t)kWarps * kGB * hd);
  dense_split_kernel<TE, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const TE*>(q), static_cast<const TE*>(k), static_cast<const TE*>(v),
      static_cast<const int32_t*>(pos), part_acc, part_ml, K, G, hd, T, split, nsplit, lpt,
      window, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_max = min(nsplit, window ? window / split + 2 : nsplit);  // live splits
  const size_t smem_c = sizeof(float) * (size_t)G * (n_max + 1);
  if (smem_c > 48 * 1024) {
    e = cudaFuncSetAttribute(dense_combine_kernel<TE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
    if (e != cudaSuccess) return (int)e;
  }
  dense_combine_kernel<TE><<<dim3(B, K), kCombineThreads, smem_c, stream>>>(
      part_acc, part_ml, static_cast<const int32_t*>(pos), static_cast<TE*>(out), K, G, hd,
      T, split, nsplit, window);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of q, k, v and out): 0 = float32, 1 = bfloat16. part_acc/part_ml:
// fp32 scratch of B*K*ceil(T/split)*G*hd and *2 floats. Two launches (split,
// combine); returns cudaGetLastError() after them (the first failure).
extern "C" int decode_attn_dense(const void* q, const void* k, const void* v,
                                 const void* pos, void* part_acc, void* part_ml, void* out,
                                 int B, int K, int G, int hd, int T, int split, int window,
                                 float scale, int dtype, void* stream) {
  if (B == 0 || K == 0 || G == 0) return 0;
  const int esize = dtype == 0 ? 4 : 2;
  const int chunks = hd * esize / 16;
  if ((dtype != 0 && dtype != 1) || hd * esize % 16 || hd > kMaxHd || T < 1 ||
      split < 1 || split > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  int lpt = 1;
  while (lpt < chunks && lpt < 32) lpt *= 2;
  const int nc = (chunks + lpt - 1) / lpt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (dtype == 0)
    return nc == 1 ? launch<float, 1>(q, k, v, pos, pa, pm, out, B, K, G, hd, T, split, lpt,
                                      window, scale, s)
                   : launch<float, 2>(q, k, v, pos, pa, pm, out, B, K, G, hd, T, split, lpt,
                                      window, scale, s);
  return launch<__nv_bfloat16, 1>(q, k, v, pos, pa, pm, out, B, K, G, hd, T, split, lpt,
                                  window, scale, s);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
