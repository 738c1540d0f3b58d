// Single-query GQA decode attention for Hopper (sm_90a), split across
// blocks along the KV axis: over a dense [B, T, K, hd] cache (a split kernel,
// then a combine kernel), and over paged pools [P, blk, K, hd] read through
// a block table (one launch: the split that ends last combines), whose
// entries are q's dtype or int8 with f32 scales [P, blk, K, 1].
//
// Replaces the TPU kernels src/repro/kernels/decode_attn/decode_attn.py:102
// decode_attn_pallas (_da_kernel :52), :255 paged_decode_attn_pallas
// (_paged_kernel :168, whose per-page math is _page_update :142) and :274
// paged_decode_attn_quant_pallas (_paged_quant_kernel :204). The TPU
// grids (row b, KV chunk or table column c) walked a row's chunks in order,
// the running softmax state in VMEM scratch, and skipped chunks outside
// [pos-window+1, pos] by scalar prefetch. Blocks of a CUDA grid run in no
// order, so here the KV axis is cut into splits of `split` tokens, one block
// per (row b, KV head k with up to kGB of its query heads, split s), and the
// splits' states are merged afterwards.
//
// What bounds it on the card: bytes. Each live K/V element is read once and
// used by G query heads (2*G flops per element read, far left of the H100's
// ~295 flops-per-byte ridge), so the floor is the live tokens' K and V bytes
// over HBM bandwidth. What the design does about it:
//   - the grid (B, K * ceil(G/kGB), nsplit) is fixed from shapes, so the host
//     never reads pos; a split outside [pos-window+1, pos] returns before any
//     load, and a live one walks only its valid tokens (no mask);
//   - a token's K (or V) row of head k is read with 16-byte loads by a group of
//     LPT lanes (bf16 hd 128: 16 lanes, two tokens per warp per step; fp32:
//     32 lanes), several tokens in flight per lane;
//   - q of the group's heads stays in registers; a token's dot products are
//     reduced with shuffles, never with a barrier per token;
//   - pass 1 writes the split's scores to shared memory, one warp per head
//     takes their max and turns them into exponentials (one exp per score),
//     pass 2 streams V weighted by them; a split's partial state
//     (m, l, acc[hd]) goes to fp32 scratch [B, K, nsplit, G, *];
//   - the merge reads only the live splits (computed from pos) and writes
//     sum_s e^(m_s-M) acc_s / max(sum_s e^(m_s-M) l_s, 1e-30).
// Every live split holds at least one valid token, so its m_s is a real score
// and a dead split is never read. pos < 0 leaves no live split: exact zeros,
// as the TPU kernels give.
//
// Dense (two launches): the combine kernel, one block per (b, k), merges;
// pos < 0 gives 0 / 1e-30. Positions past T do not exist.
//
// Paged (one launch: the host sets the pace of a decode tick, and a second
// launch per call would cost it more than the merge costs the device): T is
// nb * blk, a split is split_pages whole pages, and a live split's block
// first loads its page ids from the table, clamped into [0, P) (tables carry
// the 1<<30 sentinel plus per-layer offsets in unmapped entries), into
// shared memory; token t is then row t % blk of its page. After publishing
// its state (__threadfence) a live split draws a ticket from a per-(row, KV
// head group) counter; the block that draws the last one (the live count is
// computed from pos) merges the live splits and writes the output, then sets
// the counter back to 0, so the next call (or a CUDA graph that replays
// this one) finds zeros. A row with no live split is written as exact zeros
// by its split 0. The scratch and counters belong to the launch wrapper,
// which allocates them once and reuses them: calls on one stream only.
// The dense instance compiles none of this (if constexpr).
//
// int8 pools (the paged layout only): a lane's 16-byte load holds 16 int8
// entries, so an int8 pool moves half a bf16 pool's bytes and is never
// dequantized into a wider copy. A live split stages the k- and v-scales of
// its valid tokens (head k) in shared memory beside its page ids. The JAX
// order, exactly: the score is q.k, times the k-scale, times 1/sqrt(hd);
// the denominator sums the raw exponentials and only the numerator weighs
// them by the v-scale. Everything int8 is chosen at compile time (a
// runtime branch in this shared template cost the paged kernels 23-84%).
//
// Semantics (the JAX kernels'): scores q.k * scale (scale = 1/sqrt(hd)),
// positions t <= pos and, with a window, pos - t < window; fp32 softmax;
// output in q's dtype. q and k/v (or the pools) in fp32 or bf16 (one dtype),
// or q in fp32 or bf16 over int8 pools; hd a multiple of 16 bytes' worth of
// pool elements and at most kMaxHd.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

template <> struct Vec<int8_t> {
  static constexpr int n = 16;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * j)));
  }
};

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// E consecutive elements of T (16-byte aligned) as floats
template <typename T, int E>
__device__ __forceinline__ void load_floats(const T* p, float* f) {
  static_assert(E % Vec<T>::n == 0, "whole 16-byte loads");
#pragma unroll
  for (int i = 0; i < E; i += Vec<T>::n) Vec<T>::unpack(ld16(p + i), f + i);
}

// The valid positions of row b: [lo, hi] (empty when hi < lo).
__device__ __forceinline__ void live_range(int p, int T, int window, int& lo, int& hi) {
  lo = window ? max(p - window + 1, 0) : 0;
  hi = min(p, T - 1);
}

// Where a paged split's tokens lie: token t of the split that starts at t0
// is row (t - t0) % blk of page ids[(t - t0) / blk].
struct Pages {
  const int* ids;  // the split's page ids, clamped into [0, P), in shared memory
  int t0, blk;
};

// One round of 16-byte loads: kUnroll tokens per lane group, token t of the
// round at base + u * step + slot; lanes past the valid range or the row's
// chunks load zeros. Token t's row: row0 + t * tok (dense), or page row
// (ids[i / blk] * blk + i % blk) * tok on from row0, i = t - t0 (kPaged).
template <typename TE, int NC, bool kPaged>
__device__ __forceinline__ void load_round(uint4 (&r)[kUnroll][NC], const TE* row0, int base,
                                           int e, int step, int slot, int sub, int lpt,
                                           int chunks, size_t tok, Pages pg) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int t = base + u * step + slot;
    if constexpr (kPaged) {
      const int i = min(t, e) - pg.t0, pi = i / pg.blk;
      const TE* row = row0 + ((size_t)pg.ids[pi] * pg.blk + (i - pi * pg.blk)) * tok;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int ch = sub + c * lpt;
        r[u][c] = (t <= e && ch < chunks) ? ld16(row + ch * Vec<TE>::n) : make_uint4(0, 0, 0, 0);
      }
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int ch = sub + c * lpt;
        r[u][c] = (t <= e && ch < chunks) ? ld16(row0 + t * tok + ch * Vec<TE>::n)
                                          : make_uint4(0, 0, 0, 0);
      }
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

// The live splits of a row (the splits that meet [lo, hi]): s_lo and their
// count, 0 when the row has no valid position.
__device__ __forceinline__ void live_splits(int lo, int hi, int split, int& s_lo, int& n) {
  s_lo = lo / split;
  n = hi < lo ? 0 : hi / split - s_lo + 1;
}

// TQ: q and out; TE: the cache's entries (TQ, or int8 in the paged layout:
// then k_scale / v_scale are the f32 pools [P, blk, K, 1]).
// NC: 16-byte chunks per lane per token row (hd * sizeof(TE) / 16 / LPT,
// rounded up). LPT (lanes per token, a power of two <= 32) is a launch arg.
// kPaged: K/V are pools [P, blk, K, hd] read through the block table (T is
// nb * blk, a split is a whole number of pages), and the block that ends
// last among a (row, KV head group)'s live splits merges them and writes
// the output in this launch; otherwise K/V are a dense [B, T, K, hd] cache
// and dense_combine_kernel merges. Dynamic shared memory: scores
// [kGB][split], then the warps' partial accumulators [kWarps][kGB][hd],
// floats; kPaged adds the split's page ids [split / blk] (int), with int8
// entries the split's k- and v-scales [2][split], then the combine's
// weights [kGB][n_max] and denominators [kGB].
template <typename TQ, typename TE, int NC, bool kPaged>
__global__ void __launch_bounds__(kThreads) split_kernel(
    const TQ* __restrict__ q,        // [B, K, G, hd]
    const TE* __restrict__ k,        // [B, T, K, hd], or the pool [P, blk, K, hd]
    const TE* __restrict__ v,        // as k
    const int32_t* __restrict__ pos,
    float* __restrict__ part_acc,    // [B, K, nsplit, G, hd]
    float* __restrict__ part_ml,     // [B, K, nsplit, G, 2]
    int K, int G, int hd, int T, int split, int nsplit, int lpt, int window,
    float scale,
    const int32_t* __restrict__ tbl,  // [B, nb] page ids (kPaged)
    int32_t* __restrict__ tickets,    // [B, K * ngrp], zeros between calls (kPaged)
    TQ* __restrict__ out,             // [B, K, G, hd] (kPaged)
    int P, int blk, int nb, int n_max,
    const float* __restrict__ k_scale,  // [P, blk, K, 1] (int8 entries)
    const float* __restrict__ v_scale) {
  constexpr bool kQuant = std::is_same_v<TE, int8_t>;
  static_assert(kPaged || !kQuant, "int8 entries come in pages");
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
  if (a > e) {  // no valid token in this split: the combine skips it
    if constexpr (kPaged) {
      // a row with no valid position has no live split: split 0 writes its
      // exact zeros
      if (s == 0 && hi < lo)
        for (int i = threadIdx.x; i < ng * hd; i += kThreads)
          out[(((size_t)b * K + kh) * G + g0) * hd + i] = from_f<TQ>(0.f);
    }
    return;
  }

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane % lpt;             // lane within the token's group
  const int tpw = 32 / lpt;               // tokens per warp per step
  const int slot = warp * tpw + lane / lpt;
  const int step = kWarps * tpw;          // tokens per block per step
  const int R = step * kUnroll;           // tokens per block per round
  const int chunks = hd / E;              // 16-byte chunks per token row
  const size_t tok = (size_t)K * hd;      // elements between tokens
  const TE* kb;
  const TE* vb;
  Pages pg{nullptr, t0, blk};
  float* ks_s = nullptr;  // [split]: the split's k-scales, then v-scales (int8)
  if constexpr (kPaged) {
    int* ids = reinterpret_cast<int*>(red_s + kWarps * kGB * hd);
    for (int i = tid; i < split / blk; i += kThreads) {
      const int col = t0 / blk + i;
      const int id = col < nb ? tbl[(size_t)b * nb + col] : 0;
      ids[i] = min(max(id, 0), P - 1);  // sentinels and layer offsets clamp
    }
    __syncthreads();
    pg.ids = ids;
    if constexpr (kQuant) {  // read after the next barrier
      ks_s = reinterpret_cast<float*>(ids + split / blk);
      for (int i = a - t0 + tid; i <= e - t0; i += kThreads) {
        const int pi = i / blk;
        const size_t at = ((size_t)ids[pi] * blk + (i - pi * blk)) * K + kh;
        ks_s[i] = k_scale[at];
        ks_s[split + i] = v_scale[at];
      }
    }
    kb = k + (size_t)kh * hd;
    vb = v + (size_t)kh * hd;
  } else {
    kb = k + (size_t)b * T * tok + (size_t)kh * hd;
    vb = v + (size_t)b * T * tok + (size_t)kh * hd;
  }

  // two rounds in flight: the next round's loads are issued before the
  // current one is used
  uint4 cur[kUnroll][NC], nxt[kUnroll][NC];
  load_round<TE, NC, kPaged>(cur, kb, a, e, step, slot, sub, lpt, chunks, tok, pg);

  float qr[kGB][NC][E];
#pragma unroll
  for (int h = 0; h < kGB; ++h)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int ch = sub + c * lpt;
      if (h < ng && ch < chunks) {
        load_floats<TQ, E>(q + (((size_t)b * K + kh) * G + g0 + h) * hd + ch * E, qr[h][c]);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) qr[h][c][i] = 0.f;
      }
    }

  // pass 1: scores of the valid tokens [a, e]; the loop bound is uniform
  // over the block, so every lane takes part in the shuffles
  for (int base = a; base <= e; base += R) {
    if (base + R <= e)
      load_round<TE, NC, kPaged>(nxt, kb, base + R, e, step, slot, sub, lpt, chunks, tok, pg);
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
      if (sub == 0 && t <= e) {  // int8: scaled in the softmax step
#pragma unroll
        for (int h = 0; h < kGB; ++h) s_s[h * split + t - t0] = kQuant ? dot[h] : dot[h] * scale;
      }
    }
    take<NC>(cur, nxt);
  }
  // V's first round flies while the softmax step runs
  load_round<TE, NC, kPaged>(cur, vb, a, e, step, slot, sub, lpt, chunks, tok, pg);
  __syncthreads();

  // max and exponentials: warp h takes head h
  const int n = e - a + 1, i0 = a - t0;
  float m = -INFINITY;
  if (warp < ng) {
    float* sh = s_s + warp * split + i0;
    if constexpr (kQuant) {  // (q.k * k-scale) / sqrt(hd), as the JAX kernel
      for (int i = lane; i < n; i += 32) sh[i] = sh[i] * ks_s[i0 + i] * scale;
    }
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
    if (base + R <= e)
      load_round<TE, NC, kPaged>(nxt, vb, base + R, e, step, slot, sub, lpt, chunks, tok, pg);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * step + slot;
      if (t > e) continue;
      float pr[kGB];
#pragma unroll
      for (int h = 0; h < kGB; ++h) pr[h] = s_s[h * split + t - t0];
      if constexpr (kQuant) {  // the v-scale weighs the numerator only
        const float vsc = ks_s[split + t - t0];
#pragma unroll
        for (int h = 0; h < kGB; ++h) pr[h] *= vsc;
      }
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

  if constexpr (kPaged) {
    // The combine, in this launch: every live split publishes its state,
    // then draws a ticket; the one that draws the last merges them all and
    // puts the counter back to 0 for the next call.
    __shared__ int last;
    int s_lo, n;
    live_splits(lo, hi, split, s_lo, n);
    __threadfence();  // this block's partial state, visible device-wide
    __syncthreads();
    if (tid == 0) {
      int32_t* ticket = tickets + (size_t)b * gridDim.y + blockIdx.y;
      last = atomicAdd(ticket, 1) == n - 1;
      if (last) *ticket = 0;
      __threadfence();  // the other splits' states are read after the ticket
    }
    __syncthreads();
    if (!last) return;
    // [kGB][n_max], past the ids (and the scales)
    float* w_s = red_s + kWarps * kGB * hd + split / blk + (kQuant ? 2 * split : 0);
    float* lw_s = w_s + kGB * n_max;  // [kGB] max(sum_s weight * l_s, 1e-30)
    const float* ml = part_ml + (((size_t)b * K + kh) * nsplit + s_lo) * G * 2;  // [n][G][2]
    const float* pl = part_acc + (((size_t)b * K + kh) * nsplit + s_lo) * G * hd;
    if (warp < ng) {  // a warp per head: the live splits' weights e^(m_s - M)
      const int g = g0 + warp;
      float M = -INFINITY;
      for (int i = lane; i < n; i += 32) M = fmaxf(M, __ldcg(ml + ((size_t)i * G + g) * 2));
      for (int off = 16; off > 0; off /= 2) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
      float l = 0.f;
      for (int i = lane; i < n; i += 32) {
        const float w = expf(__ldcg(ml + ((size_t)i * G + g) * 2) - M);
        w_s[warp * n_max + i] = w;
        l = fmaf(w, __ldcg(ml + ((size_t)i * G + g) * 2 + 1), l);
      }
      for (int off = 16; off > 0; off /= 2) l += __shfl_xor_sync(0xffffffffu, l, off);
      if (lane == 0) lw_s[warp] = fmaxf(l, 1e-30f);
    }
    __syncthreads();
    TQ* ob = out + (((size_t)b * K + kh) * G + g0) * hd;
    for (int j = tid; j < ng * hd; j += kThreads) {
      const int hh = j / hd;
      const float* wg = w_s + hh * n_max;
      const float* src = pl + (size_t)g0 * hd + j;
      float x = 0.f;
      for (int i = 0; i < n; ++i) x = fmaf(wg[i], __ldcg(src + (size_t)i * G * hd), x);
      ob[j] = from_f<TQ>(x / lw_s[hh]);
    }
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
  int lo, hi, s_lo, n;
  live_range(pos[b], T, window, lo, hi);
  live_splits(lo, hi, split, s_lo, n);
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
  split_kernel<TE, TE, NC, false><<<grid, kThreads, smem, stream>>>(
      static_cast<const TE*>(q), static_cast<const TE*>(k), static_cast<const TE*>(v),
      static_cast<const int32_t*>(pos), part_acc, part_ml, K, G, hd, T, split, nsplit, lpt,
      window, scale, nullptr, nullptr, nullptr, 0, 1, 0, 0, nullptr, nullptr);
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

// The paged layout: one launch, splits of split_pages pages; with int8
// entries (TE), the scale pools k_scale / v_scale.
template <typename TQ, typename TE, int NC>
int launch_paged(const void* q, const void* pool_k, const void* pool_v, const void* tbl,
                 const void* pos, float* part_acc, float* part_ml, int32_t* tickets,
                 void* out, int B, int K, int G, int hd, int P, int blk, int nb,
                 int split_pages, int lpt, int window, float scale, cudaStream_t stream,
                 const void* k_scale = nullptr, const void* v_scale = nullptr) {
  constexpr bool kQuant = std::is_same_v<TE, int8_t>;
  const int split = split_pages * blk, T = nb * blk;
  const int nsplit = (nb + split_pages - 1) / split_pages;
  const int n_max = min(nsplit, window ? window / split + 2 : nsplit);  // live splits
  dim3 grid(B, K * ((G + kGB - 1) / kGB), nsplit);
  const size_t smem = sizeof(float) * ((size_t)kGB * split + (size_t)kWarps * kGB * hd +
                                       split_pages + (kQuant ? 2 * (size_t)split : 0) +
                                       (size_t)kGB * (n_max + 1));
  auto kernel = split_kernel<TQ, TE, NC, true>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TE*>(pool_k),
      static_cast<const TE*>(pool_v), static_cast<const int32_t*>(pos), part_acc, part_ml, K,
      G, hd, T, split, nsplit, lpt, window, scale, static_cast<const int32_t*>(tbl), tickets,
      static_cast<TQ*>(out), P, blk, nb, n_max, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale));
  return (int)cudaGetLastError();
}

// lanes per token row and 16-byte chunks per lane for rows of hd elements
// of esize bytes
void lanes(int hd, int esize, int& lpt, int& nc) {
  const int chunks = hd * esize / 16;
  lpt = 1;
  while (lpt < chunks && lpt < 32) lpt *= 2;
  nc = (chunks + lpt - 1) / lpt;
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
  if ((dtype != 0 && dtype != 1) || hd * esize % 16 || hd > kMaxHd || T < 1 ||
      split < 1 || split > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  int lpt, nc;
  lanes(hd, esize, lpt, nc);
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

// The paged layout: pools [P, blk, K, hd] in q's dtype, tbl [B, nb] int32
// page ids (clamped into [0, P) before use), splits of split_pages pages.
// part_acc/part_ml: fp32 scratch of B*K*ceil(nb/split_pages)*G*hd and *2
// floats; tickets: B*K*ceil(G/4) int32 that are 0 before the call and are 0
// again after it. One launch; returns cudaGetLastError() after it.
extern "C" int decode_attn_paged(const void* q, const void* pool_k, const void* pool_v,
                                 const void* tbl, const void* pos, void* part_acc,
                                 void* part_ml, void* tickets, void* out, int B, int K, int G,
                                 int hd, int P, int blk, int nb, int split_pages, int window,
                                 float scale, int dtype, void* stream) {
  if (B == 0 || K == 0 || G == 0) return 0;
  const int esize = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || hd * esize % 16 || hd > kMaxHd || P < 1 || blk < 1 ||
      nb < 1 || split_pages < 1 || split_pages * blk > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  int lpt, nc;
  lanes(hd, esize, lpt, nc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  int32_t* tk = static_cast<int32_t*>(tickets);
  if (dtype == 0)
    return nc == 1 ? launch_paged<float, float, 1>(q, pool_k, pool_v, tbl, pos, pa, pm, tk,
                                                   out, B, K, G, hd, P, blk, nb, split_pages,
                                                   lpt, window, scale, s)
                   : launch_paged<float, float, 2>(q, pool_k, pool_v, tbl, pos, pa, pm, tk,
                                                   out, B, K, G, hd, P, blk, nb, split_pages,
                                                   lpt, window, scale, s);
  return launch_paged<__nv_bfloat16, __nv_bfloat16, 1>(q, pool_k, pool_v, tbl, pos, pa, pm,
                                                       tk, out, B, K, G, hd, P, blk, nb,
                                                       split_pages, lpt, window, scale, s);
}

// The paged layout over int8 pools [P, blk, K, hd] with f32 scales
// [P, blk, K, 1] (pool_ks, pool_vs); q and out in fp32 (dtype 0) or bf16
// (dtype 1); hd a multiple of 16 up to kMaxHd. Scratch, tickets, table and
// splits as decode_attn_paged's. One launch; returns cudaGetLastError()
// after it.
extern "C" int decode_attn_paged_quant(const void* q, const void* pool_k, const void* pool_ks,
                                       const void* pool_v, const void* pool_vs,
                                       const void* tbl, const void* pos, void* part_acc,
                                       void* part_ml, void* tickets, void* out, int B, int K,
                                       int G, int hd, int P, int blk, int nb, int split_pages,
                                       int window, float scale, int dtype, void* stream) {
  if (B == 0 || K == 0 || G == 0) return 0;
  if ((dtype != 0 && dtype != 1) || hd % 16 || hd > kMaxHd || P < 1 || blk < 1 || nb < 1 ||
      split_pages < 1 || split_pages * blk > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  int lpt, nc;
  lanes(hd, 1, lpt, nc);  // nc is 1: 16 int8 entries per 16-byte chunk, hd <= 256
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  int32_t* tk = static_cast<int32_t*>(tickets);
  if (dtype == 0)
    return launch_paged<float, int8_t, 1>(q, pool_k, pool_v, tbl, pos, pa, pm, tk, out, B, K,
                                          G, hd, P, blk, nb, split_pages, lpt, window, scale,
                                          s, pool_ks, pool_vs);
  return launch_paged<__nv_bfloat16, int8_t, 1>(q, pool_k, pool_v, tbl, pos, pa, pm, tk, out,
                                                B, K, G, hd, P, blk, nb, split_pages, lpt,
                                                window, scale, s, pool_ks, pool_vs);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
