// SGMV — the multi-adapter LoRA delta — for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sgmv/sgmv.py:115
// sgmv_pallas_safe (_sgmv_kernel :25); the unclamped sgmv_pallas :48
// computes the same function on every input it accepts. For token block i
// (block_t tokens sharing one adapter):
//     y_i = (x_i @ A[id_i]) @ B[id_i] * scale        (fp32 accumulation,
//                                                      h kept in fp32)
// with id < 0 giving exact zeros and ids clamped into [0, n) before they
// address weights. block_t = 1 is the decode case (one adapter per row);
// block_t = S_pad is the compacted-prefill case (one row's whole prompt).
// As the JAX op does by padding: any T (the last block may be short; rows
// past T are neither read nor written) and up to ceil(T / block_t) ids (a
// block at or past n_ids is dead: zeros).
//
// What bounds it on the card: bytes, and at decode the launch itself. Per
// token it does 2*r*(din+dout) flops against (din+dout) activation
// elements plus the adapter's r*(din+dout) weights, far below the ~295
// flops/byte ridge: x [8, 4096] with 4 rank-8 adapters is ~0.6 MB.
// What the design does about it:
//   - a grid over (token tile, dout tile), one launch. A token tile holds
//     up to `tile` tokens of ONE adapter block (a tile never spans two
//     blocks; a short last block is masked, not padded); a dout tile is
//     `cols` output columns. An 8-row decode call fills 8 x dout/cols
//     blocks instead of 8. As the TPU kernel does per dout tile, each
//     block recomputes the shrink h = x_t @ A[id] for its own tokens: A
//     (64 KB at din 4096, rank 8) comes from L2 after the first block, and
//     nothing is exchanged between blocks;
//   - the shrink (fast path, rank R = 8 or 16, 16-byte aligned rows):
//     lane groups of R*size/16 lanes load whole 16-byte chunks of an A row
//     (at rank 8 in bf16 one row is one load) and multiply them by one x
//     element per token of the tile; warps stride din; partial h's reduce
//     with shuffles, then once across warps in shared memory. No divide,
//     no scalar load of A;
//   - the expand: each thread owns 16 bytes of adjacent output columns,
//     holds B's R rows of them in registers (16-byte loads), and writes
//     16-byte groups of y for every token of the tile, h read from shared
//     memory;
//   - other ranks (1..256), and rows that are not 16-byte aligned, take a
//     generic path: a warp per (token, rank column) dot product over din,
//     a thread per output element. Correct, slower.
// Tensor cores (mma.sync m16n8k16 fits rank 8 exactly) are not used: the
// arithmetic of a [1024, 4096] prefill call is ~0.13 GFLOP, ~2 us at the
// CUDA cores' fp32 rate, under its ~5 us byte bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
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
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
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
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);  // low half first
      w[i] = *reinterpret_cast<uint32_t*>(&v);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T>
struct Args {
  const T* x;            // [T, din]
  const T* A;            // client c's [din, r] row-major at A + c * a_stride
  const T* B;            // client c's [r, dout] row-major at B + c * b_stride
  const int32_t* ids;    // [n_ids]: adapter id per token block, < 0 dead
  T* y;                  // [T, dout]
  int rows, din, r, dout, n, n_ids, block_t;  // rows: T
  int tile, tpb, cols;   // tokens per tile, tiles per block, columns per tile
  long long a_stride, b_stride;
  float scale;
};

// The block's tile: tokens [t0, t0 + ntok) of adapter block `blk`, columns
// [c0, c0 + ncols). ntok <= 0: a tile past T (nothing to do).
struct Tile {
  int blk, t0, ntok, c0, ncols;
};

template <typename T>
__device__ __forceinline__ Tile tile_of(const Args<T>& p) {
  Tile s;
  s.blk = blockIdx.x / p.tpb;
  s.t0 = s.blk * p.block_t + (blockIdx.x - s.blk * p.tpb) * p.tile;
  const int end = min(min(s.t0 + p.tile, (s.blk + 1) * p.block_t), p.rows);
  s.ntok = end - s.t0;
  s.c0 = blockIdx.y * p.cols;
  s.ncols = min(p.cols, p.dout - s.c0);
  return s;
}

// exact zeros over the tile (a dead block); kVec: 16-byte stores
template <typename T, bool kVec>
__device__ __forceinline__ void zero_tile(const Args<T>& p, const Tile& s) {
  if constexpr (kVec) {
    constexpr int W = Vec<T>::n;
    const int ng = s.ncols / W;
    for (int i = threadIdx.x; i < s.ntok * ng; i += kThreads) {
      const int t = i / ng, g = i - t * ng;
      *reinterpret_cast<uint4*>(p.y + (size_t)(s.t0 + t) * p.dout + s.c0 + g * W) =
          make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = threadIdx.x; i < s.ntok * s.ncols; i += kThreads) {
      const int t = i / s.ncols, c = i - t * s.ncols;
      p.y[(size_t)(s.t0 + t) * p.dout + s.c0 + c] = from_f<T>(0.f);
    }
  }
}

// The fast path: rank R (8 or 16), A/B/y rows in 16-byte chunks, up to TT
// tokens per tile.
template <typename T, int R, int TT>
__global__ void __launch_bounds__(kThreads) sgmv_vec_kernel(const Args<T> p) {
  constexpr int E = Vec<T>::n;        // elements per 16 bytes
  constexpr int RC = R / E;           // 16-byte chunks per A row: 1, 2 or 4
  static_assert(R % E == 0 && 32 % RC == 0, "A rows must be whole 16-byte chunks");
  __shared__ float red_s[kWarps][TT][R];
  __shared__ float h_s[TT][R];
  const Tile s = tile_of(p);
  if (s.ntok <= 0) return;
  const int id = s.blk < p.n_ids ? p.ids[s.blk] : -1;
  if (id < 0) {
    zero_tile<T, true>(p, s);
    return;
  }
  const int a = min(id, p.n - 1);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, c = tid % RC;
  // loads in flight per thread: at decode (one token) all of din / 256 A
  // rows at once (one round trip to memory, not four)
  constexpr int kUnroll = TT == 1 ? 16 : TT <= 4 ? 8 : 4;

  // the expand's column groups: at decode each thread's first group of B is
  // loaded before the shrink, so its round trip overlaps A's
  const T* Bb = p.B + (size_t)a * p.b_stride + s.c0;
  const int ng = s.ncols / E;
  const int slices = max(1, kThreads / ng);
  constexpr bool kEarlyB = TT == 1;
  uint4 braw[R];
  if (kEarlyB && tid < ng * slices) {
#pragma unroll
    for (int j = 0; j < R; ++j) braw[j] = ld16(Bb + (size_t)j * p.dout + (tid % ng) * E);
  }

  // shrink: this thread's rank chunk c over rows d = tid / RC, + kThreads / RC, ...
  const T* Aa = p.A + (size_t)a * p.a_stride + c * E;
  const T* xr[TT];
#pragma unroll
  for (int t = 0; t < TT; ++t)  // tokens past the tile read its last row, unused
    xr[t] = p.x + (size_t)(s.t0 + min(t, s.ntok - 1)) * p.din;
  float acc[TT][E];
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[t][e] = 0.f;
#pragma unroll kUnroll
  for (int d = tid / RC; d < p.din; d += kThreads / RC) {
    float av[E];
    Vec<T>::unpack(ld16(Aa + (size_t)d * R), av);
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const float xv = to_f(xr[t][d]);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[t][e] = fmaf(xv, av[e], acc[t][e]);
    }
  }
  // lanes of one chunk c within a warp, then the warps
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int off = 16; off >= RC; off /= 2)
        acc[t][e] += __shfl_xor_sync(0xffffffffu, acc[t][e], off);
  if (lane < RC) {
#pragma unroll
    for (int t = 0; t < TT; ++t)
#pragma unroll
      for (int e = 0; e < E; ++e) red_s[warp][t][c * E + e] = acc[t][e];
  }
  __syncthreads();
  for (int i = tid; i < TT * R; i += kThreads) {
    float h = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) h += red_s[w][i / R][i % R];
    h_s[i / R][i % R] = h;
  }
  __syncthreads();

  // expand: column group g (E adjacent columns), B's R rows of it in
  // registers, for tokens sl, sl + slices, ...
  for (int item = tid; item < ng * slices; item += kThreads) {
    const int g = item % ng, sl = item / ng;
    if (!kEarlyB || item != tid) {
#pragma unroll
      for (int j = 0; j < R; ++j) braw[j] = ld16(Bb + (size_t)j * p.dout + g * E);
    }
    for (int t = sl; t < s.ntok; t += slices) {
      float o[E];
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float bv[E];
        Vec<T>::unpack(braw[j], bv);
        const float hj = h_s[t][j];
#pragma unroll
        for (int e = 0; e < E; ++e) o[e] = fmaf(hj, bv[e], o[e]);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] *= p.scale;
      *reinterpret_cast<uint4*>(p.y + (size_t)(s.t0 + t) * p.dout + s.c0 + g * E) =
          Vec<T>::pack(o);
    }
  }
}

// The generic path: any rank 1..256, any alignment. Dynamic shared memory:
// h [tile][r] floats.
template <typename T>
__global__ void __launch_bounds__(kThreads) sgmv_generic_kernel(const Args<T> p) {
  extern __shared__ float h_s[];
  const Tile s = tile_of(p);
  if (s.ntok <= 0) return;
  const int id = s.blk < p.n_ids ? p.ids[s.blk] : -1;
  if (id < 0) {
    zero_tile<T, false>(p, s);
    return;
  }
  const int a = min(id, p.n - 1);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, r = p.r;
  const T* Aa = p.A + (size_t)a * p.a_stride;
  for (int i = warp; i < s.ntok * r; i += kWarps) {  // a warp per (token, rank column)
    const int t = i / r, j = i - t * r;
    const T* xt = p.x + (size_t)(s.t0 + t) * p.din;
    float h = 0.f;
    for (int d = lane; d < p.din; d += 32) h = fmaf(to_f(xt[d]), to_f(Aa[(size_t)d * r + j]), h);
    for (int off = 16; off > 0; off /= 2) h += __shfl_xor_sync(0xffffffffu, h, off);
    if (lane == 0) h_s[i] = h;
  }
  __syncthreads();
  const T* Bb = p.B + (size_t)a * p.b_stride + s.c0;
  for (int i = tid; i < s.ntok * s.ncols; i += kThreads) {
    const int t = i / s.ncols, c = i - t * s.ncols;
    float o = 0.f;
    for (int j = 0; j < r; ++j) o = fmaf(h_s[t * r + j], to_f(Bb[(size_t)j * p.dout + c]), o);
    p.y[(size_t)(s.t0 + t) * p.dout + s.c0 + c] = from_f<T>(o * p.scale);
  }
}

template <typename T, int R>
int launch_vec(const Args<T>& p, dim3 grid, int tt, cudaStream_t stream) {
  if (tt <= 1) sgmv_vec_kernel<T, R, 1><<<grid, kThreads, 0, stream>>>(p);
  else if (tt <= 4) sgmv_vec_kernel<T, R, 4><<<grid, kThreads, 0, stream>>>(p);
  else sgmv_vec_kernel<T, R, 8><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <typename T>
int launch(Args<T> p, int tokens, cudaStream_t stream) {
  constexpr int E = Vec<T>::n;
  const bool vec = (p.r == 8 || p.r == 16) && p.dout % E == 0 && p.a_stride % E == 0 &&
                   p.b_stride % E == 0 && aligned16(p.A) && aligned16(p.B) && aligned16(p.y);
  // tokens per tile: at most `tokens`, one adapter block's, and (fast
  // path) the instantiated 1, 4 or 8
  const int span = min(p.block_t, p.rows);
  int tt = min(tokens, span);
  tt = tt <= 1 ? 1 : tt <= 4 ? 4 : 8;
  p.tile = min(tt, span);
  p.tpb = (span + p.tile - 1) / p.tile;
  if (vec) p.cols = (p.cols + E - 1) / E * E;
  const int nb = (p.rows + p.block_t - 1) / p.block_t;
  const dim3 grid(nb * p.tpb, (p.dout + p.cols - 1) / p.cols);
  if (vec) return p.r == 8 ? launch_vec<T, 8>(p, grid, tt, stream)
                           : launch_vec<T, 16>(p, grid, tt, stream);
  const size_t smem = sizeof(float) * (size_t)p.tile * p.r;
  sgmv_generic_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* x, const void* A, const void* B, const void* ids, void* y, int T_,
        int din, int r, int dout, int n, int n_ids, int block_t, int tokens, int cols,
        long long a_stride, long long b_stride, float scale, cudaStream_t stream) {
  Args<T> p{static_cast<const T*>(x), static_cast<const T*>(A), static_cast<const T*>(B),
            static_cast<const int32_t*>(ids), static_cast<T*>(y), T_, din, r, dout, n,
            n_ids, block_t, 0, 0, cols, a_stride, b_stride, scale};
  return launch<T>(p, tokens, stream);
}

}  // namespace

// x [T, din]; client c's A [din, r] at A + c * a_stride and B [r, dout] at
// B + c * b_stride (elements), each row-major; ids [n_ids] int32 with
// n_ids <= ceil(T / block_t); y [T, dout]. tokens: most tokens per tile
// (one adapter block's; rounded up to 1 or 4, at most 8); cols: columns per
// tile. dtype: 0 = float32, 1 = bfloat16. 1 <= r <= 256. One launch;
// returns cudaGetLastError() after it.
extern "C" int sgmv(const void* x, const void* A, const void* B, const void* ids, void* y,
                    int T, int din, int r, int dout, int n, int n_ids, int block_t,
                    int tokens, int cols, long long a_stride, long long b_stride,
                    float scale, int dtype, void* stream) {
  if (T == 0 || dout == 0) return 0;
  if (r < 1 || r > 256 || n < 1 || block_t < 1 || tokens < 1 || cols < 1 || n_ids < 0 ||
      (long long)n_ids * block_t >= (long long)T + block_t)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, A, B, ids, y, T, din, r, dout, n, n_ids, block_t, tokens, cols,
                      a_stride, b_stride, scale, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, A, B, ids, y, T, din, r, dout, n, n_ids, block_t, tokens,
                              cols, a_stride, b_stride, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
