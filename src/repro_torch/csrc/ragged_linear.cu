// Token-packed frozen base linear for Hopper (sm_90a):
// y[budget, dout] = buf[budget, din] @ w[din, dout] (+ b), rows >= n_live
// written as exact zeros, fp32 accumulation, fp32 or bf16 in and out.
//
// Replaces the TPU kernel src/repro/kernels/ragged_linear/ragged_linear.py:54
// ragged_linear_pallas (_rl_kernel :23), the paper's §3.7 packed base-layer
// execution. The TPU grid (token tile, dout tile, din tile) ran the din axis
// sequentially with the fp32 sum in VMEM scratch and skipped token tiles past
// the scalar-prefetched live count. Here one block owns a 128 x 128 output
// tile and loops over din itself, the sum in registers; the live count is
// read from device memory (or passed by value), so the host never waits for
// it, and a block whose first row is past it writes zeros without reading
// buf or w.
//
// What bounds it on the card: operations. A 1,001-token x 4096 x 12800 call
// is ~1.05e11 flops against ~0.13 GB of traffic, far right of the H100's
// ridge. What the design does about it, as a first kernel: a classic
// register-tiled SGEMM on the CUDA cores in fp32 (each thread 8 x 8 outputs
// from 4-wide shared-memory reads, rows and columns split in two halves of
// 64 so the 16-byte reads hit distinct banks), so fp32 inputs are computed
// in fp32 (never TF32) and bf16 inputs are widened on the way into shared
// memory. Left for later work: bf16 tensor cores (wgmma) with TMA-fed
// multi-stage tiles, which is where the card's operations rate is.
//
// Shapes are arbitrary: every load and store is bounds-checked (the TPU
// wrapper's padding to tiles was tiling, not semantics). w may be a view
// with strided rows (ldw >= dout, unit column stride).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 8, kThreads = 256;
constexpr int kPad = 4;  // xs row padding: conflict-free transposed stores

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ragged_linear_kernel(
    const T* __restrict__ x,             // [budget, din]
    const T* __restrict__ w,             // [din, dout], row stride ldw
    const T* __restrict__ bias,          // [dout] or nullptr
    const int32_t* __restrict__ n_dev,   // live count on the card, or nullptr
    int n_host,                          // live count when n_dev is nullptr
    T* __restrict__ y,                   // [budget, dout]
    int budget, int din, int dout, long long ldw) {
  __shared__ __align__(16) float xs[kBK][kBM + kPad];  // buf tile, k-major
  __shared__ __align__(16) float ws[kBK][kBN];         // w tile
  const int n_live = n_dev ? *n_dev : n_host;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // this thread's rows: row0 + ty*4 + {0..3} and + 64; columns likewise
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (row0 < n_live) {  // a tile with no live row is never computed
    for (int k0 = 0; k0 < din; k0 += kBK) {
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        const int r = i / kBK, kk = i - r * kBK;
        const int gr = row0 + r, gk = k0 + kk;
        xs[kk][r] = (gr < budget && gk < din) ? to_f(x[(size_t)gr * din + gk]) : 0.f;
      }
      for (int i = tid; i < kBK * kBN; i += kThreads) {
        const int kk = i / kBN, c = i - kk * kBN;
        const int gk = k0 + kk, gc = col0 + c;
        ws[kk][c] = (gk < din && gc < dout) ? to_f(w[(size_t)gk * ldw + gc]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[8], b[8];
        const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&xs[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
        b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // epilogue: bias, then rows past the live count become exact zeros
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= budget) continue;
    const bool live = row < n_live;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col >= dout) continue;
      const float v = acc[i][j] + (bias ? to_f(bias[col]) : 0.f);
      y[(size_t)row * dout + col] = from_f<T>(live ? v : 0.f);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, const void* n_dev, int n_host,
           void* y, int budget, int din, int dout, long long ldw, cudaStream_t stream) {
  dim3 grid((dout + kBN - 1) / kBN, (budget + kBM - 1) / kBM);
  ragged_linear_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<const int32_t*>(n_dev), n_host, static_cast<T*>(y), budget, din, dout,
      ldw);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of buf, w, b and y): 0 = float32, 1 = bfloat16. bias and n_dev may
// be null. Returns cudaGetLastError() of the launch.
extern "C" int ragged_linear(const void* x, const void* w, const void* bias,
                             const void* n_dev, int n_host, void* y, int budget, int din,
                             int dout, long long ldw, int dtype, void* stream) {
  if (budget == 0 || dout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, bias, n_dev, n_host, y, budget, din, dout, ldw, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, bias, n_dev, n_host, y, budget, din, dout, ldw, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
