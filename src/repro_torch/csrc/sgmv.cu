// SGMV — the multi-adapter LoRA delta — for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sgmv/sgmv.py:115
// sgmv_pallas_safe (_sgmv_kernel :25); the unclamped sgmv_pallas :48
// computes the same function on every input it accepts. For token block i
// (block_t tokens sharing one adapter):
//     y_i = (x_i @ A[id_i]) @ B[id_i] * scale        (fp32 accumulation)
// with id < 0 giving exact zeros and ids clamped into [0, n) before they
// address weights. block_t = 1 is the decode case (one adapter per row);
// block_t = S_pad is the compacted-prefill case (one row's whole prompt).
//
// What bounds it on the card: bytes. Per token it does 2*r*(din+dout)
// flops against (din+dout) activation elements plus the adapter's
// r*(din+dout) weights, far below the ~295 flops/byte ridge.
// What the design does about it: one block per token reads its activation
// row once (staged in shared memory as fp32), reduces h = x @ A[id] across
// the block into shared memory and expands y = h @ B[id] over dout with
// coalesced reads; the adapter ids are read by the block itself (no
// scalar-prefetch table), and nothing is padded — the rank and dout are
// used as given (the TPU wrapper's padding to 8 / 128 was tiling). Tokens
// of one block re-read the same A/B rows, which stay in L2 (a LoRA
// adapter of rank 8 at width 4096 is 128 KB in bf16). Left for later work:
// several tokens per block to reuse A/B from shared memory in prefill,
// tensor cores for block_t > 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// blockDim.x is a multiple of r, so thread tid always meets rank column
// tid % r in the flattened [din, r] walk over A.
template <typename T>
__global__ void sgmv_kernel(const T* __restrict__ x,        // [T, din]
                            const T* __restrict__ A,        // [n, din, r], client stride a_stride
                            const T* __restrict__ Bw,       // [n, r, dout], client stride b_stride
                            const int32_t* __restrict__ ids,  // [T / block_t]
                            T* __restrict__ y,              // [T, dout]
                            int din, int r, int dout, int n, int block_t,
                            long long a_stride, long long b_stride, float scale) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  float* x_s = smem;          // [din]
  float* red = x_s + din;     // [nt] per-thread partial sums
  float* h = red + nt;        // [r]
  const size_t t = blockIdx.x;
  const int id = ids[t / block_t];
  T* yt = y + t * dout;
  if (id < 0) {               // dead block: exact zeros
    for (int o = tid; o < dout; o += nt) yt[o] = from_f<T>(0.f);
    return;
  }
  const int a = id >= n ? n - 1 : id;
  const T* xt = x + t * din;
  for (int i = tid; i < din; i += nt) x_s[i] = to_f(xt[i]);
  __syncthreads();
  const T* Aa = A + (size_t)a * a_stride;
  float part = 0.f;
  for (int idx = tid; idx < din * r; idx += nt)
    part = fmaf(x_s[idx / r], to_f(Aa[idx]), part);
  red[tid] = part;
  __syncthreads();
  for (int j = tid; j < r; j += nt) {
    float s = 0.f;
    for (int w = j; w < nt; w += r) s += red[w];
    h[j] = s;
  }
  __syncthreads();
  const T* Bb = Bw + (size_t)a * b_stride;
  for (int o = tid; o < dout; o += nt) {
    float s = 0.f;
    for (int j = 0; j < r; ++j) s = fmaf(h[j], to_f(Bb[(size_t)j * dout + o]), s);
    yt[o] = from_f<T>(s * scale);
  }
}

template <typename T>
int launch(const void* x, const void* A, const void* B, const void* ids, void* y,
           int T_, int din, int r, int dout, int n, int block_t, long long a_stride,
           long long b_stride, float scale, cudaStream_t stream) {
  const int nt = (256 / r) * r;
  const size_t smem = sizeof(float) * ((size_t)din + nt + r);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sgmv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sgmv_kernel<T><<<T_, nt, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<const int32_t*>(ids), static_cast<T*>(y), din, r, dout, n, block_t,
      a_stride, b_stride, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. 1 <= r <= 256. Returns
// cudaGetLastError() of the launch.
extern "C" int sgmv(const void* x, const void* A, const void* B, const void* ids,
                    void* y, int T, int din, int r, int dout, int n, int block_t,
                    long long a_stride, long long b_stride, float scale, int dtype,
                    void* stream) {
  if (T == 0) return 0;
  if (r < 1 || r > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, A, B, ids, y, T, din, r, dout, n, block_t, a_stride,
                         b_stride, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, A, B, ids, y, T, din, r, dout, n, block_t,
                                 a_stride, b_stride, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
