// Token-packed frozen base linear for Hopper (sm_90a):
// y[budget, dout] = buf[budget, din] @ w[din, dout] (+ b), rows >= n_live
// written as exact zeros, fp32 accumulation, fp32 or bf16 in and out.
//
// Replaces the TPU kernel src/repro/kernels/ragged_linear/ragged_linear.py:54
// ragged_linear_pallas (_rl_kernel :23), the paper's §3.7 packed base-layer
// execution. The TPU grid (token tile, dout tile, din tile) ran the din axis
// sequentially with the fp32 sum in VMEM scratch and skipped token tiles past
// the scalar-prefetched live count. Here the live count is read from device
// memory (or passed by value), so the host never waits for it, and no tile
// whose rows all lie past it is computed.
//
// What bounds it on the card: operations. A 1,001-token x 4096 x 12800 call
// is ~1.05e11 flops against ~0.13 GB of traffic, far right of the H100's
// ridge, and the card's operations rate lives in the bf16 tensor cores, which
// only wgmma reaches. Two entry points, picked by the wrapper from dtype,
// strides and alignment before the launch:
//
// ragged_linear_tc (bf16, rows of buf and w on 16-byte strides, 16-byte
// aligned bases): a persistent, warp-specialised wgmma kernel. One block per
// SM walks the live 128 x BN output tiles (row tile fastest, so the blocks in
// flight share their w columns through L2). A producer thread keeps a ring of
// kStages shared-memory stages full by TMA (128-byte swizzle, mbarrier
// completion): buf [128 x 64] K-major, w [64 x BN] N-major (w is
// [din, dout], dout contiguous, so wgmma reads B transposed). Two consumer
// warpgroups issue wgmma.mma_async m64nBNk16 on rows 0-63 and 64-127 with
// fp32 accumulators in registers, keeping one k-block of wgmma in flight
// while they release the stage before it. The epilogue adds the bias in fp32,
// rounds to bf16 once and writes rows >= n_live as +0.0; the row tiles past
// the live count are written as zeros by every block without reading buf.
// TMA fills out-of-bounds loads with zeros, so ragged din, dout and budget
// need no padding; stores are bounds-checked. BN is 256, 128 or 64, picked
// on the host from the rows that may be live, dout and the SM count
// (tile_width): wide tiles read fewer shared-memory bytes per flop, narrow
// ones fill the SMs when tiles are few (granite's k and v at 1,001 live
// rows: 64 tiles of 128 x 128 on 132 SMs become 128 of 128 x 64). At BN 256
// each consumer thread holds 128 fp32 accumulators, so the producer
// warpgroup gives registers back (setmaxnreg: 40 for it, 232 for them). The
// tensor maps are encoded on the host for each call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library needs no -lcuda)
// and passed as __grid_constant__ parameters.
//
// ragged_linear (fp32, and bf16 that a tensor map cannot describe): a
// register-tiled SGEMM on the CUDA cores (each thread 8 x 8 outputs of a
// 128 x 128 tile from 4-wide shared-memory reads, rows and columns split in
// two halves of 64 so the 16-byte reads hit distinct banks). fp32 inputs are
// computed in fp32 (wgmma would be TF32), bf16 inputs widened on the way
// into shared memory.
//
// Shapes are arbitrary in both: w may be a view with strided rows (ldw >=
// dout, unit column stride).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {
namespace simt {

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

}  // namespace simt

namespace tc {

constexpr int kBM = 128, kBK = 64;     // tile rows; din per stage (128 bytes)
// stages of the ring: as many as fit beside the barriers in 227 KB
template <int BN>
constexpr int kStagesOf = BN == 256 ? 4 : 5;
constexpr int kConsumers = 2;          // warpgroups, 64 rows each
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kBoxW = 64;              // w box: 64 columns (128 bytes) x kBK rows
constexpr int kTensorMapError = 100001;

using namespace hopper;

// 2-D TMA load of the box at (c0 innermost, c1) into dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// D[64 x N] (+)= A[64 x 16] (K-major) * B[16 x N] (N-major, transposed)
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                          int scale_d) {
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
      " %64, %65, p, 1, 1, 0, 1;\n}\n"
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
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 1;\n}\n"
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

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void mma_k16(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    wgmma_n256(d, da, db, 1);
  else if constexpr (BN == 128)
    wgmma_n128(d, da, db, 1);
  else
    wgmma_n64(d, da, db, 1);
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1) ragged_linear_tc_kernel(
    const __grid_constant__ CUtensorMap map_x,  // buf [budget, din], box kBK x kBM
    const __grid_constant__ CUtensorMap map_w,  // w [din, dout], box kBoxW x kBK
    const __nv_bfloat16* __restrict__ bias,     // [dout] or nullptr
    const int32_t* __restrict__ n_dev,          // live count on the card, or nullptr
    int n_host, __nv_bfloat16* __restrict__ y,  // [budget, dout]
    int budget, int din, int dout) {
  constexpr int kABytes = kBM * kBK * 2;      // 16 KB
  constexpr int kWBox = kBK * kBoxW * 2;      // 8 KB
  constexpr int kStage = kABytes + (BN / kBoxW) * kWBox;
  constexpr int kStages = kStagesOf<BN>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms repeat every 1024 bytes: stages start on them
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;

  const int n_live = max(0, min(n_dev ? *n_dev : n_host, budget));
  const int live_rt = (n_live + kBM - 1) / kBM;   // row tiles holding a live row
  const int tiles = live_rt * ((dout + BN - 1) / BN);
  const int nk = (din + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer warpgroup: one thread issues every load; at BN 256 the
    // warpgroup hands registers to the consumers' 128 accumulators
    if constexpr (BN == 256) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int s = 0, ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % live_rt) * kBM, n0 = (t / live_rt) * BN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[s], ph ^ 1);
          uint8_t* st = smem + s * kStage;
          mbar_expect_tx(&full[s], kStage);  // out-of-bounds fill counts too
          tma_load(st, &map_x, &full[s], kb * kBK, m0);
#pragma unroll
          for (int j = 0; j < BN / kBoxW; ++j)
            tma_load(st + kABytes + j * kWBox, &map_w, &full[s], n0 + j * kBoxW, kb * kBK);
          if (++s == kStages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of each tile
  if constexpr (BN == 256) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = tid / 32, lane = tid % 32;
  float acc[BN / 2];
  int s = 0, ph = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % live_rt) * kBM, n0 = (t / live_rt) * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int prev = 0;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[s], ph);
      const uint8_t* a = smem + s * kStage + wg * 64 * (kBK * 2);
      const uint8_t* bw = smem + s * kStage + kABytes;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        // A: +32 bytes per 16 columns inside the swizzled 128-byte rows, 8-row
        // groups 1024 bytes apart. B: +16 rows of 128 bytes per k16, 8-row
        // groups 1024 bytes apart, the next 64 columns one box (kWBox) on.
        mma_k16<BN>(acc, desc(a + kk * 32, 16, 1024), desc(bw + kk * 16 * 128, kWBox, 1024));
      wgmma_commit();
      fence_acc(acc);
      if (kb > 0) {  // the k-block before this one is done: free its stage
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == kStages) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (nk > 0 && lane == 0) mbar_arrive(&empty[prev]);

    // epilogue: thread (warp, lane) holds rows r and r + 8, columns
    // c + 8j + {0, 1} of the warpgroup's 64 x BN block
    const int r = m0 + wg * 64 + warp * 16 + lane / 4;
    const int c = n0 + 2 * (lane % 4);
    const bool pairs = (dout % 2) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = c + 8 * j;
      if (col >= dout) continue;
      const bool two = col + 1 < dout;
      float b0 = 0.f, b1 = 0.f;
      if (bias) {
        b0 = __bfloat162float(bias[col]);
        if (two) b1 = __bfloat162float(bias[col + 1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r + 8 * h;
        if (row >= budget) continue;
        const bool live = row < n_live;
        const float v0 = live ? acc[4 * j + 2 * h] + b0 : 0.f;
        const float v1 = live ? acc[4 * j + 2 * h + 1] + b1 : 0.f;
        __nv_bfloat16* out = y + (size_t)row * dout + col;
        if (two && pairs) {
          *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
        } else {
          out[0] = __float2bfloat16(v0);
          if (two) out[1] = __float2bfloat16(v1);
        }
      }
    }
  }

  // row tiles past the live count: zeros, without reading buf or w
  const size_t z0 = (size_t)min(live_rt * kBM, budget) * dout, z1 = (size_t)budget * dout;
  const size_t i0 = (size_t)blockIdx.x * (kConsumers * 128) + threadIdx.x;
  const size_t step = (size_t)gridDim.x * (kConsumers * 128);
  if (dout % 8 == 0) {
    uint4* y8 = reinterpret_cast<uint4*>(y);
    for (size_t i = z0 / 8 + i0; i < z1 / 8; i += step) y8[i] = make_uint4(0, 0, 0, 0);
  } else {
    for (size_t i = z0 + i0; i < z1; i += step) y[i] = __float2bfloat16(0.f);
  }
}

// a bf16 row-major [rows, cols] matrix with row stride ld (elements), boxes
// of box_cols x box_rows, 128-byte swizzle, zeros out of bounds
bool encode(CUtensorMap* map, const void* base, int rows, int cols, long long ld,
            int box_cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estrides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tile width BN for `rows` rows that may be live (the live count when
// the host has it, else the budget): the least estimated time, waves of
// tiles over the SMs times each tile's cost, BN x (1.0, 1.2, 1.7) for BN
// 256, 128, 64 (a narrower tile re-reads buf's tile from shared memory for
// fewer columns). Fitted to granite's seven projections at 1,001 of 1,024
// and 1,030 or 2,048 of 2,048 rows on the H100; it picks the fastest of
// the three there in every case.
int tile_width(int rows, int dout, int sms) {
  const long long row_tiles = (rows + kBM - 1) / kBM;
  int best = 256;
  long long best_cost = -1;
  const int widths[3] = {256, 128, 64};
  for (int bn : widths) {
    const long long tiles = row_tiles * ((dout + bn - 1) / bn);
    const long long cost =
        (tiles + sms - 1) / sms * bn * (bn == 256 ? 10 : bn == 128 ? 12 : 17);
    if (best_cost < 0 || cost < best_cost) {
      best = bn;
      best_cost = cost;
    }
  }
  return best;
}

template <int BN>
int launch(const CUtensorMap& mx, const CUtensorMap& mw, const void* bias, const void* n_dev,
           int n_host, void* y, int budget, int din, int dout, int grid,
           cudaStream_t stream) {
  constexpr int kStage = kBM * kBK * 2 + kBK * BN * 2;
  const int smem = kStagesOf<BN> * kStage + 1024 + 2 * kStagesOf<BN> * 8;
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(ragged_linear_tc_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  ragged_linear_tc_kernel<BN><<<grid, kThreads, smem, stream>>>(
      mx, mw, static_cast<const __nv_bfloat16*>(bias), static_cast<const int32_t*>(n_dev),
      n_host, static_cast<__nv_bfloat16*>(y), budget, din, dout);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace

// The SIMT entry point. dtype (of buf, w, b and y): 0 = float32,
// 1 = bfloat16. bias and n_dev may be null. Returns cudaGetLastError() of
// the launch.
extern "C" int ragged_linear(const void* x, const void* w, const void* bias,
                             const void* n_dev, int n_host, void* y, int budget, int din,
                             int dout, long long ldw, int dtype, void* stream) {
  if (budget == 0 || dout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return simt::launch<float>(x, w, bias, n_dev, n_host, y, budget, din, dout, ldw, s);
  if (dtype == 1)
    return simt::launch<__nv_bfloat16>(x, w, bias, n_dev, n_host, y, budget, din, dout, ldw,
                                       s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core entry point: bf16 buf [budget, din] (row stride din), w
// [din, dout] (row stride ldw), both row strides multiples of 8 elements and
// both bases 16-byte aligned (what a tensor map needs; the wrapper checks).
// bias and n_dev may be null. Returns cudaGetLastError() of the launch, or
// kTensorMapError if a tensor map could not be encoded.
extern "C" int ragged_linear_tc(const void* x, const void* w, const void* bias,
                                const void* n_dev, int n_host, void* y, int budget, int din,
                                int dout, long long ldw, void* stream) {
  if (budget == 0 || dout == 0) return 0;
  CUtensorMap mx, mw;
  if (!tc::encode(&mx, x, budget, din, din, tc::kBK, tc::kBM) ||
      !tc::encode(&mw, w, din, dout, ldw, tc::kBoxW, tc::kBK))
    return tc::kTensorMapError;
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // A persistent grid: one block per SM, or one per tile of the whole
  // buffer when there are fewer (every block also zeroes dead rows).
  const long long row_tiles = (budget + tc::kBM - 1) / tc::kBM;
  auto grid = [&](int bn) {
    const long long t = row_tiles * ((dout + bn - 1) / bn);
    return (int)(t < sms ? t : sms);
  };
  switch (tc::tile_width(n_dev ? budget : (n_host < budget ? n_host : budget), dout, sms)) {
    case 256:
      return tc::launch<256>(mx, mw, bias, n_dev, n_host, y, budget, din, dout, grid(256), s);
    case 128:
      return tc::launch<128>(mx, mw, bias, n_dev, n_host, y, budget, din, dout, grid(128), s);
    default:
      return tc::launch<64>(mx, mw, bias, n_dev, n_host, y, budget, din, dout, grid(64), s);
  }
}

extern "C" const char* error_string(int err) {
  if (err == tc::kTensorMapError) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
