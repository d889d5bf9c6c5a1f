// The SRAM digital core's int8 MAC array for Hopper (sm_90a).
//
// Replaces the TPU kernels in src/repro/kernels/int8_matmul.py:
// _kernel_fused (the requantize epilogue, int8_matmul with scale) and
// _kernel_raw (the bare MAC array, int8_matmul without scale), both
// launched there through pl.pallas_call. For x (B, K) uint8 or int8
// codes and w (K, N) int8 synapses it computes the exact int32
// accumulator acc = Σ_k x[b,k]·w[k,n] and then
//
//   fused: out[b, n] = act(f32(acc)·scale[n] + offset[n])   (B, N) f32
//   raw:   out[b, n] = acc                                  (B, N) int32
//
// The epilogue rounds the product and the sum separately (no FMA), as
// the reference does, so the fused output equals the plain version's.
//
// What bounds it on an H100: one byte per operand element against
// 2·K operations per output, so at the deep app's digital shapes
// (B = 16384, K = 784/200/100) the bound is the bytes — x once and the
// f32 output once at 3.35 TB/s — not the 1,979 TOP/s int8 tensor-core
// rate. This first kernel is not near either: it multiplies on the
// CUDA cores in int32 (no tensor cores, no dp4a), so its own ceiling is
// the int32 multiply-add rate. The int8 tensor-core path is later work.
//
// Design: the TPU grid's sequential K axis becomes a loop inside the
// block. One block owns a 64 × 64 output tile, walks K in steps of 64
// staging both operands in shared memory as int32 (unsigned codes are
// widened without a re-centre, which only the tensor-core path needs),
// and every thread keeps a 4 × 4 micro-tile of int32 accumulators in
// registers. Ragged B, K and N edges are masked in the kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kBatchTile = 64;
constexpr int kColTile = 64;
constexpr int kDepthStep = 64;
constexpr int kThreads = 256;  // 16 × 16 threads, 4 × 4 outputs each

template <bool kSigned, bool kFused>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const void* __restrict__ x_raw,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ offset,
                   void* __restrict__ out, int B, int K, int N, int act) {
  __shared__ int xs[kDepthStep][kBatchTile + 1];
  __shared__ int ws[kDepthStep][kColTile];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int b0 = blockIdx.x * kBatchTile;
  const int n0 = blockIdx.y * kColTile;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kDepthStep) {
    for (int e = tid; e < kBatchTile * kDepthStep; e += kThreads) {
      const int bb = e / kDepthStep;
      const int kk = e % kDepthStep;
      const int b = b0 + bb;
      const int k = k0 + kk;
      int v = 0;
      if (b < B && k < K) {
        const long long idx = static_cast<long long>(b) * K + k;
        v = kSigned ? static_cast<int>(static_cast<const int8_t*>(x_raw)[idx])
                    : static_cast<int>(static_cast<const uint8_t*>(x_raw)[idx]);
      }
      xs[kk][bb] = v;
    }
    for (int e = tid; e < kDepthStep * kColTile; e += kThreads) {
      const int kk = e / kColTile;
      const int nn = e % kColTile;
      const int k = k0 + kk;
      const int n = n0 + nn;
      ws[kk][nn] = (k < K && n < N)
          ? static_cast<int>(w[static_cast<long long>(k) * N + n]) : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kDepthStep; ++kk) {
      int a[4];
      int b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    float s = 0.f;
    float o = 0.f;
    if (kFused) {
      s = scale[n];
      o = offset != nullptr ? offset[n] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = b0 + ty + 16 * i;
      if (b >= B) continue;
      const long long idx = static_cast<long long>(b) * N + n;
      if (kFused) {
        const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), s), o);
        static_cast<float*>(out)[idx] = repro_torch::activate(y, act);
      } else {
        static_cast<int*>(out)[idx] = acc[i][j];
      }
    }
  }
}

template <bool kSigned, bool kFused>
void launch(dim3 grid, cudaStream_t stream, const void* x, const int8_t* w,
            const float* scale, const float* offset, void* out, int B, int K,
            int N, int act) {
  int8_matmul_kernel<kSigned, kFused><<<grid, kThreads, 0, stream>>>(
      x, w, scale, offset, out, B, K, N, act);
}

}  // namespace

// C entry point bound with ctypes. Pointers are device pointers; with
// fused == 0 the output is int32 and scale/offset are ignored; offset
// may be null (zero). Returns cudaGetLastError() after the launch.
extern "C" int int8_matmul_launch(const void* x, int x_signed, const void* w,
                                  const void* scale, const void* offset,
                                  void* out, int B, int K, int N,
                                  int activation, int fused, void* stream) {
  const dim3 grid((B + kBatchTile - 1) / kBatchTile,
                  (N + kColTile - 1) / kColTile);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* wi = static_cast<const int8_t*>(w);
  const auto* sf = static_cast<const float*>(scale);
  const auto* of = static_cast<const float*>(offset);
  if (x_signed) {
    if (fused) {
      launch<true, true>(grid, s, x, wi, sf, of, out, B, K, N, activation);
    } else {
      launch<true, false>(grid, s, x, wi, sf, of, out, B, K, N, activation);
    }
  } else {
    if (fused) {
      launch<false, true>(grid, s, x, wi, sf, of, out, B, K, N, activation);
    } else {
      launch<false, false>(grid, s, x, wi, sf, of, out, B, K, N, activation);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
