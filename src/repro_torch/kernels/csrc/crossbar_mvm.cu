// Tiled differential-pair crossbar MVM (paper Eq. 3) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/crossbar_mvm.py (_kernel,
// launched by crossbar_mvm through pl.pallas_call). It computes, for x
// (B, R, rows) in f32 or bf16, gp/gn (R, C, rows, cols) f32 conductance
// tiles and the program-time folded scale (R, C, cols):
//
//   reduce mode:   out[b, c·cols+j] = act(Σ_r num_r[b, j]·scale[r,c,j]
//                                         + bias[c·cols+j])   (B, C·cols)
//   partials mode: out[b, r, c·cols+j] = num_r[b, j]·scale[r,c,j]
//                                                          (B, R, C·cols)
//   with num_r[b, j] = Σ_k x[b,r,k]·(gp[r,c,k,j] − gn[r,c,k,j]).
//
// Partials mode is the memristor chip's sub-neuron stage: the reference
// vmaps its kernel once per row chunk so the partials reach the
// programmed Fig. 11 combiner neurons apart; here one launch writes all
// R of them. With a bf16 x the combined tile is rounded to bf16, as the
// TPU kernel does before its MXU pass; products and sums stay f32.
//
// What bounds it on an H100: the kernel does IEEE f32 FMAs on the CUDA
// cores (no TF32), so its operations bound is the 67 TFLOP/s f32 rate,
// whose ridge point is 67e12 / 3.35e12 ≈ 20 FLOP per byte. At the deep
// app's shapes (B = 16384, 128 × 64 tiles) the three layers do 42, 32
// and 21 FLOP per byte moved, partials included: operations bound, the
// last layer close to the ridge.
//
// Design: a grid dimension cannot carry a sum on a GPU, so the TPU's
// sequential R axis becomes a loop inside the block. One block owns a
// 64 (batch) × 64 (column) output tile of one column tile c; it walks
// r and the crossbar rows in steps of 32, staging x and the combined
// tile gp − gn in shared memory (the difference is formed once per
// element, in the load), and every thread keeps a 4 × 4 micro-tile of
// sums in registers. Each row chunk's sum is scaled in registers, then
// either added to the running total (reduce) or stored (partials). The
// ragged batch edge and cols below 64 are masked in the kernel; cols
// down to 16 and rows down to 32 (or any other size) work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int kBatchTile = 64;
constexpr int kColTile = 64;
constexpr int kRowStep = 32;
constexpr int kThreads = 256;  // 16 × 16 threads, 4 × 4 outputs each

template <bool kBf16, bool kPartials>
__global__ void __launch_bounds__(kThreads)
crossbar_mvm_kernel(const void* __restrict__ x_raw,
                    const float* __restrict__ gp,
                    const float* __restrict__ gn,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    float* __restrict__ out, int B, int R, int C, int rows,
                    int cols, int act) {
  __shared__ float xs[kRowStep][kBatchTile + 1];
  __shared__ float ws[kRowStep][kColTile];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int b0 = blockIdx.x * kBatchTile;
  const int col_blocks = (cols + kColTile - 1) / kColTile;
  const int c = blockIdx.y / col_blocks;
  const int j0 = (blockIdx.y % col_blocks) * kColTile;
  const long long out_cols = static_cast<long long>(C) * cols;

  float total[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) total[i][j] = 0.f;

  for (int r = 0; r < R; ++r) {
    float num[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) num[i][j] = 0.f;

    const long long tile = (static_cast<long long>(r) * C + c) * rows * cols;
    for (int k0 = 0; k0 < rows; k0 += kRowStep) {
      for (int e = tid; e < kBatchTile * kRowStep; e += kThreads) {
        const int bb = e / kRowStep;
        const int kk = e % kRowStep;
        const int b = b0 + bb;
        const int k = k0 + kk;
        float v = 0.f;
        if (b < B && k < rows) {
          const long long idx = (static_cast<long long>(b) * R + r) * rows + k;
          if (kBf16) {
            v = __bfloat162float(
                static_cast<const __nv_bfloat16*>(x_raw)[idx]);
          } else {
            v = static_cast<const float*>(x_raw)[idx];
          }
        }
        xs[kk][bb] = v;
      }
      for (int e = tid; e < kRowStep * kColTile; e += kThreads) {
        const int kk = e / kColTile;
        const int jj = e % kColTile;
        const int k = k0 + kk;
        const int j = j0 + jj;
        float w = 0.f;
        if (k < rows && j < cols) {
          const long long idx = tile + static_cast<long long>(k) * cols + j;
          w = __fsub_rn(gp[idx], gn[idx]);
          if (kBf16) w = __bfloat162float(__float2bfloat16(w));
        }
        ws[kk][jj] = w;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kRowStep; ++kk) {
        float a[4];
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) num[i][j] = fmaf(a[i], w[j], num[i][j]);
      }
      __syncthreads();
    }

    // scale each row chunk's partial before it is summed or stored
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + tx + 16 * j;
      const float s = col < cols
          ? scale[(static_cast<long long>(r) * C + c) * cols + col] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = __fmul_rn(num[i][j], s);
        if (kPartials) {
          const int b = b0 + ty + 16 * i;
          if (b < B && col < cols) {
            out[(static_cast<long long>(b) * R + r) * out_cols +
                static_cast<long long>(c) * cols + col] = p;
          }
        } else {
          total[i][j] = __fadd_rn(total[i][j], p);
        }
      }
    }
  }

  if (!kPartials) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + tx + 16 * j;
      if (col >= cols) continue;
      const long long n = static_cast<long long>(c) * cols + col;
      const float bv = bias != nullptr ? bias[n] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int b = b0 + ty + 16 * i;
        if (b < B) {
          out[static_cast<long long>(b) * out_cols + n] =
              repro_torch::activate(__fadd_rn(total[i][j], bv), act);
        }
      }
    }
  }
}

template <bool kBf16, bool kPartials>
void launch(dim3 grid, cudaStream_t stream, const void* x, const float* gp,
            const float* gn, const float* scale, const float* bias,
            float* out, int B, int R, int C, int rows, int cols, int act) {
  crossbar_mvm_kernel<kBf16, kPartials><<<grid, kThreads, 0, stream>>>(
      x, gp, gn, scale, bias, out, B, R, C, rows, cols, act);
}

}  // namespace

// C entry point bound with ctypes. Pointers are device pointers; bias
// may be null (no bias). Returns cudaGetLastError() after the launch.
extern "C" int crossbar_mvm_launch(const void* x, int x_bf16,
                                   const void* gp, const void* gn,
                                   const void* scale, const void* bias,
                                   void* out, int B, int R, int C, int rows,
                                   int cols, int activation, int partials,
                                   void* stream) {
  const dim3 grid((B + kBatchTile - 1) / kBatchTile,
                  C * ((cols + kColTile - 1) / kColTile));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* gpf = static_cast<const float*>(gp);
  const auto* gnf = static_cast<const float*>(gn);
  const auto* sf = static_cast<const float*>(scale);
  const auto* bf = static_cast<const float*>(bias);
  auto* of = static_cast<float*>(out);
  if (x_bf16) {
    if (partials) {
      launch<true, true>(grid, s, x, gpf, gnf, sf, bf, of, B, R, C, rows,
                         cols, activation);
    } else {
      launch<true, false>(grid, s, x, gpf, gnf, sf, bf, of, B, R, C, rows,
                          cols, activation);
    }
  } else {
    if (partials) {
      launch<false, true>(grid, s, x, gpf, gnf, sf, bf, of, B, R, C, rows,
                          cols, activation);
    } else {
      launch<false, false>(grid, s, x, gpf, gnf, sf, bf, of, B, R, C, rows,
                           cols, activation);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
