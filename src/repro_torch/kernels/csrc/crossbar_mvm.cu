// Tiled differential-pair crossbar MVM (paper Eq. 3) for Hopper (sm_90a),
// on the tensor cores.
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
// For each row chunk r this is one GEMM: M = B, K = rows, N = C·cols,
// A = x[:, r, :] (K-contiguous), B = W_r[k, c·cols+j] = gp − gn.
//
// What bounds it on an H100: on the route it takes, f32 x costs three
// TF32 tensor-core products per product (494.7 TFLOP/s dense), bf16 x
// one bf16 product (989 TFLOP/s). At the deep app's shapes (B = 16384)
// that is below the bytes: layer 0 moves 178 MB, two thirds of it the
// partials it writes, so the bound is device memory (0.053 ms for layer
// 0), not the tensor cores. The first version of this kernel did IEEE
// f32 FMAs on the CUDA cores, held to the 67 TFLOP/s f32 rate.
//
// Design: one block of two warpgroups owns a 128 (batch) × 64 (column
// of C·cols) output tile; a column tile spans several crossbar tiles c
// when cols < 64. The TPU grid's sequential R axis becomes a loop
// inside the block, which walks (r, k) in steps of 32 crossbar rows:
//   * x arrives through a four-stage cp.async ring (16-byte copies
//     where the rows allow, zero-filled past the batch and the rows);
//     its rows are padded so that the fragment reads hit distinct banks.
//   * gp and gn are read one step ahead into registers (lanes on
//     neighbouring columns, so every load is coalesced), and gp − gn is
//     formed once per element and stored, double-buffered, as K-major
//     core matrices: f32 as its TF32 big and small halves, bf16 rounded.
//     The weights are small (1.8 MB for layer 0) and come from L2.
//   * Each warpgroup runs wgmma.m64n64 with A (x) from registers and B
//     from shared memory (mma.sync, each warp 32 × 32 with both operands
//     from registers, measured 17 % slower on layer 0):
//       f32 x:  3×TF32, k8. Each operand v splits into big = tf32(v) and
//               small = tf32(v − big), rounded to nearest with ties away
//               (integer ops on the bits: the same rounding as
//               cvt.rna.tf32.f32, which measured slower on the H100). The
//               accumulator takes a_small·b_big, then a_big·b_small,
//               then a_big·b_big; the small·small term (~2^-22
//               relative) is dropped, so a product keeps about 22
//               significant bits, where plain TF32 keeps 11. The error
//               against the IEEE f32 plain version is about 1e-6 of the
//               largest output on the deep app's operands and the test
//               sweep, within the unchanged rel bound of 1e-5, which
//               plain TF32 would not meet; tests/test_torch_kernels.py
//               emulates the split on the CPU and pins it.
//       bf16 x: k16 with bf16(gp − gn) as B: products are exact in f32
//               and sums stay f32.
//   * The scales of the next row chunk are read into shared memory a
//     chunk ahead; each chunk's sums are scaled in registers before
//     they are summed (reduce) or stored (partials), as the reference's
//     oracle does. Partials leave as 8-byte stores of neighbouring
//     columns, which fill whole 32-byte sectors; staging them through
//     shared memory for 16-byte stores measured slower.
//   * A small batch has too few output tiles to fill the card (B = 4:
//     four blocks for layer 0, each walking 28 steps). In partials mode
//     the launcher then gives each row chunk its own block (a grid of R
//     layers, a kernel instance of its own), as the reference launches
//     its kernel once per chunk.
// Ragged batch, rows and columns are masked in the kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "launch.cuh"
#include "mma.cuh"

namespace {

using repro_torch::cp_async;

constexpr int kBM = 128;           // batch rows of a block tile
constexpr int kBN = 64;            // columns of C·cols of a block tile
constexpr int kBK = 32;            // crossbar rows a pipeline step
constexpr int kThreads = 256;      // two warpgroups, 64 batch rows each
constexpr int kStages = 4;         // x ring; W is double-buffered
constexpr int kCore = 128;         // bytes of one 8 × 16-byte core matrix

template <bool kBf16>
struct Layout {
  // x rows: kBK elements plus a pad that keeps the fragment reads free
  // of bank conflicts and the rows 16-byte aligned
  static constexpr int kXS = kBf16 ? kBK + 8 : kBK + 4;  // elements
  static constexpr int kXBytes = kBM * kXS * (kBf16 ? 2 : 4);
  // W, K-major core matrices: kKCore k-elements a core row, kSBO bytes
  // between the 8-column groups; f32 keeps a big and a small half
  static constexpr int kKCore = kBf16 ? 8 : 4;
  static constexpr int kSBO = kBK / kKCore * kCore;
  static constexpr int kWHalf = kBN / 8 * kSBO;
  static constexpr int kWBytes = kBf16 ? kWHalf : 2 * kWHalf;
  // a thread stages kWItems runs of kKCore neighbouring k of one column
  static constexpr int kWItems = kBK / kKCore / (kThreads / kBN);
  // then the scales of two row chunks, kBN floats each
  static constexpr int kSmem =
      kStages * kXBytes + 2 * kWBytes + 2 * kBN * 4;
};

// Stage one step of x (kBM rows × kBK crossbar rows) into shared memory,
// kBytes a copy (cp.async), or by plain loads when kBytes is narrower
// than a 4-byte copy. T is the element's storage type.
template <typename T, int kBytes, int kXS>
__device__ __forceinline__ void load_x(T* xs, const T* x, int b0, int B,
                                       int R, int r, int rows, int k0) {
  constexpr int kE = kBytes / static_cast<int>(sizeof(T));
  constexpr int kPerRow = kBK / kE;
  for (int e = threadIdx.x; e < kBM * kPerRow; e += kThreads) {
    const int m = e / kPerRow;
    const int kk = (e % kPerRow) * kE;
    const int b = b0 + m;
    const int k = k0 + kk;
    const T* src = x;
    int n = 0;
    if (b < B && k < rows) {
      src = x + (static_cast<long long>(b) * R + r) * rows + k;
      n = min(rows - k, kE);
    }
    T* dst = xs + m * kXS + kk;
    if constexpr (kBytes >= 4) {
      cp_async<kBytes>(dst, src, n * static_cast<int>(sizeof(T)));
    } else {
      *dst = n ? *src : T(0);
    }
  }
}

template <bool kBf16>
__device__ __forceinline__ void load_x_any(void* xs, const void* x,
                                           int xbytes, int b0, int B, int R,
                                           int r, int rows, int k0) {
  constexpr int kXS = Layout<kBf16>::kXS;
  if constexpr (kBf16) {
    auto* d = static_cast<uint16_t*>(xs);
    const auto* s = static_cast<const uint16_t*>(x);
    switch (xbytes) {
      case 16: load_x<uint16_t, 16, kXS>(d, s, b0, B, R, r, rows, k0); break;
      case 8: load_x<uint16_t, 8, kXS>(d, s, b0, B, R, r, rows, k0); break;
      case 4: load_x<uint16_t, 4, kXS>(d, s, b0, B, R, r, rows, k0); break;
      default: load_x<uint16_t, 2, kXS>(d, s, b0, B, R, r, rows, k0);
    }
  } else {
    auto* d = static_cast<float*>(xs);
    const auto* s = static_cast<const float*>(x);
    if (xbytes == 16) {
      load_x<float, 16, kXS>(d, s, b0, B, R, r, rows, k0);
    } else {
      load_x<float, 4, kXS>(d, s, b0, B, R, r, rows, k0);
    }
  }
}

// One step of gp and gn as this thread reads them: column n0 + tid % 64
// (fixed for the whole block), kWItems runs of kKCore neighbouring k.
// Lanes read neighbouring columns, so each load is coalesced.
template <bool kBf16>
struct WRegs {
  static constexpr int kI = Layout<kBf16>::kWItems;
  static constexpr int kJ = Layout<kBf16>::kKCore;
  float gp[kI][kJ];
  float gn[kI][kJ];
};

template <bool kBf16>
__device__ __forceinline__ void load_w(WRegs<kBf16>& w, const float* gp,
                                       const float* gn, int at, int r,
                                       int C, int rows, int cols, int k0) {
  const long long tile = static_cast<long long>(r) * C * rows * cols + at;
#pragma unroll
  for (int i = 0; i < WRegs<kBf16>::kI; ++i)
#pragma unroll
    for (int j = 0; j < WRegs<kBf16>::kJ; ++j) {
      const int k = k0 + (threadIdx.x / kBN + i * (kThreads / kBN)) *
                             WRegs<kBf16>::kJ + j;
      const bool ok = at >= 0 && k < rows;
      const long long idx = tile + static_cast<long long>(k) * cols;
      w.gp[i][j] = ok ? __ldg(gp + idx) : 0.f;
      w.gn[i][j] = ok ? __ldg(gn + idx) : 0.f;
    }
}

// Form gp − gn once per element and store it where wgmma reads it: one
// 16-byte row of a K-major core matrix per run. f32 stores the TF32
// big and small halves, bf16 the rounded difference.
template <bool kBf16>
__device__ __forceinline__ void store_w(const WRegs<kBf16>& w,
                                        unsigned char* ws) {
  using L = Layout<kBf16>;
  const int n = threadIdx.x % kBN;
#pragma unroll
  for (int i = 0; i < L::kWItems; ++i) {
    const int kb = threadIdx.x / kBN + i * (kThreads / kBN);
    unsigned char* row = ws + (n / 8) * L::kSBO + kb * kCore + (n % 8) * 16;
    if constexpr (kBf16) {
      uint32_t h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            __fsub_rn(w.gp[i][2 * j], w.gn[i][2 * j]),
            __fsub_rn(w.gp[i][2 * j + 1], w.gn[i][2 * j + 1]));
        h[j] = *reinterpret_cast<const uint32_t*>(&v);
      }
      *reinterpret_cast<uint4*>(row) = make_uint4(h[0], h[1], h[2], h[3]);
    } else {
      uint32_t big[4];
      uint32_t small[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        repro_torch::tf32_split(__fsub_rn(w.gp[i][j], w.gn[i][j]), big[j],
                                small[j]);
      }
      *reinterpret_cast<uint4*>(row) =
          make_uint4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<uint4*>(row + L::kWHalf) =
          make_uint4(small[0], small[1], small[2], small[3]);
    }
  }
  repro_torch::fence_proxy_async();
}

// One pipeline step on the staged tiles: the warpgroup's 64 × 64 tile,
// A (x) from registers, B (W) from shared memory.
template <bool kBf16>
__device__ __forceinline__ void compute_step(const unsigned char* xs_raw,
                                             const unsigned char* ws,
                                             float (&acc)[32], int row,
                                             int t) {
  using L = Layout<kBf16>;
  if constexpr (kBf16) {
    constexpr int kXW = L::kXS / 2;   // row stride, words
    const auto* xs = reinterpret_cast<const uint32_t*>(xs_raw);
    uint32_t a[kBK / 16][4];
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      a[ks][0] = xs[row * kXW + ks * 8 + t];
      a[ks][1] = xs[(row + 8) * kXW + ks * 8 + t];
      a[ks][2] = xs[row * kXW + ks * 8 + 4 + t];
      a[ks][3] = xs[(row + 8) * kXW + ks * 8 + 4 + t];
    }
    repro_torch::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      repro_torch::wgmma_bf16(
          acc, a[ks], repro_torch::wgmma_desc(ws + ks * 2 * kCore, kCore,
                                              L::kSBO));
    }
  } else {
    constexpr int kXS = L::kXS;
    const auto* xs = reinterpret_cast<const float*>(xs_raw);
    uint32_t ab[kBK / 8][4];
    uint32_t as[kBK / 8][4];
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      const int k = ks * 8 + t;
      repro_torch::tf32_split(xs[row * kXS + k], ab[ks][0], as[ks][0]);
      repro_torch::tf32_split(xs[(row + 8) * kXS + k], ab[ks][1],
                              as[ks][1]);
      repro_torch::tf32_split(xs[row * kXS + k + 4], ab[ks][2], as[ks][2]);
      repro_torch::tf32_split(xs[(row + 8) * kXS + k + 4], ab[ks][3],
                              as[ks][3]);
    }
    repro_torch::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      const unsigned char* wb = ws + ks * 2 * kCore;
      const uint64_t big = repro_torch::wgmma_desc(wb, kCore, L::kSBO);
      const uint64_t small =
          repro_torch::wgmma_desc(wb + L::kWHalf, kCore, L::kSBO);
      repro_torch::wgmma_tf32(acc, as[ks], big);
      repro_torch::wgmma_tf32(acc, ab[ks], small);
      repro_torch::wgmma_tf32(acc, ab[ks], big);
    }
  }
  repro_torch::wgmma_commit();
  repro_torch::wgmma_wait<0>();
}

// Write the thread's two neighbouring results of one fragment row:
// out[0], out[1] for columns n, n + 1 (n even), 8 bytes at once when vec.
__device__ __forceinline__ void store_pair(float* out, int n, int ncols,
                                           float v0, float v1, bool vec) {
  if (vec && n + 1 < ncols) {
    *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
  } else {
    if (n < ncols) out[0] = v0;
    if (n + 1 < ncols) out[1] = v1;
  }
}

// What a launch computes: reduce mode; partials mode with each block
// walking every row chunk; partials mode with one row chunk a block.
enum Mode : int { kReduce, kAllChunks, kOneChunk };

template <bool kBf16, int kMode>
__global__ void __launch_bounds__(kThreads, 2)
crossbar_mvm_kernel(const void* __restrict__ x,
                    const float* __restrict__ gp,
                    const float* __restrict__ gn,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    float* __restrict__ out, int B, int R, int C, int rows,
                    int cols, int act, int xbytes, int ovec) {
  using L = Layout<kBf16>;
  constexpr bool kPartials = kMode != kReduce;
  constexpr bool kOne = kMode == kOneChunk;
  extern __shared__ __align__(128) unsigned char smem[];
  auto stage_x = [&](int s) { return smem + s * L::kXBytes; };
  auto stage_w = [&](int s) {
    return smem + kStages * L::kXBytes + s * L::kWBytes;
  };
  // the scales of row chunk r (slot r % 2), read one chunk ahead so
  // that the epilogue never waits on device memory
  float* sc_s = reinterpret_cast<float*>(smem + kStages * L::kXBytes +
                                         2 * L::kWBytes);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row = warp * 16 + g;   // warpgroup warp / 4, its warp warp % 4
  const int n0 = blockIdx.x * kBN;
  const int b0 = blockIdx.y * kBM;
  const int ncols = C * cols;
  const int ksteps = (rows + kBK - 1) / kBK;
  // kOneChunk: block z computes row chunk z alone (steps s0 .. steps -
  // 1); otherwise the block walks every chunk, in order. An instance of
  // its own: deciding this at run time in one instance slowed the walk
  // at B = 16384.
  const int r0 = kOne ? static_cast<int>(blockIdx.z) : 0;
  const int s0 = r0 * ksteps;
  const int steps = kOne ? s0 + ksteps : R * ksteps;

  // where this thread's W column starts inside a row chunk's tiles
  int at = -1;
  {
    const int n = n0 + threadIdx.x % kBN;
    const int c = n / cols;
    if (n < ncols) at = c * rows * cols + (n - c * cols);
  }
  // the scale of column n0 + tid in row chunk r (threads below kBN)
  auto scale_of = [&](int r) {
    const int n = n0 + threadIdx.x;
    return threadIdx.x < kBN && r < R && n < ncols
        ? __ldg(scale + static_cast<long long>(r) * ncols + n) : 0.f;
  };

  float acc[32];
  float total[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc[i] = 0.f;
    total[i] = 0.f;
  }

  // prologue: x for the first kStages - 1 steps, W for the first
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    const int s = s0 + j;
    if (s < steps) {
      load_x_any<kBf16>(stage_x(j), x, xbytes, b0, B, R, s / ksteps, rows,
                        (s % ksteps) * kBK);
    }
    repro_torch::cp_async_commit();
  }
  WRegs<kBf16> w;
  load_w<kBf16>(w, gp, gn, at, r0, C, rows, cols, 0);
  store_w<kBf16>(w, stage_w(0));
  if (threadIdx.x < kBN) sc_s[(r0 % 2) * kBN + threadIdx.x] = scale_of(r0);

  for (int s = s0; s < steps; ++s) {
    const int r = s / ksteps;
    const int j = s - s0;   // the block's own step: ring slots
    repro_torch::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int ahead = s + kStages - 1;
    if (ahead < steps) {  // refill the slot step s - 1 used
      load_x_any<kBf16>(stage_x((j + kStages - 1) % kStages), x, xbytes,
                        b0, B, R, ahead / ksteps, rows,
                        (ahead % ksteps) * kBK);
    }
    repro_torch::cp_async_commit();
    // chunk r + 1's scales fly while this step computes
    const float sc_next = !kOne && s % ksteps == 0 ? scale_of(r + 1) : 0.f;
    const bool more = s + 1 < steps;
    if (more) {  // the next step's W flies while this one computes
      load_w<kBf16>(w, gp, gn, at, (s + 1) / ksteps, C, rows, cols,
                    ((s + 1) % ksteps) * kBK);
    }
    compute_step<kBf16>(stage_x(j % kStages), stage_w(j % 2), acc, row, t);
    if (more) store_w<kBf16>(w, stage_w((j + 1) % 2));
    if (!kOne && s % ksteps == 0 && threadIdx.x < kBN) {
      sc_s[((r + 1) % 2) * kBN + threadIdx.x] = sc_next;
    }
    if ((s + 1) % ksteps != 0) continue;

    // end of row chunk r: scale its sums in registers, then store them
    // (partials) or add them to the running total (reduce)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = n0 + 8 * i + 2 * t;
      const float* sc = sc_s + (r % 2) * kBN + 8 * i + 2 * t;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        float* d = acc + 4 * i + 2 * v;
        const float p0 = __fmul_rn(d[0], sc[0]);
        const float p1 = __fmul_rn(d[1], sc[1]);
        d[0] = 0.f;
        d[1] = 0.f;
        const int b = b0 + row + 8 * v;
        if (kPartials) {
          if (b < B) {
            store_pair(out + (static_cast<long long>(b) * R + r) * ncols + n,
                       n, ncols, p0, p1, ovec);
          }
        } else {
          float* tt = total + 4 * i + 2 * v;
          tt[0] = __fadd_rn(tt[0], p0);
          tt[1] = __fadd_rn(tt[1], p1);
        }
      }
    }
  }
  repro_torch::cp_async_wait<0>();

  if (!kPartials) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = n0 + 8 * i + 2 * t;
      float bv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        bv[h] = (bias != nullptr && n + h < ncols) ? bias[n + h] : 0.f;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int b = b0 + row + 8 * v;
        if (b >= B) continue;
        const float* tt = total + 4 * i + 2 * v;
        store_pair(out + static_cast<long long>(b) * ncols + n, n, ncols,
                   repro_torch::activate(__fadd_rn(tt[0], bv[0]), act),
                   repro_torch::activate(__fadd_rn(tt[1], bv[1]), act),
                   ovec);
      }
    }
  }
}

template <bool kBf16, int kMode>
cudaError_t launch(dim3 grid, cudaStream_t stream, const void* x,
                   const float* gp, const float* gn, const float* scale,
                   const float* bias, float* out, int B, int R, int C,
                   int rows, int cols, int act, int xbytes, int ovec) {
  constexpr int kSmem = Layout<kBf16>::kSmem;
  static repro_torch::SmemOptIn opt_in;
  const cudaError_t attr =
      opt_in.allow(crossbar_mvm_kernel<kBf16, kMode>, kSmem);
  if (attr != cudaSuccess) return attr;
  crossbar_mvm_kernel<kBf16, kMode><<<grid, kThreads, kSmem, stream>>>(
      x, gp, gn, scale, bias, out, B, R, C, rows, cols, act, xbytes, ovec);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_mode(int mode, dim3 grid, cudaStream_t stream,
                        const void* x, const float* gp, const float* gn,
                        const float* scale, const float* bias, float* out,
                        int B, int R, int C, int rows, int cols, int act,
                        int xbytes, int ovec) {
  switch (mode) {
    case kReduce:
      return launch<kBf16, kReduce>(grid, stream, x, gp, gn, scale, bias,
                                    out, B, R, C, rows, cols, act, xbytes,
                                    ovec);
    case kAllChunks:
      return launch<kBf16, kAllChunks>(grid, stream, x, gp, gn, scale, bias,
                                       out, B, R, C, rows, cols, act, xbytes,
                                       ovec);
    default:
      return launch<kBf16, kOneChunk>(grid, stream, x, gp, gn, scale, bias,
                                      out, B, R, C, rows, cols, act, xbytes,
                                      ovec);
  }
}

// The widest copy (16, 8, 4 bytes; 2 = plain loads) that every x row
// step of the launch allows: rows · element size and the base pointer
// must both be multiples of it.
int x_copy_bytes(const void* x, int el, int rows) {
  const auto addr = reinterpret_cast<uintptr_t>(x);
  for (int bytes : {16, 8, 4}) {
    if (bytes < el) break;
    if ((static_cast<long long>(rows) * el) % bytes == 0 &&
        addr % bytes == 0) {
      return bytes;
    }
  }
  return el < 4 ? el : 4;
}

}  // namespace

// C entry point bound with ctypes. Pointers are device pointers; bias
// may be null (no bias). Returns the launch's cudaError_t.
extern "C" int crossbar_mvm_launch(const void* x, int x_bf16,
                                   const void* gp, const void* gn,
                                   const void* scale, const void* bias,
                                   void* out, int B, int R, int C, int rows,
                                   int cols, int activation, int partials,
                                   void* stream) {
  dim3 grid((C * cols + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  int mode = partials ? kAllChunks : kReduce;
  // partials mode: when the output tiles alone would leave SMs idle (a
  // small batch), each row chunk gets its own block
  if (partials && R > 1 &&
      static_cast<int>(grid.x * grid.y) < repro_torch::sm_count()) {
    mode = kOneChunk;
    grid.z = R;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* gpf = static_cast<const float*>(gp);
  const auto* gnf = static_cast<const float*>(gn);
  const auto* sf = static_cast<const float*>(scale);
  const auto* bf = static_cast<const float*>(bias);
  auto* of = static_cast<float*>(out);
  const int xb = x_copy_bytes(x, x_bf16 ? 2 : 4, rows);
  // 8-byte stores of neighbouring columns where every row allows them
  const int ov = (C * cols) % 2 == 0 &&
                 reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const cudaError_t err = x_bf16
      ? launch_mode<true>(mode, grid, s, x, gpf, gnf, sf, bf, of, B, R, C,
                          rows, cols, activation, xb, ov)
      : launch_mode<false>(mode, grid, s, x, gpf, gnf, sf, bf, of, B, R, C,
                           rows, cols, activation, xb, ov);
  return static_cast<int>(err);
}
