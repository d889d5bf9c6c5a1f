// The SRAM digital core's int8 MAC array for Hopper (sm_90a), on the
// int8 tensor cores.
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
// (B = 16384, K = 784/200/100) the bound is the bytes (x once and the
// output once at 3.35 TB/s, 7.8 µs for layer 0), far below the 1,979
// TOP/s int8 tensor-core rate. The first version of this kernel
// multiplied in int32 on the CUDA cores, one MAC an instruction, and
// was held to that issue rate at about 2 % of the bound.
//
// Design: mma.sync.m16n8k32 takes the uint8 codes against the int8
// synapses directly (.u8.s8; .s8.s8 for signed x), so nothing is
// re-centred and the int32 accumulator is exactly the reference's. One
// block of 16 warps owns 128 batch rows × all N (one column tile of
// 256; wider N takes several), so each x byte is read from device
// memory once. The tile is 64 columns instead when N ≤ 64 (a 256-column
// tile computes 25× the 10 columns of the deep app's last layer) or the
// batch is one row tile (serving: N = 200 then spreads over four blocks
// instead of one). It walks K in steps of 64 bytes:
//   * x through a four-stage cp.async ring. Rows of 200 or 100 bytes
//     (the deep app's later layers) are not 16-byte aligned, so the
//     launcher picks the copy width (16, 8 or 4 bytes; plain byte loads
//     for odd K, as the paper's 9-input apps have) from K and the
//     pointer, as a template parameter. The ragged last step (784 =
//     12.25 × 64) is zero-filled.
//   * w, which is (K, N) N-contiguous, while the 8-bit mma wants its B
//     operand K-contiguous: each thread reads a 4 (k) × 4 (n) block one
//     step ahead into registers, transposes it with byte permutes, and
//     stores it as [n][k]. Nothing transposed is kept in DigitalParams
//     and the wrapper launches nothing else.
// Shared-memory rows are padded to 80 bytes, which keeps the fragment
// reads and the transposed stores free of bank conflicts. Each warp
// owns 16 rows × half the column tile; the epilogue runs on the
// accumulator registers. Ragged B, K and N edges are masked in the
// kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "launch.cuh"
#include "mma.cuh"

namespace {

constexpr int kBM = 128;            // batch rows of a block
constexpr int kBK = 64;             // bytes of K a pipeline step
constexpr int kThreads = 512;       // 16 warps: 8 (batch) × 2 (columns)
constexpr int kStages = 4;          // x ring
constexpr int kRow = kBK + 16;      // shared-memory row, bytes
constexpr int kRowW = kRow / 4;     // the same, in 32-bit words
constexpr int kXStage = kBM * kRow;

template <int kBN>
constexpr int smem_bytes() {
  return kStages * kXStage + 2 * kBN * kRow;
}

// Stage one step of x (kBM rows × kBK bytes), kBytes a copy.
template <int kBytes>
__device__ __forceinline__ void load_x(unsigned char* xs,
                                       const unsigned char* x, int b0,
                                       int B, int K, int k0) {
  constexpr int kPerRow = kBK / kBytes;
  for (int e = threadIdx.x; e < kBM * kPerRow; e += kThreads) {
    const int m = e / kPerRow;
    const int kk = (e % kPerRow) * kBytes;
    const int b = b0 + m;
    const int k = k0 + kk;
    const unsigned char* src = x;
    int n = 0;
    if (b < B && k < K) {
      src = x + static_cast<long long>(b) * K + k;
      n = min(K - k, kBytes);
    }
    if constexpr (kBytes >= 4) {
      repro_torch::cp_async<kBytes>(xs + m * kRow + kk, src, n);
    } else {
      xs[m * kRow + kk] = n ? *src : 0;
    }
  }
}

// One step of w as this thread stages it: 4 (k) × 4 (n) blocks, each
// already transposed to four words of 4 k-neighbours, one per column.
template <int kBN>
struct WRegs {
  static constexpr int kItems = (kBK / 4) * (kBN / 4) / kThreads > 0
      ? (kBK / 4) * (kBN / 4) / kThreads : 1;
  uint32_t v[kItems][4];
};

// Work item e: k quad e % 16 and n quad e / 16, so that a warp's
// transposed stores fall in distinct banks.
template <int kBN>
__device__ __forceinline__ void load_w(WRegs<kBN>& w, const int8_t* wg,
                                       int K, int N, int n0, int k0,
                                       bool vec) {
#pragma unroll
  for (int i = 0; i < WRegs<kBN>::kItems; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int k = k0 + 4 * (e % (kBK / 4));
    const int n = n0 + 4 * (e / (kBK / 4));
    uint32_t r[4];
    if (e >= (kBK / 4) * (kBN / 4)) {
#pragma unroll
      for (int j = 0; j < 4; ++j) w.v[i][j] = 0;
      continue;
    }
    if (vec) {  // N % 4 == 0 and w 4-byte aligned: a quad is one word
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r[j] = (k + j < K && n < N)
            ? __ldg(reinterpret_cast<const uint32_t*>(
                  wg + static_cast<long long>(k + j) * N + n))
            : 0u;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t word = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (k + j < K && n + q < N) {
            const auto byte = static_cast<unsigned char>(
                __ldg(wg + static_cast<long long>(k + j) * N + n + q));
            word |= static_cast<uint32_t>(byte) << (8 * q);
          }
        }
        r[j] = word;
      }
    }
    // r[j] holds row k + j, byte q = column n + q; transpose to one word
    // per column, byte j = row k + j
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    w.v[i][0] = __byte_perm(t0, t2, 0x5410);
    w.v[i][1] = __byte_perm(t0, t2, 0x7632);
    w.v[i][2] = __byte_perm(t1, t3, 0x5410);
    w.v[i][3] = __byte_perm(t1, t3, 0x7632);
  }
}

template <int kBN>
__device__ __forceinline__ void store_w(const WRegs<kBN>& w, uint32_t* wt) {
#pragma unroll
  for (int i = 0; i < WRegs<kBN>::kItems; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e >= (kBK / 4) * (kBN / 4)) continue;
    const int kq = e % (kBK / 4);
    const int nn = 4 * (e / (kBK / 4));
#pragma unroll
    for (int j = 0; j < 4; ++j) wt[(nn + j) * kRowW + kq] = w.v[i][j];
  }
}

template <bool kSigned, int kXBytes, int kBN>
__global__ void __launch_bounds__(kThreads, 1)
int8_matmul_kernel(const unsigned char* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ offset,
                   void* __restrict__ out, int B, int K, int N, int act,
                   int fused, int wvec) {
  constexpr int kNT = kBN / 16;   // n8 fragments a warp
  extern __shared__ __align__(16) unsigned char smem[];
  auto xs = [&](int s) { return smem + s * kXStage; };
  auto wt = [&](int s) {
    return reinterpret_cast<uint32_t*>(smem + kStages * kXStage +
                                       s * kBN * kRow);
  };

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm = warp % 8;
  const int wn = warp / 8;
  const int g = lane / 4;
  const int t = lane % 4;
  const int n0 = blockIdx.x * kBN;
  const int b0 = blockIdx.y * kBM;
  const int steps = (K + kBK - 1) / kBK;

  int acc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_x<kXBytes>(xs(s), x, b0, B, K, s * kBK);
    repro_torch::cp_async_commit();
  }
  WRegs<kBN> wr;
  load_w<kBN>(wr, w, K, N, n0, 0, wvec);
  store_w<kBN>(wr, wt(0));

  for (int s = 0; s < steps; ++s) {
    repro_torch::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int ahead = s + kStages - 1;
    if (ahead < steps) {
      load_x<kXBytes>(xs(ahead % kStages), x, b0, B, K, ahead * kBK);
    }
    repro_torch::cp_async_commit();
    if (s + 1 < steps) load_w<kBN>(wr, w, K, N, n0, (s + 1) * kBK, wvec);

    const auto* xw = reinterpret_cast<const uint32_t*>(xs(s % kStages));
    const uint32_t* ww = wt(s % 2);
    const int row = wm * 16 + g;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      const uint32_t a[4] = {xw[row * kRowW + ks * 8 + t],
                             xw[(row + 8) * kRowW + ks * 8 + t],
                             xw[row * kRowW + ks * 8 + 4 + t],
                             xw[(row + 8) * kRowW + ks * 8 + 4 + t]};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = wn * (kBN / 2) + nt * 8 + g;
        const uint32_t b[2] = {ww[col * kRowW + ks * 8 + t],
                               ww[col * kRowW + ks * 8 + 4 + t]};
        repro_torch::mma_i8<kSigned>(acc[nt], a, b);
      }
    }
    if (s + 1 < steps) store_w<kBN>(wr, wt((s + 1) % 2));
  }

#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + wn * (kBN / 2) + nt * 8 + 2 * t + h;
      if (n >= N) continue;
      float s = 0.f;
      float o = 0.f;
      if (fused) {
        s = scale[n];
        o = offset != nullptr ? offset[n] : 0.f;
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int b = b0 + wm * 16 + g + 8 * v;
        if (b >= B) continue;
        const long long idx = static_cast<long long>(b) * N + n;
        const int a = acc[nt][2 * v + h];
        if (fused) {
          const float y = __fadd_rn(__fmul_rn(__int2float_rn(a), s), o);
          static_cast<float*>(out)[idx] = repro_torch::activate(y, act);
        } else {
          static_cast<int*>(out)[idx] = a;
        }
      }
    }
}

template <bool kSigned, int kXBytes, int kBN>
cudaError_t launch(cudaStream_t stream, const void* x, const int8_t* w,
                   const float* scale, const float* offset, void* out, int B,
                   int K, int N, int act, int fused, int wvec) {
  constexpr int kSmem = smem_bytes<kBN>();
  static repro_torch::SmemOptIn opt_in;
  const cudaError_t attr =
      opt_in.allow(int8_matmul_kernel<kSigned, kXBytes, kBN>, kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  int8_matmul_kernel<kSigned, kXBytes, kBN><<<grid, kThreads, kSmem,
                                              stream>>>(
      static_cast<const unsigned char*>(x), w, scale, offset, out, B, K, N,
      act, fused, wvec);
  return cudaGetLastError();
}

template <bool kSigned, int kXBytes>
cudaError_t launch_bn(cudaStream_t stream, const void* x, const int8_t* w,
                      const float* scale, const float* offset, void* out,
                      int B, int K, int N, int act, int fused, int wvec) {
  if (N <= 64 || B <= kBM) {  // see the header: narrow N, one row tile
    return launch<kSigned, kXBytes, 64>(stream, x, w, scale, offset, out, B,
                                        K, N, act, fused, wvec);
  }
  return launch<kSigned, kXBytes, 256>(stream, x, w, scale, offset, out, B,
                                       K, N, act, fused, wvec);
}

template <bool kSigned>
cudaError_t launch_x(cudaStream_t stream, const void* x, const int8_t* w,
                     const float* scale, const float* offset, void* out,
                     int B, int K, int N, int act, int fused, int wvec) {
  // the widest copy that K and the pointer allow: rows of 200 or 100
  // bytes are not 16-byte aligned
  const auto addr = reinterpret_cast<uintptr_t>(x);
  if (K % 16 == 0 && addr % 16 == 0) {
    return launch_bn<kSigned, 16>(stream, x, w, scale, offset, out, B, K, N,
                                  act, fused, wvec);
  }
  if (K % 8 == 0 && addr % 8 == 0) {
    return launch_bn<kSigned, 8>(stream, x, w, scale, offset, out, B, K, N,
                                 act, fused, wvec);
  }
  if (K % 4 == 0 && addr % 4 == 0) {
    return launch_bn<kSigned, 4>(stream, x, w, scale, offset, out, B, K, N,
                                 act, fused, wvec);
  }
  return launch_bn<kSigned, 1>(stream, x, w, scale, offset, out, B, K, N,
                               act, fused, wvec);
}

}  // namespace

// C entry point bound with ctypes. Pointers are device pointers; with
// fused == 0 the output is int32 and scale/offset are ignored; offset
// may be null (zero). Returns the launch's cudaError_t.
extern "C" int int8_matmul_launch(const void* x, int x_signed, const void* w,
                                  const void* scale, const void* offset,
                                  void* out, int B, int K, int N,
                                  int activation, int fused, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* wi = static_cast<const int8_t*>(w);
  const auto* sf = static_cast<const float*>(scale);
  const auto* of = static_cast<const float*>(offset);
  const int wvec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  const cudaError_t err = x_signed
      ? launch_x<true>(s, x, wi, sf, of, out, B, K, N, activation, fused,
                       wvec)
      : launch_x<false>(s, x, wi, sf, of, out, B, K, N, activation, fused,
                        wvec);
  return static_cast<int>(err);
}
