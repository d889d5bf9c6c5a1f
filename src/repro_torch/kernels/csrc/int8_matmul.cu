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
// The fused mode also takes x as f32 analog inputs with the input
// DAC's constants (int8_matmul_dac_launch): the kernel forms the
// unsigned codes clamp(round((x − lo)/step), 0, 2^bits − 1) itself, on
// the way from shared memory into the A fragments, so the codes never
// exist in device memory. That replaces the SRAM core's DAC chain in
// PyTorch (core/crossbar_layer.py quantize_inputs and the uint8 cast:
// five elementwise kernels, each a pass over the layer's input). The
// arithmetic is the one those CUDA ops run, to the bit (checked on the
// card with ties, ±inf and NaN): the sub of the Python scalar lo is
// x + (−lo) in f32; the div by the Python scalar step is a product
// with 1/step, which for the DAC's steps 2/(2^bits − 1) is
// (2^bits − 1)/2, exact in f32 (a division by f32(step) differs); round
// is rintf (half to even); the clamp keeps a NaN, which the uint8 cast
// (through int64) then makes code 0.
//
// What bounds it on an H100: one byte per code (four per f32 input)
// against 2·K operations per output, so at the deep app's digital
// shapes (B = 16384, K = 784/200/100) the bound is the bytes (x once
// and the output once at 3.35 TB/s: 7.8 µs for layer 0 with codes,
// 19.3 µs with f32 inputs), far below the 1,979 TOP/s int8
// tensor-core rate. The first version of this kernel multiplied in
// int32 on the CUDA cores, one MAC an instruction, and was held to
// that issue rate at about 2 % of the bound. This one, too, is held
// by the instructions of its step loop more than by the bytes.
//
// Design: mma.sync.m16n8k32 takes the uint8 codes against the int8
// synapses directly (.u8.s8; .s8.s8 for signed x), so nothing is
// re-centred and the int32 accumulator is exactly the reference's. One
// block of 16 warps owns 128 batch rows × all N (one column tile of
// 256; wider N takes several), so each x element is read from device
// memory once. The tile is 64 columns instead when N ≤ 64 (a 256-column
// tile computes 25× the 10 columns of the deep app's last layer) or the
// batch is one row tile (serving: N = 200 then spreads over four blocks
// instead of one). It walks K in steps of 64 elements:
//   * x through a four-stage cp.async ring. Rows of 200 or 100 bytes
//     (the deep app's later layers) are not 16-byte aligned, so the
//     launcher picks the copy width (16, 8 or 4 bytes; plain byte loads
//     for odd K, as the paper's 9-input apps have) from K and the
//     pointer, as a template parameter. f32 rows take 16-byte copies
//     (four inputs) where K % 4 == 0 and the pointer is 16-byte
//     aligned, else one input a copy. The ragged last step (784 =
//     12.25 × 64) is zero-filled.
//   * f32 x is quantised as each warp forms its A fragments: four
//     k-neighbours read as one float4, each clamped, rounded and packed
//     into the u32 the mma takes. A shared-memory pass a stage that
//     writes the codes once for both column warps (an extra barrier a
//     step) was slower at B = 65,536: layer 0 0.325 against 0.305 ms.
//   * w, which is (K, N) N-contiguous, while the 8-bit mma wants its B
//     operand K-contiguous: each thread reads a 4 (k) × 4 (n) block one
//     step ahead into registers, transposes it with byte permutes, and
//     stores it as [n][k]. Nothing transposed is kept in DigitalParams
//     and the wrapper launches nothing else. Rows of w past K are
//     zero, so whatever code the zero-filled tail of x gives (an f32
//     0 is not code 0) adds nothing; rows of x past B are never
//     stored.
// Shared-memory rows are padded to 80 bytes of codes (80 floats of f32
// inputs), which keeps the fragment reads and the transposed stores
// free of bank conflicts. Each warp owns 16 rows × half the column
// tile; the epilogue runs on the accumulator registers. Ragged B, K
// and N edges are masked in the kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "launch.cuh"
#include "mma.cuh"

namespace {

constexpr int kBM = 128;            // batch rows of a block
constexpr int kBK = 64;             // elements of K a pipeline step
constexpr int kThreads = 512;       // 16 warps: 8 (batch) × 2 (columns)
constexpr int kStages = 4;          // x ring
constexpr int kRow = kBK + 16;      // shared-memory row of codes, bytes
constexpr int kRowW = kRow / 4;     // the same, in 32-bit words
constexpr int kRowF = kBK + 16;     // shared-memory row of f32 x, floats

// The input DAC's constants (int8_matmul_dac_launch).
struct Dac {
  float shift;  // −lo
  float inv;    // 1/step
  float top;    // 2^bits − 1
};

// A shared-memory row of x, bytes: codes or f32 inputs.
template <typename XT>
constexpr int kXRowBytes = sizeof(XT) == 1 ? kRow : 4 * kRowF;

template <typename XT, int kBN>
constexpr int smem_bytes() {
  return kStages * kBM * kXRowBytes<XT> + 2 * kBN * kRow;
}

// One input's DAC code in the low byte of the result: (v − lo)/step as
// the CUDA ops compute it, then the clamp (fmaxf drops a NaN, which
// the uint8 cast would have made code 0) and the rounding, which
// commute since both bounds are integers: adding 2^23 rounds a value
// in [0, 2^23) half to even into the mantissa's low bits.
__device__ __forceinline__ uint32_t dac_bits(float v, const Dac& d) {
  float y = __fmul_rn(__fadd_rn(v, d.shift), d.inv);
  y = fminf(fmaxf(y, 0.f), d.top);
  return __float_as_uint(__fadd_rn(y, 8388608.f));
}

// Four k-neighbours (16-byte aligned in shared memory) → one operand
// word of the 8-bit mma, the lowest k in the low byte.
__device__ __forceinline__ uint32_t dac_word(const float* p, const Dac& d) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  const uint32_t lo = __byte_perm(dac_bits(v.x, d), dac_bits(v.y, d),
                                  0x0040);
  const uint32_t hi = __byte_perm(dac_bits(v.z, d), dac_bits(v.w, d),
                                  0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// Stage one step of x (kBM rows × kBK elements), kBytes a copy.
template <typename XT, int kBytes, int kRowBytes>
__device__ __forceinline__ void load_x(unsigned char* xs, const XT* x,
                                       int b0, int B, int K, int k0) {
  constexpr int kSize = static_cast<int>(sizeof(XT));
  constexpr int kElems = kBytes >= 4 ? kBytes / kSize : 1;
  constexpr int kPerRow = kBK / kElems;
  for (int e = threadIdx.x; e < kBM * kPerRow; e += kThreads) {
    const int m = e / kPerRow;
    const int kk = (e % kPerRow) * kElems;
    const int b = b0 + m;
    const int k = k0 + kk;
    const XT* src = x;
    int n = 0;
    if (b < B && k < K) {
      src = x + static_cast<long long>(b) * K + k;
      n = min(K - k, kElems) * kSize;
    }
    unsigned char* dst = xs + m * kRowBytes + kk * kSize;
    if constexpr (kBytes >= 4) {
      repro_torch::cp_async<kBytes>(dst, src, n);
    } else {
      *dst = n ? *src : 0;
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

template <typename XT, bool kSigned, int kXBytes, int kBN>
__global__ void __launch_bounds__(kThreads, 1)
int8_matmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ offset,
                   void* __restrict__ out, int B, int K, int N, int act,
                   int fused, int wvec, Dac dac) {
  constexpr int kNT = kBN / 16;   // n8 fragments a warp
  constexpr int kXRow = kXRowBytes<XT>;
  constexpr int kXStage = kBM * kXRow;
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
    if (s < steps) {
      load_x<XT, kXBytes, kXRow>(xs(s), x, b0, B, K, s * kBK);
    }
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
      load_x<XT, kXBytes, kXRow>(xs(ahead % kStages), x, b0, B, K,
                                 ahead * kBK);
    }
    repro_torch::cp_async_commit();
    if (s + 1 < steps) load_w<kBN>(wr, w, K, N, n0, (s + 1) * kBK, wvec);

    const unsigned char* xstage = xs(s % kStages);
    const uint32_t* ww = wt(s % 2);
    const int row = wm * 16 + g;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t a[4];
      if constexpr (sizeof(XT) == 4) {  // the DAC, four codes a word
        const float* p0 = reinterpret_cast<const float*>(xstage) +
                          row * kRowF + ks * 32 + 4 * t;
        const float* p1 = p0 + 8 * kRowF;
        a[0] = dac_word(p0, dac);
        a[1] = dac_word(p1, dac);
        a[2] = dac_word(p0 + 16, dac);
        a[3] = dac_word(p1 + 16, dac);
      } else {
        const auto* xw = reinterpret_cast<const uint32_t*>(xstage);
        a[0] = xw[row * kRowW + ks * 8 + t];
        a[1] = xw[(row + 8) * kRowW + ks * 8 + t];
        a[2] = xw[row * kRowW + ks * 8 + 4 + t];
        a[3] = xw[(row + 8) * kRowW + ks * 8 + 4 + t];
      }
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

// What every launch passes on to the kernel.
struct Args {
  const void* x;
  const int8_t* w;
  const float* scale;
  const float* offset;
  void* out;
  int B, K, N, act, fused, wvec;
  Dac dac;
};

template <typename XT, bool kSigned, int kXBytes, int kBN>
cudaError_t launch(cudaStream_t stream, const Args& a) {
  constexpr int kSmem = smem_bytes<XT, kBN>();
  static repro_torch::SmemOptIn opt_in;
  const auto kernel = int8_matmul_kernel<XT, kSigned, kXBytes, kBN>;
  const cudaError_t attr = opt_in.allow(kernel, kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.N + kBN - 1) / kBN, (a.B + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const XT*>(a.x), a.w, a.scale, a.offset, a.out, a.B, a.K,
      a.N, a.act, a.fused, a.wvec, a.dac);
  return cudaGetLastError();
}

template <typename XT, bool kSigned, int kXBytes>
cudaError_t launch_bn(cudaStream_t stream, const Args& a) {
  if (a.N <= 64 || a.B <= kBM) {  // see the header: narrow N, one row tile
    return launch<XT, kSigned, kXBytes, 64>(stream, a);
  }
  return launch<XT, kSigned, kXBytes, 256>(stream, a);
}

template <bool kSigned>
cudaError_t launch_codes(cudaStream_t stream, const Args& a) {
  // the widest copy that K and the pointer allow: rows of 200 or 100
  // bytes are not 16-byte aligned
  using XT = unsigned char;
  const auto addr = reinterpret_cast<uintptr_t>(a.x);
  if (a.K % 16 == 0 && addr % 16 == 0) {
    return launch_bn<XT, kSigned, 16>(stream, a);
  }
  if (a.K % 8 == 0 && addr % 8 == 0) {
    return launch_bn<XT, kSigned, 8>(stream, a);
  }
  if (a.K % 4 == 0 && addr % 4 == 0) {
    return launch_bn<XT, kSigned, 4>(stream, a);
  }
  return launch_bn<XT, kSigned, 1>(stream, a);
}

cudaError_t launch_dac(cudaStream_t stream, const Args& a) {
  // four inputs a copy where K and the pointer allow, else one
  if (a.K % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0) {
    return launch_bn<float, false, 16>(stream, a);
  }
  return launch_bn<float, false, 4>(stream, a);
}

int wvec_of(const void* w, int N) {
  return N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
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
  const Args a{x, static_cast<const int8_t*>(w),
               static_cast<const float*>(scale),
               static_cast<const float*>(offset), out, B, K, N, activation,
               fused, wvec_of(w, N), Dac{}};
  const cudaError_t err = x_signed ? launch_codes<true>(s, a)
                                   : launch_codes<false>(s, a);
  return static_cast<int>(err);
}

// The fused mode on f32 analog inputs x (B, K): the kernel forms the
// unsigned DAC codes itself from shift = −lo, inv = 1/step and
// top = 2^bits − 1 (bits ≤ 8), all f32. offset may be null.
extern "C" int int8_matmul_dac_launch(const void* x, const void* w,
                                      const void* scale, const void* offset,
                                      void* out, int B, int K, int N,
                                      int activation, float shift,
                                      float inv, float top, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const Args a{x, static_cast<const int8_t*>(w),
               static_cast<const float*>(scale),
               static_cast<const float*>(offset), out, B, K, N, activation,
               1, wvec_of(w, N), Dac{shift, inv, top}};
  const cudaError_t err = launch_dac(s, a);
  return static_cast<int>(err);
}
