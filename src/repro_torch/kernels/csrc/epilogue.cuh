// Fused-epilogue activations shared by the kernels in this directory.
//
// The codes are the ones kernels/build.py's ACTIVATION_CODES hands over,
// and each branch computes what kernels/ref.py's ACTIVATIONS table does
// in plain PyTorch: "threshold" is the memristor inverter pair (±1
// rails, NaN goes to -1 as torch.where does), "linear" the identity of
// the Fig. 11 combiner neurons. Full-precision expf/tanhf, no fast math.
#pragma once

namespace repro_torch {

enum Activation : int {
  kLinear = 0,
  kThreshold = 1,
  kSigmoid = 2,
  kRelu = 3,
  kTanh = 4,
};

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kThreshold: return v >= 0.f ? 1.f : -1.f;
    case kSigmoid: return 1.f / (1.f + expf(-v));
    case kRelu: return v < 0.f ? 0.f : v;
    case kTanh: return tanhf(v);
    default: return v;
  }
}

}  // namespace repro_torch
