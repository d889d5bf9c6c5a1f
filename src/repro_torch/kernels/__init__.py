"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``, built by
:mod:`repro_torch.kernels.build`), their plain PyTorch versions
(:mod:`repro_torch.kernels.ref`) and the device dispatch between them
(:mod:`repro_torch.kernels.ops`)."""
