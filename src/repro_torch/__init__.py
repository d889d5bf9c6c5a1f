"""repro_torch — the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package has the same
sub-package layout (``kernels``, ``core``, ``obs``, ``chip``,
``serving``, ``configs``, ``variability``, ``data``, ``fleet``,
``launch``, ``deploy``, ``tune``, ``models``, ``lm``) so each module
has one counterpart there. It imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without an explicit CPU request they raise. On CUDA
tensors the hand-written kernels in :mod:`repro_torch.kernels` run; on
CPU tensors their plain PyTorch versions do.
"""
