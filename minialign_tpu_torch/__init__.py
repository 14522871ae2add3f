"""minialign-tpu-torch: the PyTorch/CUDA port of minialign_tpu.

The same mapper as `minialign_tpu` (minimizer index, seed chaining,
adaptive-banded Smith-Waterman-Gotoh extension, SAM output), with the
device work moved from JAX/Pallas on a TPU to PyTorch and hand-written
CUDA kernels on an NVIDIA Hopper GPU (`csrc/`). Host code that never
touches JAX (`params`, `io.bseq`, `index`, `ksort`, `native`, `chain`)
is imported from `minialign_tpu` as it stands; modules that reach JAX
there are carried here with their imports changed. This package never
imports `jax`.

Entry point: `python -m minialign_tpu_torch [options] ref.fa reads.fq`.
"""

__version__ = "0.1.0"
