"""minialign-tpu-torch: the PyTorch/CUDA port of minialign_tpu.

The same mapper as `minialign_tpu` (minimizer index, seed chaining,
adaptive-banded Smith-Waterman-Gotoh extension, SAM output), with the
device work moved from JAX/Pallas on a TPU to PyTorch and hand-written
CUDA kernels on an NVIDIA Hopper GPU (`csrc/`). The host modules are
the port's own copies of the JAX package's (`params`, `io.bseq`,
`index`, `ksort`, `native` with its C++ in `csrc/host/`, `chain`, and
the JAX-free halves of `extend`, `dp.traceback`, `post`, `pipeline`,
`io.sam`, `cli`), each with a header naming its original. This
package imports neither `jax` nor `minialign_tpu`
(tests/test_torch_host.py checks both).

Entry point: `python -m minialign_tpu_torch [options] ref.fa reads.fq`.
"""

__version__ = "0.1.0"
