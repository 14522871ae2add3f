"""Intra-host process worker: maps a round-robin share of batches.

Spawned by cli.main when MINIALIGN_PROC_WORKERS=N (> 1) — the same
per-host worker + rank-ordered merge machinery as multi-host
deployment (parallel/distributed.py), run with N local processes so a
multi-core host parallelizes the Python/host stage the way the
reference's pt pool parallelizes mm_align_worker
(minialign.c:780-1133, 4535-4732). No jax.distributed is involved;
each worker opens the backend independently and the merged output is
byte-identical to the single-process stream (the same speculative
stale-rlen chain + replay that tests/test_distributed.py proves).

Usage: python -m minialign_tpu_torch.parallel.hostworker <id> <n> <out> <argv...>

Carried from the JAX package's minialign_tpu/parallel/hostworker.py
without its JAX platform setup: the device is the parent's
$MINIALIGN_TORCH_DEVICE, which the worker inherits.
"""

import sys


def main() -> int:
    host_id, n_hosts = int(sys.argv[1]), int(sys.argv[2])
    out_path = sys.argv[3]
    from . import distributed
    distributed.run_host(sys.argv[4:], out_path, host_id, n_hosts,
                         coordinator=None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
