"""Copy of minialign_tpu/prewarm.py for the port: a deployment prewarm.

    python -m minialign_tpu_torch.prewarm [-x preset ...] [read lengths...]

Maps a tiny synthetic workload (random mini-reference + reads at the
given lengths, default 20000 and 4000) through the port's CLI with the
given options, discarding output, on the card unless
MINIALIGN_TORCH_DEVICE names the CPU. The port's first-contact cost is
its builds, not per-shape compiles: nvcc builds the CUDA kernels
(_build) and g++ the host library (native) at first use, into
minialign_tpu_torch/build/, where later processes find them. They are
built before the map, and the stderr line gives their seconds beside the
map's. Apart from that (cli._prebuild, timed, and the line's build
field) it differs from the JAX module only in this header."""

from __future__ import annotations

import io
import sys
import time

import numpy as np


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    lens = [int(a) for a in argv if a.isdigit()] or [20000, 4000]
    opts = [a for a in argv if not a.isdigit()]

    from . import cli

    t0 = time.time()
    cli._prebuild()
    build_s = time.time() - t0
    rng = np.random.default_rng(0)
    glen = max(lens) * 2 + 10000
    bases = "ACGT"
    ref = "".join(bases[c] for c in rng.integers(0, 4, glen))
    reads = []
    for li, L in enumerate(lens):
        s0 = int(rng.integers(0, glen - L))
        seq = list(ref[s0:s0 + L])
        # PBSIM-profile mutations so the fills terminate realistically
        for k in range(len(seq)):
            r = rng.random()
            if r < 0.06:
                seq[k] = bases[int(rng.integers(0, 4))]
        reads.append("".join(seq))

    import tempfile

    with tempfile.TemporaryDirectory() as td:
        ref_fa = f"{td}/ref.fa"
        reads_fq = f"{td}/reads.fq"
        with open(ref_fa, "w") as f:
            f.write(f">prewarm_ref\n{ref}\n")
        with open(reads_fq, "w") as f:
            for i, r in enumerate(reads):
                f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
        t0 = time.time()
        old = sys.stdout
        sys.stdout = io.StringIO()
        try:
            rc = cli.main(opts + [ref_fa, reads_fq])
        finally:
            sys.stdout = old
        print(f"[minialign] prewarm done in {time.time() - t0:.1f} s "
              f"(lengths {lens}, opts {opts or ['<default>']}; "
              f"build {build_s:.1f} s)",
              file=sys.stderr)
        return rc


if __name__ == "__main__":
    raise SystemExit(main())
