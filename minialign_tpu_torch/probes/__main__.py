"""python -m minialign_tpu_torch.probes: see the package docstring."""

from __future__ import annotations

import argparse
import sys

from . import PROBES, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m minialign_tpu_torch.probes",
        description="The step-mix probes P1-P4 on the card (kernels held "
                    "against their plain PyTorch twins) or on the CPU.")
    ap.add_argument("probes", nargs="*", metavar="probe",
                    help=f"any of {', '.join(PROBES)} (default: all)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    unknown = [n for n in a.probes if n not in PROBES]
    if unknown:
        ap.error(f"unknown probe(s) {unknown}; any of {', '.join(PROBES)}")
    rep = run(a.probes or tuple(PROBES), a.device, a.seed)
    if rep.failures:
        print(f"{len(rep.failures)} case(s) failed: {rep.failures}",
              file=sys.stderr)
    return rep.status


if __name__ == "__main__":
    sys.exit(main())
