"""The step-mix probes P1-P4: the port of the four TPU micro-probes of
tests/tools/probe_{subint32,lowprec,bf16ops,wordstream}.py, each a
hand-written CUDA kernel (csrc/probe_*.cu) with a plain PyTorch twin.

    python -m minialign_tpu_torch.probes [subint32|lowprec|bf16ops|wordstream ...]
        [--device cuda|cpu] [--seed N]

runs the chosen probes (all four by default) at the tools' own shapes
and step counts and prints the tools' lines; on the CPU the timing
loops run their plain twins at CPU_STEPS steps. On CUDA every case's
kernel is held against its plain twin and must equal it exactly; the
exit status is 1 when one differs or a build or launch fails.

Each module mirrors its tool's function names (probe, probe_carry,
elementwise, in_carry, roll_concat, step_timer, run2, timing, var_shift,
roll_in_carry, div10_magic, stream_timing); each function takes its
inputs and a device and returns its output (the timing functions: a
Timed with the output and ns/step), and its plain twin *_plain stands
beside it. Inputs come from an explicit numpy Generator or are passed
in.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bf16ops, lowprec, subint32, wordstream
from ._common import Report

PROBES = {"subint32": subint32, "lowprec": lowprec, "bf16ops": bf16ops,
          "wordstream": wordstream}


def run(names=tuple(PROBES), device="cuda", seed: int = 0,
        out=None) -> Report:
    """Run the named probes on `device` (resolve_device: raises when CUDA
    is asked for and absent) with inputs from default_rng(seed). Returns
    the Report (its status is the exit status); its summary line per
    probe ends the output."""
    rep = Report(device, out)
    where = torch.cuda.get_device_name(rep.device) if rep.cuda else "cpu"
    rep.say(f"torch {torch.__version__}, device {rep.device} ({where})")
    rng = np.random.default_rng(seed)
    for name in names:
        rep.say(f"== {name}")
        PROBES[name].main(rep, rng)
    rep.summary()
    return rep
