"""P3: the bf16 building blocks of a difference-recurrence step, and the
timing loop of its op mix in int32 / f32 / bf16
(csrc/probe_bf16ops.cu).

Replaces tests/tools/probe_bf16ops.py:run2 and :timing. The tool passes
its ops as lambdas; here each is an op code (OPS, in the tool's order).
bf16 ops round to bf16 after each op, as JAX types them and as torch
computes them: integers above 256 are not exact in bf16, so a product
of two values from [0, 60) is rounded.
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import (W, Report, Timed, code, columns, inputs, kernel_for,
                      launch, on, roll_up, slope, tensor)

N_ARR = 6              # the tool's main: timing(dt, 6, steps)
STEPS = 200_000        # the tool's main: timing at 2e5 and 4e5 steps
REPS = 4
TIMING_DTYPES = ("int32", "float32", "bfloat16")

# (op code, the tool's case name, input dtype), in csrc/probe_bf16ops.cu's
# order
OPS = (
    ("multiply", "bf16 multiply", "bfloat16"),
    ("sub", "bf16 sub", "bfloat16"),
    ("concat-roll", "bf16 concat-roll (no select)", "bfloat16"),
    ("arith-eq-mask", "bf16 arith-eq-mask max(0,1-(x-y))", "bfloat16"),
    ("arith-select", "bf16 arith-select a+m*(b-a)", "bfloat16"),
    ("min", "bf16 min", "bfloat16"),
    ("broadcast-row-mul", "bf16 broadcast-row mul", "bfloat16"),
    ("bf16->int32", "bf16->int32 astype", "bfloat16"),
    ("int32->bf16", "int32->bf16 astype", "int32"),
    ("int16-store-int32-compute", "int16 store/int32 compute roundtrip",
     "int16"),
)
OP_NAMES = tuple(o for o, _, _ in OPS)
# operations per output element of each case (run2_plain's, with the
# casts counted as one)
OP_COST = {"multiply": 1, "sub": 1, "concat-roll": 2, "arith-eq-mask": 4,
           "arith-select": 7, "min": 1, "broadcast-row-mul": 1,
           "bf16->int32": 2, "int32->bf16": 2,
           "int16-store-int32-compute": 2}
# the cases that one PyTorch call computes
LIBRARY = {"multiply": torch.mul, "sub": torch.sub, "min": torch.minimum,
           "broadcast-row-mul": lambda a, b: torch.mul(a, b[0:1])}


def run2_plain(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The tool's lambda `op` on (a, b), as float32."""
    one = torch.ones((), dtype=a.dtype, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    if op == "multiply":
        r = a * b
    elif op == "sub":
        r = a - b
    elif op == "concat-roll":
        r = roll_up(a) + b
    elif op == "arith-eq-mask":
        r = torch.maximum(one - (torch.maximum(a, b) - b), zero)
    elif op == "arith-select":
        r = a + torch.maximum(one - (torch.maximum(a, b) - b), zero) * (b - a)
    elif op == "min":
        r = torch.minimum(a, b)
    elif op == "broadcast-row-mul":
        r = a * b[0:1]
    elif op == "bf16->int32":
        r = (a + b).to(torch.int32)
    elif op == "int32->bf16":
        r = (a + b).to(torch.bfloat16)
    elif op == "int16-store-int32-compute":
        r = (a.to(torch.int32) + b.to(torch.int32)).to(torch.int16)
    else:
        raise ValueError(f"unknown op {op!r}; one of {OP_NAMES}")
    return r.to(torch.float32)


def run2(op: str, x, y, device="cuda") -> torch.Tensor:
    """probe_bf16ops.run2 with the tool's lambda `op` on (x, y), as
    float32."""
    x, y = on(device, x, y)
    if not kernel_for(x):
        return run2_plain(op, x, y)
    if op not in OP_NAMES:
        raise ValueError(f"unknown op {op!r}; one of {OP_NAMES}")
    if x.dim() != 2 or x.shape != y.shape or x.dtype != y.dtype:
        raise ValueError("run2: x and y must be 2-D of one shape and dtype")
    out = torch.empty_like(x, dtype=torch.float32)
    launch("p3", "p3_run2_launch", x.get_device(), x.data_ptr(),
           y.data_ptr(), x.shape[0], x.shape[1], code(x), OP_NAMES.index(op),
           out.data_ptr())
    return out


def timing_plain(x: torch.Tensor, steps: int) -> torch.Tensor:
    one = torch.ones((), dtype=x.dtype, device=x.device)
    arrs = [x + torch.full((), k % 3, dtype=x.dtype, device=x.device)
            for k in range(N_ARR)]
    for _ in range(steps):
        prev, first = arrs[-1], arrs[0] - one
        arrs = [torch.maximum(torch.maximum(a + one, prev) - one, first)
                for a in arrs]
    acc = arrs[0]
    for a in arrs[1:]:
        acc = torch.maximum(acc, a)
    return acc.to(torch.float32)


def timing_loop(x, steps: int, device="cuda") -> torch.Tensor:
    """One run of the timing loop: `steps` steps of
    a <- max(max(a + 1, arrs[-1]) - 1, arrs[0] - 1) on the 6 arrays
    x + k % 3, then their max, as float32."""
    (x,) = on(device, x)
    if not kernel_for(x):
        return timing_plain(x, steps)
    B = columns(x, "timing")
    out = torch.empty_like(x, dtype=torch.float32)
    launch("p3", "p3_timing_launch", x.get_device(), x.data_ptr(), B,
           code(x), steps, out.data_ptr())
    return out


def timing(x, steps: int = STEPS, device="cuda", reps: int = REPS) -> Timed:
    """probe_bf16ops.timing and its main's slope: the loop's output at
    `steps` and its ns/step between `steps` and 2 `steps`."""
    (x,) = on(device, x)
    return slope(lambda n: timing_loop(x, n, device), steps, reps, device)


def timing_input(rng: np.random.Generator, dtype: str, device, B=128):
    """timing: x (W, B) from [0, 3)."""
    return tensor(rng.integers(0, 3, (W, B)), dtype, device)


def main(rep: Report, rng: np.random.Generator) -> None:
    """probe_bf16ops.py's __main__: the 10 building blocks, then the
    timing loop in 3 dtypes at W=64, B=128."""
    dev = rep.device
    rep.say("[bf16 building blocks]")
    for op, name, dt in OPS:
        x, y = inputs(rng, dt, dev)
        rep.case(name, "p3", lambda: run2(op, x, y, dev),
                 lambda: run2_plain(op, x, y), ((x, y), OP_COST[op]),
                 (lambda: LIBRARY[op](x, y)) if op in LIBRARY else None)
    rep.say(f"[timing] {N_ARR} arrays x ({W},128), add+2max+sub per array "
            f"per step, in-kernel loop ({rep.where()})")
    for dt in TIMING_DTYPES:
        x = timing_input(rng, dt, dev)
        ts = rep.loop(f"{dt} timing", "p3", lambda n: timing_loop(x, n, dev),
                      lambda n: timing_plain(x, n),
                      lambda n: timing(x, n, dev), (STEPS,),
                      lambda n: ((x,), N_ARR * (5 * n + 1)))
        for n, t in ts or ():
            rep.say(f"  {dt}: slope {t.ns_per_step:.2f} ns/step at {n} "
                    f"steps (t1={t.t1_ms:.1f}ms t2={t.t2_ms:.1f}ms)")
