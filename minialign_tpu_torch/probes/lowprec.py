"""P2: low-precision add / max / compare / select, the 8-round carries,
and the band-step timer, in int16 / int8 / bf16 / f32 / int32
(csrc/probe_lowprec.cu).

Replaces tests/tools/probe_lowprec.py:elementwise, :in_carry,
:roll_concat and :step_timer. The step timer is the fill's op mix in
isolation: per step, each of 4 (W, B) arrays takes a row roll under the
column's direction, an add and a max, all in the loop carry. Its kernel
keeps the fill's layout (one warp per column, W = 64), so its ns/step on
the card says what the step mix costs per dtype and how it moves with
the number of columns.

At the tool's 2048 steps one run takes ~0.3 ms on the card, where
launch gaps and the clock's ramp weigh on the slope; on the card the
timer also runs at LONG_STEPS, where a run takes tens of ms.
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import (BINOPS, LIBRARY_BINOP, W, Report, Timed, binop,
                      binop_plain, carry_plain, code, columns, inputs,
                      launch, on, on_kernel, roll_up, slope, tensor)

DTYPES = ("int16", "int8", "bfloat16", "float32", "int32")
STEP_DTYPES = ("int32", "float32", "bfloat16", "int16")
N_ARR = 4              # the tool's step_timer n_arr
STEPS = 2048           # the tool's main: step_timer(dt, 64, 128, 2048)
LONG_STEPS = 2**17
REPS = 5
ROUNDS = 8


def elementwise_plain(op: str, x: torch.Tensor,
                      y: torch.Tensor) -> torch.Tensor:
    return binop_plain(op, x, y).to(torch.float32)


def in_carry_plain(op: str, x: torch.Tensor, y: torch.Tensor,
                   rounds: int = ROUNDS) -> torch.Tensor:
    return carry_plain(op, x, y, rounds).to(torch.float32)


def roll_concat_plain(x: torch.Tensor, y: torch.Tensor,
                      rounds: int = ROUNDS) -> torch.Tensor:
    d = y[0:1] > y[1:2]
    one = torch.ones((), dtype=x.dtype, device=x.device)
    c = x
    for _ in range(rounds):
        c = torch.where(d, roll_up(c), c) + one
    return c.to(torch.float32)


def step_timer_plain(x: torch.Tensor, dd: torch.Tensor,
                     n_steps: int) -> torch.Tensor:
    one = torch.ones((), dtype=x.dtype, device=x.device)
    arrs = [x + torch.full((), k, dtype=x.dtype, device=x.device)
            for k in range(N_ARR)]
    dd = dd.reshape(1, -1)
    for i in range(n_steps):
        d = dd > (i % 7)
        arrs = [torch.maximum(torch.where(d, roll_up(a), a) + one, arrs[0])
                for a in arrs]
    acc = arrs[0]
    for a in arrs[1:]:
        acc = torch.maximum(acc, a)
    return acc.to(torch.float32)


def elementwise(op: str, x, y, device="cuda") -> torch.Tensor:
    """op(x, y) in x's type, as float32 (probe_lowprec.elementwise)."""
    return binop("p2", "p2_elementwise_launch", torch.float32, op, x, y,
                 device, 0)


def in_carry(op: str, x, y, device="cuda",
             rounds: int = ROUNDS) -> torch.Tensor:
    """c <- op(c, y) cut to x's type, `rounds` times from c = x, as
    float32 (probe_lowprec.in_carry)."""
    if rounds < 1:
        raise ValueError("in_carry: rounds must be at least 1")
    return binop("p2", "p2_elementwise_launch", torch.float32, op, x, y,
                 device, rounds)


def roll_concat(x, y, device="cuda", rounds: int = ROUNDS) -> torch.Tensor:
    """c <- where(y[0] > y[1], concat(c[1:], 0), c) + 1, `rounds` times
    from c = x, as float32 (probe_lowprec.roll_concat)."""
    x, y = on(device, x, y)
    if not on_kernel(device):
        return roll_concat_plain(x, y, rounds)
    B = columns(x, "roll_concat")
    if y.shape != x.shape or y.dtype != x.dtype:
        raise ValueError("roll_concat: x and y differ in shape or dtype")
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    launch("p2", "p2_roll_concat_launch", x, y, B, code(x), rounds, out)
    return out


def step_loop(x, dd, n_steps: int, device="cuda") -> torch.Tensor:
    """One run of the step-timer loop: n_steps steps on N_ARR arrays
    x + k, then their max, as float32."""
    x, dd = on(device, x, dd)
    if not on_kernel(device):
        return step_timer_plain(x, dd, n_steps)
    B = columns(x, "step_timer")
    dd = dd.to(torch.int32).reshape(-1).contiguous()
    if dd.numel() != B:
        raise ValueError("step_timer: dd needs one direction per column")
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    launch("p2", "p2_step_timer_launch", x, dd, B, code(x), n_steps, out)
    return out


def step_timer(x, dd, n_steps: int = STEPS, device="cuda",
               reps: int = REPS) -> Timed:
    """probe_lowprec.step_timer: the loop's output at n_steps and its
    ns/step by slope between n_steps and 2 n_steps."""
    x, dd = on(device, x, dd)
    return slope(lambda n: step_loop(x, dd, n, device), n_steps, reps,
                 device)


def step_inputs(rng: np.random.Generator, dtype: str, device, B: int = 128):
    """step_timer: x (W, B) from [0, 4), dd (1, B) int32 from [0, 7)."""
    return (tensor(rng.integers(0, 4, (W, B)), dtype, device),
            tensor(rng.integers(0, 7, (1, B)), "int32", device))


def main(rep: Report, rng: np.random.Generator) -> None:
    """probe_lowprec.py's __main__: 5 dtypes x 6 cases, then the step
    timer in 4 dtypes at W=64, B=128 (on the card at STEPS and
    LONG_STEPS)."""
    dev = rep.device
    for dt in DTYPES:
        rep.say(f"[{dt}]")
        for op in BINOPS:
            x, y = inputs(rng, dt, dev)
            rep.case(f"{dt} {op}", "p2",
                     lambda: elementwise(op, x, y, dev),
                     lambda: elementwise_plain(op, x, y), ((x, y), 1),
                     lambda: LIBRARY_BINOP[op](x, y))
        x, y = inputs(rng, dt, dev)
        rep.case(f"{dt} max-in-carry", "p2",
                 lambda: in_carry("maximum", x, y, dev),
                 lambda: in_carry_plain("maximum", x, y), ((x, y), ROUNDS))
        x, y = inputs(rng, dt, dev)
        rep.case(f"{dt} roll-sel-in-carry", "p2",
                 lambda: roll_concat(x, y, dev),
                 lambda: roll_concat_plain(x, y), ((x, y), 3 * ROUNDS))
    rep.say(f"[step timing] {N_ARR} arrays x ({W},128), roll+select+add+max "
            f"per step ({rep.where()})")
    for dt in STEP_DTYPES:
        x, dd = step_inputs(rng, dt, dev)
        ts = rep.loop(f"{dt} step timer", "p2",
                      lambda n: step_loop(x, dd, n, dev),
                      lambda n: step_timer_plain(x, dd, n),
                      lambda n: step_timer(x, dd, n, dev),
                      (STEPS, LONG_STEPS),
                      lambda n: ((x, dd), N_ARR * (3 * n + 1)))
        for n, t in ts or ():
            rep.say(f"  {dt}: {t.ns_per_step:.1f} ns/step at {n} steps "
                    f"(t1={t.t1_ms:.3f}ms)")
