"""P4: the primitives of a packed-character word stream on (8, C) int32
slabs (csrc/probe_wordstream.cu).

Replaces tests/tools/probe_wordstream.py:var_shift, :roll_in_carry,
:div10_magic and :stream_timing. The row roll is the tool's
pltpu.roll(slab, -1, axis=0), row r <- row r + 1 (mod 8), i.e.
np.roll(slab, -1, 0).

div10_magic is ((x >> 1) * 52429) >> 18 with the int32 product wrapping,
as on the TPU. It equals x // 10 only below x = 81,920, where the
product first passes 2^31; the tool draws x from [0, 2^18), so its
check against x // 10 fails there, and so does this probe's: that is the
probe's finding, not a fault of the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import Report, Timed, launch, on, on_kernel, slope, tensor

SHAPE = (8, 128)
ROWS = 8
ROLL_ROUNDS = 64       # the tool's roll_in_carry
STEPS = 200_000        # the tool's main: stream_timing at 2e5 and 4e5
REPS = 4


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values cut to int32, two's complement."""
    return (torch.remainder(v + 2**31, 2**32) - 2**31).to(torch.int32)


def _sra(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x >> s, arithmetic, sign fill for s outside [0, 31]."""
    return x >> torch.where((s < 0) | (s > 31), 31, s)


def _roll(slab: torch.Tensor) -> torch.Tensor:
    """Row r <- row r + 1 (mod rows)."""
    return torch.roll(slab, -1, 0)


def var_shift_plain(w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return _sra(w, _wrap32(3 * s.long())) & 7


def roll_in_carry_plain(w: torch.Tensor,
                        rounds: int = ROLL_ROUNDS) -> torch.Tensor:
    slab = w
    sh = torch.zeros((1, w.shape[1]), dtype=torch.int32, device=w.device)
    for _ in range(rounds):
        wrap = sh >= 30
        slab = torch.where(wrap, _roll(slab), slab)
        sh = torch.where(wrap, 0, sh + 3)
    return _wrap32(slab.long() + sh.long())


def div10_magic_plain(x: torch.Tensor) -> torch.Tensor:
    return _wrap32((x >> 1).long() * 52429) >> 18


def stream_timing_plain(wa: torch.Tensor, wb: torch.Tensor, d: torch.Tensor,
                        steps: int) -> torch.Tensor:
    z = torch.zeros((1, wa.shape[1]), dtype=torch.int32, device=wa.device)
    sa, sb, sha, shb = wa, wb, z, z
    acc = z.long()
    d = d.reshape(1, -1)
    for i in range(steps):
        cura = _sra(sa[0:1], sha) & 7
        curb = _sra(sb[0:1], shb) & 7
        di = (d > (i % 7)).to(torch.int32)
        sha = sha + 3 * (1 - di)
        shb = shb + 3 * di
        pa, pb = sha >= 30, shb >= 30
        sa = torch.where(pa, _roll(sa), sa)
        sb = torch.where(pb, _roll(sb), sb)
        sha = torch.where(pa, 0, sha)
        shb = torch.where(pb, 0, shb)
        acc = acc + cura + curb
    return _wrap32(acc + sa[0:1] + sb[0:1])


def _i32(*xs):
    for x in xs:
        if x.dtype != torch.int32:
            raise ValueError(f"the word-stream kernels take int32, got "
                             f"{x.dtype}")


def _slab(w: torch.Tensor, what: str) -> int:
    if w.dim() != 2 or w.shape[0] != ROWS:
        raise ValueError(f"{what}: the kernel takes ({ROWS}, C) slabs, got "
                         f"{tuple(w.shape)}")
    return w.shape[1]


def var_shift(w, s, device="cuda") -> torch.Tensor:
    """(w >> 3 s) & 7 (probe_wordstream.var_shift)."""
    w, s = on(device, w, s)
    if not on_kernel(device):
        return var_shift_plain(w, s)
    _i32(w, s)
    if w.shape != s.shape:
        raise ValueError("var_shift: w and s differ in shape")
    out = torch.empty_like(w)
    launch("p4", "p4_var_shift_launch", w, s, w.numel(), out)
    return out


def roll_in_carry(w, device="cuda", rounds: int = ROLL_ROUNDS) -> torch.Tensor:
    """probe_wordstream.roll_in_carry: `rounds` rounds of
    slab <- where(sh >= 30, roll(slab), slab), sh <- 0 there, else
    sh + 3, from sh = 0; returns slab + sh."""
    (w,) = on(device, w)
    if not on_kernel(device):
        return roll_in_carry_plain(w, rounds)
    _i32(w)
    C = _slab(w, "roll_in_carry")
    out = torch.empty_like(w)
    launch("p4", "p4_roll_in_carry_launch", w, C, rounds, out)
    return out


def div10_magic(x, device="cuda") -> torch.Tensor:
    """((x >> 1) * 52429) >> 18 in int32, the product wrapping
    (probe_wordstream.div10_magic without its check)."""
    (x,) = on(device, x)
    if not on_kernel(device):
        return div10_magic_plain(x)
    _i32(x)
    out = torch.empty_like(x)
    launch("p4", "p4_div10_launch", x, x.numel(), out)
    return out


def stream_loop(wa, wb, d, steps: int, device="cuda") -> torch.Tensor:
    """One run of the two-sided stream update, (1, C) int32."""
    wa, wb, d = on(device, wa, wb, d)
    if not on_kernel(device):
        return stream_timing_plain(wa, wb, d, steps)
    _i32(wa, wb, d)
    C = _slab(wa, "stream_timing")
    if wb.shape != wa.shape or d.numel() != C:
        raise ValueError("stream_timing: need wa, wb (8, C) and d (1, C)")
    out = torch.empty((1, C), dtype=torch.int32, device=wa.device)
    launch("p4", "p4_stream_launch", wa, wb, d.reshape(-1).contiguous(), C,
           steps, out)
    return out


def stream_timing(wa, wb, d, steps: int = STEPS, device="cuda",
                  reps: int = REPS) -> Timed:
    """probe_wordstream.stream_timing and its main's slope: the output at
    `steps` and ns/step between `steps` and 2 `steps`."""
    wa, wb, d = on(device, wa, wb, d)
    return slope(lambda n: stream_loop(wa, wb, d, n, device), steps, reps,
                 device)


def div10_check(x: torch.Tensor, got: torch.Tensor) -> str | None:
    """The tool's assertion, got == x // 10: None when it holds, else
    its message."""
    want = x // 10
    bad = got != want
    if not bool(bad.any()):
        return None
    return (f"{int(bad.sum())} of {x.numel()} differ from x // 10, "
            f"e.g. x={x[bad][:4].tolist()} -> {got[bad][:4].tolist()}")


def main(rep: Report, rng: np.random.Generator) -> None:
    """probe_wordstream.py's __main__."""
    dev = rep.device
    w = tensor(rng.integers(0, 2**30, SHAPE), "int32", dev)
    s = tensor(rng.integers(0, 10, SHAPE), "int32", dev)
    rep.case("var-amount shift+mask", "p4", lambda: var_shift(w, s, dev),
             lambda: var_shift_plain(w, s), ((w, s), 3), sample=True)
    w = tensor(rng.integers(0, 100, SHAPE), "int32", dev)
    rep.case("row roll int32 slab in carry", "p4",
             lambda: roll_in_carry(w, dev), lambda: roll_in_carry_plain(w),
             ((w,), 2 * ROLL_ROUNDS), sample=True)
    x = tensor(rng.integers(0, 2**18, SHAPE), "int32", dev)
    got = rep.case("div-by-10 magic", "p4", lambda: div10_magic(x, dev),
                   lambda: div10_magic_plain(x), ((x,), 3), sample=True)
    if got is not None:
        msg = div10_check(x, got)
        rep.say("  OK   div-by-10 magic == x // 10" if msg is None else
                f"  FAIL div-by-10 magic == x // 10 (the probe's finding, "
                f"not a kernel fault): {msg}")
    wa = tensor(rng.integers(0, 2**30, SHAPE), "int32", dev)
    wb = tensor(rng.integers(0, 2**30, SHAPE), "int32", dev)
    d = tensor(rng.integers(0, 7, (1, SHAPE[1])), "int32", dev)
    ts = rep.loop("stream timing", "p4",
                  lambda n: stream_loop(wa, wb, d, n, dev),
                  lambda n: stream_timing_plain(wa, wb, d, n),
                  lambda n: stream_timing(wa, wb, d, n, dev), (STEPS,),
                  lambda n: ((wa, wb, d), 30 * n))
    for n, t in ts or ():
        rep.say(f"  stream update: {t.ns_per_step:.2f} ns/step "
                f"(t1={t.t1_ms:.1f}ms; {n} steps, {rep.where()})")
