"""What the four probes share: the dtype table, the inputs and row roll
of the (W, B) probes, the kernel launch, the slope timer and the report.

A probe function takes its inputs (numpy arrays or tensors) and a
device. On the CPU it runs its plain PyTorch twin; on a CUDA device it
launches its kernel (csrc/probe_*.cu) or raises; nothing falls back.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import _build
from ..device import resolve_device

# name: (torch dtype, code in csrc/probe_common.cuh:Dtype)
DTYPES = {
    "int8": (torch.int8, 0),
    "uint8": (torch.uint8, 1),
    "int16": (torch.int16, 2),
    "int32": (torch.int32, 3),
    "bfloat16": (torch.bfloat16, 4),
    "float32": (torch.float32, 5),
}
CODE = {dt: code for dt, code in DTYPES.values()}

# the binary ops of P1 and P2, in csrc/probe_common.cuh:binop's order
BINOPS = ("add", "maximum", "compare-gt", "select")

SHAPE = (64, 128)      # the cases of P1-P3
W = 64                 # rows of the loop kernels (two per thread)
# The timing loops' step count for the plain twins on the CPU: their
# times there are host times, and the tools' counts (2048, 2e5) would
# take minutes to hours.
CPU_STEPS = 8

# The card's peaks for a kernel's bound (NVIDIA's H100 SXM data
# sheet): 3.35 TB/s of HBM, and 32-bit
# ALU operations at 33.5 T/s, i.e. its 67 TFLOP/s of float32 outside the
# tensor cores with a fused multiply-add counted as one operation.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 33.5e12

# the single PyTorch call that computes each elementwise binop
LIBRARY_BINOP = {"add": torch.add, "maximum": torch.maximum,
                 "compare-gt": torch.gt, "select": torch.maximum}


def bound_ms(nbytes: float, ops: float) -> tuple[float, float]:
    """(bytes ms, operations ms): the least times for moving nbytes
    through HBM and for doing ops 32-bit operations; the bound is the
    larger."""
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / ALU_OPS_PER_S * 1e3


def binop_plain(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """op(a, b) in the inputs' type (compare-gt: bool)."""
    if op == "add":
        return a + b
    if op == "maximum":
        return torch.maximum(a, b)
    if op == "compare-gt":
        return a > b
    if op == "select":
        return torch.where(a > b, a, b)
    raise ValueError(f"unknown op {op!r}; one of {BINOPS}")


def carry_plain(op: str, x: torch.Tensor, y: torch.Tensor,
                rounds: int) -> torch.Tensor:
    """c <- op(c, y) cut to x's type, `rounds` times from c = x (the
    probes' fori_loop carry)."""
    c = x
    for _ in range(rounds):
        c = binop_plain(op, c, y).to(x.dtype)
    return c


def binop(kernel: str, entry: str, out_dtype: torch.dtype, op: str, x, y,
          device, rounds: int) -> torch.Tensor:
    """P1's and P2's elementwise kernel (csrc/probe_common.cuh:
    binop_kernel) through `entry`: op(x, y) for rounds = 0, else the
    carry; as out_dtype. The plain twins on the CPU."""
    x, y = on(device, x, y)
    if not on_kernel(device):
        r = binop_plain(op, x, y) if rounds == 0 else \
            carry_plain(op, x, y, rounds)
        return r.to(out_dtype)
    if op not in BINOPS:
        raise ValueError(f"unknown op {op!r}; one of {BINOPS}")
    if x.shape != y.shape or x.dtype != y.dtype:
        raise ValueError(f"{kernel}: x and y differ in shape or dtype")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    launch(kernel, entry, x, y, x.numel(), code(x), BINOPS.index(op),
           rounds, out)
    return out


def tensor(x, dtype: str, device) -> torch.Tensor:
    """x as a contiguous tensor of the named dtype on the device. Numpy
    integers are cut to the type as numpy casts (uint8: -100 -> 156);
    bfloat16 goes through float32, exact for integers up to 256."""
    tdt = DTYPES[dtype][0]
    if isinstance(x, torch.Tensor):
        t = x
    elif tdt == torch.bfloat16:
        t = torch.from_numpy(np.asarray(x, np.float32))
    else:
        t = torch.from_numpy(np.asarray(x).astype(
            str(tdt).removeprefix("torch.")))
    return t.to(device=device, dtype=tdt).contiguous()


def inputs(rng: np.random.Generator, dtype: str, device, lo: int = 0,
           hi: int = 60, shape=SHAPE) -> tuple[torch.Tensor, torch.Tensor]:
    """x, y drawn from [lo, hi), as the named dtype on the device."""
    return tuple(tensor(rng.integers(lo, hi, shape), dtype, device)
                 for _ in range(2))


def roll_up(a: torch.Tensor) -> torch.Tensor:
    """concatenate([a[1:], 0]) along rows."""
    return torch.cat([a[1:], torch.zeros_like(a[:1])])


def columns(x: torch.Tensor, what: str) -> int:
    """B of a (W, B) array; raises for any other shape."""
    if x.dim() != 2 or x.shape[0] != W:
        raise ValueError(f"{what}: the kernel takes ({W}, B) arrays, got "
                         f"{tuple(x.shape)}")
    return x.shape[1]


def on(device, *xs) -> tuple[torch.Tensor, ...]:
    """Tensors (numpy arrays taken as they are typed) moved to the
    device, contiguous."""
    return tuple((x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))).to(device).contiguous() for x in xs)


def code(t: torch.Tensor) -> int:
    """The kernel's dtype code of t; raises for a type no probe takes."""
    if t.dtype not in CODE:
        raise ValueError(f"no probe kernel for dtype {t.dtype}")
    return CODE[t.dtype]


def on_kernel(device) -> bool:
    """True when a probe on `device` launches its kernel, False when it
    runs its plain twin (the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no probe kernel for device {dev}")


def launch(kernel: str, entry: str, *args) -> None:
    """Call the C entry point `entry` on the current stream of the first
    tensor among args (tensors go in by pointer), count one launch of
    `kernel` and raise on a CUDA error."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.count(kernel)
    _build.check(lib, rc, f"{entry} ({kernel})")


class Timed(NamedTuple):
    """A timing loop's output at n steps and its cost per step by slope:
    (t(2n) - t(n)) / n, each t the fastest of `reps` runs."""
    out: torch.Tensor
    ns_per_step: float
    t1_ms: float
    t2_ms: float


def _once_ms(run: Callable[[], torch.Tensor], cuda: bool):
    if cuda:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = run()
        e1.record()
        e1.synchronize()
        return out, e0.elapsed_time(e1)
    t0 = time.perf_counter()
    out = run()
    return out, (time.perf_counter() - t0) * 1e3


def slope(run: Callable[[int], torch.Tensor], n: int, reps: int,
          device) -> Timed:
    """Time run(n) and run(2 n) as the JAX probes do: one warm-up run,
    then the fastest of `reps`; CUDA events on the card, the host clock
    on the CPU (a host time, not a device time)."""
    cuda = on_kernel(device)
    best = []
    out = None
    for steps in (n, 2 * n):
        got, _ = _once_ms(lambda: run(steps), cuda)
        ts = [_once_ms(lambda: run(steps), cuda)[1] for _ in range(reps)]
        best.append(min(ts))
        if steps == n:
            out = got
    return Timed(out, (best[1] - best[0]) / n * 1e6, best[0], best[1])


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape:
        return float("inf")
    if not got.numel():
        return 0.0
    return float((got.double() - want.double()).abs().max())


class Report:
    """Runs a probe's cases on one device and prints the JAX tools'
    lines: `OK   name` or `FAIL name: ...`, and the timing lines. On CUDA
    each case's kernel is held against its plain twin on the same
    tensors and must equal it exactly; a difference, or an exception in
    a case, is a failure and makes `status` 1. Per kernel it keeps the
    largest difference and the summed kernel and plain times of the
    compared runs (CUDA events). A case's `work` is (its input tensors,
    operations per output element): its bound moves the inputs and the
    output once and does the operations; its `library` is the one
    PyTorch call, where there is one, that computes the same function on
    the same inputs, timed beside it."""

    CHECK_STEPS = (64, 2048)   # loops are compared at these step counts

    def __init__(self, device="cuda", out=None):
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self.out = out if out is not None else sys.stdout
        self.failures: list[str] = []
        self.stats: dict[str, dict] = {}
        if self.cuda:
            _build.library()   # build before anything is timed

    @property
    def status(self) -> int:
        return 1 if self.failures else 0

    def say(self, line: str) -> None:
        print(line, file=self.out, flush=True)

    def fail(self, name: str, err: BaseException) -> None:
        msg = str(err).split("\n")[0][:110]
        self.say(f"  FAIL {name}: {type(err).__name__} {msg}")
        self.failures.append(name)

    def _compare(self, kernel: str, run, plain, work, library=None):
        """(run()'s output, equal?, kernel ms, plain ms), CUDA events."""
        got, ms = _once_ms(run, True)
        want, pms = _once_ms(plain, True)
        st = self.stats.setdefault(kernel, dict(
            max_abs_err=0.0, ms=0.0, plain_ms=0.0, compared=0,
            bound_bytes_ms=0.0, bound_ops_ms=0.0, bound_ms=0.0,
            library_ms=0.0, library_kernel_ms=0.0, library_cases=0))
        st["max_abs_err"] = max(st["max_abs_err"], max_abs_err(got, want))
        st["ms"] += ms
        st["plain_ms"] += pms
        st["compared"] += 1
        ins, ops_per = work
        tb, to = bound_ms(sum(x.numel() * x.element_size() for x in ins)
                          + got.numel() * got.element_size(),
                          got.numel() * ops_per)
        st["bound_bytes_ms"] += tb
        st["bound_ops_ms"] += to
        st["bound_ms"] += max(tb, to)
        if library is not None:
            _once_ms(library, True)                  # warm-up
            st["library_ms"] += _once_ms(library, True)[1]
            st["library_kernel_ms"] += ms
            st["library_cases"] += 1
        ok = got.shape == want.shape and got.dtype == want.dtype and \
            torch.equal(got, want)
        return got, ok, ms, pms

    def case(self, name: str, kernel: str, run: Callable[[], torch.Tensor],
             plain: Callable[[], torch.Tensor], work, library=None,
             sample: bool = False):
        """run() is the probe on the report's device, plain() its twin on
        the same tensors. Returns run()'s output, None on failure."""
        try:
            if not self.cuda:
                got, ok = run(), True
            else:
                got, ok, _, _ = self._compare(kernel, run, plain, work,
                                              library)
        except Exception as e:  # the tools report per case, then go on
            self.fail(name, e)
            return None
        if not ok:
            self.fail(name, AssertionError("kernel != plain twin"))
            return None
        tail = f"  (sample {got.flatten()[:4].cpu().numpy()})" if sample \
            else ""
        self.say(f"  OK   {name}{tail}" +
                 ("  [kernel == plain]" if self.cuda else ""))
        return got

    def loop(self, name: str, kernel: str, run: Callable[[int], torch.Tensor],
             plain: Callable[[int], torch.Tensor],
             timer: Callable[[int], Timed],
             counts: tuple[int, ...], work) -> list[tuple[int, Timed]] | None:
        """A timing loop: on CUDA run(k) == plain(k) at CHECK_STEPS (and
        the last one's times printed), then timer(n) of the kernel for
        each n of counts; on the CPU timer(CPU_STEPS) of the plain twin.
        work(k) is the case's work at k steps. Returns the (n, Timed)
        pairs."""
        try:
            if self.cuda:
                for k in self.CHECK_STEPS:
                    _, ok, ms, pms = self._compare(kernel, lambda: run(k),
                                                   lambda: plain(k), work(k))
                    if not ok:
                        raise AssertionError(
                            f"kernel != plain twin at {k} steps")
                self.say(f"  OK   {name}  [kernel == plain at "
                         f"{', '.join(map(str, self.CHECK_STEPS))} steps; "
                         f"at {k} steps kernel {ms:.3f} ms, plain "
                         f"{pms:.1f} ms]")
            return [(n, timer(n))
                    for n in (counts if self.cuda else (CPU_STEPS,))]
        except Exception as e:
            self.fail(name, e)
            return None

    def where(self) -> str:
        if self.cuda:
            return f"kernel on {torch.cuda.get_device_name(self.device)}"
        return "plain torch on the CPU: a host time"
