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

# the binary ops of P1 and P2, in csrc/probe_common.cuh:Op's order
BINOPS = ("add", "maximum", "compare-gt", "select")
OP_CODE = {op: i for i, op in enumerate(BINOPS)}

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


def binop(kernel: str, entry_name: str, out_dtype: torch.dtype, op: str,
          x, y, device, rounds: int) -> torch.Tensor:
    """P1's and P2's elementwise kernel (csrc/probe_common.cuh:
    binop_kernel) through the C entry `entry_name`: op(x, y) for
    rounds = 0, else the carry; as out_dtype. The plain twins on CPU
    tensors."""
    x, y = on(device, x, y)
    if not kernel_for(x):
        r = binop_plain(op, x, y) if rounds == 0 else \
            carry_plain(op, x, y, rounds)
        return r.to(out_dtype)
    opc = binop_checks(kernel, op, x, y)
    out = torch.empty_like(x, dtype=out_dtype)
    launch(kernel, entry_name, x.get_device(), x.data_ptr(), y.data_ptr(),
           x.numel(), code(x), opc, rounds, out.data_ptr())
    return out


def binop_checks(kernel: str, op: str, x: torch.Tensor,
                 y: torch.Tensor) -> int:
    """The op's code; raises for an unknown op or for x and y of
    different shapes or dtypes."""
    opc = OP_CODE.get(op)
    if opc is None:
        raise ValueError(f"unknown op {op!r}; one of {BINOPS}")
    if x.shape != y.shape or x.dtype != y.dtype:
        raise ValueError(f"{kernel}: x and y differ in shape or dtype")
    return opc


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
    """xs on the device, contiguous. A tensor already there is taken as
    it is (the device compared as given: a torch.device with its index,
    as Report passes, finds CUDA tensors there); anything else is moved,
    numpy arrays taken as they are typed."""
    for x in xs:
        if not (isinstance(x, torch.Tensor) and x.device == device
                and x.is_contiguous()):
            return tuple(_moved(x, device) for x in xs)
    return xs


def _moved(x, device) -> torch.Tensor:
    """x on the device, contiguous (a no-op for a tensor already so)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device).contiguous()


def code(t: torch.Tensor) -> int:
    """The kernel's dtype code of t; raises for a type no probe takes."""
    c = CODE.get(t.dtype)
    if c is None:
        raise ValueError(f"no probe kernel for dtype {t.dtype}")
    return c


def kernel_for(x: torch.Tensor) -> bool:
    """True when a probe launches its kernel on x (a CUDA tensor), False
    when it runs its plain twin (a CPU tensor); raises for any other
    device."""
    if x.is_cuda:
        return True
    if x.is_cpu:
        return False
    raise ValueError(f"no probe kernel for device {x.device}")


_ENTRIES: dict = {}   # C entry name -> ctypes function of the library


def entry(name: str):
    """The kernel library's C entry point `name` (the library built and
    loaded at first use)."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = _ENTRIES[name] = getattr(_build.library(), name)
    return fn


def raw_stream(index: int) -> int:
    """The handle of device `index`'s current CUDA stream, read as
    PyTorch's own generated code reads it, without building a
    torch.cuda.Stream."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(kernel: str, name: str, index: int, *args: int) -> None:
    """Call the C entry `name` with args (integers; tensors go in as
    their data_ptr()), the device index and that device's current
    stream, count one launch of `kernel` and raise on a CUDA error. The
    entry makes the device current for the launch only when it is not
    (csrc/probe_common.cuh:DeviceGuard)."""
    rc = entry(name)(*args, index, raw_stream(index))
    _build.count(kernel)
    if rc:
        _build.check(_build.library(), rc, f"{name} ({kernel})")


def launch_floor(index: int) -> None:
    """One launch of an empty kernel (csrc/probe_common.cuh:noop_launch)
    through the probes' launch path, on device `index`: the floor that a
    one-call case's device and host times are set against (kbench.py
    --probes). The CLI never calls it."""
    launch("noop", "probe_noop_launch", index, 0, 0, 0, 0, 0, 1, 0)


class Timed(NamedTuple):
    """A timing loop's output at n steps and its cost per step by slope:
    (t(2n) - t(n)) / n, each t the fastest of `reps` runs."""
    out: torch.Tensor
    ns_per_step: float
    t1_ms: float
    t2_ms: float


def _window_ms(run: Callable[[], torch.Tensor], cuda: bool, calls: int = 1):
    """(run()'s last output, ms a call): `calls` calls between CUDA
    events, or on the host clock on the CPU."""
    if cuda:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(calls):
            out = run()
        e1.record()
        e1.synchronize()
        return out, e0.elapsed_time(e1) / calls
    t0 = time.perf_counter()
    for _ in range(calls):
        out = run()
    return out, (time.perf_counter() - t0) * 1e3 / calls


def slope(run: Callable[[int], torch.Tensor], n: int, reps: int,
          device) -> Timed:
    """Time run(n) and run(2 n) as the JAX probes do: one warm-up run,
    then the fastest of `reps`; CUDA events on the card, the host clock
    on the CPU (a host time, not a device time)."""
    cuda = torch.device(device).type == "cuda"
    best = []
    out = None
    for steps in (n, 2 * n):
        got, _ = _window_ms(lambda: run(steps), cuda)
        ts = [_window_ms(lambda: run(steps), cuda)[1] for _ in range(reps)]
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


def show_ms(ms: float | None) -> str:
    """A time for a report line; a device time not taken (on the CPU) is
    "not measured", never a number."""
    return "not measured" if ms is None else f"{ms:.5f} ms"


class Times(NamedTuple):
    """A compared case's times a call: the kernel's device time and its
    host-inclusive time (the mean over a window of calls between CUDA
    events: "a call, host"), the plain twin's one call, and the one
    PyTorch call's device and host times where there is one."""
    device_ms: float | None
    host_ms: float
    plain_ms: float
    library_device_ms: float | None = None
    library_host_ms: float | None = None

    def line(self) -> str:
        s = (f"kernel {show_ms(self.device_ms)} device, "
             f"{self.host_ms:.5f} ms a call (host)")
        if self.library_host_ms is not None:
            s += (f"; one PyTorch call {show_ms(self.library_device_ms)} "
                  f"device, {self.library_host_ms:.5f} ms a call (host)")
        return s


class Report:
    """Runs a probe's cases on one device and prints the JAX tools'
    lines: `OK   name` or `FAIL name: ...`, and the timing lines. On CUDA
    each case's kernel is held against its plain twin on the same
    tensors and must equal it exactly; a difference, or an exception in
    a case, is a failure and makes `status` 1. Per kernel it keeps the
    largest difference and the summed times of the compared runs. A
    case's `work` is (its input tensors, operations per output element):
    its bound moves the inputs and the output once and does the
    operations; its `library` is the one PyTorch call, where there is
    one, that computes the same function on the same inputs, timed
    beside it. Kernel and library are timed alike, each as device time
    (device_ms) and as host-inclusive time a call (the mean over WINDOW
    warm calls between CUDA events), wrapper overhead included in the
    latter. The sums over the cases that have a library call (the
    library_* stats, library_bound_ms among them) cover the same cases,
    so their kernel time and bound compare. The device is resolved
    once, with its index, so the probes' wrappers find the report's
    tensors already in place."""

    CHECK_STEPS = (64, 2048)   # loops are compared at these step counts
    WINDOW = 20                # calls a timed window of a compared case

    def __init__(self, device="cuda", out=None):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.cuda = dev.type == "cuda"
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

    def _device_ms(self, run) -> float | None:
        """Device ms a call of run() by kbench.device_ms (WINDOW calls
        queued behind a spin on the device, so that the window holds the
        kernels back to back, not the host's issue rate); None on the
        CPU."""
        if not self.cuda:
            return None
        from ..kbench import device_ms
        return device_ms(torch, run, calls=self.WINDOW)

    def _compare(self, kernel: str, run, plain, work, library=None):
        """(run()'s output, equal?, Times). The kernel's run() and the
        library call are timed alike: one warm-up call, then the mean a
        call over a window of WINDOW calls (CUDA events on the card, the
        host clock on the CPU) and, on the card, the device time a call;
        the plain twin once."""
        run()                                        # warm-up
        got, ms = _window_ms(run, self.cuda, self.WINDOW)
        dms = self._device_ms(run)
        want, pms = _window_ms(plain, self.cuda)
        dev0 = 0.0 if self.cuda else None
        st = self.stats.setdefault(kernel, dict(
            max_abs_err=0.0, ms=0.0, device_ms=dev0, plain_ms=0.0,
            compared=0, bound_bytes_ms=0.0, bound_ops_ms=0.0, bound_ms=0.0,
            library_ms=0.0, library_device_ms=dev0, library_kernel_ms=0.0,
            library_kernel_device_ms=dev0, library_bound_ms=0.0,
            library_cases=0))
        st["max_abs_err"] = max(st["max_abs_err"], max_abs_err(got, want))
        st["ms"] += ms
        st["plain_ms"] += pms
        st["compared"] += 1
        if self.cuda:
            st["device_ms"] += dms
        ins, ops_per = work
        tb, to = bound_ms(sum(x.numel() * x.element_size() for x in ins)
                          + got.numel() * got.element_size(),
                          got.numel() * ops_per)
        st["bound_bytes_ms"] += tb
        st["bound_ops_ms"] += to
        st["bound_ms"] += max(tb, to)
        times = Times(dms, ms, pms)
        if library is not None:
            library()                                # warm-up
            lms = _window_ms(library, self.cuda, self.WINDOW)[1]
            ldms = self._device_ms(library)
            st["library_ms"] += lms
            st["library_kernel_ms"] += ms
            st["library_bound_ms"] += max(tb, to)
            st["library_cases"] += 1
            if self.cuda:
                st["library_device_ms"] += ldms
                st["library_kernel_device_ms"] += dms
            times = times._replace(library_device_ms=ldms,
                                   library_host_ms=lms)
        ok = got.shape == want.shape and got.dtype == want.dtype and \
            torch.equal(got, want)
        return got, ok, times

    def summary(self) -> None:
        """A line per probe kernel: its compared runs and their summed
        device and host ms a call, and, on the cases that have one, the
        kernel against its one PyTorch call. On the CPU nothing was
        compared or timed on a device."""
        if not self.cuda:
            self.say("device time: not measured (plain torch on the CPU)")
            return
        for k, st in self.stats.items():
            line = (f"{k}: {st['compared']} runs; kernel "
                    f"{show_ms(st['device_ms'])} device, {st['ms']:.5f} ms a "
                    f"call (host), summed")
            n = st["library_cases"]
            if n:
                kd, ld = st["library_kernel_device_ms"], \
                    st["library_device_ms"]
                kh, lh = st["library_kernel_ms"], st["library_ms"]
                line += (f"; on its {n} one-call cases kernel "
                         f"{show_ms(kd)} against {show_ms(ld)} device "
                         f"({kd / ld:.2f}x), {kh:.5f} against {lh:.5f} ms a "
                         f"call host ({kh / lh:.2f}x), bound "
                         f"{st['library_bound_ms']:.6f} ms")
            self.say(line)

    def case(self, name: str, kernel: str, run: Callable[[], torch.Tensor],
             plain: Callable[[], torch.Tensor], work, library=None,
             sample: bool = False):
        """run() is the probe on the report's device, plain() its twin on
        the same tensors. Returns run()'s output, None on failure."""
        try:
            if not self.cuda:
                got, ok = run(), True
            else:
                got, ok, times = self._compare(kernel, run, plain, work,
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
                 (f"  [kernel == plain; {times.line()}]" if self.cuda
                  else ""))
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
                    _, ok, times = self._compare(kernel, lambda: run(k),
                                                 lambda: plain(k), work(k))
                    if not ok:
                        raise AssertionError(
                            f"kernel != plain twin at {k} steps")
                self.say(f"  OK   {name}  [kernel == plain at "
                         f"{', '.join(map(str, self.CHECK_STEPS))} steps; "
                         f"at {k} steps {times.line()}, plain "
                         f"{times.plain_ms:.1f} ms]")
            return [(n, timer(n))
                    for n in (counts if self.cuda else (CPU_STEPS,))]
        except Exception as e:
            self.fail(name, e)
            return None

    def where(self) -> str:
        if self.cuda:
            return f"kernel on {torch.cuda.get_device_name(self.device)}"
        return "plain torch on the CPU: a host time"
