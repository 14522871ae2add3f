"""P1's and P2's redesigned kernels, modelled on the CPU.

The packed layout of csrc/probe_lowprec.cu: rows t and t + 32 of a
column in one 32-bit word on thread t (a 16-bit type fills each half,
int8 the low byte of each half), the row roll as a word shuffle plus
`__byte_perm(top, 0, 0x4432)` on thread 31, and the step timer's and
roll_concat's arithmetic lane by lane. A plain PyTorch model of each,
written as the kernel computes it (words as int64 tensors), must give
what the port's plain twins give: `roll_up`, `step_timer_plain`,
`roll_concat_plain`, bit for bit, including an int16 case whose adds wrap.

Then the thin launch path (probes/_common.launch) against a stub
library that records what each wrapper passes: pointers, sizes, dtype
code, op, rounds or steps, device index and stream; one count a launch;
a raise when the entry returns a CUDA error.
"""

import numpy as np
import pytest
import torch

from minialign_tpu_torch import _build
from minialign_tpu_torch.probes import (_common, bf16ops, lowprec, subint32,
                                        wordstream)

W = _common.W
BITS = {"int16": (torch.int16, 16), "bfloat16": (torch.int16, 16),
        "int8": (torch.int8, 8)}


# ---- the packed words, modelled with int64 tensors holding uint32 bits


def lane_bits(x: torch.Tensor, dtype: str) -> torch.Tensor:
    """x's bit patterns (unsigned) as int64."""
    view, width = BITS[dtype]
    return x.view(view).long() & ((1 << width) - 1)


def from_bits(u: torch.Tensor, dtype: str) -> torch.Tensor:
    """Unsigned bit patterns back to values of the dtype."""
    view, width = BITS[dtype]
    signed = torch.where(u >= 1 << (width - 1), u - (1 << width), u)
    v = signed.to(view)
    return v.view(torch.bfloat16) if dtype == "bfloat16" else v


def pack(x: torch.Tensor, dtype: str) -> torch.Tensor:
    """(64, B) -> (32, B) words: row t low, row t + 32 at bit 16."""
    return lane_bits(x[:32], dtype) | lane_bits(x[32:], dtype) << 16


def unpack(w: torch.Tensor, dtype: str) -> torch.Tensor:
    mask = (1 << BITS[dtype][1]) - 1
    return torch.cat([from_bits(w & mask, dtype),
                      from_bits((w >> 16) & mask, dtype)])


def byte_perm(x: torch.Tensor, y, s: int) -> torch.Tensor:
    """__byte_perm(x, y, s): byte i of the result is byte (s >> 4 i) & 7
    of the 8 bytes y:x (x the low four)."""
    src = (torch.as_tensor(y) << 32) | x
    out = torch.zeros_like(x)
    for i in range(4):
        sel = (s >> (4 * i)) & 7
        out |= ((src >> (8 * sel)) & 0xff) << (8 * i)
    return out


def roll_pair(w: torch.Tensor) -> torch.Tensor:
    """roll_up_pair on (32, B) words: thread t takes __shfl_down_sync's
    word of thread t + 1 (thread 31 keeps its own there), thread 31 then
    thread 0's word through __byte_perm(top, 0, 0x4432)."""
    down = torch.cat([w[1:], w[31:]])
    top = byte_perm(w[0:1], 0, 0x4432)
    t = torch.arange(32).reshape(-1, 1)
    return torch.where(t == 31, top, down)


def lanes(w: torch.Tensor, width: int) -> list[torch.Tensor]:
    return [(w >> (width * k)) & ((1 << width) - 1)
            for k in range(32 // width)]


def join(parts: list[torch.Tensor], width: int) -> torch.Tensor:
    out = torch.zeros_like(parts[0])
    for k, p in enumerate(parts):
        out |= p << (width * k)
    return out


def lane_op(fn, dtype: str, *words: torch.Tensor) -> torch.Tensor:
    """fn on every lane of the words as the dtype's values (int8: every
    byte, as __vadd4 does; 16-bit: each half), torch's own arithmetic,
    so int16 and int8 wrap and bf16 rounds per lane."""
    width = BITS[dtype][1]
    cols = zip(*(lanes(w, width) for w in words))
    return join([lane_bits(fn(*(from_bits(c, dtype) for c in col)), dtype)
                 for col in cols], width)


def splat(v: int, dtype: str) -> torch.Tensor:
    """Pair<T>::splat: v in both rows' lanes."""
    return pack(torch.full((64, 1), v, dtype=_common.DTYPES[dtype][0]),
                dtype)


def add_sat16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An int16 add that saturates, to show that a case wraps."""
    return (a.int() + b.int()).clamp(-32768, 32767).to(torch.int16)


def step_timer_packed(x, dd, n, dtype, add=torch.add):
    """step_timer_pair_kernel on every column at once: 4 packed arrays
    x + k; per step f0 = a[0], then each a <- max((d ? roll : a) + 1, f0)
    with d = dd[col] > i % 7; the max of the arrays, as float32."""
    x2 = pack(x, dtype)
    a = [lane_op(add, dtype, x2, splat(k, dtype)) for k in range(4)]
    one = splat(1, dtype)
    d_col = dd.reshape(1, -1)
    for i in range(n):
        d = d_col > i % 7
        f0 = a[0]
        a = [lane_op(lambda v, o, f: torch.maximum(add(v, o), f), dtype,
                     torch.where(d, roll_pair(w), w), one, f0) for w in a]
    m = a[0]
    for w in a[1:]:
        m = lane_op(torch.maximum, dtype, m, w)
    return unpack(m, dtype).float()


def roll_concat_packed(x, y, dtype, rounds=lowprec.ROUNDS):
    """roll_concat_pair_kernel: w <- (d ? roll : w) + 1, `rounds` times,
    d = y[0] > y[1] per column; int8's high bytes must stay 0."""
    w = pack(x, dtype)
    d = y[0:1] > y[1:2]
    one = splat(1, dtype)
    for _ in range(rounds):
        w = lane_op(torch.add, dtype, torch.where(d, roll_pair(w), w), one)
    if dtype == "int8":
        assert not bool((w & 0xff00ff00).any())
    return unpack(w, dtype).float()


def inputs(dtype: str, lo: int, hi: int, B: int = 24, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (_common.tensor(rng.integers(lo, hi, (W, B)), dtype, "cpu"),
            _common.tensor(rng.integers(0, 7, (1, B)), "int32", "cpu"))


@pytest.mark.parametrize("dtype", ["int16", "bfloat16", "int8"])
def test_packed_roll_is_roll_up(dtype):
    """Every bit pattern of the type (NaN patterns of bf16 included)
    rolls as roll_up rolls it."""
    rng = np.random.default_rng(1)
    width = BITS[dtype][1]
    u = torch.from_numpy(rng.integers(0, 1 << width, (W, 40)))
    x = from_bits(u, dtype)
    got = unpack(roll_pair(pack(x, dtype)), dtype)
    view = BITS[dtype][0]
    assert torch.equal(got.view(view), _common.roll_up(x).view(view))


def test_byte_perm_moves_the_high_half_down():
    w = torch.tensor([0x12345678, 0xffff0001], dtype=torch.int64)
    assert byte_perm(w, 0, 0x4432).tolist() == [0x1234, 0xffff]


@pytest.mark.parametrize("dtype,lo,hi", [
    ("int16", 0, 4), ("bfloat16", 0, 4), ("int16", *lowprec.WRAP_RANGE),
    ("bfloat16", 250, 1000), ("int16", -32768, 32768)])
def test_packed_step_timer_is_step_timer_plain(dtype, lo, hi):
    x, dd = inputs(dtype, lo, hi)
    for n in (1, 9, 64):
        want = lowprec.step_timer_plain(x, dd, n)
        assert torch.equal(step_timer_packed(x, dd, n, dtype), want), n


def test_the_wrap_case_wraps():
    """From inputs near 32,767 the step timer's adds wrap within 64
    steps: a saturating add gives another result."""
    x, dd = inputs("int16", *lowprec.WRAP_RANGE)
    want = lowprec.step_timer_plain(x, dd, 64)
    assert torch.equal(step_timer_packed(x, dd, 64, "int16"), want)
    assert not torch.equal(
        step_timer_packed(x, dd, 64, "int16", add=add_sat16), want)


@pytest.mark.parametrize("dtype,lo,hi", [
    ("int16", 0, 60), ("bfloat16", 0, 60), ("int8", 0, 60),
    ("int16", 32700, 32768), ("bfloat16", 200, 3000), ("int8", -128, 128)])
def test_packed_roll_concat_is_roll_concat_plain(dtype, lo, hi):
    rng = np.random.default_rng(2)
    x, y = (_common.tensor(rng.integers(lo, hi, (W, 24)), dtype, "cpu")
            for _ in range(2))
    assert torch.equal(roll_concat_packed(x, y, dtype),
                       lowprec.roll_concat_plain(x, y))


# ---- the thin launch path against a stub library


class StubLib:
    """Records each C entry's arguments and returns `rc`."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return self.rc
        return entry

    def cuda_error_string(self, rc):
        return b"stub error"


STREAM = 0x5eed00


@pytest.fixture
def stub(monkeypatch):
    """A stub library behind probes/_common's launch path, with every
    tensor taken as one the kernel runs on. Launch counts reset."""
    lib = StubLib()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_common, "_ENTRIES", {})
    monkeypatch.setattr(_common, "raw_stream", lambda i: STREAM + i)
    for mod in (_common, lowprec, bf16ops, wordstream):
        monkeypatch.setattr(mod, "kernel_for", lambda x: True)
    _build.reset_counts()
    yield lib
    _build.reset_counts()


def t(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    return _common.tensor(rng.integers(0, 50, shape), dtype, "cpu")


def test_launch_passes_pointers_sizes_codes_device_and_stream(stub):
    x, y = t("uint8", (64, 128)), t("uint8", (64, 128), 1)
    out = subint32.probe_carry("select", x, y, "cpu", rounds=5)
    assert out.dtype == torch.int32 and out.shape == x.shape
    dev = x.get_device()
    assert stub.calls == [("p1_probe_launch", (
        x.data_ptr(), y.data_ptr(), 8192, 1, 3, 5, out.data_ptr(), dev,
        STREAM + dev))]
    assert _build.LAUNCHES["p1"] == 1


# (wrapper call, inputs, entry, expected args before (device, stream), as
# a function of the inputs and the output)
WRAPPERS = {
    "p1 probe": (lambda x, y: subint32.probe("compare-gt", x, y, "cpu"),
                 ("int16", "int16"), "p1_probe_launch",
                 lambda x, y, o: (x.data_ptr(), y.data_ptr(), 8192, 2, 2, 0,
                                  o.data_ptr())),
    "p2 elementwise": (lambda x, y: lowprec.elementwise("add", x, y, "cpu"),
                       ("bfloat16", "bfloat16"), "p2_elementwise_launch",
                       lambda x, y, o: (x.data_ptr(), y.data_ptr(), 8192, 4,
                                        0, 0, o.data_ptr())),
    "p2 in_carry": (lambda x, y: lowprec.in_carry("maximum", x, y, "cpu"),
                    ("int8", "int8"), "p2_elementwise_launch",
                    lambda x, y, o: (x.data_ptr(), y.data_ptr(), 8192, 0, 1,
                                     8, o.data_ptr())),
    "p2 roll_concat": (lambda x, y: lowprec.roll_concat(x, y, "cpu"),
                       ("int16", "int16"), "p2_roll_concat_launch",
                       lambda x, y, o: (x.data_ptr(), y.data_ptr(), 128, 2,
                                        8, o.data_ptr())),
    "p3 run2": (lambda x, y: bf16ops.run2("min", x, y, "cpu"),
                ("bfloat16", "bfloat16"), "p3_run2_launch",
                lambda x, y, o: (x.data_ptr(), y.data_ptr(), 64, 128, 4, 5,
                                 o.data_ptr())),
    "p4 var_shift": (lambda x, y: wordstream.var_shift(x, y, "cpu"),
                     ("int32", "int32"), "p4_var_shift_launch",
                     lambda x, y, o: (x.data_ptr(), y.data_ptr(), 8192,
                                      o.data_ptr())),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_each_wrapper_marshals_one_launch(name, stub):
    call, dts, entry, want = WRAPPERS[name]
    x, y = t(dts[0], (64, 128)), t(dts[1], (64, 128), 1)
    out = call(x, y)
    ((got_entry, args),) = stub.calls
    assert got_entry == entry
    dev = x.get_device()
    assert args == (*want(x, y, out), dev, STREAM + dev)
    assert sum(_build.LAUNCHES.values()) == 1
    assert _build.LAUNCHES[name[:2]] == 1


def test_step_loop_marshals_a_contiguous_int32_direction(stub):
    """The step timer's directions go in as (B,) int32, whatever the
    caller's (1, B) tensor was."""
    x = t("int16", (64, 128))
    dd = torch.arange(128, dtype=torch.int64).reshape(1, -1) % 7
    out = lowprec.step_loop(x, dd, 77, "cpu")
    ((entry, args),) = stub.calls
    assert entry == "p2_step_timer_launch"
    assert args[0] == x.data_ptr() and args[2:6] == (128, 2, 77,
                                                      out.data_ptr())
    assert _build.LAUNCHES["p2"] == 1


def test_a_cuda_error_raises_after_its_count(stub):
    stub.rc = 700
    x, y = t("int8", (64, 128)), t("int8", (64, 128), 1)
    with pytest.raises(RuntimeError, match=r"CUDA error 700 \(stub error\)"):
        subint32.probe("add", x, y, "cpu")
    assert _build.LAUNCHES["p1"] == 1


def test_checks_raise_before_any_launch(stub):
    x, y = t("int16", (64, 128)), t("int16", (128, 64))
    with pytest.raises(ValueError, match="differ in shape"):
        subint32.probe("add", x, y, "cpu")
    with pytest.raises(ValueError, match="unknown op"):
        subint32.probe("min", x, x, "cpu")
    with pytest.raises(ValueError, match="no probe kernel for dtype"):
        subint32.probe("add", x.double(), x.double(), "cpu")
    assert stub.calls == [] and _build.LAUNCHES["p1"] == 0


def test_on_takes_tensors_in_place_and_moves_the_rest():
    x = t("int16", (64, 128))
    cpu = torch.device("cpu")
    a, b = _common.on(cpu, x, x)
    assert a is x and b is x
    v = x.t()
    (c,) = _common.on(cpu, v)
    assert c.is_contiguous() and torch.equal(c, v)
    (n,) = _common.on(cpu, np.arange(6, dtype=np.int16).reshape(2, 3))
    assert n.dtype == torch.int16 and n.shape == (2, 3)
