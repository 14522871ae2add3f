"""P3's timing loop and P4's stream and roll, as their redesigned kernels
run them, modelled on the CPU.

csrc/probe_bf16ops.cu: int32 and float32 one (row, column) element a
thread, each max(x + b, c) as one step of its own and the sub as an add
of -1 (int32: two DPX VIADDMNMX an array a step); 16- and 8-bit types
two rows a 32-bit word (rows t and t + 32 on thread t), each op on both
lanes. csrc/probe_wordstream.cu: the row roll as a row pointer; the
stream's two sides on two lanes with their own sums, joined at the end;
7 steps a pass with the pass's advances computed once, the wrap seen at
the pass's end from the shift, the next word and the one after it in
registers. A plain PyTorch model of each, written as the kernel computes
it, must give what the port's plain twins (held against the JAX tools in
tests/test_torch_probe_{bf16ops,wordstream}.py) give, bit for bit, on
kbench's edge inputs. Then each changed entry against a stub library:
one launch, its arguments as the kernel takes them.
"""

import numpy as np
import pytest
import torch
from test_torch_probe_pack import STREAM, lane_op, pack, splat, stub, unpack

from minialign_tpu_torch import _build, kbench
from minialign_tpu_torch.probes import _common, bf16ops, wordstream

N_ARR = bf16ops.N_ARR
assert stub  # a fixture (the stub library), used by the launch tests below


# ---- P3: one element a thread (int32, float32)


def wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values cut to int32's range, two's complement (as int64)."""
    return torch.remainder(v + 2**31, 2**32) - 2**31


def saturate32(v: torch.Tensor) -> torch.Tensor:
    """int64 values clamped to int32's range, to show that a case wraps."""
    return v.clamp(-2**31, 2**31 - 1)


def timing_flat(x: torch.Tensor, steps: int, cut=wrap32) -> torch.Tensor:
    """timing_kernel on every thread at once: thread i holds element i of
    the flat (64, B) array; 6 values x + k % 3; a step reads p = a[5] and
    f = a[0] + (-1), then a <- addmax(addmax(a, 1, p), -1, f), addmax
    max(a + b, c): int32 as __viaddmax_s32 (int64 here, the add cut to
    int32 by `cut`), float32 as FADD then FMNMX."""
    v = x.reshape(-1)
    if x.dtype == torch.int32:
        v = v.long()
        add = lambda a, b: cut(a + b)  # noqa: E731
    else:
        add = torch.add
    one = torch.ones((), dtype=v.dtype)
    a = [add(v, k % 3 * one) for k in range(N_ARR)]
    for _ in range(steps):
        p, f = a[-1], add(a[0], -one)
        a = [torch.maximum(add(torch.maximum(add(w, one), p), -one), f)
             for w in a]
    m = a[0]
    for w in a[1:]:
        m = torch.maximum(m, w)
    return m.to(x.dtype).float().reshape(x.shape)


@pytest.mark.parametrize("dtype,edge", [("int32", False), ("int32", True),
                                        ("float32", False),
                                        ("float32", True)])
def test_flat_timing_is_timing_plain(dtype, edge):
    """From the tool's [0, 3) and from the type's ends (int32 adds that
    wrap, float32 past 2^24 where + 1 rounds), at B 128, 33 and 1."""
    rng = np.random.default_rng(31)
    for B in (128, 33, 1):
        x = (kbench.timing_edge_input(rng, dtype, B, "cpu") if edge else
             bf16ops.timing_input(rng, dtype, "cpu", B))
        for n in (0, 1, 9, 64):
            want = bf16ops.timing_plain(x, n)
            assert torch.equal(timing_flat(x, n), want), (B, n)


def test_int32_edge_adds_wrap():
    """From the int32 edge inputs the loop's adds wrap within 9 steps: a
    saturating add gives another result."""
    x = kbench.timing_edge_input(np.random.default_rng(32), "int32", 128,
                                 "cpu")
    want = bf16ops.timing_plain(x, 9)
    assert torch.equal(timing_flat(x, 9), want)
    assert not torch.equal(timing_flat(x, 9, saturate32), want)


# ---- P3: two rows a word (bfloat16, int16, int8)


def addmax_pair(dtype, a, b, c):
    """addmax_pair<T> on packed words: max(a + b, c) on every lane, the
    add wrapping (int16: __viaddmax_s16x2, int8: __vadd4 and __vmaxs4) or
    rounding (bf16: __hadd2 then __hmax2) per lane."""
    return lane_op(lambda v, o, q: torch.maximum(v + o, q), dtype, a, b, c)


def timing_pair(x: torch.Tensor, steps: int, dtype: str) -> torch.Tensor:
    """timing_pair_kernel on every column at once: (32, B) words of rows
    t and t + 32; a step reads p = a[5] and f = a[0] + (-1), then
    a <- addmax_pair(addmax_pair(a, 1, p), -1, f)."""
    x2 = pack(x, dtype)
    a = [lane_op(torch.add, dtype, x2, splat(k % 3, dtype))
         for k in range(N_ARR)]
    one, minus_one = splat(1, dtype), splat(-1, dtype)
    for _ in range(steps):
        p, f = a[-1], lane_op(torch.add, dtype, a[0], minus_one)
        a = [addmax_pair(dtype, addmax_pair(dtype, w, one, p), minus_one, f)
             for w in a]
    m = a[0]
    for w in a[1:]:
        m = lane_op(torch.maximum, dtype, m, w)
    if dtype == "int8":                # the high byte of each half stays 0
        assert not bool((m & 0xff00ff00).any())
    return unpack(m, dtype).float()


@pytest.mark.parametrize("dtype,edge", [
    ("bfloat16", False), ("bfloat16", True), ("int16", False),
    ("int16", True), ("int8", False), ("int8", True)])
def test_pair_timing_is_timing_plain(dtype, edge):
    """From the tool's [0, 3) and from the type's ends (bf16 past 256,
    where it rounds; int16 and int8 adds that wrap), at B 24 and 1."""
    rng = np.random.default_rng(33)
    for B in (24, 1):
        x = (kbench.timing_edge_input(rng, dtype, B, "cpu") if edge else
             bf16ops.timing_input(rng, dtype, "cpu", B))
        for n in (0, 1, 9, 40):
            assert torch.equal(timing_pair(x, n, dtype),
                               bf16ops.timing_plain(x, n)), (B, n)


def test_sub_is_an_add_of_minus_one():
    """Every bf16 bit pattern minus 1 equals it plus -1, bit for bit (the
    kernels issue the sub as an add of -1); NaN patterns stay NaN."""
    u = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    x = u.view(torch.bfloat16)
    one = torch.ones((), dtype=torch.bfloat16)
    a, b = x - one, x + (-one)
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    assert torch.equal(a[~nan].view(torch.int16), b[~nan].view(torch.int16))


# ---- P4: the stream on two lanes, 7 steps a pass


def stream_lanes(wa, wb, d, steps):
    """stream_kernel on every column at once. Lane side 0 runs stream a,
    side 1 stream b ((2, C) tensors); per lane the 7 advances inc[j]
    (3 where stream b moves and d > j, or stream a moves and not) and
    thresholds 30 - inc[j]; a step adds (cur >> sh) & 7 to the lane's sum,
    then on sh >= 30 - inc takes cur = nxt and sh = 0, else sh + inc; a
    pass of 7 steps wrapped where sh != sh0 + adv, and there the pointer
    moves on, nxt = nxt2 and nxt2 is read two rows on; the steps % 7 left
    run after; the two lanes' (sum + cur) are added."""
    slab = torch.stack([wa, wb]).long()            # (2, 8, C)
    C = wa.shape[1]
    dcol = d.reshape(1, C)
    side_b = torch.tensor([[False], [True]])
    inc = [torch.where((dcol > j) == side_b, 3, 0) for j in range(7)]
    thr = [30 - i for i in inc]
    adv = sum(inc)
    acc = torch.zeros((2, C), dtype=torch.int64)
    sh = torch.zeros((2, C), dtype=torch.int64)
    r = torch.zeros((2, C), dtype=torch.int64)

    def row(k):            # each lane's word k % 8 rows down its slab
        return torch.gather(slab, 1, (k % 8).unsqueeze(1)).squeeze(1)

    cur, nxt, nxt2 = row(r), row(r + 1), row(r + 2)

    def step(j):
        nonlocal acc, sh, cur
        # the shift a step reads is a multiple of 3 in [0, 27]: no clamp
        assert int(sh.min()) >= 0 and int(sh.max()) <= 27
        assert not bool((sh % 3).any())
        acc = acc + ((cur >> sh) & 7)
        wrap = sh >= thr[j]
        cur = torch.where(wrap, nxt, cur)
        sh = torch.where(wrap, 0, sh + inc[j])
        return wrap

    passes = steps // 7 if steps > 0 else 0
    for _ in range(passes):
        sh0 = sh
        wraps = sum(step(j).long() for j in range(7))
        assert int(wraps.max()) <= 1              # at most one a pass
        wrapped = sh != sh0 + adv
        assert torch.equal(wrapped, wraps == 1)
        r = torch.where(wrapped, r + 1, r)
        nxt = torch.where(wrapped, nxt2, nxt)
        nxt2 = torch.where(wrapped, row(r + 2), nxt2)
    for j in range(steps - 7 * passes):
        step(j)
    v = (acc + cur) % 2**32
    return wrap32(v[0:1] + v[1:2]).to(torch.int32)


@pytest.mark.parametrize("kind", kbench.STREAM_D_KINDS)
@pytest.mark.parametrize("C", kbench.LOOP_EDGE_C)
def test_stream_lanes_is_stream_timing_plain(C, kind):
    rng = np.random.default_rng(34 + C)
    wa, wb, d = kbench.stream_edge_case(rng, C, kind, "cpu")
    assert bool((wa < 0).any()) or C == 1
    for n in kbench.LOOP_EDGE_STEPS:
        assert torch.equal(stream_lanes(wa, wb, d, n),
                           wordstream.stream_timing_plain(wa, wb, d, n)), n


def test_stream_tool_input_in_passes():
    """The tool's inputs ([0, 2^30) words, d from [0, 7)) at the check
    step counts of probes._common.Report."""
    rng = np.random.default_rng(35)
    shape = wordstream.SHAPE
    wa, wb = (_common.tensor(rng.integers(0, 2**30, shape), "int32", "cpu")
              for _ in range(2))
    d = _common.tensor(rng.integers(0, 7, (1, shape[1])), "int32", "cpu")
    for n in _common.Report.CHECK_STEPS:
        assert torch.equal(stream_lanes(wa, wb, d, n),
                           wordstream.stream_timing_plain(wa, wb, d, n)), n


# ---- P4: roll_in_carry with a row pointer


def roll_pointer(w: torch.Tensor, rounds: int) -> torch.Tensor:
    """roll_in_carry_kernel on every column: the rows rolled r and the
    shift carried through the rounds, then out[row] = w[(row + r) % 8]
    + sh."""
    r, sh = 0, 0
    for _ in range(rounds):
        wrap = sh >= 30
        r += wrap
        sh = 0 if wrap else sh + 3
    rows = [(k + r) % 8 for k in range(8)]
    return wrap32(w[rows].long() + sh).to(torch.int32)


@pytest.mark.parametrize("rounds", kbench.ROLL_EDGE_ROUNDS)
def test_roll_pointer_is_roll_in_carry_plain(rounds):
    rng = np.random.default_rng(36)
    for C in kbench.LOOP_EDGE_C:
        w = _common.tensor(rng.integers(-2**31, 2**31, (8, C)), "int32",
                           "cpu")
        assert torch.equal(roll_pointer(w, rounds),
                           wordstream.roll_in_carry_plain(w, rounds)), C


# ---- the changed entries against a stub library


def test_timing_loop_marshals_one_launch(stub):
    for dtype in ("int32", "bfloat16"):
        x = bf16ops.timing_input(np.random.default_rng(0), dtype, "cpu", 37)
        out = bf16ops.timing_loop(x, 77, "cpu")
        assert out.dtype == torch.float32 and out.shape == x.shape
        entry, args = stub.calls[-1]
        dev = x.get_device()
        assert entry == "p3_timing_launch"
        assert args == (x.data_ptr(), 37, _common.CODE[x.dtype], 77,
                        out.data_ptr(), dev, STREAM + dev)
    assert _build.LAUNCHES["p3"] == 2 and sum(_build.LAUNCHES.values()) == 2


def test_stream_loop_marshals_one_launch(stub):
    wa, wb, d = kbench.stream_edge_case(np.random.default_rng(1), 33,
                                        "mixed", "cpu")
    out = wordstream.stream_loop(wa, wb, d, 2051, "cpu")
    assert out.shape == (1, 33) and out.dtype == torch.int32
    ((entry, args),) = stub.calls
    assert entry == "p4_stream_launch"
    assert args[:2] == (wa.data_ptr(), wb.data_ptr())
    assert args[3:6] == (33, 2051, out.data_ptr())
    assert _build.LAUNCHES["p4"] == 1


def test_roll_in_carry_marshals_one_launch(stub):
    w = _common.tensor(np.arange(8 * 33).reshape(8, 33), "int32", "cpu")
    out = wordstream.roll_in_carry(w, "cpu", rounds=65)
    ((entry, args),) = stub.calls
    assert entry == "p4_roll_in_carry_launch"
    dev = w.get_device()
    assert args == (w.data_ptr(), 33, 65, out.data_ptr(), dev,
                    STREAM + dev)
    assert _build.LAUNCHES["p4"] == 1


def test_launch_floor_marshals_one_launch(stub):
    """The empty kernel goes through the probes' launch path with P1's
    argument list, `launch` set, and counts as "noop", no probe."""
    _common.launch_floor(3)
    assert stub.calls == [("probe_noop_launch",
                           (0, 0, 0, 0, 0, 1, 0, 3, STREAM + 3))]
    assert _build.LAUNCHES["noop"] == 1
    assert sum(_build.LAUNCHES.values()) == 1
    assert _build._SIGS["probe_noop_launch"] == \
        _build._SIGS["p1_probe_launch"]


# ---- the SASS loop reader of kbench.py --probes


SASS = """\
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   ISETP.GE.AND P0, PT, R2, 0x1, PT ;
        /*0020*/               @!P0 BRA `(.L_x_1) ;
.L_x_0:
        /*0030*/                   VIADDMNMX R4, R4, 0x1, R5, !PT ;
        /*0040*/                   VIADDMNMX R4, R4, -0x1, R6, !PT ;
        /*0050*/                   IADD3 R3, R3, 0x1, RZ ;
        /*0060*/                   ISETP.NE.AND P0, PT, R3, R2, PT ;
        /*0070*/                @P0 BRA `(.L_x_0) ;
.L_x_1:
        /*0080*/                   STG.E [R8.64], R4 ;
        /*0090*/                   SHF.R.S32.HI R5, RZ, R7, R9 ;
        /*00a0*/                @P1 BRA 0x90 ;
        /*00b0*/                   EXIT ;
"""


def test_sass_loops_reads_backward_branches():
    """Two loops: one closed by a branch to a label, one by a branch to an
    address; the forward branch to .L_x_1 is none."""
    loops = kbench.sass_loops(SASS.splitlines())
    assert loops == [
        (5, {"VIADDMNMX": 2, "IADD3": 1, "ISETP": 1, "BRA": 1}),
        (2, {"SHF": 1, "BRA": 1})]
