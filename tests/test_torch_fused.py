"""D2, the store-window gathers and the fill as one launch: the port's
band.fill_store (on the CPU its plain version, gather_pair_plain then
fill_plain; on the card the fill kernel reading the stores) against the
JAX package's composition, FillEngine._gather_fn (minialign_tpu/
extend.py:499) per side, then minialign_tpu.dp.band.make_fill, as
_fused_fn (minialign_tpu/extend.py:651) composes them. Every descriptor
kind of minialign_tpu_torch.kbench.GATHER_KINDS on both sides, W 16 / 32
/ 64, traced and untraced, both score models; exact in int32. Then the
wrapper's argument checks, and the CPU engine's results against the
two-launch composition (gather_pair, then fill) that it ran before."""

import numpy as np
import pytest
import torch

from minialign_tpu.dp import band as jband
from minialign_tpu.extend import FillEngine as JaxEngine
from minialign_tpu.params import ScoreParams
from minialign_tpu_torch import extend, kbench
from minialign_tpu_torch.dp import band, cuda_fill, cuda_gather
from minialign_tpu_torch.params import from_fields

from test_torch_duo import (_requests, engine, genome, indexes,  # noqa: F401
                            one_torch_thread, reads)

NCODE = 4
L, B = 128, 3                     # row length a side, problems a case
NB = band.max_blocks_for([L], [L])
PARAMS = {
    "affine": ScoreParams(matrix=tuple(2 if (i & 3) == (i >> 2) else -3
                                       for i in range(16)),
                          gi=5, ge=1, xdrop=80),
    "combined": ScoreParams(matrix=tuple(2 if (i & 3) == (i >> 2) else -4
                                         for i in range(16)),
                            gi=4, ge=2, gfa=3, gfb=3, xdrop=60),
}
_JAX = {}


def _jax_fill(pname, W, trace):
    key = (pname, W, trace)
    if key not in _JAX:
        _JAX[key] = jband.make_fill(PARAMS[pname], W, NB, trace)
    return _JAX[key]


def _jax_gather(L):
    if "gather" not in _JAX:
        _JAX["gather"] = JaxEngine(ScoreParams(), use_pallas=False)
    return _JAX["gather"]._gather_fn(L)


def _side(kind, seed):
    """(store, side fields) of B rows of `kind` on kbench.gather_store's
    segments at L columns; elen = min(cap, L), as the engine's rows of
    such windows hold nothing past it."""
    rng = np.random.default_rng(seed)
    flat, bases, lens = kbench.gather_store(rng, L)
    rows = [kbench.gather_row(kind, rng, bases, lens, L,
                              int(rng.integers(0, 16))) for _ in range(B)]
    side = dict(zip(kbench.SIDE, (np.asarray(x, np.int64)
                                  for x in zip(*rows))))
    side["elen"] = np.minimum(side["cap"], L)
    return flat, side


def _case(kind):
    seed = kbench.GATHER_KINDS.index(kind)
    return _side(kind, 100 + seed), _side(kind, 200 + seed)


def _jax_d2(pname, W, trace, sides):
    """The JAX composition: _gather_fn at L a side, the rows padded with
    NCODE past L (the fill reads NCODE past a row; make_fill wants
    TAIL_N + W columns of pad), then make_fill."""
    rows = []
    for flat, s in sides:
        g = np.asarray(_jax_gather(L)(flat, *(s[k].astype(np.int32)
                                              for k in kbench.SIDE)))
        rows += [np.pad(g, ((0, 0), (0, 256)), constant_values=NCODE),
                 s["elen"].astype(np.int32)]
    return _jax_fill(pname, W, trace)(*rows)


def _port_d2(pname, W, trace, sides, La=L, Lb=L):
    (fa, sa), (fb, sb) = sides
    desc = torch.from_numpy(cuda_gather.pack_desc([sa, sb]))
    return band.fill_store(from_fields(PARAMS[pname]), W, NB, trace,
                           torch.from_numpy(fa), torch.from_numpy(fb), desc,
                           B, La, Lb)


def _assert_same(want, got, trace):
    (rw, bw), (rg, bg) = (want, got) if trace else ((want, None),
                                                    (got, None))
    for f in ("max_score", "max_i", "max_j", "n_steps", "n_blocks"):
        np.testing.assert_array_equal(np.asarray(getattr(rw, f)),
                                      getattr(rg, f).numpy(), err_msg=f)
    if trace:
        for f in ("masks", "dirs", "iheads", "rprevs"):
            w = np.asarray(getattr(bw, f))
            np.testing.assert_array_equal(
                w, getattr(bg, f).numpy().view(w.dtype), err_msg=f)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("W", [16, 32, 64])
@pytest.mark.parametrize("pname", ["affine", "combined"])
@pytest.mark.parametrize("kind", kbench.GATHER_KINDS)
def test_fill_store_matches_jax_d2(kind, pname, W, trace):
    sides = _case(kind)
    _assert_same(_jax_d2(pname, W, trace, sides),
                 _port_d2(pname, W, trace, sides), trace)


def test_fill_store_cuts_at_the_row_length():
    """cap past L: the fill sees only the gather's L columns. Cut at a
    shorter row it equals the fill on gather_pair_plain's rows at that
    length, not the fill of the uncut rows."""
    sides = (_side("cap_gt_L", 5),) * 2       # b == a: a full diagonal
    (fa, sa), (fb, sb) = sides
    assert (sa["cap"] > L).all() and (sb["cap"] > L).all()
    desc = torch.from_numpy(cuda_gather.pack_desc([sa, sb]))
    p = from_fields(PARAMS["affine"])
    got = _port_d2("affine", 64, False, sides, La=L // 2)
    a, b = cuda_gather.gather_pair_plain(torch.from_numpy(fa),
                                         torch.from_numpy(fb), desc, B,
                                         L // 2, L)
    e = cuda_gather.desc_fields(desc)["elen"]
    want = band.fill_plain(p, 64, NB, False, a, e[:B], b, e[B:])
    uncut = _port_d2("affine", 64, False, sides)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not torch.equal(got.max_score, uncut.max_score)


def _args(B=2):
    """Valid CPU arguments of fill_store_cuda (all but the device)."""
    st = torch.zeros(64, dtype=torch.int8)
    desc = torch.zeros(cuda_gather.WORDS * 2 * B, dtype=torch.int32)
    return dict(store_a=st, store_b=st.clone(), desc=desc, B=B, La=128,
                Lb=128)


@pytest.mark.parametrize("fault,match", [
    (dict(store_a=torch.zeros(64, dtype=torch.int32)), "store_a"),
    (dict(store_b=torch.zeros((2, 32), dtype=torch.int8)), "store_b"),
    (dict(store_a=torch.zeros(128, dtype=torch.int8)[::2]), "store_a"),
    (dict(desc=torch.zeros(cuda_gather.WORDS * 3, dtype=torch.int32)),
     "2B = 4 rows"),
    (dict(desc=torch.zeros(cuda_gather.WORDS * 4, dtype=torch.int64)),
     "desc"),
    (dict(desc=torch.zeros(cuda_gather.WORDS * 4 + 1,
                           dtype=torch.int32)[1:]), "8-byte"),
    (dict(La=-1), "La=-1"),
    (dict(), "one CUDA device"),
])
def test_fill_store_cuda_argument_checks(fault, match):
    """The CUDA wrapper refuses what the kernel does not take, before it
    loads the library; CPU tensors it refuses last (a CPU block goes to
    the plain version through band.fill_store, never to this wrapper)."""
    kw = _args() | fault
    with pytest.raises(ValueError, match=match):
        cuda_fill.fill_store_cuda(from_fields(PARAMS["affine"]), 64, 4,
                                  False, **kw)


def test_fill_store_dispatch():
    """A CPU block runs the plain D2; another device is refused, and so
    is the duo epilogue on a traced fill."""
    p = from_fields(PARAMS["affine"])
    kw = _args()
    with pytest.raises(ValueError, match="no fill for device meta"):
        band.fill_store(p, 64, 4, False, *(kw[k].to("meta") for k in (
            "store_a", "store_b", "desc")), 2, 128, 128)
    with pytest.raises(ValueError, match="band width 48"):
        cuda_fill.fill_store_cuda(p, 48, 4, False, **kw)
    with pytest.raises(ValueError, match="duo"):
        band.fill_store(p, 64, 4, True, *(kw[k] for k in (
            "store_a", "store_b", "desc")), 2, 128, 128,
            duo=(torch.zeros(0), torch.zeros(0)))


def _two_launch(p, W, nb, trace, store_a, store_b, desc, B, La, Lb,
                duo=None, general=True):
    """The engine's fill before D2 was one launch: gather_pair's rows,
    then fill on them with the block's elen (general: the kernel's
    choice of loads, which the rows do not need)."""
    a, b = cuda_gather.gather_pair(store_a, store_b, desc, B, La, Lb)
    e = cuda_gather.desc_fields(desc)["elen"]
    return band.fill(p, W, nb, trace, a, e[:B], b, e[B:], duo)


@pytest.mark.parametrize("kind", ["duo", "down", "up"])
def test_engine_matches_two_launch_composition(kind, engine, reads, genome,
                                               monkeypatch):
    """The CPU engine's results on seeded reads (duo batches W 64/32/16,
    empty windows among them; and the same windows as downs or ups) equal
    those of its two-launch composition."""
    reqs = _requests(genome, reads)
    if kind != "duo":
        reqs = [(kind,) + r[1:4] for r in reqs]
    got = engine.run(reqs)
    monkeypatch.setattr(extend, "fill_store", _two_launch)
    want = engine.run(reqs)
    assert got == want
    assert sum(r[0] > 0 for r in got) >= 3
