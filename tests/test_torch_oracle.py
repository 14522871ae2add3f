"""The port's naive DP oracle (minialign_tpu_torch/dp/oracle.py) and its
traceback_batch and calc_score (dp/traceback.py) against the JAX
package's (minialign_tpu/dp/oracle.py, dp/traceback.py:271-328) on
seeded pairs under both score models, field for field. The port's own
fill and traceback are held to the port's oracle in
tests/test_torch_oracle_port.py, with test_band.py's score models and
band-bounded mutations, which are checked here to be the same."""

import zlib

import numpy as np
import pytest

from minialign_tpu.dp import band as jband
from minialign_tpu.dp import oracle as joracle
from minialign_tpu.dp import traceback as jtraceback
from minialign_tpu_torch.dp import oracle as toracle
from minialign_tpu_torch.dp import traceback as ttraceback
from minialign_tpu_torch.params import from_fields
from test_band import PARAMS, mutate
from test_oracle import CASES, enc
from test_torch_oracle_port import PORT_PARAMS
from test_torch_oracle_port import mutate as port_mutate

MODELS = {"affine": PARAMS["affine"], "combined": PARAMS["combined"]}


def same_fields(got, want, where):
    assert type(got).__name__ == type(want).__name__, where
    assert vars(got) == vars(want), where


@pytest.mark.parametrize("case", range(len(CASES)))
def test_oracle_literals_match_jax(case):
    p, a, b, score, path = CASES[case]
    got = toracle.oracle_extend(from_fields(p), enc(a), enc(b))
    same_fields(got, joracle.oracle_extend(p, enc(a), enc(b)), case)
    assert (got.score, got.path) == (score, path)
    assert toracle.path_to_cigar(got.path) == joracle.path_to_cigar(path)


def _pairs(rng, n, lo, hi, W=32):
    a = [rng.integers(0, 5 if k % 4 == 3 else 4, int(rng.integers(lo, hi)))
         for k in range(n)]
    return a, [mutate(rng, x, W) if len(x) else x for x in a]


@pytest.mark.parametrize("pname", sorted(MODELS))
def test_oracle_random_pairs_match_jax(pname):
    """Pairs with N (code 4) in every fourth, empty and unrelated ones."""
    p = MODELS[pname]
    rng = np.random.default_rng(zlib.crc32(pname.encode()))
    a, b = _pairs(rng, 24, 0, 160)
    a += [rng.integers(0, 4, 50), np.zeros(0, np.int64)]
    b += [rng.integers(0, 4, 40), rng.integers(0, 4, 7)]
    for k, (x, y) in enumerate(zip(a, b)):
        got = toracle.oracle_extend(from_fields(p), x, y)
        same_fields(got, joracle.oracle_extend(p, x, y), k)
        assert toracle.path_to_cigar(got.path) == \
            joracle.path_to_cigar(got.path)


def _jax_fill(p, W, nb, a, b):
    ab, alen = jband.pad_codes(a)
    bb, blen = jband.pad_codes(b)
    res, bufs = jband.make_fill(p, W, max_blocks=nb, trace=True)(
        ab, alen, bb, blen)
    return (type(res)(*(np.asarray(x) for x in res)),
            type(bufs)(*(np.asarray(x) for x in bufs)))


@pytest.mark.parametrize("W", (16, 32, 64))
@pytest.mark.parametrize("pname", sorted(MODELS))
def test_traceback_batch_and_calc_score_match_jax(pname, W):
    """Both traceback_batch on the JAX fill's buffers, TraceResult field
    for field; calc_score on each path, dict for dict, equal to the
    traced score and gap counts."""
    p = MODELS[pname]
    rng = np.random.default_rng(zlib.crc32(f"tb/{pname}/{W}".encode()))
    a, b = _pairs(rng, 10, 30, 240, W)
    res, bufs = _jax_fill(p, W, 24, a, b)
    tp = from_fields(p)
    want = jtraceback.traceback_batch(p, W, bufs, res)
    got = ttraceback.traceback_batch(tp, W, bufs, res)
    assert len(got) == len(want) == len(a)
    checked = 0
    for k, (g, x) in enumerate(zip(got, want)):
        assert (g is None) == (x is None), k
        if g is None:
            continue
        same_fields(g, x, k)
        cs = ttraceback.calc_score(tp, g.path, a[k], b[k])
        assert cs == jtraceback.calc_score(p, x.path, a[k], b[k]), k
        if g.plen:
            assert (cs["score"], cs["agcnt"], cs["bgcnt"]) == \
                (g.score, g.agcnt, g.bgcnt), k
            checked += 1
    assert checked >= 4


def test_port_cross_check_uses_test_band_models_and_mutations():
    assert PORT_PARAMS.keys() == PARAMS.keys()
    for name, p in PARAMS.items():
        assert vars(PORT_PARAMS[name]) == vars(from_fields(p)), name
    for W in (16, 32, 64):
        a = np.random.default_rng(W).integers(0, 4, 300)
        np.testing.assert_array_equal(
            port_mutate(np.random.default_rng(1), a, W),
            mutate(np.random.default_rng(1), a, W))
