"""The generators: the same seed gives the same inputs; every seed gets
the same multiset of read sizes; the published means and deviations
hold within sampling error."""

import json
import os

import numpy as np

from benchmark import gen

HERE = os.path.dirname(os.path.dirname(__file__))


def _cfg(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def test_same_seed_same_inputs(tmp_path):
    big = 2**31 + 12345
    a = gen.genome(big, 50_000)
    b = gen.genome(big, 50_000)
    assert a.dtype == np.int8 and np.array_equal(a, b)
    assert not np.array_equal(a, gen.genome(big + 1, 50_000))
    cfg = _cfg("ecoli-pacbio")
    p1 = gen.Pool.make(big, a, cfg["reads"], 200_000)
    p2 = gen.Pool.make(big, b, cfg["reads"], 200_000)
    f1, f2 = tmp_path / "a.fq", tmp_path / "b.fq"
    assert p1.write_fastq(str(f1)) == p2.write_fastq(str(f2))
    assert f1.read_bytes() == f2.read_bytes()
    assert np.array_equal(p1.codes(3), p2.codes(3))


def test_every_seed_same_sizes():
    cfg = _cfg("dm6-10k")
    g = gen.genome(1, 400_000)
    p1 = gen.Pool.make(1, g, cfg["reads"], 2_000_000)
    p2 = gen.Pool.make(2, g, cfg["reads"], 2_000_000)
    k1 = sorted(zip(p1.length.tolist(), p1.acc.tolist()))
    k2 = sorted(zip(p2.length.tolist(), p2.acc.tolist()))
    assert k1 == k2
    assert not np.array_equal(p1.start, p2.start)


def test_profile_matches_published():
    cfg = _cfg("ecoli-pacbio")
    lens, accs = gen.profile(cfg["reads"], 24_000_000, 4_641_652)
    assert abs(lens.mean() - 20000) < 20 and abs(lens.std() - 2000) < 60
    # accuracy clipped to [0.70, 0.999]: the clipped normal's moments
    x = np.clip(np.random.default_rng(0).normal(0.88, 0.07, 10**6), 0.70,
                0.999)
    assert abs(accs.mean() - x.mean()) < 0.003
    assert abs(accs.std() - x.std()) < 0.003
    assert accs.min() >= 0.70 and accs.max() <= 0.999
    assert abs(lens.sum() - 24_000_000) < 25_000


def test_error_model_rates():
    rng = np.random.default_rng(5)
    src = rng.integers(0, 4, 400_000, dtype=np.int8)
    err = 0.12
    out = gen.mutate(np.random.default_rng(9), src, err, (0.4, 0.3, 0.3))
    r = np.random.default_rng(9).random(len(src))
    n_del = int(((r >= 0.048) & (r < 0.084)).sum())
    n_ins = int(((r >= 0.084) & (r < 0.12)).sum())
    assert len(out) == len(src) - n_del + n_ins
    sd = np.sqrt(len(src) * 0.036)
    assert abs(n_del - len(src) * 0.036) < 4 * sd
    assert abs(n_ins - len(src) * 0.036) < 4 * sd
    # reverse strand reads are the reverse complement of the forward draw
    g = gen.genome(3, 100_000)
    p = gen.Pool.make(3, g, _cfg("ecoli-pacbio")["reads"], 100_000)
    i = int(np.flatnonzero(p.rev)[0])
    p.rev[i] = False
    fw = p.codes(i)
    p.rev[i] = True
    assert np.array_equal(p.codes(i), gen.COMP[fw[::-1]])
