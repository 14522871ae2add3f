"""The port's own copies of the JAX package's host modules against their
originals: params, ksort, native (with the C++ library built from the
port's copy in csrc/host/), index.sketch, index.build, io.bseq and
chain, on seeded inputs, field by field, with the native library and
with the Python fallbacks. Also: a .mai written by either package maps
to the same SAM in the other, and the port imports neither jax nor
minialign_tpu (statically, and in a CLI run)."""

import ast
import contextlib
import dataclasses
import glob
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import minialign_tpu.chain as jchain
import minialign_tpu.cli as jcli
import minialign_tpu.index.build as jbuild
import minialign_tpu.index.sketch as jsketch
import minialign_tpu.io.bseq as jbseq
import minialign_tpu.ksort as jksort
import minialign_tpu.native as jnative
import minialign_tpu.params as jparams
import minialign_tpu_torch.chain as tchain
import minialign_tpu_torch.index.build as tbuild
import minialign_tpu_torch.index.sketch as tsketch
import minialign_tpu_torch.io.bseq as tbseq
import minialign_tpu_torch.ksort as tksort
import minialign_tpu_torch.native as tnative
import minialign_tpu_torch.params as tparams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
TREF = os.path.join(DATA, "tref.fa")
FORBIDDEN = ("jax", "jaxlib", "minialign_tpu")


def same(x, y, where="value"):
    """x and y equal field by field: dataclasses (by field name, so two
    packages' classes compare), arrays (values and dtype), sequences,
    dicts and scalars."""
    if dataclasses.is_dataclass(x):
        assert dataclasses.is_dataclass(y), where
        assert type(x).__name__ == type(y).__name__, where
        for f in dataclasses.fields(x):
            same(getattr(x, f.name), getattr(y, f.name), f"{where}.{f.name}")
    elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype, f"{where}: {x.dtype} != {y.dtype}"
        assert x.shape == y.shape, f"{where}: {x.shape} != {y.shape}"
        assert np.array_equal(x, y), where
    elif isinstance(x, (list, tuple)):
        assert type(x) is type(y) and len(x) == len(y), where
        for k, (a, b) in enumerate(zip(x, y)):
            same(a, b, f"{where}[{k}]")
    elif isinstance(x, dict):
        assert x.keys() == y.keys(), where
        for k in x:
            same(x[k], y[k], f"{where}[{k!r}]")
    else:
        # a numpy scalar read back from a file equals its Python value
        x, y = (v.item() if isinstance(v, np.generic) else v for v in (x, y))
        assert x == y and type(x) is type(y), f"{where}: {x!r} != {y!r}"


@pytest.fixture(params=["native", "python"])
def host_lib(request, monkeypatch):
    """Both packages with their native libraries, or both on the Python
    fallbacks (the state MINIALIGN_NO_NATIVE selects)."""
    if request.param == "native":
        assert jnative.available() and tnative.available()
    else:
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_tried", True)
    return request.param


def _genome(seed=3, n=30000):
    return np.random.default_rng(seed).integers(0, 4, n).astype(np.int8)


def _reads(genome, seed=5, n=6):
    """Slices of the genome with ~10% edits, either strand, and one
    random read."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 4, 1500).astype(np.int8)]
    for _ in range(n):
        st = int(rng.integers(0, len(genome) - 3000))
        s = genome[st:st + int(rng.integers(800, 3000))].copy()
        r = rng.random(len(s))
        s = np.where(r < 0.05, rng.integers(0, 4, len(s)), s)
        s = np.delete(s, np.flatnonzero((r >= 0.05) & (r < 0.08)))
        if rng.random() < 0.5:
            s = (3 - s)[::-1]
        out.append(s.astype(np.int8))
    return out


# ---- params

@pytest.mark.parametrize("cls", ["ScoreParams", "IndexParams", "MapParams"])
def test_default_params_equal(cls):
    same(getattr(tparams, cls)(), getattr(jparams, cls)())


SCORES = {
    "default": {},
    "affine": dict(matrix=tuple(2 if (i & 3) == (i >> 2) else -3
                                for i in range(16)), gi=5, ge=1, xdrop=80),
    "combined": dict(matrix=tuple(2 if (i & 3) == (i >> 2) else -4
                                  for i in range(16)),
                     gi=4, ge=2, gfa=3, gfb=3, xdrop=60),
    "linear": dict(gi=0, ge=2),
}


@pytest.mark.parametrize("name", sorted(SCORES))
def test_score_params_derived_values_equal(name):
    j = jparams.ScoreParams(**SCORES[name])
    t = tparams.from_fields(j)
    assert type(t) is tparams.ScoreParams
    same(t, tparams.ScoreParams(**SCORES[name]))
    n = np.arange(0, 40, dtype=np.int64)
    for attr in ("model", "max_match", "min_match", "imx_xmx", "mcoef",
                 "xcoef", "gfa_eff", "gfb_eff"):
        same(getattr(t, attr), getattr(j, attr), attr)
    same(t.matrix44(), j.matrix44(), "matrix44")
    same(t.matrix55(), j.matrix55(), "matrix55")
    same(t.gap_a(n), j.gap_a(n), "gap_a")
    same(t.gap_b(n), j.gap_b(n), "gap_b")
    same(t.with_match_mismatch(3, 5), j.with_match_mismatch(3, 5))
    same(t.with_mod("AC-2"), j.with_mod("AC-2"))


def test_from_fields_map_and_index_params():
    jm = jparams.MapParams(score=jparams.ScoreParams(gi=3, gfa=2, gfb=2),
                           wlen=5000, min_ratio=0.5, flag=jparams.MM_COMP)
    tm = tparams.from_fields(jm)
    assert type(tm.score) is tparams.ScoreParams
    same(tm, jm)
    same(tparams.from_fields(dataclasses.asdict(jm)), tm)
    ji = jparams.IndexParams(k=13, w=7, circular=("chr1",))
    same(tparams.from_fields(ji), ji)
    with pytest.raises(ValueError):
        tparams.from_fields({"no_such_field": 1})


# ---- ksort

@pytest.mark.parametrize("n", [0, 40, 3000])
@pytest.mark.parametrize("bits", [64, 128])
def test_ks_radix_permutation_equal(bits, n, host_lib):
    rng = np.random.default_rng(n + bits)
    if bits == 64:
        keys = rng.integers(0, 1 << 12, n).astype(np.uint32)
        got, want = tksort.ks_radix64(keys), jksort.ks_radix64(keys)
    else:
        keys = (rng.integers(0, 1 << 20, n).astype(np.uint64)
                << np.uint64(30))
        got, want = tksort.ks_radix128(keys), jksort.ks_radix128(keys)
    same(got, want)


# ---- sketch

@pytest.mark.parametrize("k,w", [(15, 10), (11, 5), (19, 12)])
def test_sketch_equal(k, w, host_lib):
    codes = _genome(k * w, 20000)
    same(tsketch.sketch(codes, k, w), jsketch.sketch(codes, k, w))
    same(tsketch.sketch_query(codes, k, w), jsketch.sketch_query(codes, k, w))
    if host_lib == "native":
        same(tnative.sketch_seq(codes, k, w), jnative.sketch_seq(codes, k, w))


# ---- FASTA/FASTQ

@pytest.mark.parametrize("name", ["tref.fa", "treads.fq", "cmreads.fq"])
@pytest.mark.parametrize("keep_qual", [False, True])
def test_parse_fastx_equal(name, keep_qual, host_lib):
    path = os.path.join(DATA, name)
    kw = dict(keep_qual=keep_qual, min_len=10, keep_comment=True,
              tags=("CO",))
    same(list(tbseq.read_seqs(path, **kw)), list(jbseq.read_seqs(path, **kw)))
    if host_lib == "native":
        with open(path, "rb") as f:
            data = f.read()
        (trec, tcodes), (jrec, jcodes) = (
            tnative.parse_fastx(data, keep_qual, 10),
            jnative.parse_fastx(data, keep_qual, 10))
        same(trec, jrec, "records")
        # the codes buffer is written up to the last sequence or quality
        end = int(np.maximum(jrec[:, 4] + jrec[:, 5],
                             jrec[:, 6] + jrec[:, 7]).max())
        same(tcodes[:end], jcodes[:end], "codes")


# ---- index build

def _tref():
    seqs = list(jbseq.read_seqs(TREF))
    return [s.name for s in seqs], [s.codes for s in seqs]


@pytest.mark.parametrize("field", [f.name for f in
                                   dataclasses.fields(jbuild.MMIndex)])
def test_build_index_on_tref_equal(field, host_lib):
    names, codes = _tref()
    got = tbuild.build_index(tparams.IndexParams(), names, codes)
    want = jbuild.build_index(jparams.IndexParams(), names, codes)
    same(getattr(got, field), getattr(want, field), field)


# ---- seeding and chaining

@pytest.fixture(scope="module")
def indexes():
    g = _genome()
    return (g, tbuild.build_index(tparams.IndexParams(), ["g"], [g]),
            jbuild.build_index(jparams.IndexParams(), ["g"], [g]))


def test_collect_seed_rounds_and_chains_equal(indexes, host_lib):
    genome, tmi, jmi = indexes
    n_chains = 0
    for q in _reads(genome):
        tst, jst = tchain.collect_seeds(tmi, q), jchain.collect_seeds(jmi, q)
        same(tst, jst, "collect_seeds")
        for rnd in range(len(jmi.occ)):
            ts = tchain.seed_round(tmi, tst, rnd)
            js = jchain.seed_round(jmi, jst, rnd)
            same(tst, jst, f"seed state after round {rnd}")
            assert (ts is None) == (js is None), rnd
            if js is None:
                continue
            same(ts, js, f"seed_round {rnd}")
            for twlen in (7000, 500):
                tc = tchain.chain_seeds(ts, twlen, lens=tmi.lens,
                                        circular=tmi.circular)
                jc = jchain.chain_seeds(js, twlen, lens=jmi.lens,
                                        circular=jmi.circular)
                same(tc, jc, f"chain_seeds {rnd} {twlen}")
                n_chains += len(jc)
    assert n_chains > 0


# ---- the .mai file across the two packages

def _run(cli, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(args) == 0
    return [line for line in out.getvalue().splitlines()
            if not line.startswith("@PG")]


@pytest.fixture(scope="module")
def jax_sam_from_fasta():
    """The JAX package's SAM for tref.fa and treads2.fq."""
    return _run(jcli, ["-t1", TREF, f"{DATA}/treads2.fq"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mai_from_one_package_maps_in_the_other(writer, tmp_path, monkeypatch,
                                                jax_sam_from_fasta):
    from minialign_tpu_torch import cli as tcli
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("MINIALIGN_TORCH_DEVICE", "cpu")
    try:
        w, r = (jcli, tcli) if writer == "jax" else (tcli, jcli)
        mai = str(tmp_path / "tref.mai")
        _run(w, ["-d", mai, TREF])
        # the file holds the same arrays as the other package's own build
        names, codes = _tref()
        own = (tbuild if writer == "jax" else jbuild).build_index(
            (tparams if writer == "jax" else jparams).IndexParams(),
            names, codes)
        loaded = (tbuild if writer == "jax" else jbuild).load_blocks(
            mai + ".npz")
        assert len(loaded) == 1
        same(loaded[0], own, "loaded index")
        got = _run(r, ["-t1", mai + ".npz", f"{DATA}/treads2.fq"])
    finally:
        torch.set_num_threads(torch_threads)
    assert got == jax_sam_from_fasta


# ---- the port imports neither jax nor the JAX package

def _port_files():
    files = glob.glob(os.path.join(ROOT, "minialign_tpu_torch", "**", "*.py"),
                      recursive=True)
    build = os.path.join(ROOT, "minialign_tpu_torch", "build") + os.sep
    return sorted(os.path.relpath(f, ROOT) for f in files
                  if not f.startswith(build)) + ["chip_smoke.py"]


def _absolute_imports(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


# the test tree and its tools (tests/tools/*.py are run with tests/tools
# on sys.path, so each is a top-level module name): the port keeps its
# own copies of what it takes from them (minialign_tpu_torch/fuzz.py:
# fuzz_parity's case generator)
TEST_MODULES = ("tests",) + tuple(sorted(
    os.path.splitext(os.path.basename(f))[0]
    for f in glob.glob(os.path.join(ROOT, "tests", "tools", "*.py"))))


@pytest.mark.parametrize("path", _port_files())
def test_port_file_imports_neither_jax_nor_minialign_tpu(path):
    bad = [m for m in _absolute_imports(path)
           if m.split(".")[0] in FORBIDDEN + TEST_MODULES]
    assert not bad, f"{path} imports {bad}"


def test_cli_run_leaves_no_jax_or_minialign_tpu_module():
    """python -m minialign_tpu_torch on the CPU maps tests/data's golden
    input byte-identically, and afterwards sys.modules holds no jax and
    no minialign_tpu module."""
    code = ("import json, runpy, sys\n"
            "sys.argv = ['minialign_tpu_torch'] + sys.argv[1:]\n"
            "rc = 0\n"
            "try:\n"
            "    runpy.run_module('minialign_tpu_torch', run_name='__main__',"
            " alter_sys=True)\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "sys.stdout.flush()\n"
            "bad = sorted(m for m in sys.modules\n"
            f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print('MODULES', json.dumps(bad), file=sys.stderr)\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, MINIALIGN_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    env.pop("MINIALIGN_PLATFORM", None)
    r = subprocess.run([sys.executable, "-c", code, "-t1", TREF,
                        f"{DATA}/treads.fq"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    mods = [line for line in r.stderr.splitlines()
            if line.startswith("MODULES ")]
    assert mods and json.loads(mods[-1][8:]) == [], mods
    with open(os.path.join(DATA, "ref_out.sam")) as f:
        want = [line for line in f.read().splitlines()
                if not line.startswith("@PG")]
    assert [line for line in r.stdout.splitlines()
            if not line.startswith("@PG")] == want


# ---- cli.py and parallel/ against their originals


class _Normal(ast.NodeTransformer):
    """What the port may change in a copy, taken out of both trees:
    docstrings and imports; the port's `FillEngine(...,
    device=env_device())` becomes the JAX `FillEngine(...)`, its worker
    module's name the JAX one's, and its `_prebuild()` call goes; the
    thread that builds the merge's setup while the workers map
    (`with ThreadPoolExecutor(1) as pool:`) gives way to its body without
    the submit, and the merge no longer takes `setup.result()`."""

    def visit_With(self, node):
        self.generic_visit(node)
        if "ThreadPoolExecutor" not in ast.unparse(node.items[0]):
            return node
        return [n for n in node.body
                if "pool.submit" not in ast.unparse(n)]

    def visit_Import(self, node):
        return None

    visit_ImportFrom = visit_Import

    def visit_Expr(self, node):
        v = node.value
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            return None
        if isinstance(v, ast.Call) and getattr(v.func, "id", "") == \
                "_prebuild":
            return None
        return self.generic_visit(node)

    def visit_Call(self, node):
        self.generic_visit(node)
        if ast.unparse(node.func) == "distributed.merge_host_outputs":
            node.args = [a for a in node.args
                         if ast.unparse(a) != "setup.result()"]
        if getattr(node.func, "id", "") == "FillEngine":
            node.keywords = [k for k in node.keywords if not (
                k.arg == "device" and ast.unparse(k.value) == "env_device()")]
        return node

    def visit_Constant(self, node):
        if node.value == "minialign_tpu_torch.parallel.hostworker":
            return ast.copy_location(
                ast.Constant("minialign_tpu.parallel.hostworker"), node)
        return node


def _defs(path):
    """The top-level statements of `path`, normalized (_Normal), by name
    where they define one; the JAX hostworker's platform setup (an `if`
    on JAX_PLATFORMS) dropped."""
    with open(os.path.join(ROOT, path)) as f:
        tree = _Normal().visit(ast.parse(f.read(), path))
    out = {}
    for n in tree.body:
        if isinstance(n, ast.If) and "JAX_PLATFORMS" in ast.unparse(n.test):
            continue
        name = getattr(n, "name", None) or (
            n.targets[0].id if isinstance(n, ast.Assign) and
            isinstance(n.targets[0], ast.Name)
            else ast.unparse(n).splitlines()[0])
        out[name] = n
    return out


@pytest.mark.parametrize("name", ["distributed", "hostworker"])
def test_parallel_copy_matches_original(name):
    """parallel/distributed.py and hostworker.py differ from the JAX
    package's only in imports, docstrings, `initialize` (the gloo process
    group), the engines' device, the dropped JAX platform setup, and
    merge_setup with the `setup` merge_host_outputs takes from it."""
    want = _defs(f"minialign_tpu/parallel/{name}.py")
    got = _defs(f"minialign_tpu_torch/parallel/{name}.py")
    extra = {"merge_setup"} if name == "distributed" else set()
    assert got.keys() - want.keys() == extra
    assert want.keys() <= got.keys()
    for k in want:
        if k not in ("initialize", "merge_host_outputs"):
            assert ast.dump(got[k]) == ast.dump(want[k]), k
    if name == "distributed":
        src = ast.unparse(got["initialize"])
        assert "init_process_group('gloo', init_method='tcp://' + " \
            "coordinator, world_size=n_hosts, rank=host_id)" in src
        # the merge: the JAX body less its own _align_setup and its
        # `engine = None`, after the port's two lines that take `setup`
        g, w = got["merge_host_outputs"], want["merge_host_outputs"]
        assert [ast.unparse(n) for n in g.body[:2]] == [
            "if setup is None:\n    setup = (_align_setup(argv), None)",
            "(o, mp, blocks, queries, make_writer, _log), engine = setup"]
        assert ast.unparse(w.body[0]) == ("o, mp, blocks, queries, "
                                          "make_writer, _log = "
                                          "_align_setup(argv)")
        assert [ast.dump(n) for n in g.body[2:]] == [
            ast.dump(n) for n in w.body[1:]
            if ast.unparse(n) != "engine = None"]
        setup = ast.unparse(got["merge_setup"])
        assert "setup = _align_setup(argv)" in setup
        # (_Normal took its `device=env_device()` out)
        assert "engine = FillEngine(setup[1].score)\n" in setup


def test_cli_copy_matches_original_with_worker_and_mesh_branches():
    """cli.py's definitions equal the JAX package's, _nproc_for and
    _align_procs (the worker processes) included, apart from main; main
    holds the JAX worker branch statement for statement, and the mesh
    branch builds the sharded engine and index from the CUDA devices."""
    want = _defs("minialign_tpu/cli.py")
    got = _defs("minialign_tpu_torch/cli.py")
    assert set(got) - set(want) == {"_prebuild"}
    for k in want:
        if k != "main":
            assert ast.dump(got[k]) == ast.dump(want[k]), k

    def worker_branch(defs):
        return [ast.dump(n) for n in ast.walk(defs["main"])
                if isinstance(n, ast.If)
                and "nproc > 1" in ast.unparse(n.test)]
    assert len(worker_branch(got)) == 1
    assert worker_branch(got) == worker_branch(want)
    main = ast.unparse(got["main"])
    for part in ("shard.make_mesh(device=dev.type)", "'MINIALIGN_SHARD'",
                 "ShardedFillEngine(mp.score, mesh)",
                 "ShardedIndex(mi, mesh)", "FillEngine(mp.score, device=dev)"):
        assert part in main, part


@pytest.mark.parametrize("name", ["dp/oracle", "dp/traceback", "prewarm"])
def test_copy_matches_original(name):
    """dp/oracle.py (the naive DP oracle), dp/traceback.py (traceback_one,
    traceback_batch, calc_score and their helpers) and prewarm.py define
    what the JAX package's modules define, each definition equal to the
    original apart from imports and docstrings; prewarm's main apart from
    the timed build before the map (cli._prebuild) and the build's
    seconds on its stderr line."""
    want = _defs(f"minialign_tpu/{name}.py")
    got = _defs(f"minialign_tpu_torch/{name}.py")
    assert got.keys() == want.keys()
    for k in want:
        if not (name == "prewarm" and k == "main"):
            assert ast.dump(got[k]) == ast.dump(want[k]), k
    if name == "prewarm":
        g = ast.unparse(got["main"])
        build = ("    t0 = time.time()\n    cli._prebuild()\n"
                 "    build_s = time.time() - t0\n")
        assert g.count(build) == 1 and g.count("; build {build_s:.1f} s") == 1
        g = g.replace(build, "").replace("; build {build_s:.1f} s", "")
        assert g == ast.unparse(want["main"])
