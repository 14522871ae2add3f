"""Command-line interface, option-compatible with the reference
(minialign.c:5703-6211): single-char options through a dispatch table,
recursive preset trees (-x pacbio / ont... / ava), config-file
fallback, and the index/align main split.

Usage mirrors the reference:
    minialign-tpu [options] ref.fa reads.fq > out.sam     (map)
    minialign-tpu [options] -d index.mai ref.fa           (build index)
    minialign-tpu [options] index.mai reads.fq > out.sam  (map w/ index)

Carried from the JAX package's minialign_tpu/cli.py for the port, with
its imports changed, the JAX compile-cache setup and the "Build: tpu"
tag left out of `main`, and the device mesh taken from the CUDA devices
(parallel/shard.py) instead of jax.devices(). As there, -tN with N > 1
runs N worker processes (parallel/hostworker.py; _nproc_for has the
count policy) whose outputs merge rank-ordered, byte-identical to one
process; the parent builds the kernels and the host library before it
starts them, without importing torch, and readies the merge while they
map. The device comes from $MINIALIGN_TORCH_DEVICE (default
cuda; see device.py).
"""

from __future__ import annotations

import dataclasses
import sys
import time

from . import __version__
from .index.build import build_index, load_blocks, save_blocks
from .io import bseq
from .params import (FMT_BLAST6, FMT_MAF, FMT_PAF, FMT_SAM, MM_AVA, MM_COMP,
                     MM_OMIT_REP, IndexParams, MapParams, ScoreParams, TAG_AS,
                     TAG_CG, TAG_CO, TAG_ID, TAG_IH, TAG_MD, TAG_NH, TAG_NM,
                     TAG_RG, TAG_SA, TAG_SQ, TAG_XS)

# The engine, the pipeline and the writers bring torch in: they are
# imported where they are used, so that a -tN parent starts its workers
# without waiting for torch (_align_procs).

# preset tree (minialign.c:5848-5891)
_PRESETS = {
    "pacbio": ("-k15 -w10 -a2 -b4 -p4 -q2 -r3,3 -Y50 -s50 -m0.3", {
        "clr": ("", {}),
        "ccs": ("-b5 -p6 -p2", {}),
    }),
    "ont": ("-k15 -w10 -a3 -b5 -p6 -q2 -r3,3 -Y50 -s50 -m0.3", {
        "r7": ("-b4", {"1d": ("", {}), "2d": ("", {})}),
        "r9": ("", {
            "4": ("-a2", {
                "1": ("", {"1d": ("", {}), "1dsq": ("-b6 -r4,4", {}),
                           "2d": ("-b6 -r4,4", {})}),
                "1d": ("", {}), "1dsq": ("-b6 -r4,4", {}),
                "2d": ("-b6 -r4,4", {}),
            }),
            "5": ("-a2", {
                "1": ("", {"1d": ("", {}), "1dsq": ("-b6 -r4,4", {}),
                           "2d": ("-b6 -r4,4", {})}),
                "1d": ("", {}), "1dsq": ("-b6 -r4,4", {}),
                "2d": ("-b6 -r4,4", {}),
            }),
            "1d": ("", {}), "1dsq": ("-b6 -r4,4", {}),
            "2d": ("-b6 -r4,4", {}),
        }),
        "1d": ("-a2", {}), "1dsq": ("-a2 -b6 -r4,4", {}),
        "2d": ("-a2 -b6 -r4,4", {}),
    }),
    "ava": ("-k15 -w5 -a2 -b3 -p0 -q2 -Y50 -s30 -m0.05", {}),
}

_TAG_IDS = {"RG": TAG_RG, "CO": TAG_CO, "NH": TAG_NH, "IH": TAG_IH,
            "AS": TAG_AS, "XS": TAG_XS, "NM": TAG_NM, "SA": TAG_SA,
            "MD": TAG_MD, "CG": TAG_CG, "ID": TAG_ID, "SQ": TAG_SQ}

_FORMATS = {"sam": FMT_SAM, "maf": FMT_MAF, "blast6": FMT_BLAST6,
            "paf": FMT_PAF}


@dataclasses.dataclass
class Opts:
    nth: int = 1
    # read-batch size in bases (-1). The reference uses 512 KiB
    # (minialign.c:6152); a TPU batch pipeline wants far more reads in
    # flight per round, and the value has no output-visible effect
    batch_size: int = 8 * 1024 * 1024
    min_len: int = 1
    keep_qual: bool = False
    verbose: int = 1
    fnw: str | None = None
    fmt: int = FMT_SAM
    tags: list = dataclasses.field(default_factory=list)
    tag_names: list = dataclasses.field(default_factory=list)
    rg_line: str | None = None
    rg_id: str = ""
    flag: int = 0
    # indexing
    k: int = 15
    w: int = 32            # >=32 means "derive from k"
    b: int = 14
    frq: tuple = (0.05, 0.01, 0.001)
    circ: list = dataclasses.field(default_factory=list)
    circ_all: bool = False
    # mapping
    wlen: int = 7000
    glen: int = 7000
    min_score: int = 50
    min_ratio: float = 0.3
    matrix: list = dataclasses.field(
        default_factory=lambda: [1, -1, -1, -1, -1, 1, -1, -1,
                                 -1, -1, 1, -1, -1, -1, -1, 1])
    gi: int = 1
    ge: int = 1
    gfa: int = 0
    gfb: int = 0
    xdrop: int = 50
    args: list = dataclasses.field(default_factory=list)
    arg_line: str = ""
    help: int = 0
    ecnt: int = 0

    def err(self, msg, fn="opt"):
        print(f"[E::{fn}] {msg}", file=sys.stderr)
        self.ecnt += 1


def _atoi(o: "Opts", v: str | None, _fn: str = "mm_opt_atoi") -> int:
    """mm_opt_atoi (minialign.c:5740-5749): digits only (no sign, no
    suffix); anything else reports `unparsable number' and yields 0."""
    if v is None:
        return 0
    if not v.isdigit():
        o.err(f"unparsable number `{v}'.", _fn)
        return 0
    return int(v)


def _atof(o: "Opts", v: str | None) -> float:
    """mm_opt_atof (minialign.c:5750-5764)."""
    if v is None:
        return 0.0
    if not all(c in "0123456789-.,eE" for c in v):
        o.err(f"unparsable number `{v}'.", "mm_opt_atof")
        return 0.0
    # C atof() parses the longest valid prefix and yields 0 when none
    # (e.g. "0.5e" -> 0.5)
    import re
    m = re.match(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", v)
    return float(m.group(0)) if m else 0.0


def _apply_preset(o: Opts, arg: str):
    tree = _PRESETS
    node = None
    for part in arg.replace(":", ".").split("."):
        if part in tree:
            node = tree[part]
            parse_line(o, node[0])
            tree = node[1]
        else:
            try:
                with open(part) as f:
                    parse_line(o, f.read().replace("\n", " ")
                               .replace("\t", " "))
            except OSError:
                # the reference reports both failures: the fopen in
                # mm_opt_load_conf (minialign.c:5820) and the outer
                # oassert in mm_opt_preset (minialign.c:5885)
                o.err(f"failed to find configuration file `{part}'.",
                      "mm_opt_load_conf")
                o.err(f"no preset params found for `{part}'.",
                      "mm_opt_preset")
            return


def _set_match(o: Opts, v: str):
    m = _atoi(o, v)
    if not (0 < m < 7):
        o.err("match award (-a) must be inside [1,7].", "mm_opt_match")
    for i in range(16):
        if (i & 3) == (i >> 2):
            o.matrix[i] = m


def _set_mismatch(o: Opts, v: str):
    x = _atoi(o, v)
    if not (0 < x < 7):
        o.err("mismatch penalty (-b) must be inside [1,7].",
              "mm_opt_mismatch")
    for i in range(16):
        if (i & 3) != (i >> 2):
            o.matrix[i] = -x


def _set_mod(o: Opts, v: str):
    idxaf = {"A": 1, "C": 2, "G": 3, "T": 4, "U": 4, "N": 5}
    for part in _split(v):
        ok = True
        for ch in part[:2]:
            if ch not in idxaf:
                o.err(f"unknown base `{ch}' in modifier `{part}'.",
                      "mm_opt_mod")
                ok = False
        if ok:
            o.matrix[(idxaf[part[1]] - 1) * 4
                     + (idxaf[part[0]] - 1)] += int(part[2:])


def _set_gf(o: Opts, v: str):
    parts = _split(v)
    o.gfa = _atoi(o, parts[0])
    o.gfb = _atoi(o, parts[1] if len(parts) > 1 else parts[0])
    for g in (o.gfa, o.gfb):
        if not (0 <= g < 32):
            o.err("short-gap extension penalty (-r) must be inside "
                  "[0,32].", "mm_opt_gf")


def _set_frq(o: Opts, v: str):
    fs = []
    for x in _split(v):
        f = _atof(o, x)
        if len(fs) >= 7:
            o.err("#thresholds must not exceed 7.", "mm_opt_frq")
            break
        if not (0.0 <= f < 1.0):
            o.err(f"invalid threshold `{f:.6f}' parsed from `{x}'.",
                  "mm_opt_frq")
        if fs and not fs[-1] > f:
            o.err("frequency thresholds must be descending.",
                  "mm_opt_frq")
        fs.append(f)
    o.frq = tuple(fs)


def _set_tags(o: Opts, v: str):
    """mm_opt_tags (minialign.c:5928-5948): any 2-char name is kept in
    the preserve list (input tag passthrough); known names also set
    output-tag flags."""
    for t in _split(v):
        if len(t) != 2:
            o.err(f"unknown tag: `{t}'.", "mm_opt_tags")
            continue
        o.tag_names.append(t)
        if t in _TAG_IDS:
            o.tags.append(_TAG_IDS[t])


def _set_rg(o: Opts, v: str):
    """mm_opt_rg (minialign.c:5898-5922). Note two reference quirks
    kept: backslash + ANY char unescapes to a tab, and rg_id keeps the
    `ID:` prefix (records print `RG:Z:ID:xxx`)."""
    out, i = [], 0
    while i < len(v):
        if v[i] == "\\" and i + 1 < len(v):
            out.append("\t")
            i += 2
        else:
            out.append(v[i])
            i += 1
    line = "".join(out)
    for field in line.replace("\r", "\t").replace("\n", "\t").split("\t"):
        if field.startswith("ID:"):
            o.rg_line = line
            o.rg_id = field
            o.tags.append(TAG_RG)
            return
    o.err("RG line must start with @RG and contains ID, "
          "like `@RG\\tID:1'.", "mm_opt_rg")


def _set_circ(o: Opts, v: str | None):
    if v is None:
        o.circ_all = True
        return
    for p in _split(v):
        if p in ("*", "-"):
            o.circ_all = True
        else:
            o.circ.append(p)


def _set_format(o: Opts, v: str):
    if v not in _FORMATS:
        o.err(f"unknown output format `{v}'.", "mm_opt_format")
    else:
        o.fmt = _FORMATS[v]


def _split(v: str):
    out = [v]
    for sep in ",;:/":
        out = [p for x in out for p in x.split(sep)]
    return [x for x in out if x]


def _set_threads(o: Opts, v: str):
    o.nth = _atoi(o, v)
    if not o.nth < 128:
        o.err("#threads must be less than 128.", "mm_opt_threads")


def _set_kmer(o: Opts, v: str):
    o.k = _atoi(o, v)
    if not (1 < o.k < 32):
        o.err("k must be inside [1,32).", "mm_opt_kmer")


def _set_window(o: Opts, v: str):
    o.w = _atoi(o, v)
    if not (1 < o.w < 32):
        o.err("w must be inside [1,32).", "mm_opt_window")


def _set_bin(o: Opts, v: str):
    o.b = _atoi(o, v)
    if not (1 < o.b < 32):
        o.err("b must be inside [1,32).", "mm_opt_bin")


def _set_min_len(o: Opts, v: str):
    o.min_len = _atoi(o, v)
    if not o.min_len > 0:
        o.err("minimum sequence length must be > 0.", "mm_opt_min_len")


def _set_wlen(o: Opts, v: str):
    o.wlen = _atoi(o, v)
    # the reference's range check `wlen > 100 || wlen < 100000` is a
    # tautology (minialign.c:6025) — no value can fail it


def _set_glen(o: Opts, v: str):
    o.glen = _atoi(o, v)
    # tautological range check in the reference (minialign.c:6029)


def _set_gi(o: Opts, v: str):
    o.gi = _atoi(o, v)
    if not o.gi < 32:
        o.err("gap open penalty (-p) must be inside [0,32].",
              "mm_opt_gi")


def _set_ge(o: Opts, v: str):
    o.ge = _atoi(o, v)
    if not (0 < o.ge < 32):
        o.err("gap extension penalty (-q) must be inside [1,32].",
              "mm_opt_ge")


def _set_xdrop(o: Opts, v: str):
    o.xdrop = _atoi(o, v)
    if not (10 < o.xdrop < 128):
        o.err("X-drop cutoff must be inside [10,128].", "mm_opt_xdrop")


def _set_min_score(o: Opts, v: str):
    o.min_score = _atoi(o, v)
    if not o.min_score > 0:
        o.err("minimum alignment score must be > 0.",
              "mm_opt_min_score")


def _set_min_ratio(o: Opts, v: str):
    o.min_ratio = _atof(o, v)
    if not (0.0 < o.min_ratio < 1.0):
        o.err("minimum alignment score ratio must be inside "
              "[0.0,1.0].", "mm_opt_min_ratio")


def _set_batch(o: Opts, v: str):
    o.batch_size = _atoi(o, v)
    if not o.batch_size > 64 * 1024:
        o.err("batch size must be > 64k.", "mm_opt_batch")


def _set_outbuf(o: Opts, v: str):
    if not _atoi(o, v) > 64 * 1024:
        o.err("output buffer size must be > 64k.", "mm_opt_outbuf")


# option character -> (needs_arg: 0 bool / 1 required / 2 optional, setter)
_OPTS = {
    "x": (1, _apply_preset),
    "R": (1, _set_rg),
    "T": (1, _set_tags),
    "O": (1, _set_format),
    "d": (1, lambda o, v: setattr(o, "fnw", v)),
    "X": (0, lambda o, v: setattr(o, "flag", o.flag | MM_AVA)),
    "A": (0, lambda o, v: setattr(o, "flag", o.flag | MM_COMP)),
    "P": (0, lambda o, v: setattr(o, "flag", o.flag | MM_OMIT_REP)),
    "Q": (0, lambda o, v: setattr(o, "keep_qual", True)),
    # bare -v marks "version requested" (0); -vN sets the level;
    # a non-numeric arg yields strlen+1 (mm_opt_verbose quirk)
    "v": (2, lambda o, v: setattr(
        o, "verbose", (int(v) if v.isdigit() else len(v) + 1)
        if v else 0)),
    "h": (0, lambda o, v: setattr(o, "help", o.help + 1)),
    "t": (1, _set_threads),
    "k": (1, _set_kmer),
    "w": (1, _set_window),
    "c": (2, _set_circ),
    "f": (1, _set_frq),
    "B": (1, _set_bin),
    "C": (2, lambda o, v: None),
    "L": (1, _set_min_len),
    "W": (1, _set_wlen),
    "G": (1, _set_glen),
    "a": (1, _set_match),
    "b": (1, _set_mismatch),
    "e": (1, _set_mod),
    "p": (1, _set_gi),
    "q": (1, _set_ge),
    "r": (1, _set_gf),
    "Y": (1, _set_xdrop),
    "s": (1, _set_min_score),
    "m": (1, _set_min_ratio),
    "1": (1, _set_batch),
    "2": (1, _set_outbuf),
}


def parse_argv(o: Opts, argv: list):
    """mm_opt_parse_argv (minialign.c:5771-5790): boolean options are
    eaten per char; the first non-boolean char takes the rest of the
    token as its argument, or the NEXT positional-looking token — for
    required AND optional types alike (so `-c name` consumes `name`)."""
    def _isarg(s):
        return not s.startswith("-") or len(s) == 1

    i = 0
    while i < len(argv):
        arg = argv[i]
        if _isarg(arg):
            o.args.append(arg)
            i += 1
            continue
        j = 1
        while j < len(arg) and arg[j] in _OPTS and _OPTS[arg[j]][0] == 0:
            _OPTS[arg[j]][1](o, None)
            j += 1
        if j < len(arg):
            ch = arg[j]
            if ch not in _OPTS:
                o.err(f"unknown option `-{ch}'.",
                      "mm_opt_parse_argv")
            else:
                kind, fn = _OPTS[ch]
                val = arg[j + 1:] or None
                if val is None and i + 1 < len(argv) \
                        and _isarg(argv[i + 1]):
                    i += 1
                    val = argv[i]
                if kind == 1 and val is None:
                    o.err(f"missing argument for option `-{ch}'.",
                          "mm_opt_parse_argv")
                else:
                    fn(o, val)
        i += 1
    return o


def parse_line(o: Opts, line: str):
    parse_argv(o, line.split())


def finalize(o: Opts):
    """mm_opt_check_sanity (minialign.c:6098-6114)."""
    x = min(o.matrix)                 # most negative entry (= -b)
    if not (o.gfa == 0 or o.gfa > o.ge):
        o.err("short-gap extension penalty (-r) must be larger than "
              f"gap extension penalty ({o.ge}).", "mm_opt_check_sanity")
    if not (o.gfb == 0 or o.gfb > o.ge):
        o.err("short-gap extension penalty (-r) must be larger than "
              f"gap extension penalty ({o.ge}).", "mm_opt_check_sanity")
    if ((o.gfa == 0) ^ (o.gfb == 0)) != 0:
        o.err("short-gap extension penalty (-r) must be set for both "
              "sides.", "mm_opt_check_sanity")
    if not (o.gfa == 0 or o.gfb == 0 or o.gfa + o.gfb > -x):
        o.err("short-gap extension penalty (-r) must not be greater "
              "than mismatch penalty.", "mm_opt_check_sanity")
    if o.args and o.args[0].endswith(".mai") and (o.circ or o.circ_all):
        print("[W::mm_opt_check_sanity] index will be loaded from "
              f"file `{o.args[0]}'. circular option is ignored.",
              file=sys.stderr)
    if o.w >= 32:
        o.w = int(2.0 / 3.0 * o.k + 0.499)
    return o


def make_params(o: Opts):
    sp = ScoreParams(matrix=tuple(o.matrix), gi=o.gi, ge=o.ge,
                     gfa=o.gfa, gfb=o.gfb, xdrop=o.xdrop)
    ip = IndexParams(k=o.k, w=o.w, b=o.b, frq=o.frq,
                     circular=tuple(o.circ), circular_all=o.circ_all)
    mp = MapParams(score=sp, wlen=o.wlen, glen=o.glen,
                   min_score=o.min_score, min_ratio=o.min_ratio,
                   flag=o.flag)
    return ip, mp


class Log:
    """Leveled stderr logger in the reference's format
    (mm_log_printer, minialign.c:2617-2654): 'E'/'W' always shown,
    numeric levels gated by -v; timestamped messages carry
    `[L::func::<realtime>*<cpu_ratio>]` headers."""

    def __init__(self, verbose: int):
        self.verbose = verbose
        self.t0 = time.time()
        self.c0 = time.process_time()

    def __call__(self, level, func: str, msg: str, ts: bool = True):
        if isinstance(level, int) and level > self.verbose:
            return
        lc = level if isinstance(level, str) else "M"
        if ts:
            rt = time.time() - self.t0
            cr = (time.process_time() - self.c0) / rt if rt > 0 else 0.0
            hdr = f"[{lc}::{func}::{rt:.3f}*{cr:.2f}]"
        else:
            hdr = f"[{lc}::{func}]"
        print(f"{hdr} {msg}", file=sys.stderr)


def _is_mai(path: str) -> bool:
    return path.endswith(".mai") or path.endswith(".mai.npz") \
        or path.endswith(".npz")


def _iter_index_blocks(o: Opts, refs: list, ip: IndexParams):
    """Yield index blocks in the reference's main_align order
    (minialign.c:6414-6436): a prebuilt .mai yields its stored blocks;
    otherwise each reference file builds one block on the fly."""
    if refs and _is_mai(refs[0]):
        path = refs[0] if refs[0].endswith(".npz") else refs[0] + ".npz"
        yield from load_blocks(path)
        return
    for path in refs:
        seqs = list(bseq.read_seqs(path, min_len=o.min_len))
        yield build_index(ip, [s.name for s in seqs],
                          [s.codes for s in seqs])


_HELP_SHORT = """
  minialign-tpu - TPU-native long-read alignment engine

Usage:
  first trial:
    $ minialign-tpu -t4 -xont.r9.1d ref.fa ont_r9.4_1d.fq > mapping.sam

  mapping on a prebuilt index:
    $ minialign-tpu [indexing options] -d index.mai ref.fa
    $ minialign-tpu index.mai reads.fq > mapping.sam

Options:
  General:
    -x STR/FILE  load preset params [ont] / load config file
                   {pacbio.{clr,ccs},ont.{r7,r9}.{1d,1dsq,2d},ava}
    -t INT       number of threads [1]
    -d FILE      index construction mode, dump index to FILE
    -v [INT]     show version number / set verbose level
  Indexing:
    -k INT       k-mer size [15]
    -w INT       minimizer window size [{-k}*2/3]
    -c STR,...   circular reference name, `*' to mark all as circular []
  Mapping:
    -a INT       match award [1]
    -b INT       mismatch penalty [-1]
    -e STR,...   score matrix modifier, `GA+3' adds 3 to (r,q)=(G,A) pair
    -p INT       gap open penalty offset for large indels [1]
    -q INT       per-base penalty for large indels [1]
    -r INT[,INT] per-base penalty for small ins[,del] (0 to disable) [0,0]
    -s INT       minimum score [50]
    -m INT       minimum score ratio to max [0.30]
  Output:
    -O STR       output format {sam,maf,blast6,paf} [sam]
    -Q           include quality string

  Pass -hh to show all the options.
"""

_HELP_EXTRA = """
  Indexing (additional):
    -B INT       1st stage hash table size base [14]
    -C INT[,INT] set base rid and qid, `*' to infer from seq. name [0, 0]
    -L INT       min seq length; 0 to disable [1]
  Mapping (additional):
    -f FLOAT,... occurrence thresholds [0.05,0.01,0.001]
    -Y INT       X-drop threshold [50]
    -X           all-versus-all mode (map every input against every input)
  Output (additional):
    -P           omit secondary (repetitive) alignments
    -R STR       read group header line, such as `@RG\\tID:1' []
    -T STR,...   optional tags: {RG,CO,AS,XS,NM,NH,IH,SA,MD} []
                   RG is also inferred from `-R'
                   supp. records are omitted when SA is enabled
                   tags in the input BAM file will also transferred
                   fasta/q comments are saved in CO tag
"""


def _iter_batches(o: Opts, log, queries: list):
    """Yield read batches across all query files, logging per-file
    completion (the source stage of the reference's pt_stream,
    minialign.c:4565-4583)."""
    for path in queries:
        for batch in bseq.read_batches(path, batch_size=o.batch_size,
                                       keep_qual=o.keep_qual,
                                       min_len=o.min_len,
                                       tags=tuple(o.tag_names)):
            yield batch
        log(9, "main_align", f"finished mapping `{path}'.")


def _map_block(o: Opts, log, wr, engine, mp, mi, queries: list,
               n_reads: int) -> int:
    """Map all query batches against one index block.

    With -t1 this is the plain sequential loop. With -t >= 2 it
    reproduces pt_stream's source->worker->drain overlap
    (minialign.c:1013-1048) with host threads: a source thread parses
    batch N+1 and a drain thread prints batch N-1 while the main
    thread drives batch N's device fills. The worker stage stays
    single-stream because the reference's -t1 schedule chains tbuf
    state across batches (PARITY.md item 8) — so output bytes are
    identical at any -t, matching the repo-wide -t1-schedule parity
    contract."""
    from .pipeline import align_batch

    tb = {"rlen": 0}

    if o.nth <= 1:
        for batch in _iter_batches(o, log, queries):
            regs = align_batch(mp, mi, [s.codes for s in batch],
                               engine, base_qid=n_reads, tbuf=tb)
            for s, reg in zip(batch, regs):
                wr.mapped(mi.names, mi.lens, mi.codes, s, reg)
            n_reads += len(batch)
        return n_reads

    import queue as _queue
    import threading

    src_q = _queue.Queue(maxsize=2)
    out_q = _queue.Queue(maxsize=2)
    errs = []

    def source():
        try:
            for batch in _iter_batches(o, log, queries):
                src_q.put(batch)
        except BaseException as e:          # noqa: BLE001
            errs.append(e)
        finally:
            src_q.put(None)

    def drain():
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                batch, regs = item
                for s, reg in zip(batch, regs):
                    wr.mapped(mi.names, mi.lens, mi.codes, s, reg)
        except BaseException as e:          # noqa: BLE001
            errs.append(e)
            # keep consuming so the worker never blocks on a dead drain
            while out_q.get() is not None:
                pass

    ts = threading.Thread(target=source, daemon=True)
    td = threading.Thread(target=drain, daemon=True)
    ts.start()
    td.start()
    batch = None  # the finally drain must not NameError pre-first-get
    try:
        while True:
            batch = src_q.get()
            if batch is None or errs:
                break
            regs = align_batch(mp, mi, [s.codes for s in batch],
                               engine, base_qid=n_reads, tbuf=tb)
            out_q.put((batch, regs))
            n_reads += len(batch)
    finally:
        out_q.put(None)
        td.join()
        # unblock a source still waiting on a full queue
        while batch is not None:
            batch = src_q.get()
        ts.join()
    if errs:
        raise errs[0]
    return n_reads


def _nproc_for(nth: int) -> int:
    """Worker-process count for the mapping phase. `-tN` IS the worker
    count (the reference's contract: -t sizes the pt pool driving
    mm_align_worker, minialign.c:4729, 6166-6203), clamped to the
    visible cores — N processes on a smaller host only contend, and
    each carries a full engine. MINIALIGN_PROC_WORKERS overrides both
    ways (0/1 forces single-process, >1 forces a width, e.g. to
    oversubscribe or to exercise the merge on a small host)."""
    import os
    env = os.environ.get("MINIALIGN_PROC_WORKERS")
    if env is not None:
        return max(1, int(env))
    return max(1, min(nth, os.cpu_count() or 1))


def _prebuild() -> None:
    """Build the host library and, for a CUDA run, the kernels before the
    worker processes start, so that they do not all build them at once.
    Compile only: the parent opens no CUDA context."""
    from . import _build, native
    from .device import env_device_type
    native.available()
    if env_device_type() == "cuda":
        _build.build()


def _align_procs(o: Opts, log, argv: list, nproc: int) -> int:
    """Run the mapping with N local worker processes (round-robin
    batch shares) and merge rank-ordered, byte-identical to the
    single-process stream. See parallel/hostworker.py."""
    import os
    import subprocess
    import sys as _sys
    import tempfile

    _prebuild()
    with tempfile.TemporaryDirectory() as td:
        outs = [os.path.join(td, f"w{h}.out") for h in range(nproc)]
        procs = [subprocess.Popen(
            [_sys.executable, "-m",
             "minialign_tpu_torch.parallel.hostworker",
             str(h), str(nproc), outs[h]] + list(argv),
            stdout=subprocess.DEVNULL) for h in range(nproc)]
        # the merge's own start-up (argv, index, device context) runs
        # while the workers map, not after them
        from concurrent.futures import ThreadPoolExecutor

        from .parallel import distributed
        with ThreadPoolExecutor(1) as pool:
            setup = pool.submit(distributed.merge_setup, list(argv))
            rcs = [p.wait() for p in procs]
            if any(rcs):
                log("E", "main_align",
                    f"worker process failed (rcs={rcs}).")
                return 1
            n_remap = distributed.merge_host_outputs(
                list(argv), outs, sys.stdout, setup.result())
        log(2, "main_align",
            f"{nproc} worker processes merged ({n_remap} batch(es) "
            "remapped under the true rlen chain).")
    return 0


def main(argv=None) -> int:
    from . import native as _native
    _native.tune_malloc()
    argv = list(sys.argv[1:] if argv is None else argv)
    o = Opts(arg_line="minialign-tpu " + " ".join(argv))
    parse_argv(o, argv)
    finalize(o)
    if o.ecnt:
        return 1
    log = Log(o.verbose)
    log(1, "main", f"Version: {__version__}", ts=False)
    if o.help or not o.args:
        # bare `minialign -v` prints only the version line and exits 0
        # (minialign.c:6469-6473); -h / no input also print the help
        if o.help or o.verbose == 1:
            print(_HELP_SHORT + (_HELP_EXTRA if o.help > 1 else ""),
                  file=sys.stderr)
        # rc parity: -h/-hh and missing-input exit 1, bare -v exits 0
        # (minialign.c:6469-6473; verified against the binary)
        return 0 if (not o.help and o.verbose != 1) else 1

    t0 = time.time()
    ip, mp = make_params(o)
    try:
        mp.score.check()
    except ValueError:
        log("E", "main_align",
            "failed to instanciate alignment context.")
        return 1

    if o.fnw is not None:
        # index-build mode (main_index, minialign.c:6308-6336): one
        # block per positional file, appended into one index file
        blocks = []
        for path in o.args:
            seqs = list(bseq.read_seqs(path, min_len=o.min_len))
            blocks.append(build_index(
                ip, [s.name for s in seqs], [s.codes for s in seqs]))
        out = o.fnw if o.fnw.endswith(".npz") else o.fnw + ".npz"
        save_blocks(out, blocks)
        log(1, "main_index", f"index saved: {out} "
            f"({len(blocks)} block(s))")
        log(1, "main", "Command: " + o.arg_line, ts=False)
        log(1, "main", f"Real time: {time.time() - t0:.3f} sec; "
            f"CPU: {time.process_time():.3f} sec", ts=False)
        return 0

    # align mode (main_align, minialign.c:6365-6446): rt = tail of
    # reference-side args, qh = head of query-side args; all-vs-all
    # without a prebuilt index maps every file against every file
    rt, qh = 1, 1
    if (o.flag & MM_AVA) and not _is_mai(o.args[0]):
        rt, qh = len(o.args), 0
    queries = o.args[qh:]
    if not queries:
        log(1, "main_align", "query-side input redirected to stdin.")
        queries = ["-"]

    # intra-host process workers: `-tN` runs the mapping with N local
    # worker processes through the multi-host round-robin + rank-
    # ordered-merge machinery, byte-identical output (see _nproc_for
    # for the count policy). Structural exclusions stay single-process:
    # stdin (a pipe can be consumed once, but every worker must
    # re-read the query input by path — the reference shares one
    # stream under one reader thread, which a process split cannot
    # do) and AVA (reference-side files double as queries, so the
    # per-pair index build would replicate per worker); both still
    # get the in-process `-t` I/O-overlap pipeline.
    nproc = _nproc_for(o.nth)
    if nproc > 1 and not (o.flag & MM_AVA) and "-" not in queries \
            and o.fnw is None:
        rc = _align_procs(o, log, argv, nproc)
        log(1, "main", "Command: " + o.arg_line, ts=False)
        log(1, "main", f"Real time: {time.time() - t0:.3f} sec; "
            f"CPU: {time.process_time():.3f} sec", ts=False)
        return rc

    from .device import env_device
    from .extend import FillEngine
    from .io.sam import Blast6Writer, MafWriter, PafWriter, SamWriter
    omit = bool(o.flag & MM_OMIT_REP)
    if o.fmt == FMT_SAM:
        wr = SamWriter(sys.stdout, tags=tuple(o.tags), rg_line=o.rg_line,
                       rg_id=o.rg_id, arg_line=o.arg_line,
                       version=__version__, omit_rep=omit)
    elif o.fmt == FMT_MAF:
        wr = MafWriter(sys.stdout, tags=tuple(o.tags), omit_rep=omit)
    elif o.fmt == FMT_BLAST6:
        wr = Blast6Writer(sys.stdout, tags=tuple(o.tags), omit_rep=omit)
    else:
        wr = PafWriter(sys.stdout, tags=tuple(o.tags))

    # multi-device auto-path: with more than one CUDA device visible the
    # extension batches run data-parallel over a device mesh and the
    # minimizer table is hash-range-sharded with cross-shard merge
    # (SURVEY.md section 2.6; the reference's analogue is -t engaging
    # pt everywhere, minialign.c:4729). MINIALIGN_SHARD=0 forces the
    # single-device engine; output bytes are identical either way
    # (tests/test_torch_shard.py). On the CPU the mesh has one entry, so
    # the CPU stays single-device
    import os
    dev = env_device()
    mesh = None
    if os.environ.get("MINIALIGN_SHARD", "") != "0":
        from .parallel import shard
        devs = shard.make_mesh(device=dev.type)
        if len(devs) > 1:
            mesh = devs
            log(1, "main_align",
                f"mapping over a {len(mesh)}-device mesh.")
    if mesh is not None:
        from .parallel.shard import ShardedFillEngine
        engine = ShardedFillEngine(mp.score, mesh)
    else:
        engine = FillEngine(mp.score, device=dev)
    n_reads = 0
    for mi in _iter_index_blocks(o, o.args[:rt], ip):
        log(9, "main_align", f"loaded/built index for {mi.n_seq} "
            "target sequence(s).")
        if mesh is not None:
            from .parallel.shard import ShardedIndex
            mi = ShardedIndex(mi, mesh)
        # header per index block (mm_print_header inside the block
        # loop, minialign.c:6425)
        wr.header(mi.names, mi.lens)
        n_reads = _map_block(o, log, wr, engine, mp, mi, queries,
                             n_reads)
    log(1, "main_align", f"mapped {n_reads} reads.")
    log(1, "main", "Command: " + o.arg_line, ts=False)
    log(1, "main", f"Real time: {time.time() - t0:.3f} sec; "
        f"CPU: {time.process_time():.3f} sec", ts=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
