"""Copy of minialign_tpu/params.py for the port, unchanged apart from this
header and `from_fields` at the end, which carries the JAX package's
params objects across by field name.

Scoring and mapping parameters.

Mirrors the semantics of the reference option structs:
  - gaba_params_s (gaba.h:81-97): 4x4 score matrix, gi/ge affine gap,
    gfa/gfb combined-gap linear penalties, xdrop.
  - mm_opt_t defaults (minialign.c:6141-6163): k=15, w=2k/3, b=14,
    frq={0.05,0.01,0.001}, wlen=glen=7000, min_score=50, min_ratio=0.3,
    matrix +-1, gi=ge=1, gfa=gfb=0, xdrop=50.
  - model selection (gaba_wrap.h:208-222): gi==0 -> linear,
    gfa!=0 and gfb!=0 -> combined, else affine.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# alphabet (minialign.c:216-223)
A, C, G, T, N = 0, 1, 2, 3, 4

LINEAR, AFFINE, COMBINED = 0, 1, 2

# "1"-indexed base codes for the -e matrix modifier (minialign.c idxaf)
_IDXAF = {"A": 1, "C": 2, "G": 3, "T": 4, "U": 4, "N": 5}


@dataclasses.dataclass(frozen=True)
class ScoreParams:
    """DP scoring parameters (gaba_params_s equivalent)."""

    # score_matrix[b*4 + a] = score of aligning ref base a against query
    # base b (matches reference layout: mm_opt_mod writes
    # (idxaf[p[1]]-1)*4 + (idxaf[p[0]]-1), minialign.c:6046).
    matrix: Tuple[int, ...] = (1, -1, -1, -1,
                               -1, 1, -1, -1,
                               -1, -1, 1, -1,
                               -1, -1, -1, 1)
    gi: int = 1          # gap open (affine); 0 selects the linear model
    ge: int = 1          # gap extend, > 0
    gfa: int = 0         # combined-gap linear penalty, gaps on seq a
    gfb: int = 0         # combined-gap linear penalty, gaps on seq b
    xdrop: int = 50

    # --- derived properties -------------------------------------------------

    @property
    def model(self) -> int:
        """gaba_wrap.h:208-222 model row selection."""
        if self.gi == 0:
            return LINEAR
        if self.gfa != 0 and self.gfb != 0:
            return COMBINED
        return AFFINE

    @property
    def max_match(self) -> int:
        return max(self.matrix)

    @property
    def min_match(self) -> int:
        return min(self.matrix)

    @property
    def imx_xmx(self) -> tuple:
        """Identity-estimate constants (gaba.c:3794-3828): m = mean of
        the 4 diagonal matrix entries, x = mean of the 12 off-diagonal;
        imx = 1/(m-x), xmx = x/(m-x), precomputed as doubles so the
        identity op order `(dsc/dlen)*imx - xmx` matches bit-for-bit."""
        diag = sum(self.matrix[i] for i in range(16) if (i & 3) == (i >> 2))
        off = sum(self.matrix[i] for i in range(16) if (i & 3) != (i >> 2))
        m, x = diag / 4.0, off / 12.0
        return 1.0 / (m - x), x / (m - x)

    @property
    def mcoef(self) -> float:
        """Match coefficient used for chain-length score estimates and mapq.

        The reference computes both mcoef and xcoef from score_matrix[0]
        (mm_align_init, minialign.c:4675-4680 — the loop sums matrix[0]
        for every entry), so both equal matrix[0]. Reproduced for output
        parity.
        """
        return float(self.matrix[0])

    @property
    def xcoef(self) -> float:
        return float(self.matrix[0])

    def matrix44(self) -> np.ndarray:
        """4x4 substitution matrix, [query_base, ref_base] layout."""
        return np.asarray(self.matrix, dtype=np.int32).reshape(4, 4)

    def matrix55(self) -> np.ndarray:
        """5x5 matrix extended with the N sentinel.

        A cell involving N scores -2*(gi+ge): the reference's shuffle
        table lookup yields 0 for the 0x80 tail sentinel, which after
        the score-vector bias (-2*(ge+gi), gaba.c:3660) equals
        -2*(gi+ge). gaba_init_check_score enforces min_match >=
        -2*(gi+ge) so this is a lower bound on substitution scores.
        """
        m = np.full((5, 5), -2 * (self.gi + self.ge), dtype=np.int32)
        m[:4, :4] = self.matrix44()
        return m

    def gap_a(self, length) -> np.ndarray:
        """Best score of a gap of `length` bases on sequence a
        (gaba.c:834: max(affine, -gfa*l) for the combined model)."""
        length = np.asarray(length)
        aff = -(self.gi * (length > 0).astype(np.int64)) - self.ge * length
        if self.model == COMBINED:
            return np.maximum(aff, -self.gfa * length)
        return aff

    def gap_b(self, length) -> np.ndarray:
        length = np.asarray(length)
        aff = -(self.gi * (length > 0).astype(np.int64)) - self.ge * length
        if self.model == COMBINED:
            return np.maximum(aff, -self.gfb * length)
        return aff

    # effective gf penalties for the naive oracle: when gfa/gfb are 0 the
    # oracle substitutes gi+2*ge (gaba.c:4657-4658) which can never win.
    @property
    def gfa_eff(self) -> int:
        return self.gfa if self.gfa != 0 else self.gi + 2 * self.ge

    @property
    def gfb_eff(self) -> int:
        return self.gfb if self.gfb != 0 else self.gi + 2 * self.ge

    def check(self) -> None:
        """gaba_init_check_score equivalents (gaba.c:3613-3638)."""
        if self.max_match <= 0 or self.max_match > 6:
            raise ValueError("max match score must be in [1, 6]")
        if self.min_match >= 0 or self.min_match < -7:
            raise ValueError("min match score must be in [-7, -1]")
        if self.min_match < -2 * (self.gi + self.ge):
            raise ValueError("min match must be >= -2*(gi+ge)")
        if self.ge <= 0 or self.gi < 0:
            raise ValueError("ge must be > 0 and gi >= 0")
        if (self.gfa == 0) != (self.gfb == 0):
            raise ValueError("gfa and gfb must be set together")
        if self.gfa != 0 and (self.gfa <= self.ge or self.gfb <= self.ge):
            raise ValueError("gf must be > ge")
        if self.gfa != 0 and self.min_match <= -(self.gfa + self.gfb):
            raise ValueError("gf sum must be < -min_match")

    def with_match_mismatch(self, m: int | None = None,
                            x: int | None = None) -> "ScoreParams":
        """Apply -a / -b style uniform updates (minialign.c:6029-6043)."""
        mat = list(self.matrix)
        for i in range(16):
            if (i & 0x03) == (i >> 2):
                if m is not None:
                    mat[i] = m
            else:
                if x is not None:
                    mat[i] = -x
        return dataclasses.replace(self, matrix=tuple(mat))

    def with_mod(self, mod: str) -> "ScoreParams":
        """Apply a -e score-matrix modifier like "AG3" (minialign.c:6044)."""
        mat = list(self.matrix)
        ra, qb, delta = mod[0], mod[1], int(mod[2:])
        mat[(_IDXAF[qb] - 1) * 4 + (_IDXAF[ra] - 1)] += delta
        return dataclasses.replace(self, matrix=tuple(mat))


@dataclasses.dataclass(frozen=True)
class IndexParams:
    """mm_idx_params_t equivalent (minialign.c:2454-2460 + defaults)."""

    k: int = 15
    w: int = 10               # default 2k/3 rounded (minialign.c:6136)
    b: int = 14               # first-stage bucket bits, clipped to 2k
    frq: Tuple[float, ...] = (0.05, 0.01, 0.001)
    circular: Tuple[str, ...] = ()   # circular reference names
    circular_all: bool = False

    @property
    def b_eff(self) -> int:
        return min(2 * self.k, self.b)  # minialign.c:2953


@dataclasses.dataclass(frozen=True)
class MapParams:
    """mm_align_params_t equivalent (minialign.c:2514-2523)."""

    score: ScoreParams = dataclasses.field(default_factory=ScoreParams)
    wlen: int = 7000          # chainable window edge length
    glen: int = 7000          # linkable gap length
    min_score: int = 50
    min_ratio: float = 0.3
    flag: int = 0             # MM_AVA/MM_OMIT_REP/MM_COMP bits
    base_rid: int = 0
    base_qid: int = 0


MM_AVA = 0x01
MM_OMIT_REP = 0x08
MM_COMP = 0x10

# output format ids (minialign.c:2545-2552)
FMT_SAM, FMT_MAF, FMT_BLAST6, FMT_PAF = 0, 1, 2, 5

# sam tag ids (minialign.c:2527-2539)
TAG_RG, TAG_CO, TAG_NH, TAG_IH, TAG_AS, TAG_XS, TAG_NM, TAG_SA, TAG_MD, \
    TAG_CG, TAG_ID, TAG_SQ = range(12)

MAPQ_DEC = 4
MAPQ_COEF = 1 << MAPQ_DEC


def from_fields(obj):
    """The port's ScoreParams, IndexParams or MapParams carrying the
    fields of `obj`, by name: a dataclass of the same class name from
    another package (the JAX package's params, which this module never
    imports) or a dict of field values, whose keys pick the class. A
    nested `score` is converted as well."""
    if isinstance(obj, dict):
        fields = dict(obj)
        keys = set(fields)
        match = [c for c in (ScoreParams, IndexParams, MapParams)
                 if keys <= {f.name for f in dataclasses.fields(c)}]
        if len(match) != 1:
            raise ValueError(f"from_fields: keys {sorted(keys)} do not name "
                             "exactly one params class")
        cls = match[0]
    else:
        cls = {c.__name__: c for c in (ScoreParams, IndexParams, MapParams)
               }.get(type(obj).__name__)
        if cls is None or not dataclasses.is_dataclass(obj):
            raise TypeError(f"from_fields: no params class for {obj!r}")
        fields = {f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(cls)}
    if "score" in fields and not isinstance(fields["score"], ScoreParams):
        fields["score"] = from_fields(fields["score"])
    return cls(**fields)
