"""Inputs made from the seed: a random genome at the configuration's
length, and a pool of simulated long reads drawn from it.

Every seed gets the same multiset of (source length, accuracy) pairs:
the lengths and the accuracies are the quantiles of the configuration's
normal distributions (clipped as the configuration says), paired by one
fixed permutation. The seed picks the genome, the order of the reads,
their origins and strands, and their errors. So two seeds differ in
where the work lies, not in how much of it there is.

The error model is PBSIM's split as the configuration gives it: per
source base, a substitution (a base drawn at random), a deletion, or an
insertion of a random base after it. Each read is drawn from a random
stream of its own (seed, read index), so one read can be made again
without the others.
"""

from __future__ import annotations

import dataclasses
from statistics import NormalDist

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
COMP = np.array([3, 2, 1, 0], np.int8)
_SEED_MOD = 1 << 64


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed % _SEED_MOD, *key]))


def genome(seed: int, length: int) -> np.ndarray:
    """(length,) int8 codes 0..3 (A, C, G, T), uniform."""
    return _rng(seed, 0).integers(0, 4, length, dtype=np.int8)


def fasta_bytes(name: str, codes: np.ndarray, width: int = 80) -> bytes:
    seq = BASES[codes]
    full = len(seq) // width
    body = np.empty((full, width + 1), np.uint8)
    body[:, :width] = seq[:full * width].reshape(full, width)
    body[:, width] = ord("\n")
    tail = seq[full * width:].tobytes()
    return (b">" + name.encode() + b"\n" + body.tobytes()
            + (tail + b"\n" if tail else b""))


def _quantiles(mean: float, sd: float, n: int, lo: float,
               hi: float) -> np.ndarray:
    nd = NormalDist(mean, sd)
    q = np.asarray([nd.inv_cdf((k + 0.5) / n) for k in range(n)])
    return np.clip(q, lo, hi)


def profile(reads: dict, pool_bases: int, glen: int):
    """The pool's (source lengths, accuracies), in profile order: the
    same for every seed. `reads` is the configuration's read profile."""
    lo = reads["len_min"]
    hi = glen - 1

    def lens_for(n):
        return np.rint(_quantiles(reads["len_mean"], reads["len_sd"], n, lo,
                                  hi)).astype(np.int64)
    n = max(1, round(pool_bases / reads["len_mean"]))
    for _ in range(4):
        n = max(1, round(pool_bases / float(lens_for(n).mean())))
    lens = lens_for(n)
    accs = _quantiles(reads["acc_mean"], reads["acc_sd"], n,
                      reads["acc_min"], reads["acc_max"])
    return lens, accs[np.random.default_rng(0).permutation(n)]


def mutate(rng: np.random.Generator, src: np.ndarray, err: float,
           split: tuple) -> np.ndarray:
    """Substitutions, deletions and insertions-after at shares `split`
    (sub, ins, del) of the error rate `err`, per source base."""
    n = len(src)
    ps = err * split[0]
    pd = ps + err * split[2]
    r = rng.random(n)
    sub = r < ps
    dele = (r >= ps) & (r < pd)
    ins = (r >= pd) & (r < err)
    base = np.where(sub, rng.integers(0, 4, n, dtype=np.int8), src)
    counts = np.ones(n, np.int64)
    counts[dele] = 0
    counts[ins] = 2
    start = np.cumsum(counts) - counts
    out = np.empty(int(counts.sum()), np.int8)
    keep = ~dele
    out[start[keep]] = base[keep]
    ipos = start[ins] + 1
    out[ipos] = rng.integers(0, 4, len(ipos), dtype=np.int8)
    return out


@dataclasses.dataclass
class Pool:
    """The read pool of one seed: read i is `codes(i)`, named `r<i>`,
    drawn from genome[start[i]:start[i] + length[i]] on strand rev[i]."""
    seed: int
    genome: np.ndarray
    length: np.ndarray
    acc: np.ndarray
    start: np.ndarray
    rev: np.ndarray
    split: tuple

    @classmethod
    def make(cls, seed: int, genome_codes: np.ndarray, reads: dict,
             pool_bases: int) -> "Pool":
        glen = len(genome_codes)
        lens, accs = profile(reads, pool_bases, glen)
        rng = _rng(seed, 1)
        order = rng.permutation(len(lens))
        lens, accs = lens[order], accs[order]
        start = (rng.random(len(lens)) * (glen - lens)).astype(np.int64)
        rev = np.zeros(len(lens), bool)             # half on each strand
        rev[rng.permutation(len(lens))[:len(lens) // 2]] = True
        split = tuple(reads["error_split"])
        return cls(seed, genome_codes, lens, accs, start, rev, split)

    def __len__(self) -> int:
        return len(self.length)

    def codes(self, i: int) -> np.ndarray:
        s = int(self.start[i])
        r = mutate(_rng(self.seed, 2, i),
                   self.genome[s:s + int(self.length[i])],
                   1.0 - float(self.acc[i]), self.split)
        return COMP[r[::-1]] if self.rev[i] else r

    def write_fastq(self, path: str, chunk: int = 256) -> int:
        """Writes the pool as FASTQ; returns the bases written."""
        total = 0
        with open(path, "wb") as f:
            for c0 in range(0, len(self), chunk):
                parts = []
                for i in range(c0, min(c0 + chunk, len(self))):
                    seq = BASES[self.codes(i)].tobytes()
                    total += len(seq)
                    parts += [b"@r%d\n" % i, seq, b"\n+\n",
                              b"I" * len(seq), b"\n"]
                f.write(b"".join(parts))
        return total
