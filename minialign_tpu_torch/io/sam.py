"""SAM / PAF output formatters.

Format semantics from the reference printer (minialign.c:4734-5701):
  * SAM: 11 mandatory fields; no optional tags unless requested via -T;
    quality '*' unless kept; soft clips on primary records, hard clips
    on secondary/supplementary; flag 0x10 from the strand, 0x800 for
    supplementary (non-first unique), 0x100 for secondary.
  * CIGAR (and MD / MAF-row) tokenization follows gaba's REVERSE path
    parser (_parser_loop_rv, gaba_parse.h:168-190) over the up-space
    bit path — the parse every reference printer applies
    (gaba_dump_cigar_reverse at minialign.c:5173/5224/5613, the MD
    walker at :5292, gaba_dump_seq_reverse for MAF). See
    parse_path_rv; the forward parser cigar_ops is kept for
    forward-space paths (tests, debugging).
  * mapq is stored x16 and printed >> 4 (MAPQ_DEC, minialign.c:4175).
  * MD re-walks the path against both sequences (minialign.c:5240).

Carried from the JAX package's minialign_tpu/io/sam.py unchanged; only
the imports differ (the JAX module reaches jax through its extend/band
imports), and SamWriter and PafWriter time each read's records, their
writes to the sink included, as one `io.format` span (stats.py).
"""

from __future__ import annotations

import numpy as np

from .. import stats
from ..extend import Aln
from ..params import (TAG_AS, TAG_IH, TAG_MD, TAG_NH, TAG_NM, TAG_RG, TAG_SA,
                      TAG_XS)
from .bseq import DEC_F, decode


_OPC = "MID"


def parse_path_rv(upath: str, off: int, plen: int) -> list:
    """gaba's reverse path parser (_parser_loop_rv, gaba_parse.h:168-190)
    over the up-space bit path — the parse every reference printer uses
    (gaba_dump_cigar_reverse for SAM/SA cigars at minialign.c:5173/5224,
    the MD walker at :5292, gaba_dump_seq_reverse for MAF rows).

    Scans the bits of upath[off:off+plen] from the top (up-space end =
    display-order start) and emits [(count, 'M'|'I'|'D')] in display
    order. Replicates the reference's 64-bit window mechanics exactly:
    a ref-gap (D) run leaves its last op behind per window (so runs
    longer than 63 split, and a D-run directly followed by an I
    re-associates one op pair into M), insertion runs split at 64, and
    bits below `off` (earlier path segments, or the zero padding below
    the path head, which reads as 'R') participate in the window
    counts."""
    from .. import native
    if native.available():
        r = native.parse_rv(upath, off, plen)
        if r is not None:
            return r
    pops = upath[off:off + plen][::-1]
    ctx = upath[:off][::-1]            # scan continues here past pops
    n = plen
    nctx = len(ctx)

    def at(k):                          # scan char at position k
        if k < n:
            return pops[k]
        k -= n
        return ctx[k] if k < nctx else "R"

    def run(i, ch):                     # ch-run length from i, cap 64
        m = 0
        while m < 64 and at(i + m) == ch:
            m += 1
        return m

    def altrun(i):                      # R,D,R,D... pattern run from i
        m = 0
        while at(i + m) == ("R" if (m & 1) == 0 else "D"):
            m += 1
        return m

    out = []
    i = 0
    while i < n:
        start = i
        m = run(i, "R")
        c = min(n - i, m - (1 if m > 0 else 0))
        if c:
            out.append((c, "D"))
            i += c
        m = run(i, "D")
        c = min(n - i, m)
        if c:
            out.append((c, "I"))
            i += c
        c = min(n - i, altrun(i)) & ~1
        if c:
            out.append((c >> 1, "M"))
            i += c
        if i == start:
            # progress guard: a trailing lone R over a non-R context
            # char cannot advance under the window rules. Real paths
            # never hit this (segments split after R moves, and the
            # padding below the path head reads as R), but guard
            # against a stall on malformed input.
            out.append((1, "D" if pops[i] == "R" else "I"))
            i += 1
    return out


def seg_cigar(a, s) -> str:
    """CIGAR string for one path segment — native fused parse+format
    when available (the per-token tuple construction and f-strings
    dominated the printer at 500-read scale)."""
    up = getattr(a, "upath", "")
    if up:
        from .. import native
        if native.available():
            off = len(up) - (s.po + len(s.path))
            cg = native.rv_cigar(up, off, len(s.path))
            if cg is not None:
                return cg
    return cigar_from(seg_tokens(a, s))


def seg_tokens(a, s) -> list:
    """Display-order cigar tokens for one path segment of an alignment,
    via the reference's reverse parse of the up-space path."""
    up = getattr(a, "upath", "")
    if up:
        off = len(up) - (s.po + len(s.path))
        return parse_path_rv(up, off, len(s.path))
    return cigar_ops(s.path)            # fallback: forward-space parse


def cigar_from(tokens) -> str:
    return "".join(f"{c}{op}" for c, op in tokens)


def cigar_ops(path: str) -> list:
    """Forward path ('D'=query base, 'R'=ref base) -> [(count, op)]
    per the gaba parser conventions (see module docstring)."""
    from .. import native
    if native.available():
        rle = native.cigar_rle(path)
        return [(int(w) >> 4, _OPC[w & 15]) for w in rle]
    out = []
    i, n = 0, len(path)
    while i < n:
        # query-gap (I) run: leave one 'D' as a potential diag start
        m = 0
        while i + m < n and path[i + m] == "D":
            m += 1
        c = m - 1 if m else 0
        if c:
            out.append((c, "I"))
            i += c
        # ref-gap (D) run
        m = 0
        while i + m < n and path[i + m] == "R":
            m += 1
        if m:
            out.append((m, "D"))
            i += m
        # diagonal run
        m = 0
        while i + 1 < n and path[i] == "D" and path[i + 1] == "R":
            m += 1
            i += 2
        if m:
            out.append((m, "M"))
        elif i < n and path[i] == "D":
            out.append((1, "I"))     # trailing lone insertion (defensive)
            i += 1
    return out


def cigar_string(path: str) -> str:
    return "".join(f"{c}{op}" for c, op in cigar_ops(path))


def md_tag(tokens: list, rcodes: np.ndarray, qcodes: np.ndarray) -> str:
    """MD:Z value from display-order cigar tokens: match-run lengths,
    mismatch ref bases, ^-prefixed deletions (minialign.c:5240-5298 —
    which walks the same _parser_loop_rv tokens). rcodes/qcodes are the
    aligned slices (ref forward, query in alignment orientation)."""
    out = []
    run = 0
    ri = qi = 0
    dec = DEC_F.tobytes().decode()
    rc = np.asarray(rcodes)
    qc = np.asarray(qcodes)
    for c, op in tokens:
        if op == "M":
            r = rc[ri:ri + c]
            last = 0
            for k in np.flatnonzero(r != qc[qi:qi + c]):
                out.append(str(run + int(k) - last))
                out.append(dec[min(int(r[k]), 4)])
                run = 0
                last = int(k) + 1
            run += c - last
            ri += c
            qi += c
        elif op == "D":
            out.append(str(run))
            run = 0
            out.append("^" + "".join(dec[min(int(x), 4)]
                                     for x in rc[ri:ri + c]))
            ri += c
        else:
            qi += c
    out.append(str(run))
    return "".join(out)


def _nm(a: Aln) -> int:
    xcnt = int(a.dcnt * (1.0 - a.identity))
    return xcnt + a.agcnt + a.bgcnt


class SamWriter:
    def __init__(self, out, tags: tuple = (), rg_line: str | None = None,
                 rg_id: str = "", arg_line: str = "", version: str = "0.1.0",
                 omit_rep: bool = False):
        self.out = out
        self.tags = set(tags)
        self.rg_line = rg_line
        self.rg_id = rg_id
        self.arg_line = arg_line
        self.version = version
        self.omit_rep = omit_rep

    def header(self, names, lens):
        w = self.out.write
        w("@HD\tVN:1.0\tSO:unsorted\n")
        for n, l in zip(names, lens):
            w(f"@SQ\tSN:{n}\tLN:{int(l)}\n")
        if self.rg_line:
            w(self.rg_line + "\n")
        w(f"@PG\tID:minialign\tPN:minialign\tVN:{self.version}"
          f"\tCL:{self.arg_line}\n")

    def unmapped(self, seq):
        sp = stats.begin("io.format") if stats.ON else None
        self._unmapped(seq)
        if sp is not None:
            stats.end(sp)

    def _unmapped(self, seq):
        qual = seq.qual.decode() if seq.qual else "*"
        self.out.write(
            f"{seq.name}\t4\t*\t0\t0\t*\t*\t0\t0\t"
            f"{decode(seq.codes).decode()}\t{qual}")
        self._saved_tags(seq)
        self.out.write("\n")

    def _saved_tags(self, seq):
        """mm_restore_sam_tags (minialign.c:5249-5272): tags preserved
        from the input (BAM aux / FASTA CO comment), pre-rendered by
        the bseq reader."""
        for t in getattr(seq, "tags", ()):
            self.out.write("\t" + t)

    def mapped(self, ref_names, ref_lens, ref_codes, seq, reg):
        """mm_print_sam_mapped (minialign.c:5390-5426): per alignment,
        one record per path segment (head first; circular-origin splits
        produce several), flag 0x800 after the first primary record,
        0x100 for every secondary-alignment record."""
        sp = stats.begin("io.format") if stats.ON else None
        self._mapped(ref_names, ref_lens, ref_codes, seq, reg)
        if sp is not None:
            stats.end(sp)

    def _mapped(self, ref_names, ref_lens, ref_codes, seq, reg):
        if reg is None:
            self._unmapped(seq)
            return
        n = reg.n_uniq if self.omit_rep else len(reg.alns)
        flag = 0
        for i in range(n):
            ra = reg.alns[i]
            a = ra.aln
            if i >= reg.n_uniq:
                flag = 0x100
            for j, s in enumerate(a.segs):
                self._record(ref_names, ref_lens, ref_codes, seq, reg,
                             a, s, ra.mapq, flag, i, len(reg.alns))
                if i == 0 and j == 0:
                    flag = 0x800
                    if self._primary_tags(ref_names, seq, reg):
                        self.out.write("\n")
                        return          # SA replaces supp records
                self.out.write("\n")
            flag = 0x800

    def _record(self, ref_names, ref_lens, ref_codes, seq, reg, a: Aln,
                s, mapq, flag, idx, n_reg):
        w = self.out.write
        qlen = len(seq.codes)
        flag |= 0x10 if a.rev else 0
        hl, tl = s.bs0, qlen - s.be
        hard = bool(flag & 0x900)
        qs = hl if hard else 0
        qe = qlen - (tl if hard else 0)
        clip = "H" if hard else "S"

        cig = []
        if hl:
            cig.append(f"{hl}{clip}")
        cig.append(seg_cigar(a, s))
        if tl:
            cig.append(f"{tl}{clip}")

        if a.rev:
            # slice-then-revcomp == the double-reversal form, one copy
            sseq = decode(seq.codes[qlen - qe:qlen - qs],
                          rev=True).decode()
        else:
            sseq = decode(seq.codes[qs:qe]).decode()

        if seq.qual:
            q = seq.qual[::-1] if a.rev else seq.qual
            qual = q[qs:qe].decode()
        else:
            qual = "*"

        w(f"{seq.name}\t{flag}\t{ref_names[a.rid]}\t{s.as0 + 1}\t"
          f"{mapq >> 4}\t{''.join(cig)}\t*\t0\t0\t{sseq}\t{qual}")

        # general tags (minialign.c:5304-5340) — per alignment, so
        # AS/NM repeat unchanged on split-segment records
        if TAG_RG in self.tags and self.rg_id:
            w(f"\tRG:Z:{self.rg_id}")
        if TAG_NH in self.tags:
            w(f"\tNH:i:{n_reg}")
        if TAG_IH in self.tags:
            w(f"\tIH:i:{idx}")
        if TAG_AS in self.tags:
            w(f"\tAS:i:{a.score}")
        if TAG_NM in self.tags:
            w(f"\tNM:i:{_nm(a)}")
        if TAG_MD in self.tags:
            rsl = np.asarray(ref_codes[a.rid][s.as0:s.ae])
            qdir = seq.codes if not a.rev else \
                (3 - seq.codes[::-1]).astype(np.int8)
            w("\tMD:Z:" + md_tag(seg_tokens(a, s), rsl,
                                  qdir[s.bs0:s.be]))

    def _primary_tags(self, ref_names, seq, reg) -> bool:
        """mm_print_sam_primary_tags (minialign.c:5348-5384); returns
        True if the SA tag was printed (supp records then omitted)."""
        w = self.out.write
        qlen = len(seq.codes)
        if TAG_XS in self.tags:
            xs = reg.alns[1].aln.score if len(reg.alns) > 1 else 0
            w(f"\tXS:i:{xs}")
        ret = False
        if TAG_SA in self.tags and (reg.n_uniq > 1
                                    or reg.alns[0].aln.slen > 1):
            w("\tSA:Z:")
            for k in range(reg.n_uniq):
                ra = reg.alns[k]
                sa = ra.aln
                nm = _nm(sa)
                for j, s in enumerate(sa.segs):
                    if k == 0 and j == 0:
                        continue
                    shl, stl = s.bs0, qlen - s.be
                    parts = []
                    if shl:
                        parts.append(f"{shl}H")
                    parts.append(seg_cigar(sa, s))
                    if stl:
                        parts.append(f"{stl}H")
                    # SA's mapq is printed RAW (x16: mm_print_sam_supp
                    # at minialign.c:5230 receives mm_aln_t.mapq which
                    # mm_pack_reg fills with bin->plen, the unshifted
                    # fixed-point value — 60 prints as 960)
                    w(f"{ref_names[sa.rid]},{s.as0 + 1},"
                      f"{'+' if not sa.rev else '-'},{''.join(parts)},"
                      f"{ra.mapq},{nm};")
            ret = True
        self._saved_tags(seq)
        return ret


class PafWriter:
    """PAF formatter (minialign.c:5569-5619)."""

    def __init__(self, out, tags: tuple = ()):
        self.out = out
        self.tags = set(tags)

    def header(self, names, lens):
        pass

    def mapped(self, ref_names, ref_lens, ref_codes, seq, reg):
        sp = stats.begin("io.format") if stats.ON else None
        self._mapped(ref_names, ref_lens, seq, reg)
        if sp is not None:
            stats.end(sp)

    def _mapped(self, ref_names, ref_lens, seq, reg):
        if reg is None:
            return
        qlen = len(seq.codes)
        for i, ra in enumerate(reg.alns):
            a = ra.aln
            # mcnt/blk per minialign.c:5600-5603; q coords are in
            # alignment-orientation (strand) space like the reference's
            # reversed-segment arithmetic (minialign.c:5583-5584)
            mcnt = int(a.dcnt * a.identity)
            gcnt = a.agcnt + a.bgcnt
            blk = a.dcnt + gcnt
            qs, qe = a.bs0, a.be
            self.out.write(
                f"{seq.name}\t{qlen}\t{qs}\t{qe}\t"
                f"{'-' if a.rev else '+'}\t{ref_names[a.rid]}\t"
                f"{int(ref_lens[a.rid])}\t{a.as0}\t{a.ae}\t"
                f"{mcnt}\t{blk}\t{ra.mapq >> 4}")
            if TAG_AS in self.tags:
                self.out.write(f"\tAS:i:{a.score}")
            if TAG_NM in self.tags:
                self.out.write(f"\tNM:i:{_nm(a)}")
            self.out.write("\n")


def _pad_pair(n1: int, n2: int) -> tuple:
    """Right-align two numbers to a common width with spaces (the
    reference's _putpi pair formatter, minialign.c:4840-4866)."""
    w = max(len(str(n1)), len(str(n2)))
    return str(n1).rjust(w), str(n2).rjust(w)


def _fixed(n: int, c: int) -> str:
    """_putfi fixed-point print: integer n as n/10^c with c decimals."""
    s = str(n).rjust(c + 1, "0")
    return s[:-c] + "." + s[-c:]


def gapped_pair(tokens: list, rcodes, qcodes) -> tuple:
    """Gapped alignment rows for MAF (ref row, query row), from
    display-order cigar tokens (the reference renders these with
    gaba_dump_seq_reverse — the same _parser_loop_rv tokens)."""
    from .bseq import decode
    r = decode(rcodes).decode()
    q = decode(qcodes).decode()
    ri = qi = 0
    ro, qo = [], []
    for c, op in tokens:
        if op == "M":
            ro.append(r[ri:ri + c])
            qo.append(q[qi:qi + c])
            ri += c
            qi += c
        elif op == "D":
            ro.append(r[ri:ri + c])
            qo.append("-" * c)
            ri += c
        else:
            ro.append("-" * c)
            qo.append(q[qi:qi + c])
            qi += c
    return "".join(ro), "".join(qo)


class MafWriter:
    """MAF formatter (mm_print_maf_mapped, minialign.c:5429-5510)."""

    def __init__(self, out, tags: tuple = (), omit_rep: bool = False):
        self.out = out
        self.omit_rep = omit_rep

    def header(self, names, lens):
        pass

    def mapped(self, ref_names, ref_lens, ref_codes, seq, reg):
        if reg is None:
            return
        import numpy as np
        qlen = len(seq.codes)
        n = reg.n_uniq if self.omit_rep else len(reg.alns)
        for i in range(n):
            a = reg.alns[i].aln
            w = self.out.write
            # one block per path segment, head first (the reference
            # iterates seg[slen-1]..seg[0], minialign.c:5505-5507,
            # with the whole alignment's score on each block)
            for s in a.segs:
                w(f"a score={a.score}\n")
                rname, qname = ref_names[a.rid], seq.name
                pad = max(len(rname), len(qname)) + 1
                rs_s, qs_s = _pad_pair(s.as0, s.bs0)
                al_s, bl_s = _pad_pair(s.ae - s.as0, s.be - s.bs0)
                rl_s, ql_s = _pad_pair(int(ref_lens[a.rid]), qlen)
                qdir = seq.codes if not a.rev else \
                    (3 - np.asarray(seq.codes)[::-1]).astype(np.int8)
                rsl = np.asarray(ref_codes[a.rid][s.as0:s.ae])
                rrow, qrow = gapped_pair(seg_tokens(a, s), rsl,
                                         qdir[s.bs0:s.be])
                w(f"s {rname.ljust(pad)}{rs_s} {al_s} + {rl_s} "
                  f"{rrow}\n")
                w(f"s {qname.ljust(pad)}{qs_s} {bl_s} "
                  f"{'-' if a.rev else '+'} {ql_s} {qrow}\n\n")


class Blast6Writer:
    """BLAST outfmt-6 (mm_print_blast6_mapped, minialign.c:5517-5561)."""

    def __init__(self, out, tags: tuple = (), omit_rep: bool = False):
        self.out = out
        self.omit_rep = omit_rep

    def header(self, names, lens):
        pass

    def mapped(self, ref_names, ref_lens, ref_codes, seq, reg):
        if reg is None:
            return
        qlen = len(seq.codes)
        n = reg.n_uniq if self.omit_rep else len(reg.alns)
        for i in range(n):
            a = reg.alns[i].aln
            dcnt = a.dcnt
            mcnt = int(dcnt * a.identity)
            gcnt = a.agcnt + a.bgcnt
            slen = dcnt + gcnt
            mid = int(1000.0 * a.identity)
            # strand-dependent coordinate swap (minialign.c:5531-5533)
            if not a.rev:
                rs, re = a.as0 + 1, a.ae
            else:
                rs, re = a.ae, a.as0 + 1
            qs, qe = a.bs0 + 1, a.be
            bit = 1.85 * a.score - 0.02
            ev = int(1000.0 * float(ref_lens[a.rid]) * qlen
                     * (2.0 ** -bit))
            self.out.write(
                f"{seq.name}\t{ref_names[a.rid]}\t{_fixed(mid, 3)}\t"
                f"{slen}\t{dcnt - mcnt}\t{gcnt}\t{qs}\t{qe}\t{rs}\t{re}\t"
                f"{_fixed(ev, 3)}\t{int(bit)}\n")
