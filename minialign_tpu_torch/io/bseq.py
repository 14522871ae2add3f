"""Copy of minialign_tpu/io/bseq.py for the port, unchanged apart from
this header (its imports are relative, so they resolve in this package).

FASTA/FASTQ batch reader.

Mirrors the reference bseq reader semantics (minialign.c:1574-2347):
  * gzip/plain auto-detection, FASTA/FASTQ auto-detection from the
    first byte ('>' or '@').
  * name = token up to the first space/tab; the remainder of the header
    line is kept as a comment (emitted as a CO:Z: tag when requested).
  * bases are 2-bit encoded with _encaf: code = 3 & ((c>>2) ^ (c>>1)),
    which maps ACGT/acgt correctly and squashes N (and other letters)
    pseudo-randomly into 0..3 (minialign.c:229).
  * quality strings are dropped unless keep_qual (the reference default;
    -Q keeps them, minialign.c:5966).
  * reads shorter than min_len are skipped.
  * batches of ~batch_size bases (512 KiB default) preserve input order.

The vectorized numpy parser processes whole buffers at once (the
reference uses 32-byte SIMD scans; here the same work is one
np.frombuffer + boolean masks per batch).
"""

from __future__ import annotations

import dataclasses
import gzip
import io as _io

import numpy as np


@dataclasses.dataclass
class Seq:
    name: str
    comment: str
    codes: np.ndarray      # (L,) int8 2-bit codes
    qual: bytes            # b"" if absent/dropped
    tags: list = dataclasses.field(default_factory=list)
    # saved SAM tags, pre-rendered ("RG:Z:x"); filtered by the -T list
    # at read time like bseq_save_tags (minialign.c:1832-1878)


_ENC = np.zeros(256, np.int8)
for _c in range(256):
    _ENC[_c] = 3 & ((_c >> 2) ^ (_c >> 1))


def encode(seq_bytes: bytes) -> np.ndarray:
    return _ENC[np.frombuffer(seq_bytes, np.uint8)]


DEC_F = np.frombuffer(b"ACGTN", np.uint8)
DEC_R = np.frombuffer(b"TGCAN", np.uint8)


def decode(codes: np.ndarray, rev: bool = False) -> bytes:
    t = DEC_R if rev else DEC_F
    c = np.asarray(codes)
    if rev:
        c = c[::-1]
    return t[np.clip(c, 0, 4)].tobytes()


def _open(path: str):
    """Open FASTA/FASTQ(.gz); '-' reads stdin (main_align pours stdin to
    the query side when no query file is given, minialign.c:6380-6384)."""
    if path == "-":
        import io as _io
        import sys
        data = sys.stdin.buffer.read()
        if data[:2] == b"\x1f\x8b":
            return gzip.open(_io.BytesIO(data), "rb")
        return _io.BytesIO(data)
    f = open(path, "rb")
    head = f.read(2)
    f.seek(0)
    if head[:2] == b"\x1f\x8b":
        return gzip.open(f, "rb")
    return f


def read_seqs(path: str, keep_qual: bool = False, min_len: int = 1,
              keep_comment: bool = False, tags: tuple = ()):
    """Iterate Seq records from a FASTA/FASTQ/BAM(.gz) file. `tags` is
    the -T preserve list (2-char names); 'CO' keeps FASTA/Q comments
    (minialign.c:1801)."""
    keep_comment = keep_comment or ("CO" in tags)
    with _open(path) as f:
        first = f.peek(1)[:1] if hasattr(f, "peek") else b""
        data = f.read()
    if not data:
        return
    if data[:4] == b"BAM\x01":
        yield from _parse_bam(data, keep_qual, min_len, tags)
        return
    from .. import native
    if native.available():
        r = native.parse_fastx(data, keep_qual, min_len)
        if r is not None:
            recs, codes = r
            for row in recs:
                comment = data[row[2]:row[2] + row[3]].decode() \
                    if row[3] and keep_comment else ""
                qual = codes[row[6]:row[6] + row[7]].astype(
                    np.uint8).tobytes() if row[7] else b""
                yield Seq(
                    name=data[row[0]:row[0] + row[1]].decode(),
                    comment=comment,
                    codes=codes[row[4]:row[4] + row[5]].copy(),
                    qual=qual,
                    tags=_comment_tags(comment, keep_comment, tags))
            return
    is_fastq = data.lstrip()[:1] == b"@"
    if is_fastq:
        yield from _parse_fastq(data, keep_qual, min_len, keep_comment,
                                tags)
    else:
        yield from _parse_fasta(data, min_len, keep_comment, tags)


def _split_header(line: bytes):
    line = line.strip()
    sp = min([i for i in (line.find(b" "), line.find(b"\t")) if i >= 0],
             default=-1)
    if sp < 0:
        return line.decode(), ""
    # strip separator runs between name and comment (the reference's
    # parser state 4, minialign.c:2033-2035)
    return line[:sp].decode(), line[sp + 1:].lstrip().decode()


def _comment_tags(comment: str, keep_comment: bool, tags: tuple) -> list:
    if keep_comment and "CO" in tags and comment:
        return [f"CO:Z:{comment}"]
    return []


def _parse_fasta(data: bytes, min_len: int, keep_comment: bool,
                 tags: tuple = ()):
    recs = data.split(b"\n>")
    for i, rec in enumerate(recs):
        if i == 0:
            rec = rec.lstrip()
            if rec[:1] != b">":
                continue
            rec = rec[1:]
        nl = rec.find(b"\n")
        if nl < 0:
            continue
        name, comment = _split_header(rec[:nl])
        seq = rec[nl + 1:].translate(None, b"\r\n \t")
        if len(seq) < min_len:
            continue
        yield Seq(name=name, comment=comment if keep_comment else "",
                  codes=encode(seq), qual=b"",
                  tags=_comment_tags(comment, keep_comment, tags))


def _parse_fastq(data: bytes, keep_qual: bool, min_len: int,
                 keep_comment: bool, tags: tuple = ()):
    lines = data.split(b"\n")
    i = 0
    n = len(lines)
    while i + 3 < n or (i < n and lines[i][:1] == b"@"):
        if not lines[i][:1] == b"@":
            i += 1
            continue
        name, comment = _split_header(lines[i][1:])
        # multi-line seq until '+'
        seq_parts = []
        i += 1
        while i < n and lines[i][:1] != b"+":
            seq_parts.append(lines[i].strip())
            i += 1
        seq = b"".join(seq_parts)
        i += 1  # skip '+'
        qual_parts = []
        qlen = 0
        while i < n and qlen < len(seq):
            q = lines[i].strip()
            qual_parts.append(q)
            qlen += len(q)
            i += 1
        qual = b"".join(qual_parts)
        if len(seq) < min_len:
            continue
        yield Seq(name=name, comment=comment if keep_comment else "",
                  codes=encode(seq),
                  qual=qual if keep_qual else b"",
                  tags=_comment_tags(comment, keep_comment, tags))


# BAM nibble -> 2-bit code; anything but A/C/G/T (incl. N = 15) maps to
# A (fw) / A (rv), as the reference's enc4f/enc4r do (minialign.c:221)
_BAM_NIB = np.zeros(16, np.int8)
_BAM_NIB[1], _BAM_NIB[2], _BAM_NIB[4], _BAM_NIB[8] = 0, 1, 2, 3
_BAM_NIB_R = np.zeros(16, np.int8)
_BAM_NIB_R[1], _BAM_NIB_R[2], _BAM_NIB_R[4], _BAM_NIB_R[8] = 3, 2, 1, 0

_TAG_SIZE = {b"A": 1, b"c": 1, b"C": 1, b"s": 2, b"S": 2,
             b"i": 4, b"I": 4, b"f": 4}
_TAG_FMT = {b"c": "b", b"C": "B", b"s": "<h", b"S": "<H",
            b"i": "<i", b"I": "<I", b"f": "<f"}


def _render_num(t: bytes, raw: bytes) -> str:
    import struct
    if t == b"A":
        return chr(raw[0])
    v = struct.unpack(_TAG_FMT[t], raw)[0]
    if t == b"f":
        return f"{v:f}"          # sprintf("%f") like mm_print_sam_num
    return str(v)


def _bam_tags(buf: bytes, keep: tuple) -> list:
    """Walk a BAM aux section, rendering kept tags in SAM text form
    (bseq_save_tags + mm_restore_sam_tags semantics, incl. the array
    quirk: B arrays print without the subtype char and with a trailing
    comma per element)."""
    out = []
    p, n = 0, len(buf)
    while p + 3 <= n:
        name = buf[p:p + 2].decode("latin1")
        t = buf[p + 2:p + 3]
        p += 3
        if t == b"Z" or t == b"H":
            e = buf.index(b"\x00", p)
            if name in keep:
                out.append(f"{name}:{t.decode()}:"
                           f"{buf[p:e].decode('latin1')}")
            p = e + 1
        elif t == b"B":
            sub = buf[p:p + 1]
            cnt = int.from_bytes(buf[p + 1:p + 5], "little")
            sz = _TAG_SIZE[sub]
            if name in keep:
                body = "".join(
                    _render_num(sub, buf[p + 5 + i * sz:p + 5 + (i + 1) * sz])
                    + "," for i in range(cnt))
                out.append(f"{name}:B:{body}")
            p += 5 + cnt * sz
        else:
            sz = _TAG_SIZE[t]
            if name in keep:
                out.append(f"{name}:{t.decode()}:"
                           f"{_render_num(t, buf[p:p + sz])}")
            p += sz
    return out


def _parse_bam(data: bytes, keep_qual: bool, min_len: int,
               tags: tuple = ()):
    """Uncompressed-payload BAM record walk (bseq_read_bam,
    minialign.c:1884-1950): skips 0x900-flagged records, restores the
    original read orientation for 0x10-flagged ones, +33 quals (0xff
    first byte = absent), keeps -T-listed aux tags."""
    import struct
    pos = 4
    l_text = int.from_bytes(data[pos:pos + 4], "little")
    pos += 4 + l_text
    n_ref = int.from_bytes(data[pos:pos + 4], "little")
    pos += 4
    for _ in range(n_ref):
        l_name = int.from_bytes(data[pos:pos + 4], "little")
        pos += 4 + l_name + 4
    while pos + 4 <= len(data):
        bsize = int.from_bytes(data[pos:pos + 4], "little")
        pos += 4
        rec = data[pos:pos + bsize]
        pos += bsize
        if len(rec) < 32:
            break
        (_rid, _p, l_qname, _mapq, _bin, n_cigar, flag, l_seq,
         _nrid, _npos, _tlen) = struct.unpack("<iiBBHHHiiii", rec[:32])
        if flag & 0x900 or l_seq < min_len:
            continue
        o = 32
        name = rec[o:o + l_qname - 1].decode("latin1")
        o += l_qname + 4 * n_cigar
        nseq = (l_seq + 1) // 2
        packed = np.frombuffer(rec[o:o + nseq], np.uint8)
        nib = np.empty(2 * nseq, np.uint8)
        nib[0::2] = packed >> 4
        nib[1::2] = packed & 0x0F
        o += nseq
        qual_raw = rec[o:o + l_seq]
        o += l_seq
        has_qual = keep_qual and l_seq and qual_raw[0:1] != b"\xff"
        if flag & 0x10:
            codes = _BAM_NIB_R[nib[:l_seq]][::-1]
            qual_raw = qual_raw[::-1]
        else:
            codes = _BAM_NIB[nib[:l_seq]]
        qual = bytes((q + 33) & 0xFF for q in qual_raw) if has_qual \
            else b""
        yield Seq(name=name, comment="", codes=codes, qual=qual,
                  tags=_bam_tags(rec[o:], tags))


def read_batches(path: str, batch_size: int = 512 * 1024, **kw):
    """Yield lists of Seq totalling ~batch_size bases (bseq_read
    batching, minialign.c:2105)."""
    batch, total = [], 0
    for s in read_seqs(path, **kw):
        batch.append(s)
        total += len(s.codes)
        if total >= batch_size:
            yield batch
            batch, total = [], 0
    if batch:
        yield batch
