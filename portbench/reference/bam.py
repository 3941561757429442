"""A plain BAM reader (BGZF is multi-member gzip; SAM spec section 4.2)."""
from __future__ import annotations

import gzip
import struct

_SEQ = "=ACMGRSVTWYHKDBN"
_CIG = "MIDNSHP=X"
_PAIR = [_SEQ[x >> 4] + _SEQ[x & 15] for x in range(256)]


class Record:
    __slots__ = ("name", "flag", "ref", "pos", "mapq", "cigar", "seq", "qual",
                 "tags")

    def __init__(self, name, flag, ref, pos, mapq, cigar, seq, qual, tags):
        self.name, self.flag, self.ref, self.pos = name, flag, ref, pos
        self.mapq, self.cigar, self.seq, self.qual = mapq, cigar, seq, qual
        self.tags = tags


def _tags(b: bytes, i: int, end: int) -> dict:
    out = {}
    while i < end:
        key = b[i:i + 2].decode()
        t = chr(b[i + 2])
        i += 3
        if t in "cCsSiI":
            fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i",
                   "I": "<I"}[t]
            n = struct.calcsize(fmt)
            out[key] = struct.unpack_from(fmt, b, i)[0]
            i += n
        elif t == "A":
            out[key] = chr(b[i])
            i += 1
        elif t == "f":
            out[key] = struct.unpack_from("<f", b, i)[0]
            i += 4
        elif t in "ZH":
            j = b.index(b"\0", i)
            out[key] = b[i:j].decode()
            i = j + 1
        elif t == "B":
            sub = chr(b[i])
            n = struct.unpack_from("<i", b, i + 1)[0]
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I",
                   "f": "f"}[sub]
            sz = struct.calcsize(fmt)
            out[key] = list(struct.unpack_from(f"<{n}{fmt}", b, i + 5))
            i += 5 + n * sz
        else:
            raise ValueError(f"BAM: unknown tag type {t}")
    return out


def read_bam(path: str):
    """(reference names, reference lengths, list of Record)"""
    with gzip.open(path, "rb") as f:
        b = f.read()
    if b[:4] != b"BAM\1":
        raise ValueError(f"{path}: not a BAM file")
    l_text = struct.unpack_from("<i", b, 4)[0]
    i = 8 + l_text
    n_ref = struct.unpack_from("<i", b, i)[0]
    i += 4
    names, lens = [], []
    for _ in range(n_ref):
        ln = struct.unpack_from("<i", b, i)[0]
        names.append(b[i + 4:i + 4 + ln - 1].decode())
        lens.append(struct.unpack_from("<i", b, i + 4 + ln)[0])
        i += 8 + ln
    recs = []
    n = len(b)
    while i < n:
        size = struct.unpack_from("<i", b, i)[0]
        (ref, pos, l_name, mapq, _bin, n_cig, flag, l_seq, _nr, _np,
         _tl) = struct.unpack_from("<iiBBHHHiiii", b, i + 4)
        j = i + 36
        name = b[j:j + l_name - 1].decode()
        j += l_name
        cig = struct.unpack_from(f"<{n_cig}I", b, j)
        cigar = [(c & 15, c >> 4) for c in cig]
        j += 4 * n_cig
        sb = b[j:j + (l_seq + 1) // 2]
        seq = "".join(map(_PAIR.__getitem__, sb))[:l_seq]
        j += (l_seq + 1) // 2
        qual = b[j:j + l_seq]
        j += l_seq
        recs.append(Record(name, flag, ref, pos, mapq,
                           [(_CIG[op], ln) for op, ln in cigar], seq,
                           bytes(q + 33 for q in qual) if l_seq and qual[0] != 255
                           else b"*", _tags(b, j, i + 4 + size)))
        i += 4 + size
    return names, lens, recs
