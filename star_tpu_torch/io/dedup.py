"""BAM duplicate marking (--bamRemoveDuplicatesType).

Reference behavior: source/bamRemoveDuplicates.cpp — stream a coordinate-
sorted PE BAM; mark every unique alignment (and multimappers when
UniqueIdentical) with flag 0x400; group consecutive records while on the
same chromosome and overlapping the group's max right-mate coordinate; in
each group sort unique records by (name length, name, flag&0x80) to pair
mates, sort pairs by (S-extended starts, FLAGs, S-extended CIGARs, mate2
5' sequence prefix), and unmark the best-AS pair of every identical run.
"""
from __future__ import annotations

import gzip
import struct
from typing import List, Optional

from .bam import BgzfWriter


def _read_bam(path: str):
    data = gzip.decompress(open(path, "rb").read())
    if data[:4] != b"BAM\x01":
        raise SystemExit("EXITING because of fatal ERROR: could not open "
                         "--inputBAMfile " + path)
    lt = struct.unpack("<i", data[4:8])[0]
    off = 8 + lt
    nref = struct.unpack("<i", data[off:off + 4])[0]
    off += 4
    for _ in range(nref):
        ln = struct.unpack("<i", data[off:off + 4])[0]
        off += 4 + ln + 4
    header = data[:off]
    recs = []
    while off < len(data):
        bs = struct.unpack("<i", data[off:off + 4])[0]
        recs.append(bytearray(data[off:off + 4 + bs]))
        off += 4 + bs
    return header, recs


class _Rec:
    __slots__ = ("buf", "ref", "pos", "next_pos", "flag", "name", "name_len",
                 "cigar", "seq", "seq_len", "nh", "score")

    def __init__(self, buf: bytearray):
        self.buf = buf
        (self.ref, self.pos) = struct.unpack("<ii", buf[4:12])
        bin_mq_nl, flag_nc = struct.unpack("<II", buf[12:20])
        self.name_len = bin_mq_nl & 0xFF
        n_cigar = flag_nc & 0xFFFF
        self.flag = flag_nc >> 16
        self.seq_len = struct.unpack("<i", buf[20:24])[0]
        self.next_pos = struct.unpack("<i", buf[32:36])[0]
        o = 36 + self.name_len
        self.name = bytes(buf[36:o])
        self.cigar = [struct.unpack("<I", buf[o + 4 * i:o + 4 * i + 4])[0]
                      for i in range(n_cigar)]
        o += 4 * n_cigar
        self.seq = bytes(buf[o:o + (self.seq_len + 1) // 2])
        o += (self.seq_len + 1) // 2 + self.seq_len
        self.nh, self.score = _aux_ints(buf, o, (b"NH", b"AS"))

    def set_dup(self, on: bool):
        flag_nc = struct.unpack("<I", self.buf[16:20])[0]
        if on:
            flag_nc |= 0x400 << 16
        else:
            flag_nc ^= 0x400 << 16
        self.buf[16:20] = struct.pack("<I", flag_nc)
        self.flag = flag_nc >> 16


def _aux_ints(buf, off: int, tags):
    out = {t: None for t in tags}
    i = off
    n = len(buf)
    while i < n - 2:
        tag = bytes(buf[i:i + 2])
        typ = bytes(buf[i + 2:i + 3])
        i += 3
        if typ == b"Z" or typ == b"H":
            j = buf.index(b"\x00", i)
            val = None
            i = j + 1
        elif typ == b"B":
            st = buf[i:i + 1]
            cnt = struct.unpack("<i", buf[i + 1:i + 5])[0]
            width = {b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4,
                     b"f": 4}[st]
            val = None
            i += 5 + cnt * width
        elif typ == b"A":
            val = None
            i += 1
        else:
            width, fmt = {b"c": (1, "<b"), b"C": (1, "<B"), b"s": (2, "<h"),
                          b"S": (2, "<H"), b"i": (4, "<i"), b"I": (4, "<I"),
                          b"f": (4, "<f")}[typ]
            val = struct.unpack(fmt, buf[i:i + width])[0]
            i += width
        if tag in out:
            out[tag] = val
    return tuple(out[t] for t in tags)


def _start_extend_s(r: _Rec) -> int:
    if r.cigar and (r.cigar[0] & 0xF) == 4:
        return r.pos - (r.cigar[0] >> 4)
    return r.pos


def _cigar_extend_s(r: _Rec) -> List[int]:
    cig = list(r.cigar)
    if cig and (cig[0] & 0xF) == 4:
        s = cig[0] >> 4
        cig = cig[1:]
        if cig:
            cig[0] += s << 4
    if cig and (cig[-1] & 0xF) == 4:
        s = cig[-1] >> 4
        cig = cig[:-1]
        if cig:
            cig[-1] += s << 4
    return cig


def _pair_key(pair, mate2_bases_n: int):
    a, b = pair
    key = [_start_extend_s(a), _start_extend_s(b), a.flag, b.flag]
    ca = _cigar_extend_s(a)
    cb = _cigar_extend_s(b)
    key.append(len(ca))
    key.append(tuple(ca))
    key.append(len(cb))
    key.append(tuple(cb))
    # mate2 5' sequence prefix (reference funCompareCoordFlagCigarSeq:89-109)
    seq_cmp = []
    if mate2_bases_n > 0:
        s = b.seq
        if (b.flag & 0x10) == 0:
            ii = 1
            while ii < mate2_bases_n:
                seq_cmp.append(s[ii // 2])
                ii += 2
            if mate2_bases_n % 2 > 0:
                seq_cmp.append(s[ii // 2] >> 4)
        else:
            ii = b.seq_len - mate2_bases_n
            if ii % 2 > 0:
                seq_cmp.append(s[ii // 2] & 15)
                ii += 1
            while ii < b.seq_len:
                seq_cmp.append(s[ii // 2])
                ii += 2
    key.append(tuple(seq_cmp))
    return tuple(key)


def bam_remove_duplicates(in_path: str, out_path: str, P):
    """mark duplicates in a coordinate-sorted PE BAM -> Processed.out.bam"""
    mark_multi = P.bamRemoveDuplicatesType == "UniqueIdentical"
    mate2_n = int(getattr(P, "bamRemoveDuplicatesMate2basesN", 0))
    header, bufs = _read_bam(in_path)
    recs = [_Rec(b) for b in bufs]

    def process_group(group: List[_Rec]):
        # pair mates: sort by (name length, name bytes, flag&0x80)
        group = sorted(group, key=lambda r: (r.name_len, r.name,
                                             r.flag & 0x80))
        pairs = [(group[i], group[i + 1]) for i in range(0, len(group) - 1, 2)]
        pairs.sort(key=lambda p: _pair_key(p, mate2_n))
        b_score, b_p = -999, 0
        for pp in range(len(pairs)):
            if pairs[pp][0].nh is None or pairs[pp][0].score is None:
                raise SystemExit(
                    "EXITING because of fatal ERROR: SAM tag NH or AS is "
                    "missing from a read, but it's required for deduplication."
                    "\nSOLUTION: re-generate BAM file with NH and AS tags.")
            if pairs[pp][0].score > b_score:
                b_score = pairs[pp][0].score
                b_p = pp
            if (pp == len(pairs) - 1
                    or _pair_key(pairs[pp], mate2_n) != _pair_key(pairs[pp + 1],
                                                                  mate2_n)):
                pairs[b_p][0].set_dup(False)
                pairs[b_p][1].set_dup(False)
                b_score = -999

    group: List[_Rec] = []
    group_chr = None
    right_max = 0
    for r in recs:
        if r.nh == 1 or ((r.nh or 0) > 1 and mark_multi):
            r.set_dup(True)
        ref_u = r.ref & 0xFFFFFFFF
        if group_chr is not None and (
                ref_u != group_chr or (right_max > 0
                                       and (r.pos & 0xFFFFFFFF) > right_max)):
            process_group(group)
            group = []
            right_max = 0
            group_chr = None
        if group_chr is None:
            group_chr = ref_u
        if r.nh == 1:
            group.append(r)
            if (r.next_pos & 0xFFFFFFFF) > (r.pos & 0xFFFFFFFF):
                right_max = max(right_max, r.next_pos & 0xFFFFFFFF)
    if group:
        process_group(group)

    w = BgzfWriter(out_path, level=int(getattr(P, "outBAMcompression", 1)))
    w.write(header)
    for b in bufs:
        w.write(bytes(b))
    w.close()
