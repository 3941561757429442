"""BAM output: BGZF writer + binary record encoding + coordinate sort.

Record field semantics mirror the reference emitter exactly (reference:
source/ReadAlign_alignBAM.cpp record layout, source/BAMfunctions.h attribute
int-width selection, source/BAMfunctions.cpp reg2bin/header) so decompressed
record streams are byte-comparable; BGZF block boundaries/compression level
are our own (compressed bytes may differ, content does not).
Coordinate sorting replaces the reference's genome-bin spill files + per-bin
qsort (reference: BAMoutput.cpp, bamSortByCoordinate.cpp) with an in-memory
key sort; same output order.
"""
from __future__ import annotations

import struct
import zlib
from typing import List, Optional

from ..constants import SJ_SAM_ANNOTATED_MOTIF_SHIFT
from .sam import _mapq, revcomp_str

BAM_MAGIC = b"BAM\x01"

# 4-bit nucleotide codes '=ACMGRSVTWYHKDBN'
_NT4 = {"A": 1, "C": 2, "G": 4, "T": 8, "N": 15, "=": 0}


class BgzfWriter:
    """minimal BGZF (blocked gzip) writer with the standard EOF marker"""

    MAX_BLOCK = 0xFF00

    def __init__(self, path: str, level: int = 6):
        self.f = open(path, "wb")
        self.level = level
        self.buf = bytearray()

    def write(self, data: bytes):
        self.buf += data
        while len(self.buf) >= self.MAX_BLOCK:
            self._flush_block(self.buf[:self.MAX_BLOCK])
            del self.buf[:self.MAX_BLOCK]

    def _flush_block(self, payload):
        co = zlib.compressobj(self.level, zlib.DEFLATED, -15)
        cdata = co.compress(bytes(payload)) + co.flush()
        crc = zlib.crc32(bytes(payload)) & 0xFFFFFFFF
        bsize = len(cdata) + 25 + 1
        header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                  + struct.pack("<HHHH", 6, 0x4342, 2, bsize - 1))
        self.f.write(header + cdata + struct.pack("<II", crc, len(payload)))

    def close(self):
        if self.buf:
            self._flush_block(self.buf)
            self.buf = bytearray()
        # EOF marker block
        self.f.write(bytes.fromhex(
            "1f8b08040000000000ff0600424302001b0003000000000000000000"))
        self.f.close()


def reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def pack_seq(seq: str) -> bytes:
    out = bytearray((len(seq) + 1) // 2)
    for i, ch in enumerate(seq):
        code = _NT4.get(ch, 15)
        if i % 2 == 0:
            out[i // 2] = code << 4
        else:
            out[i // 2] |= code
    return bytes(out)


def attr_int(tag: str, x: int) -> bytes:
    """samtools-style smallest-width integer attribute"""
    t = tag.encode()
    if x < 0:
        if x >= -127:
            return t + b"c" + struct.pack("<b", x)
        if x >= -32767:
            return t + b"s" + struct.pack("<h", x)
        return t + b"i" + struct.pack("<i", x)
    if x <= 255:
        return t + b"C" + struct.pack("<B", x)
    if x <= 65535:
        return t + b"S" + struct.pack("<H", x)
    return t + b"I" + struct.pack("<I", x)


def attr_char(tag: str, c: str) -> bytes:
    return tag.encode() + b"A" + c.encode()


def attr_str(tag: str, s: str) -> bytes:
    return tag.encode() + b"Z" + s.encode() + b"\x00"


def attr_array(tag: str, typ: str, vals) -> bytes:
    fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I"}[typ]
    out = tag.encode() + b"B" + typ.encode() + struct.pack("<i", len(vals))
    for v in vals:
        out += struct.pack(fmt, int(v))
    return out


def bam_header_bytes(gi, P, cmd_line: str = "", chr_names=None, chr_lens=None,
                     sorted_coord: bool = False) -> bytes:
    from .sam import sam_header
    if gi is None:
        text = b"@HD\tVN:1.4\n" + b"".join(
            f"@SQ\tSN:{n}\tLN:{l}\n".encode()
            for n, l in zip(chr_names, chr_lens))
    else:
        text = sam_header(gi, P, cmd_line, sorted_coord).encode()
    names = chr_names if chr_names is not None else gi.chr_name
    lens = chr_lens if chr_lens is not None else [int(x) for x in gi.chr_length]
    out = BAM_MAGIC + struct.pack("<i", len(text)) + text
    out += struct.pack("<i", len(names))
    for n, l in zip(names, lens):
        nb = n.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", int(l))
    return out


def _cigar_ops(tr, imate, i_ex_mate, left_mate, res, align_type=-1):
    """numeric CIGAR ops [(op,len)] for one mate; ops MIDNSHP=X -> 0..8.
    Chimeric align_type -11/-12 hard-clips the left/right trim
    (reference ReadAlign_alignBAM.cpp:237,273)."""
    from .sam import clip_trim_l
    read_length = res.read_length
    read_length_orig = getattr(res, "read_length_original", None) or read_length
    i_ex1 = 0 if imate == 0 else i_ex_mate + 1
    i_ex2 = i_ex_mate if imate == 0 else tr.nExons - 1
    mate = tr.exons[i_ex1][3]
    ops = []
    trim_l = clip_trim_l(tr, mate, res)
    trim_l1 = trim_l + tr.exons[i_ex1][0] - (
        0 if tr.exons[i_ex1][0] < read_length[left_mate] else read_length[left_mate] + 1)
    if trim_l1 > 0:
        ops.append((5 if align_type == -11 else 4, trim_l1))
    for ii in range(i_ex1, i_ex2 + 1):
        if ii > i_ex1:
            gap_g = tr.exons[ii][1] - (tr.exons[ii - 1][1] + tr.exons[ii - 1][2])
            gap_r = tr.exons[ii][0] - tr.exons[ii - 1][0] - tr.exons[ii - 1][2]
            if gap_r > 0:
                ops.append((1, gap_r))
            if tr.canonSJ[ii - 1] >= 0 or tr.sjAnnot[ii - 1] == 1:
                ops.append((3, gap_g))
            elif gap_g > 0:
                ops.append((2, gap_g))
        ops.append((0, tr.exons[ii][2]))
    trim_r1 = (read_length_orig[left_mate]
               if tr.exons[i_ex1][0] < read_length[left_mate]
               else read_length[left_mate] + 1 + read_length_orig[mate]) \
        - tr.exons[i_ex2][0] - tr.exons[i_ex2][2] - trim_l
    if trim_r1 > 0:
        ops.append((5 if align_type == -12 else 4, trim_r1))
    return ops, i_ex1, i_ex2, mate


def encode_mapped(tr, res, n_tr_out, i_tr, gi, P, attrs_order=None,
                  align_type=-1, mate_info=None, meta=None) -> List[bytes]:
    """binary records for all mates of one mapped alignment.
    align_type <= -10 encodes chimeric pieces (reference alignBAM):
    -10 representative, -11/-12 hard-clipped supplementary (left/right),
    -13 soft-clipped supplementary; mate_info=(mateChr, mateStartAbs,
    mateStrand) supplies pairing fields for single-mate pieces; meta (list)
    collects (chr, pos, flag, cigar_str, mapq, nm) per record for SA tags."""
    from .sam import _nm_md
    n_mates_read = len(res.seqs)
    flag_paired = n_mates_read == 2
    lread = res.lread

    i_ex_mate = tr.nExons - 1
    n_mates = 1
    for i in range(tr.nExons - 1):
        if tr.canonSJ[i] == -3:
            i_ex_mate = i
            n_mates = 2
            break

    sam_flag_common = 0
    if flag_paired:
        sam_flag_common = 0x1
        if i_ex_mate == tr.nExons - 1:
            if mate_info is None:
                sam_flag_common += 0x8
        else:
            if (P.alignEndsProtrudeConcordant
                or (tr.exons[0][1] <= tr.exons[i_ex_mate + 1][1] + tr.exons[0][0]
                    and tr.exons[i_ex_mate][1] + tr.exons[i_ex_mate][2]
                    <= tr.exons[-1][1] + lread - tr.exons[-1][0])):
                sam_flag_common += 0x2

    Str = tr.Str
    left_mate = Str if flag_paired else 0
    chr_start = int(gi.chr_start[tr.Chr])
    out = []
    for imate in range(n_mates):
        sam_flag = sam_flag_common
        ops, i_ex1, i_ex2, mate = _cigar_ops(tr, imate, i_ex_mate, left_mate,
                                             res, align_type)
        if align_type in (-11, -12, -13):
            sam_flag |= 0x800
        if mate == 0:
            sam_flag |= Str * 0x10
            if n_mates == 2:
                sam_flag |= (1 - Str) * 0x20
        else:
            sam_flag |= (1 - Str) * 0x10
            if n_mates == 2:
                sam_flag |= Str * 0x20
        if flag_paired:
            sam_flag |= 0x40 if mate == 0 else 0x80
            if n_mates == 1 and mate_info is not None and mate_info[2] == 1:
                sam_flag |= 0x20  # chimeric mate strand (alignBAM:222)
        if not tr.primaryFlag:
            sam_flag |= 0x100

        if mate == Str:
            seq_out = res.seqs[mate]
            qual_out = res.quals[mate]
        else:
            seq_out = revcomp_str(res.seqs[mate])
            qual_out = res.quals[mate][::-1]
        if align_type == -11 and ops and ops[0][0] == 5:
            seq_out = seq_out[ops[0][1]:]
            qual_out = qual_out[ops[0][1]:]
        elif align_type == -12 and ops and ops[-1][0] == 5:
            seq_out = seq_out[:-ops[-1][1]]
            qual_out = qual_out[:-ops[-1][1]]

        mapq = _mapq(n_tr_out, P)
        pos = tr.exons[i_ex1][1] - chr_start
        end = tr.exons[i_ex2][1] + tr.exons[i_ex2][2] - chr_start
        name = res.name.encode() + b"\x00"

        if n_mates > 1:
            next_ref = tr.Chr
            next_pos = tr.exons[i_ex_mate + 1 if imate == 0 else 0][1] - chr_start
            tlen = tr.exons[-1][1] + tr.exons[-1][2] - tr.exons[0][1]
            tlen = tlen if imate == 0 else -tlen
        elif mate_info is not None:
            next_ref = mate_info[0]
            next_pos = mate_info[1] - int(gi.chr_start[mate_info[0]])
            tlen = 0
        else:
            next_ref = -1
            next_pos = -1
            tlen = 0

        # attributes
        attrs = b""
        sj_motif, sj_intron = _sj_arrays(tr, i_ex1, i_ex2, gi, chr_start)
        tag_nm = tag_md = None
        for attr in (attrs_order if attrs_order is not None else P.samAttrOrder):
            if attr == "NH":
                attrs += attr_int("NH", n_tr_out)
            elif attr == "HI":
                attrs += attr_int("HI", i_tr + P.outSAMattrIHstart)
            elif attr == "AS":
                attrs += attr_int("AS", tr.maxScore)
            elif attr == "nM":
                attrs += attr_int("nM", tr.nMM)
            elif attr == "jM":
                attrs += attr_array("jM", "c", sj_motif)
            elif attr == "jI":
                attrs += attr_array("jI", "i", sj_intron)
            elif attr == "XS":
                if tr.sjMotifStrand == 1:
                    attrs += attr_char("XS", "+")
                elif tr.sjMotifStrand == 2:
                    attrs += attr_char("XS", "-")
            elif attr in ("NM", "MD"):
                if tag_nm is None:
                    tag_nm, tag_md = _nm_md(tr, i_ex1, i_ex2, res, gi)
                attrs += attr_int("NM", tag_nm) if attr == "NM" else attr_str("MD", tag_md)
            elif attr == "vA":
                if tr.varAllele:
                    attrs += attr_array("vA", "c", tr.varAllele)
            elif attr == "vG":
                if tr.varGenCoord:
                    attrs += attr_array("vG", "i", tr.varGenCoord)
            elif attr == "vW":
                # fixed-width int32 'i' (BAMfunctions.cpp:106-111), not the
                # smallest-width samtools form
                if getattr(res, "wasp_type", -1) != -1:
                    attrs += b"vWi" + struct.pack("<i", res.wasp_type)
            elif attr == "MC" and n_mates > 1:
                mops = _cigar_ops(tr, 1 - imate, i_ex_mate, left_mate, res)[0]
                mc = "".join(f"{l}{'MIDNSHP=X'[op]}" for op, l in mops)
                attrs += attr_str("MC", mc)
            elif attr == "ha":
                # diploid-transform haplotype (ReadAlign_alignBAM.cpp:369-372)
                if getattr(P, "_transform_type", 0) == 2:
                    attrs += b"hai" + struct.pack("<i", tr.haploType)
            elif attr == "ch":
                if align_type <= -10:
                    attrs += attr_char("ch", "1")
            else:
                from .sam import solo_attr_value
                v = solo_attr_value(attr, res, i_tr, P)
                if v is not None:
                    attrs += attr_str(attr, v)

        flag_final = (sam_flag & P.outSAMflagAND) | P.outSAMflagOR
        core = struct.pack(
            "<iiIIiiii",
            tr.Chr, pos,
            (reg2bin(pos, end) << 16) | (mapq << 8) | len(name),
            (flag_final << 16) | len(ops),
            len(seq_out), next_ref, next_pos, tlen)
        rec = core + name
        for op, ln in ops:
            rec += struct.pack("<I", (ln << 4) | op)
        rec += pack_seq(seq_out)
        if res.read_file_type == 2 and P.outSAMmode != "NoQS":
            rec += bytes(ord(c) - 33 for c in qual_out)
        else:
            rec += b"\xff" * len(seq_out)
        rec += attrs
        if meta is not None:
            cig = "".join(f"{l}{'MIDNSHP=X'[op]}" for op, l in ops)
            meta.append((tr.Chr, pos, flag_final, cig, mapq,
                         tag_nm if tag_nm is not None else 0))
        out.append((struct.pack("<I", len(rec)) + rec, tr.Chr, pos, imate))
    return out


def encode_chimeric(al1, al2, res, i_tr, chim_n, is_best, gi, P):
    """BAM records for one chimeric alignment pair, with mutual SA tags
    (reference ChimericAlign_chimericBAMoutput.cpp)."""
    tr_chim = [al1, al2]
    chim_represent, chim_type = -999, 0
    if al1.exons[0][3] != al1.exons[-1][3]:
        chim_represent, chim_type = 0, 1
    elif al2.exons[0][3] != al2.exons[-1][3]:
        chim_represent, chim_type = 1, 1
    elif al1.exons[0][3] != al2.exons[0][3]:
        chim_represent, chim_type = -1, 2
    else:
        chim_represent = 0 if al1.maxScore > al2.maxScore else 1
        chim_type = 3

    recs = []
    metas = []
    bam_irepr = bam_isuppl = -1
    for itr in range(2):
        t = tr_chim[itr]
        t.primaryFlag = is_best
        mate_info = None
        if chim_type == 2:
            o = tr_chim[1 - itr]
            mate_info = (o.Chr, o.exons[0][1],
                         int(o.Str != o.exons[0][3]))
            align_type = -10
        elif chim_represent == itr:
            align_type = -10
            bam_irepr = len(recs)
            if t.exons[0][3] != tr_chim[1 - itr].exons[0][3]:
                bam_irepr += 1
        else:
            align_type = ((-12 if itr % 2 == t.Str else -11)
                          if P.chimOutTypeHardClip else -13)
            bam_isuppl = len(recs)
            if chim_type == 1:
                r = tr_chim[chim_represent]
                iex = 0
                while iex < r.nExons - 1 and r.exons[iex][3] == t.exons[0][3]:
                    iex += 1
                mate_info = (r.Chr, r.exons[iex][1],
                             int(r.Str != r.exons[iex][3]))
        out = encode_mapped(t, res, chim_n, i_tr, gi, P,
                            align_type=align_type, mate_info=mate_info,
                            meta=metas)
        recs += out

    final = []
    for ii, (rec, c, p, m) in enumerate(recs):
        tag_i = -1
        if ii == bam_irepr:
            tag_i = bam_isuppl
        elif ii == bam_isuppl:
            tag_i = bam_irepr
        if tag_i >= 0:
            oc, op, ofl, ocig, omq, onm = metas[tag_i]
            sa = (f"{gi.chr_name[oc]},{op + 1},"
                  f"{'-' if ofl & 0x10 else '+'},{ocig},{omq},{onm};")
            body = rec[4:] + attr_str("SA", sa)
            rec = struct.pack("<I", len(body)) + body
        final.append((rec, c, p, m))
    return final


def _sj_arrays(tr, i_ex1, i_ex2, gi, chr_start):
    sj_motif = []
    sj_intron = []
    for ii in range(i_ex1 + 1, i_ex2 + 1):
        if tr.canonSJ[ii - 1] >= 0 or tr.sjAnnot[ii - 1] == 1:
            sj_motif.append(tr.canonSJ[ii - 1]
                            + (0 if tr.sjAnnot[ii - 1] == 0 else SJ_SAM_ANNOTATED_MOTIF_SHIFT))
            sj_intron.append(tr.exons[ii - 1][1] + tr.exons[ii - 1][2] + 1 - chr_start)
            sj_intron.append(tr.exons[ii][1] - chr_start)
    if not sj_motif:
        return [-1], [-1]
    return sj_motif, sj_intron


def encode_unmapped(res, gi, P, mate_mapped) -> List[bytes]:
    tb = res.tr_best
    n_mates = len(res.seqs)
    out = []
    for imate in range(n_mates):
        if mate_mapped[imate]:
            continue
        flag = 0x4
        if n_mates == 2:
            flag |= 0x1 + (0x40 if imate == 0 else 0x80)
            if mate_mapped[1 - imate]:
                if tb.Str != 1 - imate:
                    flag |= 0x20
            else:
                flag |= 0x8
        if mate_mapped[1 - imate] and not tb.primaryFlag and P.outSAMunmappedKeepPairs:
            flag |= 0x100
        name = res.name.encode() + b"\x00"
        if mate_mapped[1 - imate]:
            ref = tb.Chr
            pos = tb.exons[0][1] - int(gi.chr_start[tb.Chr])
        else:
            ref = -1
            pos = -1
        seq = res.seqs[imate]
        attrs = (attr_int("NH", 0) + attr_int("HI", 0)
                 + attr_int("AS", tb.maxScore) + attr_int("nM", tb.nMM)
                 + attr_char("uT", str(res.unmap_type)))
        from .sam import solo_attr_value
        for attr in P.samAttrOrder:
            v = solo_attr_value(attr, res, 0, P)
            if v is not None:
                attrs += attr_str(attr, v)
        core = struct.pack(
            "<iiIIiiii", -1, -1,
            (reg2bin(-1, 0) << 16) | len(name),
            (flag << 16) | 0, len(seq), ref, pos, 0)
        rec = core + name + pack_seq(seq)
        if res.read_file_type == 2:
            rec += bytes(ord(c) - 33 for c in res.quals[imate])
        else:
            rec += b"\xff" * len(seq)
        rec += attrs
        out.append((struct.pack("<I", len(rec)) + rec, 1 << 30, 1 << 30, imate))
    return out


class BamCollector:
    """collects records for unsorted and/or coordinate-sorted output.

    Coordinate sorting uses genome-bin spill (reference: BAMoutput.cpp
    coordBins + BAMbinSortByCoordinate.cpp): records are routed to bins by
    genomic coordinate; a bin whose RAM buffer exceeds the per-bin cap spills
    to a temp file; at finish each bin is loaded, sorted and written in bin
    order — peak RAM is bounded by (bins in flight) x (per-bin cap)."""

    SPILL_BYTES_PER_BIN = 32 << 20

    def __init__(self, gi, P, prefix: str):
        self.gi = gi
        self.P = P
        self.unsorted = BgzfWriter(prefix + "Aligned.out.bam") if P.outBAMunsorted else None
        self.coord = None
        self.coord_path = prefix + "Aligned.sortedByCoord.out.bam"
        if P.outBAMcoord:
            self.n_bins = max(int(getattr(P, "outBAMsortingBinsN", 50)), 2)
            # per-bin RAM cap: honor --limitBAMsortRAM when set (reference
            # bamSortByCoordinate.cpp sizes bins from limitBAMsortRAM)
            lim = int(getattr(P, "limitBAMsortRAM", 0) or 0)
            self.spill_bytes_per_bin = (max(lim // self.n_bins, 1 << 20)
                                        if lim > 0 else self.SPILL_BYTES_PER_BIN)
            g_total = int(gi.chr_start[-1]) + 1
            self.bin_size = max(g_total // (self.n_bins - 1) + 1, 1)
            self.coord = [[] for _ in range(self.n_bins)]
            self._bin_bytes = [0] * self.n_bins
            self._spill_files = [None] * self.n_bins
            self._tmp_dir = prefix + "_STARtmp"
            self._chr_start = gi.chr_start
        hdr = bam_header_bytes(gi, P)
        if self.unsorted:
            self.unsorted.write(hdr)
        self._hdr = bam_header_bytes(gi, P, sorted_coord=True)
        self.i_read = 0

    # ---- spill machinery -------------------------------------------------
    def _bin_of(self, c: int, p: int) -> int:
        if c >= (1 << 30):
            return self.n_bins - 1
        gpos = int(self._chr_start[c]) + p
        return min(gpos // self.bin_size, self.n_bins - 2)

    def _coord_add(self, c, p, key, r):
        b = self._bin_of(c, p)
        self.coord[b].append((c, p, key, r))
        self._bin_bytes[b] += len(r) + 48
        if self._bin_bytes[b] > self.spill_bytes_per_bin:
            self._spill(b)

    def _spill(self, b: int):
        if self._spill_files[b] is None:
            import os
            os.makedirs(self._tmp_dir, exist_ok=True)
            self._spill_files[b] = open(
                f"{self._tmp_dir}/bamsort.bin{b}", "w+b")
        f = self._spill_files[b]
        for (c, p, key, r) in self.coord[b]:
            f.write(struct.pack("<qqqI", c, p, key, len(r)))
            f.write(r)
        self.coord[b] = []
        self._bin_bytes[b] = 0

    def _load_bin(self, b: int):
        recs = self.coord[b]
        f = self._spill_files[b]
        if f is not None:
            f.seek(0)
            spilled = []
            while True:
                hdr = f.read(28)
                if len(hdr) < 28:
                    break
                c, p, key, ln = struct.unpack("<qqqI", hdr)
                spilled.append((c, p, key, f.read(ln)))
            f.close()
            import os
            try:
                os.unlink(f"{self._tmp_dir}/bamsort.bin{b}")
            except OSError:
                pass
            recs = spilled + recs
        recs.sort(key=lambda t: (t[0], t[1], t[2]))
        return recs

    def add_read(self, res):
        P, gi = self.P, self.gi
        self.i_read = getattr(res, "i_read_all", self.i_read)
        recs = []
        if res.unmap_type < 0:
            n_out = min(res.n_tr if P.outSAMmultNmax == -1 else P.outSAMmultNmax, res.n_tr)
            mate_mapped = [False, False]
            for i_tr in range(n_out):
                recs += [(r, c, p, (self.i_read << 16) | (i_tr << 2) | m)
                         for (r, c, p, m) in encode_mapped(
                             res.transcripts[i_tr], res, res.n_tr, i_tr, gi, P)]
            tb = res.tr_best
            mate_mapped[tb.exons[0][3]] = True
            mate_mapped[tb.exons[-1][3]] = True
            if len(res.seqs) > 1 and not all(mate_mapped[:len(res.seqs)]):
                if P.outSAMunmappedWithin:
                    recs += [(r, c, p, (self.i_read << 16) | 0xFFFF)
                             for (r, c, p, m) in encode_unmapped(res, gi, P, mate_mapped)]
        elif P.outSAMunmappedWithin:
            recs += [(r, c, p, (self.i_read << 16) | 0xFFFF)
                     for (r, c, p, m) in encode_unmapped(res, gi, P, [False, False])]
        self.i_read += 1
        for (r, c, p, key) in recs:
            if self.unsorted:
                self.unsorted.write(r)
            if self.coord is not None:
                self._coord_add(c, p, key, r)

    def add_chimeric(self, recs, i_read, i_tr):
        """chimeric records precede the read's normal alignments in the
        unsorted stream (oneRead calls chimericDetection before
        outputAlignments)"""
        for (r, c, p, m) in recs:
            if self.unsorted:
                self.unsorted.write(r)
            if self.coord is not None:
                self._coord_add(c, p, (i_read << 16) | (i_tr << 2) | m, r)

    def finish(self, solo_tags=None):
        """solo_tags: (read_info, wl_str, umi_l) to append CB/UB during the
        coordinate sort (reference SoloFeature_addBAMtags.cpp, hooked in
        BAMbinSortByCoordinate; the unmapped bin gets no tags)"""
        if self.unsorted:
            self.unsorted.close()
        if self.coord is not None:
            w = BgzfWriter(self.coord_path)
            w.write(self._hdr)
            try:
                for b in range(self.n_bins):
                    for (c, _, key, r) in self._load_bin(b):
                        if solo_tags is not None and c < (1 << 30):
                            r = _add_cb_ub(r, key >> 16, *solo_tags)
                        w.write(r)
                    self.coord[b] = []
            finally:
                w.close()
                self._cleanup_spill()

    def _cleanup_spill(self):
        """close leaked spill handles and remove the _STARtmp dir if empty"""
        import os
        for b, f in enumerate(self._spill_files):
            if f is not None and not f.closed:
                f.close()
                try:
                    os.unlink(f"{self._tmp_dir}/bamsort.bin{b}")
                except OSError:
                    pass
            self._spill_files[b] = None
        try:
            os.rmdir(self._tmp_dir)
        except OSError:
            pass  # missing, or other run state still inside

    def __del__(self):
        try:
            if self.coord is not None and any(
                    f is not None for f in self._spill_files):
                self._cleanup_spill()
        except Exception:
            pass


def _add_cb_ub(rec: bytes, iread: int, read_info, wl_str, umi_l) -> bytes:
    info = read_info.get(iread)
    cb = umi = "-"
    if info is not None:
        if info[0] != -1:
            cb = wl_str[info[0]]
        if info[1] != (1 << 32) - 1:
            umi = "".join("ACGT"[(info[1] >> (2 * (umi_l - 1 - i))) & 3]
                          for i in range(umi_l))
    body = rec[4:] + attr_str("CB", cb) + attr_str("UB", umi)
    return struct.pack("<I", len(body)) + body
