"""Signal (wiggle/bedGraph) output from a coordinate-sorted BAM.

Reference behavior: source/signalFromBAM.cpp — per-strand Unique and
UniqueMultiple tracks from CIGAR-projected coverage, RPM normalisation,
bedGraph/wiggle formatting; also serves --runMode inputAlignmentsFromBAM.
"""
from __future__ import annotations

import gzip
import struct
from typing import List


def _iter_bam(path):
    """yield (tid, pos, flag, nh, cigar_ops) per record + (names, lens)"""
    data = gzip.decompress(open(path, "rb").read())
    assert data[:4] == b"BAM\x01"
    lt = struct.unpack("<i", data[4:8])[0]
    off = 8 + lt
    nref = struct.unpack("<i", data[off:off + 4])[0]
    off += 4
    names = []
    lens = []
    for _ in range(nref):
        ln = struct.unpack("<i", data[off:off + 4])[0]
        names.append(data[off + 4:off + 4 + ln - 1].decode())
        off += 4 + ln
        lens.append(struct.unpack("<i", data[off:off + 4])[0])
        off += 4
    recs = []
    while off < len(data):
        sz = struct.unpack("<I", data[off:off + 4])[0]
        rec = data[off + 4:off + 4 + sz]
        off += 4 + sz
        tid, pos, bin_mq_nl, flag_nc, l_seq, _, _, _ = struct.unpack("<iiIIiiii", rec[:32])
        l_name = bin_mq_nl & 0xFF
        n_cigar = flag_nc & 0xFFFF
        flag = flag_nc >> 16
        o = 32 + l_name
        cigar = []
        for i in range(n_cigar):
            v = struct.unpack("<I", rec[o + 4 * i:o + 4 * i + 4])[0]
            cigar.append((v & 0xF, v >> 4))
        o += 4 * n_cigar
        o += (l_seq + 1) // 2 + l_seq
        nh = 1
        while o < len(rec):
            tag = rec[o:o + 2]
            typ = chr(rec[o + 2])
            o += 3
            if typ == "A":
                val = rec[o]; o += 1
            elif typ in "cC":
                val = rec[o]; o += 1
            elif typ in "sS":
                val = struct.unpack("<H", rec[o:o + 2])[0]; o += 2
            elif typ in "iIf":
                val = struct.unpack("<I", rec[o:o + 4])[0]; o += 4
            elif typ == "Z":
                e = rec.index(0, o); val = rec[o:e]; o = e + 1
            elif typ == "B":
                at = chr(rec[o]); n = struct.unpack("<i", rec[o + 1:o + 5])[0]
                w = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[at]
                o += 5 + n * w
                val = None
            else:
                break
            if tag == b"NH":
                nh = val
        recs.append((tid, pos, flag, nh, cigar))
    return names, lens, recs


def signal_from_bam(bam_path: str, out_prefix: str, P):
    stranded = P.outWigStrand == "Stranded"
    wtype = {"bedGraph": 0, "wiggle": 1}.get(P.outWigType[0], 0)
    sub = P.outWigType[1] if len(P.outWigType) > 1 else ""
    sig_type = {"": 0, "read1_5p": 1, "read2": 2}.get(sub, 0)
    norm = 1 if P.outWigNorm == "RPM" else 0
    sig_n = 4 if stranded else 2

    names, lens, recs = _iter_bam(bam_path)

    n_uniq = 0.0
    n_mult = 0.0
    if norm == 1:
        for tid, pos, flag, nh, cigar in recs:
            if tid < 0:
                continue
            if nh == 1:
                n_uniq += 1
            elif nh > 1:
                n_mult += 1.0 / nh
    norm_factor = [1.0, 1.0, 1.0, 1.0]
    if norm == 1:
        norm_factor[0] = 1e6 / n_uniq if n_uniq else 0.0
        norm_factor[1] = 1e6 / (n_uniq + n_mult) if (n_uniq + n_mult) else 0.0
        norm_factor[2] = norm_factor[0]
        norm_factor[3] = norm_factor[1]

    suff = ".bg" if wtype == 0 else ".wig"
    file_names = [out_prefix + ".Unique.str1.out" + suff,
                  out_prefix + ".UniqueMultiple.str1.out" + suff]
    if stranded:
        file_names += [out_prefix + ".Unique.str2.out" + suff,
                       out_prefix + ".UniqueMultiple.str2.out" + suff]
    outs = [open(f, "w") for f in file_names]

    def flush_chr(i_chr, sig, chr_len):
        for i_s in range(sig_n):
            f = outs[i_s]
            if wtype == 1:
                f.write(f"variableStep chrom={names[i_chr]}\n")
            prev = 0.0
            for ig in range(chr_len):
                new = sig[ig * sig_n + i_s]
                if wtype == 0:
                    if new != prev:
                        if prev != 0:
                            f.write(f"{ig}\t{_fmt(prev * norm_factor[i_s], norm)}\n")
                        if new != 0:
                            f.write(f"{names[i_chr]}\t{ig}\t")
                        prev = new
                else:
                    if new != 0:
                        f.write(f"{ig + 1}\t{_fmt(new * norm_factor[i_s], norm)}\n")

    i_chr = -999
    sig = None
    chr_len = 0
    for rec in recs + [(-2, 0, 0, 0, [])]:
        tid, pos, flag, nh, cigar = rec
        if tid != i_chr or tid == -2:
            if i_chr != -999 and i_chr >= 0:
                flush_chr(i_chr, sig, chr_len)
            if tid == -2:
                break
            i_chr = tid
            if i_chr == -1:
                i_chr = -999
                continue
            chr_len = lens[i_chr] + 1
            sig = [0.0] * (sig_n * chr_len)
        if i_chr == -999 or tid < 0:
            continue
        if flag & 0x400:
            continue
        if nh == 0:
            continue
        a_g = pos
        i_strand = 0
        if stranded:
            i_strand = int(((flag & 0x10) > 0) == ((flag & 0x80) == 0))
        if sig_type == 1:
            if flag & 0x80:
                continue
            if i_strand == 0:
                if nh == 1:
                    sig[a_g * sig_n + 0 + 2 * i_strand] += 1
                sig[a_g * sig_n + 1 + 2 * i_strand] += 1.0 / nh
                continue
        for (op, ln) in cigar:
            if op in (2, 3):
                a_g += ln
            elif op == 0:
                if sig_type == 0 or (sig_type == 2 and (flag & 0x80)):
                    for _ in range(ln):
                        if nh == 1:
                            sig[a_g * sig_n + 0 + 2 * i_strand] += 1
                        sig[a_g * sig_n + 1 + 2 * i_strand] += 1.0 / nh
                        a_g += 1
                else:
                    a_g += ln
        if sig_type == 1:
            a_g -= 1
            if nh == 1:
                sig[a_g * sig_n + 0 + 2 * i_strand] += 1
            sig[a_g * sig_n + 1 + 2 * i_strand] += 1.0 / nh
    for f in outs:
        f.close()


def _fmt(x: float, norm: int) -> str:
    if norm == 1:
        return f"{x:.5f}"
    g = f"{x:g}"
    return g
