"""SAM text output.

Field-for-field compatible with the reference emitter
(reference: source/ReadAlign_outputTranscriptSAM.cpp, source/samHeaders.cpp):
CIGAR built from exon blocks (S/M/I/D/N), MAPQ tiers, NH/HI/AS/nM standard
attributes plus NM/MD/jM/jI/XS/MC on request, unmapped records with uT:A:.
"""
from __future__ import annotations

from typing import List, Optional

from ..constants import NUM_TO_NT, SJ_SAM_ANNOTATED_MOTIF_SHIFT
from ..align.engine import ReadResult
from ..align.transcript import Transcript

_RC = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
_RC_TABLE = {i: "N" for i in range(256)}
for _k, _v in _RC.items():
    _RC_TABLE[ord(_k)] = _v


def revcomp_str(s: str) -> str:
    return s.translate(_RC_TABLE)[::-1]


def sam_header(gi, P, cmd_line: str = "", sorted_coord: bool = False) -> str:
    # sorted BAM gets SO:coordinate on @HD (reference samHeaders.cpp:100)
    out = ["@HD\tVN:1.4" + ("\tSO:coordinate" if sorted_coord else "")]
    for name, length in zip(gi.chr_name, gi.chr_length):
        out.append(f"@SQ\tSN:{name}\tLN:{int(length)}")
    from .. import __version__
    pg = f"@PG\tID:STAR\tPN:STAR\tVN:{__version__}"
    if cmd_line:
        pg += f"\tCL:{cmd_line}"
    out.append(pg)
    if cmd_line:
        out.append(f"@CO\tuser command line: {cmd_line}")
    return "\n".join(out) + "\n"


def solo_attr_value(attr: str, res, i_tr: int, P):
    """value for STARsolo SAM attributes (reference ReadAlign_alignBAM.cpp
    ATTR_CR/CY/UR/UY/GX/GN/gx/gn cases); None if not a solo attr"""
    if attr in ("CR", "CY", "UR", "UY"):
        bar = getattr(res, "solo_bar", None)
        if bar is None:
            return None
        return bar[("CR", "CY", "UR", "UY").index(attr)]
    if attr == "CB":
        # corrected CB emitted at alignment time only when defined
        # (CB_samTagOut; reference alignBAM.cpp:469)
        return getattr(res, "cb_corrected", None)
    if attr not in ("GX", "GN", "gx", "gn"):
        return None
    trm = getattr(P, "_solo_trm", None)
    if trm is None:
        return None
    fa = getattr(res, "solo_falign", None) or []
    names = trm.gene_id if attr in ("GX", "gx") else trm.gene_name
    if attr in ("GX", "GN"):
        fs = getattr(res, "solo_fset", None) or set()
        g = -1
        if len(fs) == 1 and i_tr < len(fa) and len(fa[i_tr]) == 1:
            g = next(iter(fa[i_tr]))
        return "-" if g < 0 else names[g]
    gl = sorted(fa[i_tr]) if i_tr < len(fa) else []
    return ";".join(names[g] for g in gl) or "-"


def _mapq(n_tr: int, P) -> int:
    if n_tr >= 5:
        return 0
    if n_tr >= 3:
        return 1
    if n_tr == 2:
        return 3
    return P.outSAMmapqUnique


def write_read_sam(res: ReadResult, gi, P, out: List[str]):
    """emit all SAM lines for one read (mapped or unmapped-within)."""
    n_mates = len(res.seqs)
    if res.unmap_type < 0:
        n_out = min(res.n_tr if P.outSAMmultNmax == -1 else P.outSAMmultNmax, res.n_tr)
        mate_mapped = [False, False]
        for i_tr in range(n_out):
            tr = res.transcripts[i_tr]
            out.append(transcript_sam(tr, res, res.n_tr, i_tr, gi, P))
        tb = res.tr_best
        mate_mapped[tb.exons[0][3]] = True
        mate_mapped[tb.exons[-1][3]] = True
        res.mate_mapped = mate_mapped
        if n_mates > 1 and not (mate_mapped[0] and mate_mapped[1]):
            res.unmap_type = 4
            if P.outSAMunmappedWithin:
                out.append(unmapped_sam(res, gi, P, mate_mapped))
    else:
        res.mate_mapped = [False, False]
        if P.outSAMunmappedWithin:
            out.append(unmapped_sam(res, gi, P, [False, False]))


def unmapped_sam(res: ReadResult, gi, P, mate_mapped) -> str:
    lines = []
    tb = res.tr_best
    n_mates = len(res.seqs)
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
        f = [res.name, str(flag), "*", "0", "0", "*"]
        if mate_mapped[1 - imate]:
            f += [gi.chr_name[tb.Chr], str(int(tb.exons[0][1] + 1 - gi.chr_start[tb.Chr]))]
        else:
            f += ["*", "0"]
        f += ["0", res.seqs[imate],
              res.quals[imate] if res.read_file_type == 2 else "*",
              "NH:i:0", "HI:i:0", f"AS:i:{tb.maxScore}", f"nM:i:{tb.nMM}",
              f"uT:A:{res.unmap_type}"]
        for attr in P.samAttrOrder:
            v = solo_attr_value(attr, res, 0, P)
            if v is not None:
                f.append(f"{attr}:Z:{v}")
        extra = getattr(res, "name_extra", None)
        if P.readFilesTypeN == 10 and extra and extra[imate]:
            # SAM input attributes re-emitted (outputTranscriptSAM.cpp:47-49)
            f.append(extra[imate])
        lines.append("\t".join(f))
    return "\n".join(lines)


_STD_ATTRS = ("NH", "HI", "AS", "nM")


def _transcript_sam_se_fast(tr, res, n_tr_out, i_tr, gi, P) -> str:
    """single-format emitter for the dominant record shape (SE read, standard
    attributes, no flag masking) — same bytes as the general path below"""
    sam_flag = (0x10 if tr.Str else 0) | (0 if tr.primaryFlag else 0x100)
    cigar, _, _ = _cigar(tr, 0, tr.nExons - 1, 0, res, gi, P)
    if tr.Str == 0:
        seq_out = res.seqs[0]
        qual_out = res.quals[0]
    else:
        seq_out = revcomp_str(res.seqs[0])
        qual_out = res.quals[0][::-1]
    if res.read_file_type != 2 or P.outSAMmode == "NoQS":
        qual_out = "*"
    return (f"{res.name}\t{sam_flag}\t{gi.chr_name[tr.Chr]}"
            f"\t{int(tr.exons[0][1] + 1 - gi.chr_start[tr.Chr])}"
            f"\t{_mapq(n_tr_out, P)}\t{cigar}\t*\t0\t0\t{seq_out}\t{qual_out}"
            f"\tNH:i:{n_tr_out}\tHI:i:{i_tr + P.outSAMattrIHstart}"
            f"\tAS:i:{tr.maxScore}\tnM:i:{tr.nMM}")


def transcript_sam(tr: Transcript, res: ReadResult, n_tr_out: int, i_tr: int,
                   gi, P, mate_chr=None, mate_start=None, mate_strand=0) -> str:
    if (mate_chr is None and len(res.seqs) == 1
            and tuple(P.samAttrOrder) == _STD_ATTRS
            and P.readFilesTypeN != 10
            and P.outSAMflagAND == 65535 and P.outSAMflagOR == 0):
        return _transcript_sam_se_fast(tr, res, n_tr_out, i_tr, gi, P)
    n_mates_read = len(res.seqs)
    flag_paired = n_mates_read == 2
    lread = res.lread
    read_length = res.read_length

    # split exons into mates at the -3 junction
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
            if mate_chr is None or mate_chr > gi.n_chr_real:
                sam_flag_common += 0x8
        else:
            if (P.alignEndsProtrudeConcordant
                or (tr.exons[0][1] <= tr.exons[i_ex_mate + 1][1] + tr.exons[0][0]
                    and tr.exons[i_ex_mate][1] + tr.exons[i_ex_mate][2]
                    <= tr.exons[-1][1] + lread - tr.exons[-1][0])):
                sam_flag_common += 0x2

    Str = tr.Str
    left_mate = Str if flag_paired else 0

    lines = []
    mate_cigars = [None, None]
    if "MC" in P.samAttrOrder and n_mates > 1:
        for imate in range(n_mates):
            mate_cigars[imate] = _cigar(tr, imate, i_ex_mate, left_mate, res, gi, P)[0]

    for imate in range(n_mates):
        sam_flag = sam_flag_common
        i_ex1 = 0 if imate == 0 else i_ex_mate + 1
        i_ex2 = i_ex_mate if imate == 0 else tr.nExons - 1
        mate = tr.exons[i_ex1][3]
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
            if n_mates == 1 and mate_strand == 1:
                sam_flag |= 0x20
        if not tr.primaryFlag:
            sam_flag |= 0x100

        cigar, sj_motif, sj_intron = _cigar(tr, imate, i_ex_mate, left_mate, res, gi, P)

        if mate == Str:
            seq_out = res.seqs[mate]
            qual_out = res.quals[mate]
        else:
            seq_out = revcomp_str(res.seqs[mate])
            qual_out = res.quals[mate][::-1]

        mapq = _mapq(n_tr_out, P)
        pos = int(tr.exons[i_ex1][1] + 1 - gi.chr_start[tr.Chr])
        f = [res.name, str((sam_flag & P.outSAMflagAND) | P.outSAMflagOR),
             gi.chr_name[tr.Chr], str(pos), str(mapq), cigar]
        if n_mates > 1:
            other = i_ex_mate + 1 if imate == 0 else 0
            mate_pos = int(tr.exons[other][1] + 1 - gi.chr_start[tr.Chr])
            tlen = int(tr.exons[-1][1] + tr.exons[-1][2] - tr.exons[0][1])
            f += ["=", str(mate_pos), ("" if imate == 0 else "-") + str(tlen)]
        elif mate_chr is not None and mate_chr < gi.n_chr_real:
            f += [gi.chr_name[mate_chr], str(int(mate_start + 1 - gi.chr_start[mate_chr])), "0"]
        else:
            f += ["*", "0", "0"]
        f.append(seq_out)
        f.append(qual_out if (res.read_file_type == 2 and P.outSAMmode != "NoQS") else "*")

        tag_nm, tag_md = (None, None)
        if "NM" in P.samAttrOrder or "MD" in P.samAttrOrder:
            tag_nm, tag_md = _nm_md(tr, i_ex1, i_ex2, res, gi)

        for attr in P.samAttrOrder:
            if attr == "NH":
                f.append(f"NH:i:{n_tr_out}")
            elif attr == "HI":
                f.append(f"HI:i:{i_tr + P.outSAMattrIHstart}")
            elif attr == "AS":
                f.append(f"AS:i:{tr.maxScore}")
            elif attr == "nM":
                f.append(f"nM:i:{tr.nMM}")
            elif attr == "jM":
                f.append(f"jM:B:c{sj_motif}")
            elif attr == "jI":
                f.append(f"jI:B:i{sj_intron}")
            elif attr == "XS":
                if tr.sjMotifStrand == 1:
                    f.append("XS:A:+")
                elif tr.sjMotifStrand == 2:
                    f.append("XS:A:-")
            elif attr == "NM":
                f.append(f"NM:i:{tag_nm}")
            elif attr == "MD":
                f.append(f"MD:Z:{tag_md}")
            elif attr == "MC":
                if n_mates > 1:
                    f.append(f"MC:Z:{mate_cigars[1 - imate]}")
            elif attr == "ha":
                # diploid-transform haplotype (outputTranscriptSAM.cpp:319-322)
                if getattr(P, "_transform_type", 0) == 2:
                    f.append(f"ha:i:{tr.haploType}")
            else:
                v = solo_attr_value(attr, res, i_tr, P)
                if v is not None:
                    f.append(f"{attr}:Z:{v}")
        extra = getattr(res, "name_extra", None)
        if P.readFilesTypeN == 10 and extra and extra[mate]:
            # SAM input: the input line's attributes are re-emitted verbatim
            # (reference outputTranscriptSAM.cpp:351-353)
            f.append(extra[mate])
        lines.append("\t".join(f))
    return "\n".join(lines)


def clip_trim_l(tr, mate: int, res) -> int:
    """left-side trim from clipping (reference outputTranscriptSAM.cpp:135-143)"""
    clips = getattr(res, "clips", None)
    if clips is None:
        return 0
    if tr.Str == 0:
        return clips[mate][0] if mate == 0 else clips[mate][1]
    return clips[mate][1] if mate == 0 else clips[mate][0]


def _cigar(tr: Transcript, imate: int, i_ex_mate: int, left_mate: int, res, gi, P):
    read_length = res.read_length
    read_length_orig = getattr(res, "read_length_original", None) or read_length
    i_ex1 = 0 if imate == 0 else i_ex_mate + 1
    i_ex2 = i_ex_mate if imate == 0 else tr.nExons - 1
    mate = tr.exons[i_ex1][3]
    parts = []
    sj_motif = []
    sj_intron = []
    trim_l = clip_trim_l(tr, mate, res)
    trim_l1 = trim_l + tr.exons[i_ex1][0] - (
        0 if tr.exons[i_ex1][0] < read_length[left_mate] else read_length[left_mate] + 1)
    if trim_l1 > 0:
        parts.append(f"{trim_l1}S")
    for ii in range(i_ex1, i_ex2 + 1):
        if ii > i_ex1:
            gap_g = tr.exons[ii][1] - (tr.exons[ii - 1][1] + tr.exons[ii - 1][2])
            gap_r = tr.exons[ii][0] - tr.exons[ii - 1][0] - tr.exons[ii - 1][2]
            if gap_r > 0:
                parts.append(f"{gap_r}I")
            if tr.canonSJ[ii - 1] >= 0 or tr.sjAnnot[ii - 1] == 1:
                parts.append(f"{gap_g}N")
                sj_motif.append(tr.canonSJ[ii - 1]
                                + (0 if tr.sjAnnot[ii - 1] == 0 else SJ_SAM_ANNOTATED_MOTIF_SHIFT))
                sj_intron.append(int(tr.exons[ii - 1][1] + tr.exons[ii - 1][2] + 1
                                     - gi.chr_start[tr.Chr]))
                sj_intron.append(int(tr.exons[ii][1] - gi.chr_start[tr.Chr]))
            elif gap_g > 0:
                parts.append(f"{gap_g}D")
        parts.append(f"{tr.exons[ii][2]}M")
    trim_r1 = (read_length_orig[left_mate]
               if tr.exons[i_ex1][0] < read_length[left_mate]
               else read_length[left_mate] + 1 + read_length_orig[mate]) \
        - tr.exons[i_ex2][0] - tr.exons[i_ex2][2] - trim_l
    if trim_r1 > 0:
        parts.append(f"{trim_r1}S")
    if sj_motif:
        motif_s = "".join(f",{m}" for m in sj_motif)
        intron_s = ""
        for a in range(0, len(sj_intron), 2):
            intron_s += f",{sj_intron[a]},{sj_intron[a+1]}"
    else:
        motif_s = ",-1"
        intron_s = ",-1"
    return "".join(parts), motif_s, intron_s


def _nm_md(tr: Transcript, i_ex1: int, i_ex2: int, res, gi):
    """NM/MD tags from base-level comparison (reference lines 242-276)."""
    from ..constants import encode_seq, COMPLEMENT
    import numpy as np
    # rebuild combined numeric read (clipped frame) in the transcript's strand
    clips = getattr(res, "clips", [[0, 0], [0, 0]])
    seqs = [s[clips[i][0]:len(s) - clips[i][1]]
            for i, s in enumerate(res.seqs)]
    mates = [encode_seq(s) for s in seqs]
    from ..constants import MARK_FRAG_SPACER_BASE
    if len(mates) == 2:
        comb = np.concatenate([mates[0], np.array([MARK_FRAG_SPACER_BASE], np.int8),
                               np.array(COMPLEMENT, dtype=np.int8)[mates[1]][::-1]])
    else:
        comb = mates[0]
    if tr.roStr != 0:
        lut = np.array(COMPLEMENT + (0,) * 6 + (MARK_FRAG_SPACER_BASE,), dtype=np.int8)
        comb = lut[comb[::-1]]
    G = gi.G
    tag_nm = 0
    md = []
    match_n = 0
    for iex in range(i_ex1, i_ex2 + 1):
        r0, g0, ln = tr.exons[iex][0], tr.exons[iex][1], tr.exons[iex][2]
        for ii in range(ln):
            r1 = comb[r0 + ii]
            g1 = G[g0 + ii]
            if r1 != g1 or r1 == 4 or g1 == 4:
                tag_nm += 1
                md.append(str(match_n))
                md.append(NUM_TO_NT[g1])
                match_n = 0
            else:
                match_n += 1
        if iex < i_ex2:
            if tr.canonSJ[iex] == -1:
                tag_nm += tr.exons[iex + 1][1] - (g0 + ln)
                md.append(str(match_n) + "^")
                for g in range(g0 + ln, tr.exons[iex + 1][1]):
                    md.append(NUM_TO_NT[G[g]])
                match_n = 0
            elif tr.canonSJ[iex] == -2:
                tag_nm += tr.exons[iex + 1][0] - r0 - ln
    md.append(str(match_n))
    return tag_nm, "".join(md)
