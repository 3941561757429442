"""The judge of a bulk RNA-seq mapping job: Aligned.out.bam, SJ.out.tab and
Aligned.toTranscriptome.out.bam, held against the genome, the annotation
and the reads that were fed in.

It is a checker, not a second aligner.  It re-derives from the raw FASTA and
GTF (reference/genome.py) and the reads everything an answer can be judged
by, and compares:

  reads_missing   reads fed in the window without a record in the BAM, plus
                  records of reads never fed (Unmapped Within: every read
                  has one)
  bad_records     records whose SEQ/QUAL are not the read's, whose CIGAR does
                  not cover the read, whose AS, NM or MD differ from the
                  score, edit distance and mismatch string of that alignment
                  on the genome under STAR's scoring (annotated junctions
                  +sjdbScore, motif penalties, indel penalties, the
                  log2-genomic-length term), whose NH/HI/MAPQ/primary flag
                  disagree with the read's other records, whose score lies
                  out of the multimapper score range, or whose best alignment
                  fails the output filters; under --clipAdapterType
                  CellRanger4 also records whose soft clips leave any base
                  of the read's clip aligned (reference/cr4_clip.py worked
                  out from the read), the filters then measuring the read
                  without its clip
  missed_pct      of the reads whose true origin (the generator's blocks)
                  passes the output filters, the share (%) that came out
                  unmapped (other than as too many loci) or whose best AS is
                  below the true alignment's score
  sj_rows_diff    rows of SJ.out.tab not equal to the reference's: the
                  junctions of the BAM's alignments collapsed over reads
                  (unique / multi counts, largest overhang, motif from the
                  genome, annotation from the GTF) and filtered by the
                  outSJfilter* rules
  genecounts_diff lines of ReadsPerGene.out.tab not equal to the reference's
                  htseq-count (union) counts of the BAM's unique alignments
                  over the annotation's exons, in the three strandedness
                  columns, with the unmapped, multimapping, no-feature and
                  ambiguous lines (--quantMode GeneCounts)
  trsam_diff      reads whose Aligned.toTranscriptome.out.bam records differ
                  from the projections of their genomic alignments onto the
                  annotation's transcripts (indels banned, soft clips
                  extended, NH = the count, one primary)
"""
from __future__ import annotations

import math
import os
from collections import defaultdict

import numpy as np

from .bam import read_bam
from .cr4_clip import clips
from .genome import encode, motif
from .star_params import Scoring, parse

COMP = str.maketrans("ACGTN", "TGCAN")
MD_BASE = "ACGTN"


def revcomp(s: str) -> str:
    return s.translate(COMP)[::-1]


def cigar_blocks(cigar, g0):
    """(blocks [(g, q, n)], gaps {index of the following block: (op, n)},
    query length, left clip, right clip)"""
    blocks, gaps = [], {}
    q, g, lc, rc = 0, g0, 0, 0
    for i, (op, n) in enumerate(cigar):
        if op == "S":
            if blocks:
                rc = n
            else:
                lc = n
            q += n
        elif op in "M=X":
            blocks.append((g, q, n))
            q += n
            g += n
        elif op == "I":
            gaps[len(blocks)] = ("I", n)
            q += n
        elif op in "DN":
            gaps[len(blocks)] = (op, n)
            g += n
        else:
            raise ValueError(f"CIGAR op {op}")
    return blocks, gaps, q, lc, rc


class Scored:
    __slots__ = ("score", "nm", "md", "n_mm", "n_match", "mapped", "junctions")


def score(read, blocks, gaps, G, sjdb, sc) -> Scored:
    """STAR's score, NM and MD of an alignment of the read (codes, forward
    orientation), and its junctions [(start, end, overhang)]"""
    out = Scored()
    s = nm = n_mm = n_match = mapped = 0
    md, run = [], 0
    junctions = []
    for bi, (g, q, n) in enumerate(blocks):
        if bi in gaps:
            op, ln = gaps[bi]
            pg, _, pn = blocks[bi - 1]
            if op == "I":
                s += sc.ins_open + sc.ins_base * ln
                nm += ln
            elif op == "D":
                s += sc.del_open + sc.del_base * ln
                nm += ln
                md.append(f"{run}^" + "".join(MD_BASE[x] for x in G[pg + pn:g]))
                run = 0
            else:
                a, b = pg + pn, g - 1
                if (a, b) in sjdb:
                    s += sc.sjdb
                else:
                    s += sc.gap + sc.pen[motif(G, a, b)]
                junctions.append((a, b, min(pn, n)))
        r = read[q:q + n]
        gg = G[g:g + n]
        valid = (r < 4) & (gg < 4)
        eq = (r == gg) & valid
        k_eq = int(eq.sum())
        k_mm = int((valid & ~eq).sum())
        s += k_eq - k_mm
        n_match += k_eq
        n_mm += k_mm
        mapped += n
        prev = 0
        for k in np.nonzero(~eq)[0]:
            md.append(f"{run + k - prev}{MD_BASE[gg[k]]}")
            run = 0
            prev = k + 1
            nm += 1
        run += n - prev
    md.append(str(run))
    if sc.log2scale != 0:
        glen = blocks[-1][0] + blocks[-1][2] - blocks[0][0]
        s += int(math.ceil(math.log2(max(glen, 1)) * sc.log2scale - 0.5))
    out.score = max(0, s)
    out.nm, out.md, out.n_mm, out.n_match = nm, "".join(md), n_mm, n_match
    out.mapped, out.junctions = mapped, junctions
    return out


def _mapq(nh, unique):
    return unique if nh == 1 else 3 if nh == 2 else 1 if nh <= 4 else 0


def passes_filters(sc_, L, p):
    """STAR's mapped-read filters (ReadAlign_mappedFilter) on a best
    alignment"""
    mm_max = min(p["outFilterMismatchNmax"][0],
                 int(p["outFilterMismatchNoverReadLmax"][0] * L))
    return (sc_.score >= p["outFilterScoreMin"][0]
            and sc_.score >= int(p["outFilterScoreMinOverLread"][0] * (L - 1))
            and sc_.n_match >= p["outFilterMatchNmin"][0]
            and sc_.n_match >= int(p["outFilterMatchNminOverLread"][0] * (L - 1))
            and sc_.n_mm <= mm_max
            and (sc_.mapped == 0
                 or sc_.n_mm / sc_.mapped <= p["outFilterMismatchNoverLmax"][0]))


class Judge:
    """judges the alignments of one job; `reads` maps each fed read's name
    to (sequence, quality) of its aligned mate"""

    def __init__(self, genome, flags):
        self.G = genome
        self.p = parse(flags)
        self.sc = Scoring(self.p)
        self.notes = []
        self.cr4 = self.p.get("clipAdapterType", ["Hamming"])[0] == "CellRanger4"
        self._clips = None

    def clip_of(self, reads):
        """{name: (5' clip, 3' clip)} of the reads' aligned mates under the
        CellRanger4 clip (none otherwise)"""
        if self._clips is None:
            names = list(reads)
            got = clips([reads[n][0] for n in names]) if self.cr4 else \
                [(0, 0)] * len(names)
            self._clips = dict(zip(names, got))
        return self._clips

    def note(self, msg):
        if len(self.notes) < 20:
            self.notes.append(msg)

    def alignments(self, bam_path, reads, extra_check=None):
        """records by read; counts reads missing and bad records.  Returns
        (by read {name: [(record, Scored, blocks, gaps, lc, rc)]}, reads
        missing, bad records, best scores {name: score or "u" + uT}).
        Without --outSAMunmapped Within an unmapped read has no record: a
        fed read without one is then unmapped, not missing.
        extra_check(name, record) returns what is wrong with a record's
        other tags, or None."""
        names, _, recs = read_bam(bam_path)
        offs = [int(self.G.offset[self.G.index[n]]) for n in names]
        by = defaultdict(list)
        for r in recs:
            by[r.name].append(r)
        p, sc, G = self.p, self.sc, self.G
        within = "Within" in p.get("outSAMunmapped", [])
        attrs = set(p.get("outSAMattributes", ["NH", "HI", "AS", "nM"]))
        clip = self.clip_of(reads)
        missing = sum(1 for n in by if n not in reads)
        if within:
            missing += sum(1 for n in reads if n not in by)
        bad = 0
        mapped = {}
        best = {n: "u-" for n in reads if n not in by}
        for name, rs in by.items():
            if name not in reads:
                continue
            seq, qual = reads[name][:2]
            L = len(seq)
            um = [r for r in rs if r.flag & 4]
            mp = [r for r in rs if not r.flag & 4]
            if um and mp or len(um) > 1:
                bad += len(rs)
                self.note(f"{name}: mapped and unmapped records")
                continue
            if um:
                r = um[0]
                ok = (r.seq == seq and r.qual == qual.encode()
                      and r.tags.get("uT") in tuple("01234")
                      and r.tags.get("NH") == 0)
                if not ok:
                    bad += 1
                    self.note(f"{name}: bad unmapped record")
                best[name] = "u" + str(r.tags.get("uT"))
                continue
            nh = len(mp)
            got = []
            read_f = encode(seq)
            read_r = encode(revcomp(seq))
            for r in mp:
                rev = bool(r.flag & 16)
                want_seq = revcomp(seq) if rev else seq
                want_q = (qual[::-1] if rev else qual).encode()
                blocks, gaps, qlen, lc, rc = cigar_blocks(r.cigar, offs[r.ref] + r.pos)
                why = None
                if r.seq != want_seq or r.qual != want_q:
                    why = "SEQ/QUAL"
                elif qlen != L or not blocks:
                    why = "CIGAR length"
                elif lc < clip[name][rev] or rc < clip[name][not rev]:
                    # the 5' clip is on the left of a forward record
                    why = f"soft clips {lc}S/{rc}S short of the clip {clip[name]}"
                if why is None:
                    s_ = score(read_r if rev else read_f, blocks, gaps, G.seq,
                               G.sjdb, sc)
                    t = r.tags
                    want = {"AS": s_.score, "NM": s_.nm, "MD": s_.md,
                            "nM": s_.n_mm, "NH": nh}
                    diff = [k for k in want if k in attrs
                            and t.get(k) != want[k]]
                    if diff:
                        why = "tags " + ", ".join(
                            f"{k} {t.get(k)} != {want[k]}" for k in diff)
                    elif r.mapq != _mapq(nh, p["outSAMmapqUnique"][0]):
                        why = "MAPQ"
                    elif extra_check is not None:
                        why = extra_check(name, r)
                if why is not None:
                    bad += 1
                    self.note(f"{name}: {why}")
                    continue
                got.append((r, s_, blocks, gaps, lc, rc))
            if len(got) != nh:
                continue
            top = max(x[1].score for x in got)
            prim = [x for x in got if not x[0].flag & 256]
            his = sorted(x[0].tags.get("HI") for x in got)
            why = None
            if his != list(range(1, nh + 1)):
                why = "HI"
            elif len(prim) != 1 or prim[0][1].score != top:
                why = "primary"
            elif any(x[1].score < top - p["outFilterMultimapScoreRange"][0]
                     for x in got):
                why = "score range"
            elif nh > p["outFilterMultimapNmax"][0]:
                why = "NH over outFilterMultimapNmax"
            elif not passes_filters(prim[0][1], L - sum(clip[name]), p):
                why = "output filters"
            if why:
                bad += nh
                self.note(f"{name}: {why}")
                continue
            mapped[name] = got
            best[name] = top
        return mapped, missing, bad, best

    # ------------------------------------------------------------ truth
    def missed(self, truth, reads, best, unrecorded_missed=False):
        """(share % of the judged reads the job missed, reads judged).  A
        read is judged where its true alignment is one STAR may report:
        it passes the output filters, every junction's flanking blocks
        reach the overhang minimum (alignSJDBoverhangMin where annotated,
        alignSJoverhangMin where not).  Under the CellRanger4 clip the true
        alignment is cut to the bases that the clip leaves, and the filters
        measure the read without its clip.  A read without a record (no
        --outSAMunmapped Within) counts as missed where unrecorded_missed."""
        n = miss = 0
        sc, G, p = self.sc, self.G, self.p
        clip = self.clip_of(reads)
        oh_db, oh_new = p["alignSJDBoverhangMin"][0], p["alignSJoverhangMin"][0]
        for name, (kind, _c, fwd, blocks) in ((n_, t[:4]) for n_, t in
                                              truth.items()):
            if name not in reads or name not in best:
                continue
            seq = reads[name][0]
            fseq = seq if fwd else revcomp(seq)
            L = len(seq)
            c5, c3 = clip[name]
            lo, hi = (c5, L - c3) if fwd else (c3, L - c5)
            bl = []
            for g, q, ln in blocks:
                a, b = max(int(q), lo), min(int(q) + int(ln), hi)
                if b > a:
                    bl.append((int(g) + a - int(q), a, b - a))
            if not bl:
                continue
            gaps = {}
            short = False
            for i in range(1, len(bl)):
                pg, pq, pn = bl[i - 1]
                g, q, ln = bl[i]
                if q > pq + pn:
                    gaps[i] = ("I", q - pq - pn)
                elif g - pg - pn >= sc.intron_min:
                    gaps[i] = ("N", g - pg - pn)
                    need = oh_db if (pg + pn, g - 1) in G.sjdb else oh_new
                    short |= min(pn, ln) < need
                elif g > pg + pn:
                    gaps[i] = ("D", g - pg - pn)
            if short:
                continue
            t = score(encode(fseq), bl, gaps, G.seq, G.sjdb, sc)
            if not passes_filters(t, L - c5 - c3, p):
                continue
            n += 1
            b = best[name]
            if (isinstance(b, str) and b != "u3"
                    and (b != "u-" or unrecorded_missed)) or (
                    not isinstance(b, str) and b < t.score):
                miss += 1
                if miss <= 5:
                    self.note(f"{name} ({kind}): best {b} < truth {t.score}")
        return (100.0 * miss / n if n else 0.0), n

    # ------------------------------------------------------------ SJ.out.tab
    def sj_rows_diff(self, path, mapped):
        """rows of SJ.out.tab that differ from the reference's"""
        p, G = self.p, self.G
        rec = {}
        for name, got in mapped.items():
            nh = len(got)
            seen = {}
            for x in got:
                for a, b, oh in x[1].junctions:
                    seen[(a, b)] = max(seen.get((a, b), 0), oh)
            for key, oh in seen.items():
                r = rec.setdefault(key, [0, 0, 0])
                r[0 if nh == 1 else 1] += 1
                r[2] = max(r[2], oh)
        rows = []
        for (a, b), (nu, nm_, oh) in sorted(rec.items()):
            mo = motif(G.seq, a, b)
            ann = int((a, b) in G.sjdb)
            mc = (mo + 1) // 2
            n = nu + nm_
            imv = p["outSJfilterIntronMaxVsReadN"]
            keep = ann or (
                (nu >= p["outSJfilterCountUniqueMin"][mc]
                 or n >= p["outSJfilterCountTotalMin"][mc])
                and oh >= p["outSJfilterOverhangMin"][mc]
                and (n > len(imv) or b - a + 1 <= imv[min(n, len(imv)) - 1]))
            if keep:
                rows.append([a, b, mo, ann, nu, nm_, oh])
        if p["outFilterType"][0] != "BySJout" and rows:
            dmin = p["outSJfilterDistToOtherSJmin"]
            n = len(rows)
            keep = [True] * n
            don = [r[0] for r in rows]
            for i, r in enumerate(rows):
                x1 = don[i - 1] if i > 0 else 0
                x2 = don[i + 1] if i + 1 < n else 1 << 62
                keep[i] = min(r[0] - x1, x2 - r[0]) >= dmin[(r[2] + 1) // 2]
            acc = sorted(range(n), key=lambda i: rows[i][1])
            pos = [rows[i][1] + 1 for i in acc]
            for j, i in enumerate(acc):
                if rows[i][3]:
                    keep[i] = True
                    continue
                x1 = pos[j - 1] if j > 0 else 0
                x2 = pos[j + 1] if j + 1 < n else 1 << 62
                keep[i] = keep[i] and min(pos[j] - x1, x2 - pos[j]) >= \
                    dmin[(rows[i][2] + 1) // 2]
            rows = [r for r, k in zip(rows, keep) if k]
        want = set()
        for a, b, mo, ann, nu, nm_, oh in rows:
            c = G.chrom_of(a)
            o = int(G.offset[c])
            strand = 0 if mo == 0 else (mo + 1) % 2 + 1
            want.add((G.names[c], a - o + 1, b - o + 1, strand, mo, ann, nu,
                      nm_, oh))
        have = set()
        with open(path) as f:
            for line in f:
                c = line.rstrip("\n").split("\t")
                have.add((c[0], *(int(x) for x in c[1:9])))
        diff = want ^ have
        for d in sorted(diff)[:3]:
            self.note(f"SJ.out.tab: {'missing' if d in want else 'extra'} {d}")
        return len(diff)

    # --------------------------------------------- Aligned.toTranscriptome.out.bam
    def _tx_tables(self):
        if getattr(self, "_tx", None) is None:
            G = self.G
            rows = []
            for t in G.tx_id:
                _gid, strand, ex = G.tx[t]
                cum = np.concatenate([[0], np.cumsum([b - a for a, b in ex])])
                rows.append((ex[0][0], ex[-1][1], t, strand, ex, cum))
            rows.sort(key=lambda r: r[0])
            self._tx = rows
            self._tx_s = np.array([r[0] for r in rows], np.int64)
        return self._tx, self._tx_s

    def project(self, seq, x):
        """transcript records [(transcript, pos, reverse)] of one genomic
        alignment x, as STAR's quantTranscriptome would write them"""
        r, s_, blocks, gaps, lc, rc = x
        if any(op in "ID" for op, _ in gaps.values()):
            return []
        p, G = self.p, self.G
        L = len(seq)
        rev = bool(r.flag & 16)
        read = encode(revcomp(seq) if rev else seq)
        extra = 0
        bl = [list(b) for b in blocks]
        g0 = bl[0][0]
        for b in range(1, lc + 1):
            rr, gg = read[lc - b], G.seq[g0 - b]
            extra += int(rr != gg and rr < 4 and gg < 4)
        ge = bl[-1][0] + bl[-1][2]
        for b in range(rc):
            rr, gg = read[L - rc + b], G.seq[ge + b]
            extra += int(rr != gg and rr < 4 and gg < 4)
        mm_max = min(p["outFilterMismatchNmax"][0],
                     int(p["outFilterMismatchNoverReadLmax"][0] * L))
        if s_.n_mm + extra > min(mm_max, int(p["outFilterMismatchNoverLmax"][0]
                                              * (L - 1))):
            return []
        bl[0][0] -= lc
        bl[0][2] += lc
        bl[-1][2] += rc
        start, last = bl[0][0], bl[-1][0]
        tx, tx_s = self._tx_tables()
        out = []
        for k in range(int(np.searchsorted(tx_s, start, side="right"))):
            t0, t1, tid, strand, ex, cum = tx[k]
            if last > t1 - 1:
                continue
            e = 0
            while e < len(ex) and not (ex[e][0] <= start <= ex[e][1] - 1):
                e += 1
            if e == len(ex):
                continue
            tpos = start - ex[e][0] + int(cum[e])
            ok = True
            for i, (g, _q, n) in enumerate(bl):
                if g + n > ex[e][1]:
                    ok = False
                    break
                if i + 1 < len(bl):
                    if g + n == ex[e][1] and e + 1 < len(ex) \
                            and bl[i + 1][0] == ex[e + 1][0]:
                        e += 1
                    else:
                        ok = False
                        break
            if not ok:
                continue
            if strand == "+":
                out.append((tid, tpos, rev))
            else:
                out.append((tid, int(cum[-1]) - tpos - L, not rev))
        return out

    def trsam_diff(self, path, mapped, reads):
        """reads whose transcriptome records differ from the reference's"""
        names, _, recs = read_bam(path)
        have = defaultdict(list)
        for r in recs:
            have[r.name].append((names[r.ref], r.pos, bool(r.flag & 16),
                                 not r.flag & 256, r.tags.get("NH")))
        nh_bad = {name for name, rs in have.items()
                  if sum(z[3] for z in rs) != 1
                  or any(z[4] != len(rs) for z in rs)}
        diff = 0
        for name in set(have) | set(mapped):
            want = []
            for x in mapped.get(name, []):
                want += self.project(reads[name][0], x)
            got = [z[:3] for z in have.get(name, [])]
            if sorted(want) != sorted(got) or name in nh_bad:
                diff += 1
                if diff <= 3:
                    self.note(f"trsam {name}: {sorted(got)} != {sorted(want)}")
        return diff


def genecounts_diff(J, path, mapped, n_unmapped):
    """lines of ReadsPerGene.out.tab that differ from the reference's"""
    G = J.G
    ex = sorted((a, b, strand, gid) for t in G.tx_id
                for gid, strand, exs in [G.tx[t]] for a, b in exs)
    ex_s = np.array([e[0] for e in ex], np.int64)
    ex_emax = np.maximum.accumulate(np.array([e[1] for e in ex], np.int64))
    counts = defaultdict(lambda: [0, 0, 0])
    none, ambig, multi = [0, 0, 0], [0, 0, 0], 0
    for name, got in mapped.items():
        if len(got) > 1:
            multi += 1
            continue
        r, _s, blocks = got[0][:3]
        rstr = 1 if r.flag & 16 else 0
        genes = [set(), set(), set()]
        for g, _q, n in blocks:
            k = int(np.searchsorted(ex_s, g + n - 1, side="right")) - 1
            while k >= 0 and ex_emax[k] > g:
                a, b, strand, gid = ex[k]
                if b > g:
                    es = 0 if strand == "+" else 1
                    genes[0].add(gid)
                    (genes[1] if es == rstr else genes[2]).add(gid)
                k -= 1
        for i in range(3):
            if not genes[i]:
                none[i] += 1
            elif len(genes[i]) > 1:
                ambig[i] += 1
            else:
                counts[next(iter(genes[i]))][i] += 1
    want = {"N_unmapped": [n_unmapped] * 3, "N_multimapping": [multi] * 3,
            "N_noFeature": none, "N_ambiguous": ambig}
    for gid in G.genes:
        want[gid] = counts[gid] if gid in counts else [0, 0, 0]
    have = {}
    with open(path) as f:
        for line in f:
            c = line.rstrip("\n").split("\t")
            have[c[0]] = [int(x) for x in c[1:4]]
    diff = [k for k in set(want) | set(have) if want.get(k) != have.get(k)]
    for k in sorted(diff)[:3]:
        J.note(f"ReadsPerGene {k}: {have.get(k)} != {want.get(k)}")
    return len(diff)


def check(ctx):
    """[(name, value, limit)] of one bulk job; ctx: genome (RefGenome),
    flags, out_dir, reads {name: (seq, qual)}, truth {name: (kind, chr,
    forward, blocks)}, limits {name: limit}"""
    J = Judge(ctx["genome"], ctx["flags"])
    out = ctx["out_dir"]
    reads, lim = ctx["reads"], ctx["limits"]
    bam = os.path.join(out, "Aligned.out.bam")
    mapped, missing, bad, best = J.alignments(bam, reads)
    res = [("reads_missing", missing, lim["reads_missing"]),
           ("bad_records", bad, lim["bad_records"])]
    miss, n_truth = J.missed(ctx["truth"], reads, best)
    res.append(("missed_pct", miss, lim["missed_pct"]))
    res.append(("sj_rows_diff", J.sj_rows_diff(os.path.join(out, "SJ.out.tab"),
                                               mapped), lim["sj_rows_diff"]))
    if "GeneCounts" in J.p["quantMode"]:
        n_unmapped = sum(1 for b in best.values() if isinstance(b, str))
        res.append(("genecounts_diff", genecounts_diff(
            J, os.path.join(out, "ReadsPerGene.out.tab"), mapped, n_unmapped),
            lim["genecounts_diff"]))
    tr = os.path.join(out, "Aligned.toTranscriptome.out.bam")
    if "TranscriptomeSAM" in J.p["quantMode"]:
        res.append(("trsam_diff", J.trsam_diff(tr, mapped, reads),
                    lim["trsam_diff"]))
    ctx["notes"] = J.notes
    ctx["counts"] = {"reads": len(reads), "mapped": len(mapped),
                     "truth_judged": n_truth}
    return res
