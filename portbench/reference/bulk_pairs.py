"""The judge of a paired-end bulk RNA-seq mapping job: Aligned.out.bam (or
Aligned.out.sam), SJ.out.tab, Aligned.toTranscriptome.out.bam and
Aligned.sortedByCoord.out.bam, held against the genome, the annotation and
the pairs that were fed in.

It extends bulk_alignments.py's single-end judge (its scoring, filters,
SJ.out.tab and transcript tables) to pairs by STAR 2.7.11b's rules: a pair is
one read of two mates joined by a mate gap, its alignment one transcript of
both mates' blocks.  It imports nothing of the aligner.

  reads_missing   pairs fed in the window without a record of each mate
                  (Unmapped Within: every mate has one), plus records of
                  pairs never fed
  bad_records     per mate: SEQ/QUAL not the mate's (reverse-complemented on
                  the reverse strand), a CIGAR that does not cover the mate,
                  NM or MD not the mate's edit distance and mismatch string
                  on the genome, flags 0x1, 0x2, 0x4, 0x8, 0x10, 0x20, 0x40,
                  0x80 and 0x100 not the pair's, RNEXT / PNEXT / TLEN not the
                  other mate's place and the pair's span; per pair: AS (and
                  nM) not the score of both mates' blocks as one transcript
                  (junction and indel penalties, +sjdbScore, the log2 term
                  over the pair's genomic span, no penalty for the mate
                  gap), NH / HI / MAPQ / primary inconsistent over the
                  pair's records, a score out of the multimapper range, or
                  a best alignment that fails the output filters over the
                  pair's summed length (so an alignment of one mate, under
                  outFilterMatchNminOverLread 0.66 of the pair, is bad)
  missed_pct      of the pairs whose true origin (both mates' generator
                  blocks) passes the output filters, the share (%) that came
                  out unmapped (other than as too many loci) or whose best
                  AS is below the true alignment's score
  sj_rows_diff    rows of SJ.out.tab not equal to the reference's: the
                  junctions of both mates, a junction crossed by both
                  overlapping mates (or by several alignments) counted once
                  for the pair with its largest overhang, as STAR's
                  outputTranscriptSJ does; filtered by the outSJfilter*
                  rules, under BySJout without the distance rule
  trsam_diff      pairs whose Aligned.toTranscriptome.out.bam records differ
                  from the projections of their alignments onto the
                  annotation's transcripts (both mates' positions and
                  strands; alignments with an indel banned, soft clips
                  extended with STAR's mismatch re-check over the pair,
                  alignments of one mate banned; NH = the count, one
                  primary pair)
  sorted_bam_diff records of Aligned.sortedByCoord.out.bam not those of
                  Aligned.out.bam byte for byte, records out of coordinate
                  order, and a header without SO:coordinate
"""
from __future__ import annotations

import copy
import gzip
import math
import os
import struct
from bisect import bisect_right
from collections import Counter, defaultdict

import numpy as np

from .bam import Record, read_bam
from .bulk_alignments import Judge, Scored, _mapq, cigar_blocks, revcomp, score
from .genome import encode


def _sam_tags(fields):
    out = {}
    for f in fields:
        key, t, v = f.split(":", 2)
        out[key] = int(v) if t == "i" else float(v) if t == "f" else v
    return out


def read_sam(path):
    """(reference names, Records, mate fields [(next ref, next pos, tlen)])
    of a SAM file, positions 0-based and -1 where absent, as in BAM"""
    names, recs, mates = [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                if line.startswith("@SQ"):
                    names.append(line.split("\tSN:")[1].split("\t")[0].strip())
                continue
            c = line.rstrip("\n").split("\t")
            ref = names.index(c[2]) if c[2] != "*" else -1
            cig = [] if c[5] == "*" else _parse_cigar(c[5])
            recs.append(Record(c[0], int(c[1]), ref, int(c[3]) - 1, int(c[4]),
                               cig, c[9], c[10].encode(), _sam_tags(c[11:])))
            nref = ref if c[6] == "=" else (names.index(c[6]) if c[6] != "*"
                                            else -1)
            mates.append((nref, int(c[7]) - 1, int(c[8])))
    return names, recs, mates


def _parse_cigar(s):
    out, n = [], ""
    for ch in s:
        if ch.isdigit():
            n += ch
        else:
            out.append((ch, int(n)))
            n = ""
    return out


def bam_raw(path):
    """(header text, [record bytes]) of a BAM file, each record without its
    block_size word"""
    with gzip.open(path, "rb") as f:
        b = f.read()
    n_text = struct.unpack_from("<i", b, 4)[0]
    text = b[8:8 + n_text].decode()
    i = 8 + n_text
    n_ref = struct.unpack_from("<i", b, i)[0]
    i += 4
    for _ in range(n_ref):
        i += 8 + struct.unpack_from("<i", b, i)[0]
    out = []
    while i < len(b):
        size = struct.unpack_from("<i", b, i)[0]
        out.append(b[i + 4:i + 4 + size])
        i += 4 + size
    return text, out


def bam_mate_fields(path):
    """[(next ref, next pos, tlen)] of a BAM file's records, in order (the
    fields reference/bam.py's reader leaves out)"""
    return [struct.unpack_from("<iii", r, 20) for r in bam_raw(path)[1]]


def sorted_bam_diff(unsorted_path, sorted_path):
    """records of Aligned.sortedByCoord.out.bam that are not
    Aligned.out.bam's (or are missing from it), byte for byte, plus the
    records that break coordinate order (reference, then position; records
    with no reference last), plus 1 if the header does not say SO:coordinate"""
    want = Counter(bam_raw(unsorted_path)[1])
    text, recs = bam_raw(sorted_path)
    got = Counter(recs)
    diff = sum(((want - got) + (got - want)).values())
    keys = [struct.unpack_from("<ii", r, 0) for r in recs]
    keys = [(ref if ref >= 0 else 1 << 31, pos) for ref, pos in keys]
    diff += sum(a > b for a, b in zip(keys, keys[1:]))
    return diff + ("SO:coordinate" not in text.split("\n")[0])


class Mate:
    """one mate's record of a pair alignment, judged on the genome"""
    __slots__ = ("rec", "rev", "blocks", "gaps", "lc", "rc", "read", "s",
                 "start", "end", "next")


class PairJudge(Judge):
    """judges the alignments of one paired-end job; `reads` maps each fed
    pair's name to (mate 1 sequence, mate 1 quality, mate 2 sequence, mate 2
    quality)"""

    def __init__(self, genome, flags):
        super().__init__(genome, flags)
        self.sc_mate = copy.copy(self.sc)
        self.sc_mate.log2scale = 0
        pr = self.p.get("alignEndsProtrude", [0, "ConcordantPair"])
        self.concordant = len(pr) > 1 and pr[1] == "ConcordantPair"

    # --------------------------------------------------------- the records
    def records(self, out_dir):
        """(reference names, Records, mate fields) of the job's alignments:
        Aligned.out.bam under --outSAMtype BAM, else Aligned.out.sam"""
        if self.p["outSAMtype"][0] == "BAM":
            path = os.path.join(out_dir, "Aligned.out.bam")
            names, _, recs = read_bam(path)
            return names, recs, bam_mate_fields(path)
        return read_sam(os.path.join(out_dir, "Aligned.out.sam"))

    def pair_score(self, left, right):
        """the pair's Scored: both mates' (log2 term off) summed, with the
        log2 term over the pair's span and the junctions of both"""
        out = Scored()
        s = left.s.score + right.s.score
        if self.sc.log2scale != 0:
            glen = right.end - left.start
            s += int(math.ceil(math.log2(max(glen, 1)) * self.sc.log2scale
                               - 0.5))
        out.score = max(0, s)
        for k in ("nm", "n_mm", "n_match", "mapped"):
            setattr(out, k, getattr(left.s, k) + getattr(right.s, k))
        out.md = None
        out.junctions = left.s.junctions + right.s.junctions
        return out

    def passes(self, ps, len1, len2):
        """STAR's mapped-read filters over the pair (ReadAlign_mappedFilter):
        Lread - 1 = len1 + len2, the mismatch cap over both mates"""
        p = self.p
        L1 = len1 + len2
        mm_max = min(p["outFilterMismatchNmax"][0],
                     int(p["outFilterMismatchNoverReadLmax"][0] * L1))
        return (ps.score >= p["outFilterScoreMin"][0]
                and ps.score >= int(p["outFilterScoreMinOverLread"][0] * L1)
                and ps.n_match >= p["outFilterMatchNmin"][0]
                and ps.n_match >= int(p["outFilterMatchNminOverLread"][0] * L1)
                and ps.n_mm <= mm_max
                and (ps.mapped == 0 or ps.n_mm / ps.mapped
                     <= p["outFilterMismatchNoverLmax"][0]))

    def _mate(self, r, mf, seq, qual, offs):
        """a mapped record as a Mate, or what is wrong with its SEQ, QUAL or
        CIGAR"""
        m = Mate()
        m.rec, m.next = r, mf
        m.rev = bool(r.flag & 16)
        if r.seq != (revcomp(seq) if m.rev else seq) or \
                r.qual != (qual[::-1] if m.rev else qual).encode():
            return "SEQ/QUAL"
        m.blocks, m.gaps, qlen, m.lc, m.rc = cigar_blocks(
            r.cigar, offs[r.ref] + r.pos)
        if qlen != len(seq) or not m.blocks:
            return "CIGAR length"
        m.read = encode(r.seq)
        m.s = score(m.read, m.blocks, m.gaps, self.G.seq, self.G.sjdb,
                    self.sc_mate)
        m.start = m.blocks[0][0]
        m.end = m.blocks[-1][0] + m.blocks[-1][2]
        return m

    def _pair_fields(self, a, b, nh, attrs):
        """what is wrong with the flags, mate fields and tags of one
        alignment's two records (a: mate 1, b: mate 2), or None"""
        if a.rev == b.rev:
            return "mates on one strand"
        left, right = (a, b) if not a.rev else (b, a)
        proper = self.concordant or (
            left.start <= right.start + left.lc
            and left.end <= right.end + right.rc)
        ps = self.pair_score(left, right)
        for m, o, bit in ((a, b, 0x40), (b, a, 0x80)):
            r = m.rec
            want = (0x1 | bit | (0x2 if proper else 0) | (0x10 if m.rev else 0)
                    | (0x20 if o.rev else 0) | (r.flag & 0x100))
            if r.flag != want:
                return f"flag {r.flag} != {want}"
            if (r.flag ^ o.rec.flag) & 0x100:
                return "0x100 differs between the mates"
            span = right.end - left.start
            tlen = span if m is left else -span
            if m.next != (o.rec.ref, o.rec.pos, tlen) or r.ref != o.rec.ref:
                return f"RNEXT/PNEXT/TLEN {m.next} != " \
                       f"{(o.rec.ref, o.rec.pos, tlen)}"
            want_t = {"AS": ps.score, "nM": ps.n_mm, "NH": nh,
                      "NM": m.s.nm, "MD": m.s.md}
            diff = [k for k in want_t if k in attrs
                    and r.tags.get(k) != want_t[k]]
            if diff:
                return "tags " + ", ".join(f"{k} {r.tags.get(k)} != "
                                           f"{want_t[k]}" for k in diff)
            if r.tags.get("HI") != o.rec.tags.get("HI"):
                return "HI differs between the mates"
            if r.mapq != _mapq(nh, self.p["outSAMmapqUnique"][0]):
                return "MAPQ"
        return ps

    def alignments(self, out_dir, reads):
        """records by pair; counts pairs missing and bad records.  Returns
        (by pair {name: [(records (mate 1, mate 2), pair Scored, left Mate,
        right Mate)]}, pairs missing, bad records, best scores {name: score
        or "u" + uT})"""
        names, recs, mfs = self.records(out_dir)
        offs = [int(self.G.offset[self.G.index[n]]) for n in names]
        by = defaultdict(list)
        for r, mf in zip(recs, mfs):
            by[r.name].append((r, mf))
        p = self.p
        within = "Within" in p.get("outSAMunmapped", [])
        attrs = set(p.get("outSAMattributes", ["NH", "HI", "AS", "nM"]))
        missing = sum(1 for n in by if n not in reads)
        if within:
            for n in reads:
                got = {r.flag & 0xC0 for r, _ in by.get(n, ())}
                missing += got != {0x40, 0x80}
        bad = 0
        mapped = {}
        best = {n: "u-" for n in reads if n not in by}
        for name, rs in by.items():
            if name not in reads:
                continue
            s1, q1, s2, q2 = reads[name]
            um = [x for x in rs if x[0].flag & 4]
            mp = [x for x in rs if not x[0].flag & 4]
            if um and mp:
                bad += len(rs)
                self.note(f"{name}: mapped and unmapped records (an "
                          "alignment of one mate)")
                continue
            if um:
                why = None
                uts = set()
                for r, mf in um:
                    bit = r.flag & 0xC0
                    seq, qual = (s1, q1) if bit == 0x40 else (s2, q2)
                    uts.add(r.tags.get("uT"))
                    if r.flag != (0x4 | 0x1 | 0x8 | bit) or bit not in (0x40, 0x80):
                        why = f"unmapped flag {r.flag}"
                    elif r.seq != seq or r.qual != qual.encode():
                        why = "unmapped SEQ/QUAL"
                    elif r.tags.get("NH") != 0 or mf != (-1, -1, 0) \
                            or r.ref != -1:
                        why = "unmapped NH or mate fields"
                if why is None and (len(um) != 2 or len(uts) != 1
                                    or not uts <= set("01234")):
                    why = "unmapped pair's records"
                if why:
                    bad += len(um)
                    self.note(f"{name}: {why}")
                best[name] = "u" + str(next(iter(uts)))
                continue
            groups = defaultdict(list)
            for x in mp:
                groups[x[0].tags.get("HI")].append(x)
            nh = len(groups)
            got = []
            for hi, g in groups.items():
                g = sorted(g, key=lambda x: x[0].flag & 0xC0)
                if [x[0].flag & 0xC0 for x in g] != [0x40, 0x80]:
                    bad += len(g)
                    self.note(f"{name} HI {hi}: not one record of each mate")
                    continue
                a = self._mate(*g[0], s1, q1, offs)
                b = self._mate(*g[1], s2, q2, offs)
                why = a if isinstance(a, str) else b if isinstance(b, str) \
                    else None
                ps = None
                if why is None:
                    ps = self._pair_fields(a, b, nh, attrs)
                    why = ps if isinstance(ps, str) else None
                if why is not None:
                    bad += 2
                    self.note(f"{name} HI {hi}: {why}")
                    continue
                left, right = (a, b) if not a.rev else (b, a)
                got.append(((a.rec, b.rec), ps, left, right))
            if len(got) != nh:
                continue
            top = max(x[1].score for x in got)
            prim = [x for x in got if not x[0][0].flag & 256]
            his = sorted(x[0][0].tags.get("HI") for x in got)
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
            elif not self.passes(prim[0][1], len(s1), len(s2)):
                why = "output filters"
            if why:
                bad += 2 * nh
                self.note(f"{name}: {why}")
                continue
            mapped[name] = got
            best[name] = top
        return mapped, missing, bad, best

    # ------------------------------------------------------------ truth
    def _true_mate(self, seq, fwd, blocks):
        """(Mate of the true alignment, or None where an overhang is short
        of the minimum STAR may report)"""
        G, sc, p = self.G, self.sc, self.p
        oh_db, oh_new = p["alignSJDBoverhangMin"][0], p["alignSJoverhangMin"][0]
        bl = [(int(g), int(q), int(n)) for g, q, n in blocks]
        gaps = {}
        for i in range(1, len(bl)):
            pg, pq, pn = bl[i - 1]
            g, q, ln = bl[i]
            if q > pq + pn:
                gaps[i] = ("I", q - pq - pn)
            elif g - pg - pn >= sc.intron_min:
                gaps[i] = ("N", g - pg - pn)
                need = oh_db if (pg + pn, g - 1) in G.sjdb else oh_new
                if min(pn, ln) < need:
                    return None
            elif g > pg + pn:
                gaps[i] = ("D", g - pg - pn)
        m = Mate()
        m.rev = not fwd
        m.read = encode(seq if fwd else revcomp(seq))
        m.blocks, m.gaps = bl, gaps
        m.s = score(m.read, bl, gaps, G.seq, G.sjdb, self.sc_mate)
        m.start, m.end = bl[0][0], bl[-1][0] + bl[-1][2]
        return m

    def missed_pairs(self, truth, reads, best):
        """(share % of the judged pairs the job missed, pairs judged).  A
        pair is judged where its true alignment is one STAR may report: both
        mates' junctions reach the overhang minimum and the pair passes the
        output filters.  A pair without records is missing, not missed."""
        n = miss = 0
        for name, (kind, _c, mates) in truth.items():
            if name not in reads or name not in best:
                continue
            s1, _, s2, _ = reads[name]
            ms = [self._true_mate(s, fwd, bl)
                  for s, (fwd, bl) in zip((s1, s2), mates)]
            if None in ms or ms[0].rev == ms[1].rev:
                continue
            left, right = (ms[0], ms[1]) if not ms[0].rev else (ms[1], ms[0])
            t = self.pair_score(left, right)
            if not self.passes(t, len(s1), len(s2)):
                continue
            n += 1
            b = best[name]
            if (isinstance(b, str) and b not in ("u3", "u-")) or (
                    not isinstance(b, str) and b < t.score):
                miss += 1
                if miss <= 5:
                    self.note(f"{name} ({kind}): best {b} < truth {t.score}")
        return (100.0 * miss / n if n else 0.0), n

    # --------------------------------------------- Aligned.toTranscriptome.out.bam
    def _extend(self, m):
        """a mate's blocks with its soft clips extended; the mismatches the
        extension adds"""
        G, read = self.G.seq, m.read
        extra = 0
        bl = [list(b) for b in m.blocks]
        g0 = bl[0][0]
        for b in range(1, m.lc + 1):
            rr, gg = read[m.lc - b], G[g0 - b]
            extra += int(rr != gg and rr < 4 and gg < 4)
        ge = bl[-1][0] + bl[-1][2]
        L = len(read)
        for b in range(m.rc):
            rr, gg = read[L - m.rc + b], G[ge + b]
            extra += int(rr != gg and rr < 4 and gg < 4)
        bl[0][0] -= m.lc
        bl[0][2] += m.lc
        bl[-1][2] += m.rc
        return bl, extra

    def project_pair(self, x):
        """transcript records [(transcript, pos, reverse, mate bit)] of one
        pair alignment, as STAR's quantTranscriptome would write them"""
        (r1, r2), ps, left, right = x
        if any(op in "ID" for m in (left, right) for op, _ in m.gaps.values()):
            return []
        p = self.p
        ext_l, e1 = self._extend(left)
        ext_r, e2 = self._extend(right)
        L1, L2 = len(left.read), len(right.read)
        mm_max = min(p["outFilterMismatchNmax"][0],
                     int(p["outFilterMismatchNoverReadLmax"][0] * (L1 + L2)))
        if ps.n_mm + e1 + e2 > min(mm_max, int(
                p["outFilterMismatchNoverLmax"][0] * (L1 + L2))):
            return []
        bit_l = 0x40 if left.rec is r1 else 0x80
        start, last = ext_l[0][0], ext_r[-1][0]
        tx, tx_s = self._tx_tables()
        out = []
        for k in range(int(np.searchsorted(tx_s, start, side="right"))):
            t0, t1, tid, strand, ex, cum = tx[k]
            if last > t1 - 1:
                continue
            pos = self._in_transcript(ext_l, ext_r, ex, cum)
            if pos is None:
                continue
            trlen = int(cum[-1])
            for m, tp, ln, bit in ((left, pos[0], L1, bit_l),
                                   (right, pos[1], L2, 0xC0 ^ bit_l)):
                if strand == "+":
                    out.append((tid, tp, m.rev, bit))
                else:
                    out.append((tid, trlen - tp - ln, not m.rev, bit))
        return out

    @staticmethod
    def _in_transcript(ext_l, ext_r, ex, cum):
        """the transcript positions (+ strand) of both mates' first bases
        where the pair's blocks follow the transcript's exons (STAR's
        alignToTranscript), else None"""
        X = [v for a, b in ex for v in (a, b - 1)]
        pos = []
        e = None
        for mi, bl in enumerate((ext_l, ext_r)):
            g0 = bl[0][0]
            if mi == 0:
                e = 0
                while e < len(ex) and not (ex[e][0] <= g0 <= ex[e][1] - 1):
                    e += 1
                if e == len(ex):
                    return None
            else:
                i = bisect_right(X, g0) - 1
                if i % 2 == 1:
                    return None
                e = i // 2
            pos.append(g0 - ex[e][0] + int(cum[e]))
            for i, (g, _q, n) in enumerate(bl):
                if g + n > ex[e][1]:
                    return None
                if i + 1 < len(bl):
                    if g + n == ex[e][1] and e + 1 < len(ex) \
                            and bl[i + 1][0] == ex[e + 1][0]:
                        e += 1
                    else:
                        return None
        return pos

    def trsam_pairs_diff(self, path, mapped):
        """pairs whose transcriptome records differ from the reference's"""
        names, _, recs = read_bam(path)
        have = defaultdict(list)
        for r in recs:
            have[r.name].append((names[r.ref], r.pos, bool(r.flag & 16),
                                 r.flag & 0xC0, not r.flag & 256,
                                 r.tags.get("NH")))
        diff = 0
        for name in set(have) | set(mapped):
            want = []
            for x in mapped.get(name, []):
                want += self.project_pair(x)
            rs = have.get(name, [])
            got = [z[:4] for z in rs]
            ok = sorted(want) == sorted(got) and (
                not rs or (sum(z[4] for z in rs) == 2
                           and all(z[5] == len(rs) // 2 for z in rs)))
            if not ok:
                diff += 1
                if diff <= 3:
                    self.note(f"trsam {name}: {sorted(got)} != {sorted(want)}")
        return diff


def check(ctx):
    """[(name, value, limit)] of one paired-end bulk job; ctx: genome
    (RefGenome), flags, out_dir, reads {name: (seq 1, qual 1, seq 2, qual
    2)}, truth {name: (kind, chr, [(forward, blocks) of each mate])},
    limits {name: limit}"""
    J = PairJudge(ctx["genome"], ctx["flags"])
    out = ctx["out_dir"]
    reads, lim = ctx["reads"], ctx["limits"]
    mapped, missing, bad, best = J.alignments(out, reads)
    res = [("reads_missing", missing, lim["reads_missing"]),
           ("bad_records", bad, lim["bad_records"])]
    miss, n_truth = J.missed_pairs(ctx["truth"], reads, best)
    res.append(("missed_pct", miss, lim["missed_pct"]))
    res.append(("sj_rows_diff", J.sj_rows_diff(os.path.join(out, "SJ.out.tab"),
                                               mapped), lim["sj_rows_diff"]))
    if "TranscriptomeSAM" in J.p["quantMode"]:
        res.append(("trsam_diff", J.trsam_pairs_diff(
            os.path.join(out, "Aligned.toTranscriptome.out.bam"), mapped),
            lim["trsam_diff"]))
    if "SortedByCoordinate" in J.p["outSAMtype"]:
        res.append(("sorted_bam_diff", sorted_bam_diff(
            os.path.join(out, "Aligned.out.bam"),
            os.path.join(out, "Aligned.sortedByCoord.out.bam")),
            lim["sorted_bam_diff"]))
    ctx["notes"] = J.notes
    ctx["counts"] = {"pairs": len(reads), "mapped": len(mapped),
                     "truth_judged": n_truth}
    return res
