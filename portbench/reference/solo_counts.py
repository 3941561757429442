"""The judge of a STARsolo job (CB_UMI_Simple, Cell Ranger 4 matching):
the coordinate-sorted BAM and Solo.out/{Gene,GeneFull}, held against the
genome, the annotation, the cDNA reads and the barcode reads fed in.

The alignments are judged as bulk_alignments judges them (SEQ/QUAL, CIGAR,
AS and nM recomputed on the genome, NH/HI/MAPQ/primary, the score range,
the Cell Ranger 4 clip worked out again from the cDNA read, which no
record may leave aligned, and the output filters on the clipped read),
with the raw barcode and UMI tags (CR, UR) and the corrected barcode (CB)
held against the barcode read.  The counting is then done again from the
judged alignments, the annotation and the barcode reads, and compared:

  reads_missing       records of reads never fed
  bad_records         records that fail the alignment checks above
  missed_pct          truth-passing cDNA reads left unmapped (no record) or
                      below their true alignment's score (cut to what the
                      clip leaves), in %
  gene_matrix_diff    entries of Solo.out/Gene/raw (gene, barcode, UMIs)
                      not equal to the reference's
  genefull_matrix_diff  the same for GeneFull
  cell_calls_diff     barcodes of the simple filter (Cell Ranger's: the
                      expected cells' 99th-percentile UMIs over 10) missing
                      from Gene/filtered, plus filtered barcodes under the
                      EmptyDrops_CR candidates' UMI floor

The reference's counting, in STARsolo's terms: a barcode read with an N or
a single-base homopolymer in its UMI, or two Ns in its barcode, counts for
nothing; its barcode is the whitelist's exact match, else the one whitelist
barcode a base away (an N base: any base), else, of several, the one whose
exact-match count (plus one, the pseudocount) times the error probability
of the differing base holds at least 0.975 of their sum.  A read counts
for a feature where its alignments give exactly one gene: Gene takes the
genes of transcripts whose exons hold every aligned block on the read's
sense strand, with each junction joining consecutive exons; GeneFull the
genes whose span any block overlaps, sense strand.  Per barcode and gene,
UMIs a base apart fold into the one with more reads (1MM_CR), and a UMI
that lands on several genes goes to the gene with the most reads of it,
or to none on a tie or where another gene had more of its raw reads
(MultiGeneUMI_CR).
"""
from __future__ import annotations

import os
from collections import defaultdict

import numpy as np

from .bulk_alignments import Judge

_V = {"A": 0, "C": 1, "G": 2, "T": 3}


def enc(s: str):
    """(2-bit value, first base highest; position of a single N or -1, or
    -2 for two Ns)"""
    v, pos = 0, -1
    for i, c in enumerate(s):
        v <<= 2
        if c in _V:
            v += _V[c]
        elif pos >= 0:
            return v, -2
        else:
            pos = i
    return v, pos


def one_mm(x: int) -> bool:
    """two 2-bit codes one base apart"""
    if x == 0:
        return False
    while x & 3 == 0:
        x >>= 2
    return x < 4


def c_round(x):
    return int(np.floor(x + 0.5))


class Barcodes:
    def __init__(self, wl, cb_len, umi_len):
        self.wl = wl
        self.index = {w: i for i, w in enumerate(wl)}
        self.cb_len, self.umi_len = cb_len, umi_len

    def parse(self, bseq, bqual):
        """(kind, candidates [(whitelist index, quality char)], umi value)
        with kind "exact", "mm" or None (counts for nothing)"""
        cb, umi = bseq[:self.cb_len], bseq[self.cb_len:self.cb_len + self.umi_len]
        u, upos = enc(umi)
        if upos != -1 or len(set(umi)) == 1:
            return None, [], 0
        v, pos = enc(cb)
        if pos == -2:
            return None, [], 0
        if pos == -1 and cb in self.index:
            return "exact", [(self.index[cb], "")], u
        cands = []
        if pos >= 0:
            for b in "ACGT":
                w = cb[:pos] + b + cb[pos + 1:]
                if w in self.index:
                    cands.append((self.index[w], bqual[pos]))
        else:
            for i in range(self.cb_len - 1, -1, -1):
                for b in "ACGT":
                    if b != cb[i]:
                        w = cb[:i] + b + cb[i + 1:]
                        if w in self.index:
                            cands.append((self.index[w], bqual[i]))
        return ("mm" if cands else None), cands, u


def resolve(kind, cands, exact):
    """the barcode of a read (whitelist index) or -1"""
    if kind == "exact" or (kind == "mm" and len(cands) == 1):
        return cands[0][0]
    if kind != "mm":
        return -1
    ptot = pmax = np.float32(0.0)
    best = -1
    for w, q in cands:
        if exact[w] > 0:
            pin = np.float32(float(exact[w]) * 10.0 ** (-min(ord(q) - 33, 33) / 10.0))
            ptot += pin
            if pin > pmax:
                best, pmax = w, pin
    if float(ptot) > 0 and float(pmax) >= 0.975 * float(ptot):
        return best
    return -1


def gene_sets(G, got, tx_tab, gene_span):
    """(Gene set, GeneFull set) of a read's judged alignments, sense strand"""
    gene, full = set(), set()
    for r, _s, blocks, gaps, _lc, _rc in got:
        rstr = 1 if r.flag & 16 else 0
        first, last_end = blocks[0][0], blocks[-1][0] + blocks[-1][2]
        for t0, t1, gid, strand, starts, ends in tx_tab:
            if t0 > first:
                break
            if last_end > t1 or (rstr if strand == "+" else 1 - rstr) != 0:
                continue
            if _concordant(blocks, gaps, starts, ends):
                gene.add(gid)
        for g0, g1, gid, strand in gene_span:
            if (rstr if strand == "+" else 1 - rstr) != 0:
                continue
            if any(g < g1 and g + n > g0 for g, _q, n in blocks):
                full.add(gid)
    return gene, full


def _concordant(blocks, gaps, starts, ends):
    """every block inside the transcript's exons, each junction from one
    exon's end to the next exon's start (ends exclusive)"""
    ex = -1
    for i, (g, _q, n) in enumerate(blocks):
        gap = gaps.get(i, (None, 0))[0]
        if i == 0 or gap == "N":
            if i > 0:
                pg, _, pn = blocks[i - 1]
                if not (ex + 1 < len(starts) and pg + pn == ends[ex]
                        and g == starts[ex + 1]):
                    return False
                ex += 1
            else:
                ex = int(np.searchsorted(starts, g, side="right")) - 1
                if ex < 0 or g > ends[-1] - 1:
                    return False
        if not (starts[ex] <= g and g + n <= ends[ex]):
            return False
    return True


def collapse_cr(recs):
    """{gene: UMIs} of one barcode's (gene, umi) records: 1MM_CR and
    MultiGeneUMI_CR"""
    by_gene = defaultdict(lambda: defaultdict(int))
    for g, u in recs:
        by_gene[g][u] += 1
    raw = defaultdict(dict)           # umi -> gene -> reads
    corr_count = defaultdict(lambda: defaultdict(int))
    for g, umis in by_gene.items():
        ent = sorted(umis.items(), key=lambda e: (e[1], e[0]))
        for u, c in ent:
            raw[u][g] = raw[u].get(g, 0) + c
        n = len(ent)
        for i in range(n):
            corr = ent[i][0]
            for j in range(n - 1, i, -1):
                if one_mm(ent[i][0] ^ ent[j][0]):
                    corr = ent[j][0]
                    break
            corr_count[corr][g] += ent[i][1]
    out = defaultdict(int)
    for u, gc in corr_count.items():
        maxu, maxg = 0, None
        for g, c in gc.items():
            if c > maxu:
                maxu, maxg = c, g
            elif c == maxu:
                maxg = None
        if maxg is None:
            continue
        r = raw.get(u, {})
        if any(c > r.get(maxg, 0) for c in r.values()):
            continue
        out[maxg] += 1
    return out


def read_mtx(d):
    """{(gene id, barcode): count} of a raw or filtered matrix directory"""
    feats = [l.split("\t")[0] for l in open(os.path.join(d, "features.tsv"))
             .read().splitlines()]
    bcs = open(os.path.join(d, "barcodes.tsv")).read().split()
    out = {}
    with open(os.path.join(d, "matrix.mtx")) as f:
        lines = [l for l in f.read().splitlines() if not l.startswith("%")]
    for l in lines[1:]:
        i, j, v = (int(x) for x in l.split())
        out[(feats[i - 1], bcs[j - 1])] = v
    return out


def check(ctx):
    G, flags, reads, lim = ctx["genome"], ctx["flags"], ctx["reads"], ctx["limits"]
    J = Judge(G, flags)
    p = J.p
    out = ctx["out_dir"]
    wl = open(p["soloCBwhitelist"][0]).read().split()
    cb_len = p.get("soloCBlen", [16])[0]
    umi_len = p.get("soloUMIlen", [10])[0]
    bc = Barcodes(sorted(wl), cb_len, umi_len)
    parsed = {n: bc.parse(r[2], r[3]) for n, r in reads.items()}
    exact = np.zeros(len(bc.wl), np.int64)
    for kind, cands, _u in parsed.values():
        if kind == "exact":
            exact[cands[0][0]] += 1
    exact += 1                         # the pseudocount of every barcode
    cb_of = {n: resolve(k, c, exact) for n, (k, c, _u) in parsed.items()}

    def tags(name, r):
        bseq = reads[name][2]
        want = {"CR": bseq[:cb_len], "UR": bseq[cb_len:cb_len + umi_len],
                "CB": bc.wl[cb_of[name]] if cb_of[name] >= 0 else "-"}
        bad = [k for k, v in want.items() if r.tags.get(k) != v]
        return ("tags " + ", ".join(f"{k} {r.tags.get(k)} != {want[k]}"
                                    for k in bad)) if bad else None

    bam = os.path.join(out, "Aligned.sortedByCoord.out.bam")
    mapped, missing, bad, best = J.alignments(bam, reads, extra_check=tags)
    res = [("reads_missing", missing, lim["reads_missing"]),
           ("bad_records", bad, lim["bad_records"])]
    miss, n_truth = J.missed(ctx["truth"], reads, best, unrecorded_missed=True)
    res.append(("missed_pct", miss, lim["missed_pct"]))

    tx_tab = sorted(((ex[0][0], ex[-1][1], gid, strand,
                      np.array([a for a, _ in ex]), np.array([b for _, b in ex]))
                     for gid, strand, ex in G.tx.values()),
                    key=lambda r: r[:3])
    span = defaultdict(lambda: [1 << 62, 0, ""])
    for gid, strand, ex in G.tx.values():
        s = span[gid]
        s[0], s[1], s[2] = min(s[0], ex[0][0]), max(s[1], ex[-1][1]), strand
    gene_span = [(a, b, gid, st) for gid, (a, b, st) in span.items()]
    recs = {"Gene": defaultdict(list), "GeneFull": defaultdict(list)}
    for name, got in mapped.items():
        cb = cb_of[name]
        if cb < 0:
            continue
        gs, fs = gene_sets(G, got, tx_tab, gene_span)
        u = parsed[name][2]
        for ft, s in (("Gene", gs), ("GeneFull", fs)):
            if len(s) == 1:
                recs[ft][cb].append((next(iter(s)), u))
    n_umi = {}
    for ft in ("Gene", "GeneFull"):
        want = {}
        for cb, rr in recs[ft].items():
            for g, n in collapse_cr(rr).items():
                want[(g, bc.wl[cb])] = n
            if ft == "Gene":
                n_umi[cb] = sum(collapse_cr(rr).values())
        have = read_mtx(os.path.join(out, "Solo.out", ft, "raw"))
        diff = set(want.items()) ^ set(have.items())
        for d in sorted(diff)[:3]:
            J.note(f"{ft} raw: {'missing' if d in want.items() else 'extra'} {d}")
        name = {"Gene": "gene_matrix_diff", "GeneFull": "genefull_matrix_diff"}[ft]
        res.append((name, len(diff), lim[name]))
    res.append(("cell_calls_diff", _calls_diff(J, p, n_umi, bc, out),
                lim["cell_calls_diff"]))
    ctx["notes"] = J.notes
    ctx["counts"] = {"reads": len(reads), "mapped": len(mapped),
                     "truth_judged": n_truth,
                     "counted": {k: sum(len(v) for v in r.values())
                                 for k, r in recs.items()}}
    return res


def _calls_diff(J, p, n_umi, bc, out):
    """simple-filter barcodes missing from Gene/filtered + filtered barcodes
    under the EmptyDrops_CR candidates' UMI floor"""
    filt = p["soloCellFilter"]
    n_exp, max_perc, ratio = int(filt[1]), float(filt[2]), float(filt[3])
    umi_min = int(filt[6])
    vals = sorted(n_umi.values(), reverse=True)
    if not vals:
        return 0
    top = vals[min(len(vals) - 1, c_round(n_exp * (1.0 - max_perc)))]
    floor = max(c_round(top / ratio), 1)
    simple = {bc.wl[cb] for cb, n in n_umi.items() if n >= floor}
    called = set(open(os.path.join(out, "Solo.out", "Gene", "filtered",
                                   "barcodes.tsv")).read().split())
    low = {c for c in called - simple
           if n_umi.get(bc.index[c], 0) < umi_min}
    lost = simple - called
    if lost or low:
        J.note(f"cell calls: {len(lost)} simple-filter barcodes not called, "
               f"{len(low)} called under {umi_min} UMIs")
    return len(lost) + len(low)
