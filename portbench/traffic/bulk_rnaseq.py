"""Bulk RNA-seq reads: single-end fragments of a stranded library.

Parameters (a workload file's "traffic" object):
  read_len        bases a read
  shares          {"exonic", "intronic", "intergenic", "repeat"}: the read
                  classes (mature transcripts, pre-mRNA introns, between
                  genes, transcribed repeat copies), summing to 1
  expression_sigma  sigma of the log-normal gene expression
  isoform_sigma   sigma of the log-normal isoform weights within a gene
  profile_seed    seed of the expression profile: the sample, the same for
                  every --seed (which draws only the reads)
  protocol        "antisense" (dUTP: read 1 is the transcript's reverse
                  complement), "sense" or "unstranded"
  sub_rate        mean substitution rate; the rate rises linearly from half
                  of it at the read's first base to 1.5 times at its last
  indel_rate      indels a base (1-2 bases, inside a block)
  batch_reads     reads made at once from (seed, batch index)

Every read carries its truth: the forward-strand blocks
(genome offset, offset in the read as aligned forward, length) that it was
copied from, so that a reference can score where it came from.
"""
from __future__ import annotations

import numpy as np

COMP = np.array([3, 2, 1, 0], np.uint8)
BASES = np.frombuffer(b"ACGT", np.uint8)


def _blocks_of(starts, ends, u, n):
    """forward blocks [(g, length)] of positions [u, u+n) of the
    concatenation of intervals [starts, ends)"""
    out = []
    cum = 0
    for a, b in zip(starts, ends):
        L = b - a
        if u < cum + L and u + n > cum:
            lo = max(u, cum)
            hi = min(u + n, cum + L)
            out.append((a + lo - cum, hi - lo))
        cum += L
    return out


def _pick(rng, cum):
    """an index drawn by the cumulative weights cum"""
    return min(int(np.searchsorted(cum, rng.random(), side="right")),
               len(cum) - 1)


class Traffic:
    mates = 1

    def __init__(self, model, params, seed):
        self.m = model
        self.p = params
        self.seed = int(seed) % (1 << 63)
        m, p = model, params
        rng = np.random.default_rng(p["profile_seed"])
        self.L = int(p["read_len"])
        Lt = self.L + 2
        expr = rng.lognormal(0.0, p["expression_sigma"], m.n_genes)
        iso = rng.lognormal(0.0, p["isoform_sigma"], len(m.tx_gene))
        w = expr[m.tx_gene] * iso * np.maximum(m.tx_len - Lt + 1, 0)
        self.tx_w = np.cumsum(w / w.sum())
        # introns of each gene's full transcript (the first of its gene)
        first = np.unique(m.tx_gene, return_index=True)[1]
        intr = []
        for t in first:
            e = m.ex[m.tx_off[t]:m.tx_off[t + 1]]
            for (a0, b0), (a1, b1) in zip(e[:-1], e[1:]):
                if a1 - b0 > Lt + 2:
                    intr.append((m.tx_chr[t], b0 + 1, a1 - 1, m.tx_strand[t],
                                 m.tx_gene[t]))
        self.introns = np.array(intr, np.int64).reshape(-1, 5)
        w = expr[self.introns[:, 4]] * (self.introns[:, 2] - self.introns[:, 1] - Lt)
        self.intron_w = np.cumsum(w / w.sum())
        # intergenic intervals: between the genes' spans
        inter = []
        for c in range(len(m.names)):
            g = m.genes[m.genes[:, 0] == c]
            g = g[np.argsort(g[:, 1])]
            edges = np.concatenate([[0], g[:, 2]]), np.concatenate([g[:, 1], [m.lens[c]]])
            for a, b in zip(*edges):
                if b - a > Lt + 10:
                    inter.append((c, a + 5, b - 5))
        self.inter = np.array(inter, np.int64).reshape(-1, 3)
        w = (self.inter[:, 2] - self.inter[:, 1] - Lt).astype(float)
        self.inter_w = np.cumsum(w / w.sum())
        rep = m.rep[(m.rep[:, 2] - m.rep[:, 1]) > Lt + 2]
        self.rep = rep
        w = (rep[:, 2] - rep[:, 1] - Lt).astype(float)
        self.rep_w = np.cumsum(w / w.sum())
        kinds = ("exonic", "intronic", "intergenic", "repeat")
        self.kinds = kinds
        sh = np.array([p["shares"].get(k, 0.0) for k in kinds])
        self.share = sh / sh.sum()
        i = np.arange(self.L)
        self.sub_p = p["sub_rate"] * (0.5 + i / max(self.L - 1, 1))

    # ------------------------------------------------------------------
    def _origin(self, rng, kind):
        """(chromosome, forward blocks [(chr pos, length)] of L+2 bases,
        read forward?)"""
        m, p, Lt = self.m, self.p, self.L + 2
        if kind == "exonic":
            t = _pick(rng, self.tx_w)
            e = m.ex[m.tx_off[t]:m.tx_off[t + 1]]
            u = int(rng.integers(0, m.tx_len[t] - Lt + 1))
            blocks = _blocks_of(e[:, 0], e[:, 1], u, Lt)
            c, sense_fwd = int(m.tx_chr[t]), m.tx_strand[t] == 0
        elif kind == "intronic":
            k = _pick(rng, self.intron_w)
            c, a, b, strand, _ = (int(x) for x in self.introns[k])
            s = int(rng.integers(a, b - Lt))
            blocks, sense_fwd = [(s, Lt)], strand == 0
        elif kind == "intergenic":
            k = _pick(rng, self.inter_w)
            c, a, b = (int(x) for x in self.inter[k])
            s = int(rng.integers(a, b - Lt))
            blocks, sense_fwd = [(s, Lt)], rng.random() < 0.5
        else:
            k = _pick(rng, self.rep_w)
            c, a, b, _ = (int(x) for x in self.rep[k])
            s = int(rng.integers(a, b - Lt))
            blocks, sense_fwd = [(s, Lt)], rng.random() < 0.5
        proto = p["protocol"]
        if proto == "sense":
            fwd = bool(sense_fwd)
        elif proto == "antisense":
            fwd = not sense_fwd
        else:
            fwd = rng.random() < 0.5
        return c, blocks, fwd

    def _truth(self, rng, blocks):
        """truth blocks [(chr pos, read offset, length)] of an L-base read
        from the template's forward blocks [(chr pos, length)], with at
        most one indel of 1-2 bases at least 6 bases inside a block;
        returns (truth blocks, indel kind or None)"""
        L = self.L
        p_indel = 1.0 - (1.0 - self.p["indel_rate"]) ** L
        kind, d, at = None, 0, 0
        if rng.random() < p_indel:
            kind = "del" if rng.random() < 0.5 else "ins"
            d = int(rng.integers(1, 3))
            at = int(rng.integers(10, L - 10))
        if kind:
            c = 0
            for g, n in blocks:
                if c + 6 <= at and at + d + 6 <= c + n:
                    break
                c += n
            else:
                kind, d = None, 0
        need = L + d if kind == "del" else (L - d if kind == "ins" else L)
        segs, got = [], 0
        for g, n in blocks:
            n = min(n, need - got)
            if n <= 0:
                break
            segs.append((g, n))
            got += n
        out, c, q = [], 0, 0
        for g, n in segs:
            if kind and c < at < c + n:
                k = at - c
                out.append((g, q, k))
                if kind == "del":
                    out.append((g + k + d, q + k, n - k - d))
                    q += n - d
                else:
                    out.append((g + k, q + k + d, n - k))
                    q += n + d
            else:
                out.append((g, q, n))
                q += n
            c += n
        return [b for b in out if b[2] > 0], kind

    def prepare(self, out_dir):
        """files the job needs besides the reads: none"""

    def warmup(self, n):
        """n reads of the warm-up stream (never the window's)"""
        recs, k = [], 0
        while len(recs) < n:
            recs += self.batch(k, stream=1)[0][0]
            k += 1
        return [recs[:n]]

    def window_reads(self, n):
        """the first n reads of the window's stream: ({name: (sequence,
        quality)}, {name: (kind, chromosome, forward, truth blocks)})"""
        reads, truth, k = {}, {}, 0
        while len(reads) < n:
            recs, tr = self.batch(k)
            for rec, t in zip(recs[0], tr):
                if len(reads) == n:
                    break
                _, seq, _, qual = rec.split("\n")[:4]
                reads[t[0]] = (seq, qual)
                truth[t[0]] = t[1:]
            k += 1
        return reads, truth

    def batch(self, k, stream=0):
        """reads [k * batch_reads, (k + 1) * batch_reads) of a stream of the
        run (0: the window, 1: the warm-up): (FASTQ records per mate,
        truth)"""
        n = int(self.p["batch_reads"])
        rng = np.random.default_rng([self.seed, stream, k])
        m, L = self.m, self.L
        kinds = rng.choice(len(self.kinds), size=n, p=self.share)
        recs, truth = [], []
        qual = "F" * L
        for i in range(n):
            kind = self.kinds[kinds[i]]
            c, blocks, fwd = self._origin(rng, kind)
            tb, indel = self._truth(rng, blocks)
            off = int(m.chr_off[c])
            tmpl = rng.integers(0, 4, L).astype(np.uint8)   # inserted bases
            for g, q, ln in tb:
                tmpl[q:q + ln] = m.seq[off + g:off + g + ln]
            read = tmpl if fwd else COMP[tmpl[::-1]]
            read = read.copy()
            hit = rng.random(L) < self.sub_p
            read[hit] = (read[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
            seq = BASES[read].tobytes().decode()
            name = f"s{stream}b{k}r{i}"
            recs.append(f"@{name}\n{seq}\n+\n{qual}\n")
            truth.append((name, kind, c, fwd, [(off + g, q, ln) for g, q, ln in tb]))
        return [recs], truth
