"""10x Chromium v3 reads: read 1 (16-base cell barcode + 12-base UMI) and
the cDNA read 2, over the genome model's genes.

A frozen copy of chip_smoke.solo_reads (the bring-up smoke script at the
repository's root), widened to the genome files' gene model and made batch
by batch: batch k of a stream is made from (seed, stream, k), after batches
0..k-1 of the same stream (a barcode's earlier molecules are what its
duplicates repeat).

Parameters (a workload file's "traffic" object):
  cdna_len, tail         cDNA read length; the transcript's last `tail` bases
                         that the exonic reads come from (3' capture)
  shares                 {"exonic", "intronic", "intergenic"} of the molecules
  cells, types, ambient  cells (log-normal sizes, sigma cell_sigma) of
                         `types` cell types, each with its own gene profile;
                         barcodes holding ambient reads; ambient_share of the
                         reads is theirs
  dup_share, dup_umi_err a barcode's reads that repeat one of its molecules,
                         and the share of those with one UMI base changed
  tso_share, polya_share cDNA reads led by the last 20-30 bases of the 10x
                         template-switch oligo, and ending in 20-40 As
  cb_mm, cb_n            barcodes with one substituted base, and with an N
  sub_rate               cDNA substitutions a base
  whitelist, wl_seed     barcodes of the whitelist (cells and ambient among
                         them), and the seed of the list (the configuration's)
  profile_seed           seed of the cells, types and profiles: the same
                         sample for every --seed, which draws only the reads
  batch_reads            reads made at once

The cDNA read's truth carries the forward-strand blocks of its transcript
part: the TSO prefix and the polyA tail are in no block.
"""
from __future__ import annotations

import os

import numpy as np

CR4_TSO = "AAGCAGTGGTATCAACGCAGAGTACATGGG"   # 10x's template-switch oligo
COMP = np.array([3, 2, 1, 0], np.uint8)
BASES = np.frombuffer(b"ACGT", np.uint8)


def _pick(rng, cum):
    return min(int(np.searchsorted(cum, rng.random(), side="right")),
               len(cum) - 1)


def _bc(codes):
    return BASES[codes].tobytes().decode()


class Traffic:
    mates = 2

    def __init__(self, model, params, seed):
        self.m = model
        self.p = p = params
        self.seed = int(seed) % (1 << 63)
        self.L = int(p["cdna_len"])
        wl_rng = np.random.default_rng(p["wl_seed"])
        codes = np.unique(wl_rng.integers(0, 1 << 32, int(p["whitelist"] * 1.05),
                                          dtype=np.uint64))
        codes = wl_rng.permutation(codes)[:p["whitelist"]]
        digits = (codes[:, None] >> (2 * np.arange(15, -1, -1, dtype=np.uint64))
                  ) & np.uint64(3)
        self.wl = sorted(x.decode() for x in np.ascontiguousarray(
            BASES[digits.astype(np.uint8)]).view("S16").ravel())
        rng = np.random.default_rng(p["profile_seed"])
        m = model
        first = np.unique(m.tx_gene, return_index=True)[1]
        # a gene's transcript: its full one (the first of the gene)
        self.tx = first
        n_genes = len(first)
        pop = rng.lognormal(0.0, 1.0, n_genes)
        prof = pop[None, :] * rng.lognormal(0.0, 1.5, (p["types"], n_genes))
        self.cum = np.cumsum(prof / prof.sum(1, keepdims=True), axis=1)
        order = rng.permutation(len(self.wl))
        self.cells = [self.wl[i] for i in order[:p["cells"]]]
        self.ambient = [self.wl[i] for i in
                        order[p["cells"]:p["cells"] + p["ambient"]]]
        self.ctype = rng.integers(0, p["types"], p["cells"])
        csize = np.cumsum(rng.lognormal(0.0, p["cell_sigma"], p["cells"]))
        self.csize = csize / csize[-1]
        sh = p["shares"]
        self.share = np.cumsum([sh["exonic"], sh["intronic"], sh["intergenic"]])
        self.share /= self.share[-1]
        # introns of each gene's transcript, long enough for a read
        self.introns = []
        for t in first:
            e = m.ex[m.tx_off[t]:m.tx_off[t + 1]]
            self.introns.append([(b0, a1) for (_, b0), (a1, _) in
                                 zip(e[:-1], e[1:]) if a1 - b0 >= self.L + 2])
        spans = m.genes
        self.inter = []
        for c in range(len(m.names)):
            g = spans[spans[:, 0] == c]
            g = g[np.argsort(g[:, 1])]
            for a, b in zip(np.concatenate([[0], g[:, 2]]),
                            np.concatenate([g[:, 1], [m.lens[c]]])):
                if b - a > self.L + 10:
                    self.inter.append((c, int(a) + 5, int(b) - 5))
        w = np.array([b - a - self.L for _, a, b in self.inter], float)
        self.inter_cum = np.cumsum(w / w.sum())
        self.state = {}

    def prepare(self, out_dir):
        """the job's whitelist: out_dir/whitelist.txt"""
        with open(os.path.join(out_dir, "whitelist.txt"), "w") as f:
            f.write("".join(w + "\n" for w in self.wl))

    # ------------------------------------------------------------------
    def _molecule(self, rng, t):
        """(kind, chromosome, forward blocks [(chr pos, length)], read
        forward?) of a new molecule of a cell of type t; the cDNA read is in
        the gene's sense"""
        m, L = self.m, self.L
        u = rng.random()
        if u < self.share[1]:
            g = _pick(rng, self.cum[t])
            tx = self.tx[g]
            e = m.ex[m.tx_off[tx]:m.tx_off[tx + 1]]
            c, strand = int(m.tx_chr[tx]), int(m.tx_strand[tx])
            if u < self.share[0]:
                tl = int(m.tx_len[tx])
                tail = min(self.p["tail"], tl)
                # transcript position from its 5' end, in the last `tail` bases
                a = int(rng.integers(tl - tail, tl - L + 1)) if tl >= L else 0
                u0 = a if strand == 0 else tl - a - L     # forward concat
                blocks, cum = [], 0
                for s, t_ in e:
                    n = t_ - s
                    if u0 < cum + n and u0 + L > cum:
                        lo, hi = max(u0, cum), min(u0 + L, cum + n)
                        blocks.append((int(s + lo - cum), int(hi - lo)))
                    cum += n
                if sum(b for _, b in blocks) == L:
                    return "exonic", c, blocks, strand == 0
            elif self.introns[g]:
                a, b = self.introns[g][int(rng.integers(0, len(self.introns[g])))]
                s = int(rng.integers(a, b - L + 1))
                return "intronic", c, [(s, L)], strand == 0
        k = _pick(rng, self.inter_cum)
        c, a, b = self.inter[k]
        s = int(rng.integers(a, b - L))
        return "intergenic", c, [(s, L)], bool(rng.random() < 0.5)

    def batch(self, k, stream=0):
        """reads [k * batch_reads, (k + 1) * batch_reads) of a stream (0: the
        window, 1: the warm-up), after the stream's earlier batches:
        ([cDNA records, barcode records], truth)"""
        st = self.state.setdefault(stream, {"next": 0, "mols": {}})
        if k != st["next"]:
            raise ValueError(f"tenx_v3: batch {k} of stream {stream} before "
                             f"batch {st['next']}")
        st["next"] += 1
        p, m, L = self.p, self.m, self.L
        rng = np.random.default_rng([self.seed, stream, k])
        mols = st["mols"]
        rc, rb, truth = [], [], []
        qc, qb = "F" * L, "F" * 28
        for i in range(int(p["batch_reads"])):
            if rng.random() >= p["ambient_share"]:
                j = min(int(np.searchsorted(self.csize, rng.random())),
                        p["cells"] - 1)
                cb, t = self.cells[j], int(self.ctype[j])
            else:
                cb = self.ambient[int(rng.integers(0, p["ambient"]))]
                t = int(rng.integers(0, p["types"]))
            seen = mols.setdefault(cb, [])
            if seen and rng.random() < p["dup_share"]:
                mol, umi = seen[int(rng.integers(0, len(seen)))]
                if rng.random() < p["dup_umi_err"]:
                    umi = _one_off(rng, umi)
            else:
                mol = self._molecule(rng, t)
                umi = _bc(rng.integers(0, 4, 12).astype(np.uint8))
                seen.append((mol, umi))
            kind, c, blocks, fwd = mol
            off = int(m.chr_off[c])
            tmpl = np.concatenate([m.seq[off + g:off + g + n] for g, n in blocks])
            read = tmpl if fwd else COMP[tmpl[::-1]]
            # forward blocks in read coordinates (as the read aligns forward)
            tb, q = [], 0
            for g, n in blocks:
                tb.append([off + g, q, n])
                q += n
            lead = tail = 0
            seq = _bc(read)
            if rng.random() < p["tso_share"]:
                lead = int(rng.integers(20, 31))
                seq = CR4_TSO[-lead:] + seq[:L - lead]
            if rng.random() < p["polya_share"]:
                tail = int(rng.integers(20, 41))
                seq = seq[:L - tail] + "A" * tail
            hit = rng.random(L) < p["sub_rate"]
            if hit.any():
                s = np.frombuffer(seq.encode(), np.uint8).copy()
                s[hit] = BASES[(np.searchsorted(BASES, s[hit])
                                + rng.integers(1, 4, int(hit.sum()))) % 4]
                seq = s.tobytes().decode()
            tb = _cut(tb, lead, tail, fwd, L)
            u = rng.random()
            cb_read = cb
            if u < p["cb_n"]:
                cb_read = _one_off(rng, cb, "N")
            elif u < p["cb_n"] + p["cb_mm"]:
                cb_read = _one_off(rng, cb)
            name = f"s{stream}b{k}r{i}"
            rc.append(f"@{name}\n{seq}\n+\n{qc}\n")
            rb.append(f"@{name}\n{cb_read}{umi}\n+\n{qb}\n")
            truth.append((name, kind, c, fwd, tb, cb))
        return [rc, rb], truth

    def warmup(self, n):
        recs, k = [[], []], 0
        while len(recs[0]) < n:
            r, _ = self.batch(k, stream=1)
            recs[0] += r[0]
            recs[1] += r[1]
            k += 1
        return [recs[0][:n], recs[1][:n]]

    def window_reads(self, n):
        """the first n reads of the window's stream: ({name: (cDNA sequence,
        quality, barcode read, quality)}, {name: (kind, chromosome, forward,
        truth blocks, true barcode)})"""
        self.state.pop(0, None)
        reads, truth, k = {}, {}, 0
        while len(reads) < n:
            recs, tr = self.batch(k)
            for a, b, t in zip(recs[0], recs[1], tr):
                if len(reads) == n:
                    break
                _, s1, _, q1 = a.split("\n")[:4]
                _, s2, _, q2 = b.split("\n")[:4]
                reads[t[0]] = (s1, q1, s2, q2)
                truth[t[0]] = t[1:]
            k += 1
        return reads, truth


def _one_off(rng, x, base=None):
    j = int(rng.integers(0, len(x)))
    b = base or "ACGT".replace(x[j], "")[int(rng.integers(0, 3))]
    return x[:j] + b + x[j + 1:]


def _cut(tb, lead, tail, fwd, L):
    """forward truth blocks of a read whose molecule's forward blocks are tb
    (read coordinates of the molecule's first L bases), after a TSO prefix
    of `lead` bases shifted the molecule right and a polyA tail replaced its
    last `tail` bases: the molecule keeps K = L - lead - tail bases"""
    K = L - lead - tail
    lo, hi, shift = (0, K, lead) if fwd else (L - K, L, -lead)
    out = []
    for g, q, n in tb:
        s, e = max(q, lo), min(q + n, hi)
        if e > s:
            out.append((g + s - q, s + shift, e - s))
    return out
