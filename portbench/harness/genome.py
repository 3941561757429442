"""Synthetic genome and annotation of a genome file (portbench/genomes/).

A genome file fixes everything: the chromosomes, the repeat families and
their shares, the gene model and the seed.  `build` makes the sequence, the
GTF and a compact model (the arrays the traffic generators draw from) and
writes them into a directory; the same file always gives the same bytes.

The sequence is uniform background at the file's GC share, overwritten by
interspersed repeat copies (each family's consensus, cut and diverged by
substitutions, on either strand), simple repeats and segmental duplications,
so repeats fall in introns and between genes as they do in a mammalian
genome.  Genes are then laid out without overlap; their exons are fresh
sequence (no repeats) and every intron starts with GT and ends with AG on the
gene's strand.
"""
from __future__ import annotations

import os

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)


def _background(rng, n, gc):
    p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
    return rng.choice(4, size=n, p=p).astype(np.uint8)


def _diverge(rng, seq, d):
    """seq with a share d of its bases substituted by another base"""
    out = seq.copy()
    hit = rng.random(len(out)) < d
    out[hit] = (out[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return out


def _revcomp(codes):
    return (3 - codes)[::-1]


def _place(rng, chrs, lens, copy):
    """overwrite a random place of a chromosome (chosen by length) with copy;
    returns (chromosome index, start)"""
    c = int(rng.choice(len(chrs), p=lens / lens.sum()))
    L = len(copy)
    s = int(rng.integers(0, lens[c] - L))
    chrs[c][s:s + L] = copy
    return c, s


def _repeats(rng, spec, chrs, lens):
    """interspersed families, simple repeats and segmental duplications;
    returns the copies as (chromosome, start, end, family index)"""
    G = float(lens.sum())
    copies = []
    fams = spec["repeats"]["families"]
    for fi, fam in enumerate(fams):
        cons = [_background(rng, fam["consensus_len"], spec["gc"])
                for _ in range(fam.get("subfamilies", 1))]
        lo, hi = fam["copy_len"]
        placed = 0.0
        while placed < fam["share"] * G:
            k = int(rng.integers(0, len(cons)))
            # truncated copies keep the consensus' 3' end (as L1 copies do)
            L = int(round(np.exp(rng.uniform(np.log(lo), np.log(hi)))))
            seq = cons[k][len(cons[k]) - L:]
            seq = _diverge(rng, seq, rng.uniform(*fam["divergence"]))
            if rng.random() < 0.5:
                seq = _revcomp(seq)
            c, s = _place(rng, chrs, lens, seq)
            copies.append((c, s, s + L, fi))
            placed += L
    simple = spec["repeats"]["simple"]
    placed = 0.0
    fi = len(fams)
    while placed < simple["share"] * G:
        unit = rng.integers(0, 4, int(rng.integers(simple["unit_len"][0],
                                                   simple["unit_len"][1] + 1)))
        L = int(rng.integers(simple["copy_len"][0], simple["copy_len"][1] + 1))
        seq = _diverge(rng, np.resize(unit, L).astype(np.uint8),
                       simple["divergence"])
        c, s = _place(rng, chrs, lens, seq)
        copies.append((c, s, s + L, fi))
        placed += L
    sd = spec["repeats"]["segdup"]
    placed = 0.0
    fi += 1
    while placed < sd["share"] * G:
        L = int(rng.integers(sd["copy_len"][0], sd["copy_len"][1] + 1))
        c0 = int(rng.choice(len(chrs), p=lens / lens.sum()))
        s0 = int(rng.integers(0, lens[c0] - L))
        seq = _diverge(rng, chrs[c0][s0:s0 + L], rng.uniform(*sd["divergence"]))
        if rng.random() < 0.5:
            seq = _revcomp(seq)
        c, s = _place(rng, chrs, lens, seq)
        copies.append((c, s, s + L, fi))
        placed += L
    return copies


def _lognormal_int(rng, median, sigma, lo, hi, n=None):
    x = np.exp(rng.normal(np.log(median), sigma, n))
    return np.clip(np.round(x), lo, hi).astype(np.int64)


def _genes(rng, spec, chrs, lens):
    """lay genes out along the chromosomes; returns the gene and transcript
    tables (exons as 0-based half-open genome intervals, ascending)"""
    gs = spec["genes"]
    n_genes = gs["n"]
    per_chr = np.floor(n_genes * lens / lens.sum()).astype(int)
    per_chr[0] += n_genes - per_chr.sum()
    genes = []
    for c, n_c in enumerate(per_chr):
        # draw every gene's structure, then share the rest as intergenic gaps
        structs = []
        for _ in range(n_c):
            n_ex = int(_lognormal_int(rng, gs["exons_median"], gs["exons_sigma"],
                                      1, gs["exons_max"]))
            ex = _lognormal_int(rng, gs["exon_len_median"], gs["exon_len_sigma"],
                                gs["exon_len_min"], gs["exon_len_max"], n_ex)
            ex[0] = _lognormal_int(rng, gs["first_exon_median"],
                                   gs["exon_len_sigma"], gs["exon_len_min"],
                                   gs["exon_len_max"])
            if n_ex > 1:
                ex[-1] = _lognormal_int(rng, gs["last_exon_median"],
                                        gs["exon_len_sigma"], gs["exon_len_min"],
                                        gs["exon_len_max"])
            intr = _lognormal_int(rng, gs["intron_median"], gs["intron_sigma"],
                                  gs["intron_min"], gs["intron_max"], n_ex - 1)
            structs.append((ex, intr))
        span = sum(int(e.sum() + i.sum()) for e, i in structs)
        free = lens[c] - span - 2 * gs["chr_margin"]
        if free <= 0:
            raise ValueError("genome file: genes do not fit the chromosome")
        cuts = np.sort(rng.integers(0, free, n_c))
        gaps = np.diff(np.concatenate([[0], cuts]))
        pos = gs["chr_margin"]
        for (ex, intr), gap in zip(structs, gaps):
            pos += int(gap)
            starts, p = [], pos
            for k in range(len(ex)):
                starts.append(p)
                p += int(ex[k]) + (int(intr[k]) if k < len(intr) else 0)
            genes.append((c, pos, [(s, s + int(l)) for s, l in zip(starts, ex)]))
            pos = p
    tx = []
    for gi_, (c, _, exons) in enumerate(genes):
        strand = int(rng.integers(0, 2))      # 0: +, 1: -
        seqs = chrs[c]
        for a, b in exons:                     # exons carry no repeats
            seqs[a:b] = _background(rng, b - a, spec["gc"])
        for (a0, b0), (a1, b1) in zip(exons[:-1], exons[1:]):
            if strand == 0:
                seqs[b0:b0 + 2] = (2, 3)       # GT ... AG
                seqs[a1 - 2:a1] = (0, 2)
            else:
                seqs[b0:b0 + 2] = (1, 3)       # CT ... AC (AG..GT reversed)
                seqs[a1 - 2:a1] = (0, 1)
        n_iso = int(rng.integers(gs["isoforms"][0], gs["isoforms"][1] + 1))
        seen = set()
        for k in range(n_iso):
            keep = [True] * len(exons)
            if k > 0 and len(exons) > 2:
                for j in range(1, len(exons) - 1):
                    keep[j] = rng.random() >= gs["exon_skip"]
            key = tuple(keep)
            if key in seen:
                continue
            seen.add(key)
            tx.append((gi_, c, strand, [e for e, kk in zip(exons, keep) if kk]))
    return genes, tx


def build(spec: dict, out_dir: str) -> None:
    """write genome.fa, annot.gtf and model.npz of the spec into out_dir"""
    rng = np.random.default_rng(spec["seed"])
    names = [c[0] for c in spec["chromosomes"]]
    lens = np.array([c[1] for c in spec["chromosomes"]], np.int64)
    chrs = [_background(rng, int(n), spec["gc"]) for n in lens]
    copies = _repeats(rng, spec, chrs, lens)
    genes, tx = _genes(rng, spec, chrs, lens)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "genome.fa"), "wb") as f:
        for name, s in zip(names, chrs):
            f.write(f">{name}\n".encode())
            txt = BASES[s]
            n_full = len(txt) // 60
            body = np.empty((n_full, 61), np.uint8)
            body[:, :60] = txt[:n_full * 60].reshape(n_full, 60)
            body[:, 60] = ord("\n")
            f.write(body.tobytes())
            if len(txt) % 60:
                f.write(txt[n_full * 60:].tobytes() + b"\n")
    with open(os.path.join(out_dir, "annot.gtf"), "w") as f:
        by_gene = {}
        for t in tx:
            by_gene.setdefault(t[0], []).append(t)
        for g, ts in sorted(by_gene.items()):
            c, strand = ts[0][1], "+-"[ts[0][2]]
            lo = min(t[3][0][0] for t in ts)
            hi = max(t[3][-1][1] for t in ts)
            gid = f"G{g:05d}"
            ga = f'gene_id "{gid}"; gene_name "GN{g:05d}"; gene_type "protein_coding";'
            f.write(f"{names[c]}\tsynth\tgene\t{lo + 1}\t{hi}\t.\t{strand}\t.\t{ga}\n")
            for k, t in enumerate(ts):
                ta = f'{ga} transcript_id "{gid}.{k + 1}";'
                ex = t[3]
                f.write(f"{names[c]}\tsynth\ttranscript\t{ex[0][0] + 1}\t"
                        f"{ex[-1][1]}\t.\t{strand}\t.\t{ta}\n")
                for a, b in ex:
                    f.write(f"{names[c]}\tsynth\texon\t{a + 1}\t{b}\t.\t"
                            f"{strand}\t.\t{ta}\n")
    tx_off = np.cumsum([0] + [len(t[3]) for t in tx])
    ex = np.array([e for t in tx for e in t[3]], np.int64).reshape(-1, 2)
    rep = np.array(copies, np.int64).reshape(-1, 4)
    gene_rows = np.array([(c, ex_[0][0], ex_[-1][1]) for c, _, ex_ in genes],
                         np.int64)
    np.savez(os.path.join(out_dir, "model.npz"),
             names=np.array(names), lens=lens,
             seq=np.concatenate(chrs),
             tx_gene=np.array([t[0] for t in tx], np.int64),
             tx_chr=np.array([t[1] for t in tx], np.int64),
             tx_strand=np.array([t[2] for t in tx], np.int64),
             tx_off=tx_off.astype(np.int64), ex=ex, rep=rep, genes=gene_rows)


class Model:
    """the arrays of model.npz, with per-transcript sequences and offsets"""

    def __init__(self, path: str):
        z = np.load(os.path.join(path, "model.npz"))
        self.names = [str(x) for x in z["names"]]
        self.lens = z["lens"]
        self.chr_off = np.concatenate([[0], np.cumsum(self.lens)])
        self.seq = z["seq"]
        self.tx_gene, self.tx_chr = z["tx_gene"], z["tx_chr"]
        self.tx_strand, self.tx_off, self.ex = z["tx_strand"], z["tx_off"], z["ex"]
        self.rep, self.genes = z["rep"], z["genes"]
        self.n_genes = len(self.genes)
        ex_len = self.ex[:, 1] - self.ex[:, 0]
        self.tx_len = np.add.reduceat(ex_len, self.tx_off[:-1])
