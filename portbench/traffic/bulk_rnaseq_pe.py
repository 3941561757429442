"""Bulk RNA-seq reads: paired-end fragments of a stranded library.

The expression profile, the read classes and the error model are those of
bulk_rnaseq.py (imported, with its parameters); a read is a pair of mates
read from the two ends of one fragment.  Parameters besides bulk_rnaseq's
(read_len is each mate's length):
  fragment        {"median", "sigma", "min", "max"}: the fragment length,
                  log-normal in transcript coordinates (the spliced length
                  for a mature transcript), cut to [min, max]; never shorter
                  than a mate, so no mate reads into the adapter
  protocol        "antisense" (dUTP: mate 1 is the transcript's reverse
                  complement, read from the fragment's 3' end; mate 2 its
                  sense 5' end), "sense" (the other way round) or
                  "unstranded"

A fragment is drawn from the read's origin as bulk_rnaseq.py draws a read:
a mature transcript, a pre-mRNA intron, an intergenic interval or a repeat
copy, each long enough to hold it (an origin shorter than the fragment is
drawn again, up to TRIES times, then the fragment is cut to the origin).
Each mate carries its truth: whether it reads the forward strand, and the
forward-strand blocks (genome offset, offset in the mate as aligned forward,
length) it was copied from, with its own substitutions and at most one
indel.
"""
from __future__ import annotations

import importlib.util
import os

import numpy as np

_spec = importlib.util.spec_from_file_location(
    "bulk_rnaseq_se", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "bulk_rnaseq.py"))
se = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(se)

TRIES = 20      # draws of an origin long enough for the fragment


class Traffic(se.Traffic):
    mates = 2

    def __init__(self, model, params, seed):
        super().__init__(model, params, seed)
        f = params["fragment"]
        self.frag = (float(f["median"]), float(f["sigma"]), int(f["min"]),
                     int(f["max"]))

    def _fragment_len(self, rng):
        med, sigma, lo, hi = self.frag
        n = int(round(np.exp(rng.normal(np.log(med), sigma))))
        return min(max(n, lo, self.L), hi)

    def _fragment(self, rng, kind, F):
        """(chromosome, forward blocks [(chr pos, length)] of the fragment
        and 2 bases past its right end, sense strand forward?)"""
        m, Lt = self.m, F + 2
        for _ in range(TRIES):
            if kind == "exonic":
                t = se._pick(rng, self.tx_w)
                room = int(m.tx_len[t])
            elif kind == "intronic":
                k = se._pick(rng, self.intron_w)
                c, a, b, strand, _ = (int(x) for x in self.introns[k])
                room = b - a
            elif kind == "intergenic":
                k = se._pick(rng, self.inter_w)
                c, a, b = (int(x) for x in self.inter[k])
                room = b - a
            else:
                k = se._pick(rng, self.rep_w)
                c, a, b, _ = (int(x) for x in self.rep[k])
                room = b - a
            if room >= Lt:
                break
        Lt = min(Lt, room)
        if kind == "exonic":
            e = m.ex[m.tx_off[t]:m.tx_off[t + 1]]
            u = int(rng.integers(0, room - Lt + 1))
            return (int(m.tx_chr[t]), se._blocks_of(e[:, 0], e[:, 1], u, Lt),
                    m.tx_strand[t] == 0)
        s = int(rng.integers(a, b - Lt + 1))
        sense = strand == 0 if kind == "intronic" else rng.random() < 0.5
        return c, [(s, Lt)], sense

    def _mate(self, rng, blocks, fwd, off):
        """(FASTQ sequence, truth blocks) of a mate copied from the forward
        blocks (L + 2 bases) and read forward or reverse"""
        m, L = self.m, self.L
        tb, _ = self._truth(rng, blocks)
        tmpl = rng.integers(0, 4, L).astype(np.uint8)   # inserted bases
        for g, q, ln in tb:
            tmpl[q:q + ln] = m.seq[off + g:off + g + ln]
        read = (tmpl if fwd else se.COMP[tmpl[::-1]]).copy()
        hit = rng.random(L) < self.sub_p
        read[hit] = (read[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
        return (se.BASES[read].tobytes().decode(),
                [(off + g, q, ln) for g, q, ln in tb])

    def warmup(self, n):
        """n pairs of the warm-up stream (never the window's)"""
        recs, k = [[], []], 0
        while len(recs[0]) < n:
            got = self.batch(k, stream=1)[0]
            recs[0] += got[0]
            recs[1] += got[1]
            k += 1
        return [recs[0][:n], recs[1][:n]]

    def window_reads(self, n):
        """the first n pairs of the window's stream: ({name: (mate 1
        sequence, mate 1 quality, mate 2 sequence, mate 2 quality)}, {name:
        (kind, chromosome, [(forward, truth blocks) of mate 1, of mate 2])})"""
        reads, truth, k = {}, {}, 0
        while len(reads) < n:
            recs, tr = self.batch(k)
            for r1, r2, t in zip(recs[0], recs[1], tr):
                if len(reads) == n:
                    break
                _, s1, _, q1 = r1.split("\n")[:4]
                _, s2, _, q2 = r2.split("\n")[:4]
                reads[t[0]] = (s1, q1, s2, q2)
                truth[t[0]] = t[1:]
            k += 1
        return reads, truth

    def batch(self, k, stream=0):
        """pairs [k * batch_reads, (k + 1) * batch_reads) of a stream of the
        run (0: the window, 1: the warm-up): (FASTQ records [mate 1, mate 2],
        truth)"""
        n = int(self.p["batch_reads"])
        rng = np.random.default_rng([self.seed, stream, k])
        m, L = self.m, self.L
        kinds = rng.choice(len(self.kinds), size=n, p=self.share)
        recs, truth = [[], []], []
        qual = "F" * L
        proto = self.p["protocol"]
        for i in range(n):
            kind = self.kinds[kinds[i]]
            F = self._fragment_len(rng)
            c, blocks, sense_fwd = self._fragment(rng, kind, F)
            F = sum(b[1] for b in blocks) - 2
            # the fragment's left end, read forward, and its right end, read
            # reverse; each copied from L + 2 forward bases (room for a
            # deletion)
            left = se._blocks_of([b[0] for b in blocks],
                                 [b[0] + b[1] for b in blocks], 0, L + 2)
            right = se._blocks_of([b[0] for b in blocks],
                                  [b[0] + b[1] for b in blocks], F - L, L + 2)
            if proto == "antisense":
                fwd1 = not sense_fwd
            elif proto == "sense":
                fwd1 = bool(sense_fwd)
            else:
                fwd1 = rng.random() < 0.5
            off = int(m.chr_off[c])
            name = f"p{stream}b{k}r{i}"
            mates = []
            for im, fwd in enumerate((fwd1, not fwd1)):
                seq, tb = self._mate(rng, left if fwd else right, fwd, off)
                recs[im].append(f"@{name}\n{seq}\n+\n{qual}\n")
                mates.append((fwd, tb))
            truth.append((name, kind, c, mates))
        return recs, truth
