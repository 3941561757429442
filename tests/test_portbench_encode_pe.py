"""The benchmark's paired-end ENCODE cell, encode_lrna_pe100.polya, on the
CPU beyond what every cell is held to (tests/test_portbench_cells.py and
tests/test_portbench_faults.py): its traffic (portbench/traffic/
bulk_rnaseq_pe.py), a run that loses one mate's records of every pair, and
its judge (portbench/reference/bulk_pairs.py) on STAR 2.7.11b's own
paired-end golden.  The stitch levels keep the numpy grow here (the device
engine on CPU tensors is the stitch tests' to hold)."""
import os
import struct

import numpy as np
import pytest

from tests.conftest import DATA, GOLD, ROOT
from tests.portbench_cases import (modules_of_the_session, run,  # noqa: F401
                                   tiny)

from portbench import run as pbrun  # noqa: E402

CELL = "encode_lrna_pe100.polya"
SEED = 2**31 + 11


@pytest.fixture(autouse=True)
def numpy_grow(monkeypatch):
    from star_tpu_torch.ops import batch_engine as be
    monkeypatch.setattr(be, "DEVICE_GROW_MIN_RECORDS",
                        {k: 1 << 40 for k in be.DEVICE_GROW_MIN_RECORDS})


def test_one_mate_dropped_is_not_correct(tiny, monkeypatch):
    """every pair's mate-2 records left out of Aligned.out.bam"""
    from star_tpu_torch.io import bam
    orig = bam.BamCollector.add_read

    def dropped(self, res):
        w = self.unsorted

        class Sieve:
            def write(self, r):
                if not struct.unpack_from("<H", r, 18)[0] & 0x80:
                    w.write(r)
        self.unsorted = Sieve()
        try:
            orig(self, res)
        finally:
            self.unsorted = w
    result, checks = run(tiny, CELL, plant=lambda: monkeypatch.setattr(
        bam.BamCollector, "add_read", dropped))
    assert not result["correct"], checks
    got = {n: v for n, v, _ in checks}
    assert got["reads_missing"] == result["attempted"]


def _fastq(path):
    with open(path) as f:
        lines = f.read().split("\n")
    return {lines[i][1:].split()[0]: (lines[i + 1], lines[i + 3])
            for i in range(0, len(lines) - 3, 4)}


def test_judge_passes_stars_paired_end_golden(tmp_path):
    """STAR 2.7.11b's tests/golden/small/pe (default flags, --outSAMunmapped
    Within, SAM, an index without annotation): no bad record, SJ.out.tab
    re-derived row for row"""
    from portbench.reference.bulk_pairs import PairJudge
    from portbench.reference.genome import RefGenome
    m1 = _fastq(os.path.join(DATA, "reads_pe_1.fastq"))
    m2 = _fastq(os.path.join(DATA, "reads_pe_2.fastq"))
    reads = {n: (*m1[n], *m2[n]) for n in m1}
    (tmp_path / "none.gtf").write_text("")
    G = RefGenome(os.path.join(DATA, "genome.fa"), str(tmp_path / "none.gtf"))
    J = PairJudge(G, ["--outSAMunmapped", "Within"])
    gold = os.path.join(GOLD, "pe")
    mapped, missing, bad, best = J.alignments(gold, reads)
    assert (missing, bad) == (0, 0), J.notes
    assert len(mapped) == len(reads) == 150
    assert J.sj_rows_diff(os.path.join(gold, "SJ.out.tab"), mapped) == 0
    # a record's AS one off is caught
    _, recs, mfs = J.records(gold)
    J.records = lambda out_dir: (_, recs, mfs)
    recs[5].tags["AS"] += 1
    assert J.alignments(gold, reads)[2] == 2


def test_traffic_pairs(tiny):
    """the same seed gives the same pairs; mates are the two ends of one
    fragment on opposite strands, mate 1 antisense to its transcript
    (dUTP), with fragment lengths log-normal around 250 and about a fifth
    of the pairs overlapping"""
    from portbench.harness import cache
    from portbench.harness.feeder import make_traffic
    cell = pbrun.Cell(CELL, tiny)
    spec = {"root": ROOT, "model_dir": cache.genome_dir(cell.cfg["genome"], tiny),
            "seed": SEED, "params": cell.wl["params"],
            "traffic_file": os.path.join(tiny, "traffic", "bulk_rnaseq_pe.py")}
    t = make_traffic(spec)
    assert t.mates == 2
    recs, truth = t.batch(0)
    assert recs == make_traffic(spec).batch(0)[0]
    assert len(recs[0]) == len(recs[1]) == len(truth) == 256
    m = t.m
    overlap, antisense, exonic = 0, 0, 0
    for (name, kind, c, ((f1, b1), (f2, b2))), r1, r2 in zip(truth, *recs):
        assert r1.split("\n")[0] == r2.split("\n")[0] == "@" + name
        assert f1 != f2 and all(len(x.split("\n")[1]) == 100 for x in (r1, r2))
        left, right = (b1, b2) if f1 else (b2, b1)
        assert left[0][0] <= right[0][0]
        overlap += left[-1][0] + left[-1][2] > right[0][0]
        if kind == "exonic":
            exonic += 1
            g = left[0][0] - int(m.chr_off[c])
            hit = [k for k in range(len(m.tx_chr)) if m.tx_chr[k] == c
                   and m.ex[m.tx_off[k]][0] <= g < m.ex[m.tx_off[k + 1] - 1][1]]
            antisense += bool(hit) and f1 == bool(m.tx_strand[hit[0]])
    assert exonic > 200 and antisense == exonic
    assert 0.08 < overlap / len(truth) < 0.35
    rng = np.random.default_rng(SEED)
    frag = np.array([t._fragment_len(rng) for _ in range(4000)])
    assert frag.min() >= 120 and frag.max() <= 600
    assert 240 < np.median(frag) < 260
    assert 0.15 < (frag < 200).mean() < 0.23


def test_sorted_bam_check_passes_stars_golden():
    """STAR 2.7.11b's tests/golden/small/se_bam wrote Aligned.out.bam and
    Aligned.sortedByCoord.out.bam in one job: the judge finds the same
    records in coordinate order under an SO:coordinate header, and finds
    the unsorted BAM out of order"""
    from portbench.reference.bulk_pairs import sorted_bam_diff
    gold = os.path.join(GOLD, "se_bam")
    uns = os.path.join(gold, "Aligned.out.bam")
    assert sorted_bam_diff(uns, os.path.join(
        gold, "Aligned.sortedByCoord.out.bam")) == 0
    assert sorted_bam_diff(uns, uns) > 100
