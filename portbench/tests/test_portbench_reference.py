"""The reference against the port run on the CPU on a tiny genome: a sound
run comes out correct with every exact number at 0, and a run with the timed
path broken underneath comes out not correct, once for each fault a cell
can have (one chip: no exchange between chips to leave out).  The controls
of the configuration come out not correct too.  The parked ENCODE cell's
check, transcriptome BAM included, holds on the port's host path, and the
reference's Cell Ranger 4 clip is the port's."""
from __future__ import annotations

import numpy as np
import pytest

from portbench_tiny import CELLS, PARKED, tiny  # noqa: F401

SEED = 2**31 + 11
SECONDS = 4.0


EXACT = {"encode_lrna_se100.polya": {"reads_missing", "bad_records",
                                     "sj_rows_diff", "trsam_diff"},
         "solo_cr4_10xv3.pbmc": {"reads_missing", "bad_records",
                                 "gene_matrix_diff", "genefull_matrix_diff",
                                 "cell_calls_diff"}}
HOST = ["--tpuUseDevice", "0"]


def _run(pb, cell, plant=None, extra=()):
    import run
    return run.run_cell(cell, SEED, SECONDS, False, device="cpu", pb=pb,
                        plant=plant, extra_flags=extra)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    result, checks = _run(tiny, cell)
    assert result["correct"], checks
    assert result["attempted"] > 500
    exact = {n: v for n, v, _ in checks if n != "missed_pct"}
    assert set(exact) == EXACT[cell]
    assert all(v == 0 for v in exact.values())
    assert list(result)[-1] == "checks"


def _half_batch(monkeypatch):
    from star_tpu_torch import run as st_run
    orig = st_run._align_all

    def half(P, *a, **k):
        # the second half of every batch is left out of the job's outputs
        for i, res in enumerate(orig(P, *a, **k)):
            if i % P.tpuBatchSize < P.tpuBatchSize // 2:
                yield res
    return lambda: monkeypatch.setattr(st_run, "_align_all", half)


def _state_unchanged(monkeypatch):
    from star_tpu_torch.ops import pipeline
    orig = pipeline.DeviceAligner._run_chains_fused

    def unchanged(self, *a):
        # the seed loop hands back its tables as it made them: no probe ran
        return tuple(np.zeros_like(x) for x in orig(self, *a))
    return lambda: monkeypatch.setattr(pipeline.DeviceAligner,
                                       "_run_chains_fused", unchanged)


def _answer_altered(monkeypatch):
    from star_tpu_torch.ops import pipeline
    orig = pipeline._fast_finish
    seen = [0]

    def altered(host, res, seeds, pre, P, gi):
        out = orig(host, res, seeds, pre, P, gi)
        seen[0] += 1
        if seen[0] % 50 == 0 and out.unmap_type < 0:
            out.transcripts[0].maxScore += 1
        return out
    return lambda: monkeypatch.setattr(pipeline, "_fast_finish", altered)


def _sj_altered(monkeypatch):
    from star_tpu_torch.io.sj import SJCollector
    orig = SJCollector.collapse_and_filter

    def altered(self):
        rows = orig(self)
        if rows:
            rows[len(rows) // 2][5] += 1      # one junction's unique reads
        return rows
    return lambda: monkeypatch.setattr(SJCollector, "collapse_and_filter",
                                       altered)


def _clip_skipped(monkeypatch):
    from star_tpu_torch.align.clip import ClipMate
    orig = ClipMate.clip_batch

    def skipped(self, seqs):
        # the batch's 5' TSO clip finds no adapter in any read
        orig(self, seqs)
        self.batch_info = {k: 0 for k in self.batch_info}
    return lambda: monkeypatch.setattr(ClipMate, "clip_batch", skipped)


def _matrix_altered(monkeypatch):
    from star_tpu_torch.solo import feature
    orig = feature.collapse_cb
    seen = [0]

    def altered(records, conf, read_info_yes):
        rows, n_gene, n_umi, ri, mult = orig(records, conf, read_info_yes)
        seen[0] += 1
        if rows and seen[0] % 10 == 0:
            rows[0][1] += 1                   # one gene's UMIs in a barcode
        return rows, n_gene, n_umi, ri, mult
    return lambda: monkeypatch.setattr(feature, "collapse_cb", altered)


FAULTS = {"half_batch": _half_batch, "state_unchanged": _state_unchanged,
          "answer_altered": _answer_altered, "sj_altered": _sj_altered,
          "clip_skipped": _clip_skipped, "matrix_altered": _matrix_altered}
CELL_FAULTS = [(c, f) for c in CELLS for f in
               ("half_batch", "state_unchanged", "answer_altered")]
CELL_FAULTS += [("solo_cr4_10xv3.pbmc", "matrix_altered"),
                ("solo_cr4_10xv3.pbmc", "clip_skipped")]


@pytest.mark.parametrize("cell,fault", CELL_FAULTS)
def test_fault_is_not_correct(tiny, monkeypatch, cell, fault):
    result, checks = _run(tiny, cell, plant=FAULTS[fault](monkeypatch))
    assert not result["correct"], checks


CONTROLS = [(c, k) for c in CELLS for k in
            {"solo_cr4_10xv3.pbmc": ("umi_exact", "mismatch_1")}[c]]


@pytest.mark.parametrize("cell,control", CONTROLS)
def test_control_is_not_correct(tiny, cell, control):
    import run
    c = run.Cell(cell, tiny)
    flags = [x["flags"] for x in c.cfg["controls"] if x["name"] == control][0]
    result, checks = _run(tiny, cell, extra=flags)
    assert not result["correct"], checks


@pytest.mark.parametrize("cell", PARKED)
def test_transcriptome_bam_on_the_host_path(tiny, cell):
    """the parked ENCODE cell's check (--quantMode TranscriptomeSAM, which
    the port's device path cannot run yet: PERF.md) comes out correct on
    the port's per-read host path, every exact number at 0"""
    result, checks = _run(tiny, cell, extra=HOST)
    assert result["correct"], checks
    exact = {n: v for n, v, _ in checks if n != "missed_pct"}
    assert set(exact) == EXACT[cell]
    assert all(v == 0 for v in exact.values())


@pytest.mark.parametrize("cell", PARKED)
def test_parked_fault_is_not_correct(tiny, monkeypatch, cell):
    result, checks = _run(tiny, cell, plant=_sj_altered(monkeypatch),
                          extra=HOST)
    assert not result["correct"], checks


def test_reference_clip_is_the_ports():
    """reference/cr4_clip.py clips what the port's CellRanger4 ClipMates
    clip, on reads led by parts of the TSO and ending in A tails, with
    substitutions in both"""
    from portbench.reference.cr4_clip import TSO, clips
    from star_tpu_torch.align.clip import ClipMate
    from star_tpu_torch.constants import encode_seq
    rng = np.random.default_rng(2**31 + 3)
    seqs = []
    for _ in range(3000):
        s = list(rng.choice(list("ACGT"), 91))
        if rng.random() < 0.5:
            n = int(rng.integers(5, 31))
            s[:n] = TSO[-n:]
        if rng.random() < 0.4:
            n = int(rng.integers(5, 50))
            s[91 - n:] = "A" * n
        for k in np.nonzero(rng.random(91) < 0.03)[0]:
            s[k] = "ACGTN"[int(rng.integers(0, 5))]
        seqs.append("".join(s))
    c5, c3 = ClipMate(10, 0, TSO, 0, 0.1), ClipMate(11, 0, "A", 0, 0.1)
    c5.clip_batch(seqs)
    want = []
    for s in seqs:
        m = encode_seq(s)
        lread, off = c5.clip(m, len(m))
        c3.clip(m[off:], lread)
        want.append((c5.clipped_n, c3.clipped_n))
    got = clips(seqs)
    assert got == want
    assert sum(a > 0 for a, _ in got) > 500 and sum(b > 0 for _, b in got) > 300
