"""What the benchmark's CPU tests run on every cell: a tiny copy of the
benchmark (portbench_tiny.make_tiny), a cell's run on it with the port on
CPU tensors, the exact checks a workload names (its limits of 0), the
controls its configuration names, and faults planted under the timed path.

portbench/tests/test_portbench_reference.py holds the same faults, with its
exact checks and controls keyed by the cells it knew; tests/test_portbench_
cells.py and tests/test_portbench_faults.py take both from the cells' files,
so that every cell of BENCHMARK.json is held to them."""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PB = os.path.join(ROOT, "portbench")
sys.path.insert(0, os.path.join(PB, "tests"))
from portbench_tiny import CELLS, PARKED, make_tiny  # noqa: E402,F401

SEED = 2**31 + 11
SECONDS = 4.0
HOST = ["--tpuUseDevice", "0"]


def workload(cell):
    with open(os.path.join(PB, "workloads", cell + ".json")) as f:
        return json.load(f)


def exact_checks(cell):
    """the checks a cell holds at 0"""
    return {n for n, v in workload(cell)["limits"].items() if v == 0}


def controls(cell):
    """{name: extra flags} of the cell's configuration's controls"""
    with open(os.path.join(PB, "configs",
                           workload(cell)["config"] + ".json")) as f:
        return {c["name"]: c["flags"] for c in json.load(f)["controls"]}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield make_tiny(str(tmp_path_factory.mktemp("tiny")))
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def modules_of_the_session(monkeypatch):
    """tests/conftest.py loads jax into this process before the run: the run
    itself must load no module of JAX or the JAX package"""
    from portbench import run as pbrun
    before = set(sys.modules)
    real = pbrun.forbidden_loaded
    monkeypatch.setattr(pbrun, "forbidden_loaded", lambda names: real(
        [n for n in names if n not in before]))


def run(pb, cell, plant=None, extra=()):
    from portbench import run as pbrun
    return pbrun.run_cell(cell, SEED, SECONDS, False, device="cpu", pb=pb,
                          plant=plant, extra_flags=extra)


def assert_sound(result, checks, cell):
    assert result["correct"], checks
    assert result["attempted"] > 500
    exact = {n: v for n, v, _ in checks if n != "missed_pct"}
    assert set(exact) == exact_checks(cell)
    assert all(v == 0 for v in exact.values())


# ---- faults under the timed path -----------------------------------------

def half_batch(monkeypatch):
    from star_tpu_torch import run as st_run
    orig = st_run._align_all

    def half(P, *a, **k):
        # the second half of every batch is left out of the job's outputs
        for i, res in enumerate(orig(P, *a, **k)):
            if i % P.tpuBatchSize < P.tpuBatchSize // 2:
                yield res
    return lambda: monkeypatch.setattr(st_run, "_align_all", half)


def state_unchanged(monkeypatch):
    from star_tpu_torch.ops import pipeline
    orig = pipeline.DeviceAligner._run_chains_fused

    def unchanged(self, *a):
        # the seed loop hands back its tables as it made them: no probe ran
        return tuple(np.zeros_like(x) for x in orig(self, *a))
    return lambda: monkeypatch.setattr(pipeline.DeviceAligner,
                                       "_run_chains_fused", unchanged)


def answer_altered(monkeypatch):
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


def sj_altered(monkeypatch):
    from star_tpu_torch.io.sj import SJCollector
    orig = SJCollector.collapse_and_filter

    def altered(self):
        rows = orig(self)
        if rows:
            rows[len(rows) // 2][5] += 1      # one junction's unique reads
        return rows
    return lambda: monkeypatch.setattr(SJCollector, "collapse_and_filter",
                                       altered)


def clip_skipped(monkeypatch):
    from star_tpu_torch.align.clip import ClipMate
    orig = ClipMate.clip_batch

    def skipped(self, seqs):
        # the batch's 5' TSO clip finds no adapter in any read
        orig(self, seqs)
        self.batch_info = {k: 0 for k in self.batch_info}
    return lambda: monkeypatch.setattr(ClipMate, "clip_batch", skipped)


def matrix_altered(monkeypatch):
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


def sorted_bam_unsorted(monkeypatch):
    from star_tpu_torch.io import bam
    orig = bam.BamCollector._load_bin

    def unsorted(self, b):
        # each bin of the coordinate sort is written in arrival order
        recs = orig(self, b)
        recs.sort(key=lambda t: t[2])
        return recs
    return lambda: monkeypatch.setattr(bam.BamCollector, "_load_bin",
                                       unsorted)


FAULTS = {f.__name__: f for f in (half_batch, state_unchanged,
                                  answer_altered, sj_altered, clip_skipped,
                                  matrix_altered, sorted_bam_unsorted)}
# every cell: the three faults of the timed path; then each cell's own
CELL_FAULTS = [(c, f) for c in CELLS for f in
               ("half_batch", "state_unchanged", "answer_altered")]
CELL_FAULTS += [(c, f) for c, f in (
    ("solo_cr4_10xv3.pbmc", "matrix_altered"),
    ("solo_cr4_10xv3.pbmc", "clip_skipped"),
    ("encode_lrna_pe100.polya", "sorted_bam_unsorted")) if c in CELLS]
