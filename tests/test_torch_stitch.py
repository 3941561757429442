"""The port's device grow engine (star_tpu_torch/ops/device_stitch.py) on the
CPU, where fetch_rows takes its plain version.

Every grow the alignment runs is held, field by field, against the port's
numpy grow_chains on copies of the same inputs, with the same chain-cap
fallbacks, on every escalation level of the five
goldens; the same runs, with the device grow forced on every level, give
the goldens byte for byte.  Exact equality throughout (integer data, text
outputs).  More engine cases: test_torch_stitch_engine.py."""
import copy
import os

import numpy as np
import pytest
import torch

from star_tpu_torch.genome.index import GenomeIndex
from star_tpu_torch.ops import batch_engine as be
from star_tpu_torch.ops import device_stitch as ds
from star_tpu_torch.params import Parameters
from star_tpu_torch.run import align_reads
from tests.conftest import DATA, GOLD

READS = {"se": ["reads_se.fastq"],
         "pe": ["reads_pe_1.fastq", "reads_pe_2.fastq"]}
GOLDENS = [("se", "genome_idx", "se"), ("pe", "genome_idx", "pe"),
           ("se_gtf", "genome_idx_gtf", "se"),
           ("se_sp2", "genome_idx_sp2", "se"),
           ("pe_sp2", "genome_idx_sp2", "pe")]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """the grow is thousands of small tensor ops: on the CPU one intra-op
    thread runs them faster than a pool, and keeps the parallel test
    workers from oversubscribing the cores"""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def force_device_grow(monkeypatch):
    monkeypatch.delenv("STAR_TPU_DEVICE_STITCH", raising=False)
    monkeypatch.setattr(be, "DEVICE_GROW_MIN_RECORDS",
                        {s_max: 0 for _, s_max, _ in be.LEVELS})


def assert_lanes_equal(got, want):
    for k in be._lane_fields():
        a, b = getattr(got, k), getattr(want, k)
        assert a.shape == b.shape and np.array_equal(a, b), k


def spy_grow(monkeypatch):
    """wrap the port's grow_chains_device: each call also runs the numpy
    grow_chains on copies of its inputs, and asserts equal LaneStates and
    fallbacks.  Returns the list of calls seen."""
    real = ds.grow_chains_device
    seen = []

    def spy(gi, P, st, ws, RS, nmm, Lpad, s_max, chain_cap, device):
        st_np = copy.deepcopy(st)
        want = be.grow_chains(gi, P, gi.G.view(np.uint8), RS, st_np, ws, nmm,
                              Lpad, chain_cap=chain_cap)
        got = real(gi, P, st, ws, RS, nmm, Lpad, s_max, chain_cap, device)
        assert_lanes_equal(got, want)
        assert np.array_equal(st.fallback, st_np.fallback)
        seen.append({"w_max": ws.win_alive.shape[1], "lanes": len(want.b),
                     "Lpad": Lpad})
        return got

    monkeypatch.setattr(ds, "grow_chains_device", spy)
    return seen


def _body(path):
    with open(path) as f:
        return [l for l in f if not l.startswith("@")]


def _align_golden(tmp_path, idx, reads):
    prefix = str(tmp_path) + "/"
    P = Parameters(["--genomeDir", os.path.join(GOLD, idx),
                    "--readFilesIn", *[os.path.join(DATA, r)
                                       for r in READS[reads]],
                    "--outFileNamePrefix", prefix,
                    "--outSAMunmapped", "Within"])
    align_reads(P, gi=GenomeIndex.load(os.path.join(GOLD, idx)),
                device="cpu")
    return prefix


@pytest.mark.parametrize("gold,idx,reads", GOLDENS,
                         ids=[g[0] for g in GOLDENS])
def test_device_grow_matches_numpy_and_goldens(tmp_path, monkeypatch,
                                               force_device_grow, gold, idx,
                                               reads):
    seen = spy_grow(monkeypatch)
    be.LEVEL_STATS.clear()
    prefix = _align_golden(tmp_path, idx, reads)
    assert seen and all(c["lanes"] > 0 for c in seen)
    runs = {w: be.LEVEL_STATS[w, "runs"] for w, _ in be.LEVEL_STATS}
    assert runs and all(be.LEVEL_STATS[w, "device"] == n
                        for w, n in runs.items())
    assert _body(prefix + "Aligned.out.sam") == \
        _body(os.path.join(GOLD, gold, "Aligned.out.sam"))
    with open(prefix + "SJ.out.tab") as a, \
            open(os.path.join(GOLD, gold, "SJ.out.tab")) as b:
        assert a.read() == b.read()
