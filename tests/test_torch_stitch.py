"""The port's device stitch engine (star_tpu_torch/ops/device_stitch.py) on
the CPU, where fetch_rows takes its plain version.

Every grow the alignment runs is held, field by field, against the port's
numpy grow_chains on copies of the same inputs, with the same chain-cap
fallbacks, on every escalation level of the five goldens; so is its
finalize (accept and the extended lanes) against numpy finalize_lanes, and
on single-end runs its select against a numpy form of the same rule.  The
same runs, with the device engine forced on every level, give the goldens
byte for byte.  Exact equality throughout (integer data, text outputs).
More engine cases: test_torch_stitch_engine.py, test_torch_finalize.py."""
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


NEGI, BIGI = -(1 << 30), 1 << 30


def numpy_select(P, lanes, accept, B):
    """numpy form of the device select (device_stitch.select_lanes) over the
    numpy engine's finalized lanes, which are in (read, window, DFS) order:
    (over [B] bool, indices of the lanes a classifying run downloads)"""
    ai = np.nonzero(accept)[0]
    b = lanes.b[ai].astype(np.int64)
    score = lanes.score[ai]
    occ = np.arange(ds.E)[None, :] < lanes.n_ex[ai][:, None]
    ml = np.where(occ, lanes.ex_len[ai], 0).sum(axis=1)
    up, inv = np.unique(lanes.prow[ai], return_inverse=True)
    pb = np.zeros(len(up), np.int64)
    pb[inv] = b
    wmax = np.full(len(up), NEGI, np.int64)
    np.maximum.at(wmax, inv, score)
    rmax = np.full(B, NEGI, np.int64)
    np.maximum.at(rmax, pb, wmax)
    prox = wmax + P.outFilterMultimapScoreRange >= rmax[pb]
    nwin = np.bincount(pb[prox], minlength=B)
    mlmax = np.full(len(up), NEGI, np.int64)
    np.maximum.at(mlmax, inv, ml)
    mlmin = np.full(len(up), BIGI, np.int64)
    np.minimum.at(mlmin, inv, ml)
    unsafe = np.zeros(B, bool)
    np.logical_or.at(unsafe, pb, prox & (mlmax != mlmin))
    over = (nwin > P.outFilterMultimapNmax) & ~unsafe
    # trBest: score desc, gLength asc, window asc, then the first in DFS
    glen = lanes.tG2[ai] + 1 - lanes.ex_gs[ai, 0]
    order = np.lexsort((np.arange(len(ai)), lanes.w[ai], glen, -score, b))
    first = np.ones(len(order), bool)
    first[1:] = b[order][1:] != b[order][:-1]
    tb = np.zeros(len(ai), bool)
    tb[order[first]] = True
    return over, ai[~over[b] | tb]


def check_stitch(gi, P, st, ws, RS, nmm, Lpad, chain_cap, lread, read_len2,
                 got, acc, over):
    """hold one device grow (+ finalize, + select) result, made from st,
    against the numpy engine on a copy of st taken before it.  Returns the
    numpy lanes (grown, finalized where lread is given)."""
    G = gi.G.view(np.uint8)
    st_np = copy.deepcopy(st)
    want = be.grow_chains(gi, P, G, RS, st_np, ws, nmm, Lpad,
                          chain_cap=chain_cap)
    if lread is None:
        assert acc is None and over is None
        assert_lanes_equal(got, want)
        return want, st_np
    want_acc = be.finalize_lanes(gi, P, G, RS, want, ws, nmm, read_len2,
                                 lread, Lpad)
    if over is None:             # no classify: every retired lane
        assert_lanes_equal(got, want)
        assert np.array_equal(acc, want_acc)
    else:
        want_over, keep = numpy_select(P, want, want_acc, ws.n_reads)
        assert np.array_equal(over, want_over)
        assert acc.all()
        assert_lanes_equal(got, be._lanes_take(want, keep))
    return want, st_np


def spy_grow(monkeypatch):
    """wrap the port's grow_chains_device: each call also runs the numpy
    grow_chains (and finalize_lanes, and the select's numpy form) on copies
    of its inputs, and asserts equal results and fallbacks.  Returns the
    list of calls seen."""
    real = ds.grow_chains_device
    seen = []

    def spy(gi, P, st, ws, RS, nmm, Lpad, s_max, chain_cap, device,
            lread=None, read_len2=None, classify=False):
        st0 = copy.deepcopy(st)
        got, acc, over = real(gi, P, st, ws, RS, nmm, Lpad, s_max, chain_cap,
                              device, lread=lread, read_len2=read_len2,
                              classify=classify)
        want, st_np = check_stitch(gi, P, st0, ws, RS, nmm, Lpad, chain_cap,
                                   lread, read_len2, got, acc, over)
        assert np.array_equal(st.fallback, st_np.fallback)
        seen.append({"w_max": ws.win_alive.shape[1], "lanes": len(want.b),
                     "Lpad": Lpad, "finalized": acc is not None,
                     "over": None if over is None else int(over.sum())})
        return got, acc, over

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
    assert seen and all(c["lanes"] > 0 and c["finalized"] for c in seen)
    # single-end levels classify on the device, paired-end levels do not
    assert all((c["over"] is None) == (reads == "pe") for c in seen)
    runs = {w: be.LEVEL_STATS[w, "runs"] for w, _ in be.LEVEL_STATS}
    assert runs and all(be.LEVEL_STATS[w, "device"] == n
                        for w, n in runs.items())
    assert _body(prefix + "Aligned.out.sam") == \
        _body(os.path.join(GOLD, gold, "Aligned.out.sam"))
    with open(prefix + "SJ.out.tab") as a, \
            open(os.path.join(GOLD, gold, "SJ.out.tab")) as b:
        assert a.read() == b.read()
