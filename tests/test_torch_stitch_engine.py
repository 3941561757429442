"""The port's device grow engine (star_tpu_torch/ops/device_stitch.py) on the
CPU, beyond the goldens of test_torch_stitch.py: a 2x150 PE set whose
genome regions need two fetch rows (equal to the numpy grow on every level),
the fetch region's column mapping at every span, the iteration cap's
overflow 2, and capacity overflows that retry and split without changing a
byte, or raise once one read's chains exceed the hard caps.  A grow chunk's
lanes (chunk_lanes) shrink for long reads on CPU tensors, stay 2^16 at W512
on a CUDA device, and change no lane of the result; on CPU tensors a chunk
runs the plain version and launches no kernel."""
import copy
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from star_tpu_torch.genome.index import GenomeIndex
from star_tpu_torch.ops import batch_engine as be
from star_tpu_torch.ops import device_stitch as ds
from star_tpu_torch.ops import fetch
from star_tpu_torch.params import Parameters
from star_tpu_torch.run import align_reads
from tests.conftest import GOLD, ROOT
from tests.test_torch_stitch import (  # noqa: F401  (fixtures)
    _align_golden, _body, force_device_grow, one_torch_thread, spy_grow)


def test_device_grow_2x150_pe_spans_two_fetch_rows(tmp_path, monkeypatch,
                                                  force_device_grow):
    """2x150 PE: Lpad 303, so a chunk's genome regions span 1,172 bytes, more
    than one 2 KiB fetch row holds from an arbitrary alignment (1,025)"""
    data = tmp_path / "data"
    subprocess.run([sys.executable,
                    os.path.join(ROOT, "tools", "make_test_data.py"),
                    "--out", str(data), "--read-len", "150", "--seed", "5",
                    "--n-reads", "120"], check=True, stdout=subprocess.DEVNULL)
    gi = GenomeIndex.generate([str(data / "genome.fa")], sa_index_nbases=7)
    gi.save(str(tmp_path / "idx"))
    seen = spy_grow(monkeypatch)
    P = Parameters(["--genomeDir", str(tmp_path / "idx"), "--readFilesIn",
                    str(data / "reads_pe_1.fastq"),
                    str(data / "reads_pe_2.fastq"),
                    "--outFileNamePrefix", str(tmp_path) + "/"])
    stats = align_reads(P, gi=gi, device="cpu")
    assert stats.read_n == 60
    assert seen and seen[0]["lanes"] > 1000
    Lpad = seen[0]["Lpad"]
    assert Lpad == 303 and ds.region_spans(Lpad)[1] > fetch.TILE + 1


@pytest.mark.parametrize("span", [1, 1024, 1025, 1126, 1172, 2100, 4000])
def test_fetch_region_maps_every_column(span):
    rng = np.random.default_rng(span)
    raw = rng.integers(0, 6, size=20_000).astype(np.int8)
    tabf = torch.from_numpy(ds._prep_table(raw))
    full = np.concatenate([np.zeros(ds.FRONT_PAD, np.int8), raw])
    off = rng.integers(-ds.FRONT_PAD, len(raw) - span, size=300)
    off[:3] = [-ds.FRONT_PAD, 0, len(raw) - span]
    got = ds._fetch_region(tabf, torch.from_numpy(off).int(), span).numpy()
    want = np.stack([full[o + ds.FRONT_PAD:o + ds.FRONT_PAD + span]
                     for o in off]).view(np.uint8)
    assert got.shape == (len(off), span) and np.array_equal(got, want)
    # junk offsets far outside the table clamp instead of failing
    junk = torch.tensor([-10**6, 10**7], dtype=torch.int32)
    assert ds._fetch_region(tabf, junk, span).shape == (2, span)


def _level0(tmp, reads):
    """a golden's level-0 grow inputs, from its dumped stitch inputs"""
    mp = pytest.MonkeyPatch()
    mp.setenv("STAR_TPU_DEVICE_STITCH", "0")
    mp.setenv("STAR_TPU_DUMP_STITCH", str(tmp / "dump"))
    try:
        _align_golden(tmp, "genome_idx", reads)
    finally:
        mp.undo()
    with open(tmp / "dump" / "batch_0000.pkl", "rb") as f:
        d = pickle.load(f)
    gi = GenomeIndex.load(os.path.join(GOLD, "genome_idx"))
    P = Parameters(["--genomeDir", os.path.join(GOLD, "genome_idx"),
                    "--readFilesIn", "none.fastq"])
    B = len(d["lread"])
    recs = be.expand_hits(gi, P, d["seeds"], d["lread"], B)
    ws, st, _, RS, Lpad = be.level_state(gi, P, recs, B, d["fwd"], d["rc"],
                                         be.W_MAX, be.S_MAX)
    return gi, P, ws, st, RS, Lpad, d["nmm_max"]


@pytest.fixture(scope="module")
def se_level0(tmp_path_factory):
    """the se golden's level-0 grow inputs"""
    return _level0(tmp_path_factory.mktemp("se_level0"), "se")


@pytest.fixture(scope="module")
def pe_level0(tmp_path_factory):
    """the pe golden's level-0 grow inputs (mate-joined reads)"""
    return _level0(tmp_path_factory.mktemp("pe_level0"), "pe")


def _grow_args(ctx, st):
    return (ctx.Gf, ctx.rs_dev, torch.from_numpy(ctx.rows),
            torch.from_numpy(ctx.pm), ctx.ft_dev, ctx.ct_dev, ctx.sjt,
            torch.from_numpy(st.fallback.astype(np.int32)),
            int(ctx.wan.max()))


def test_iteration_cap_reports_overflow_2(se_level0):
    gi, P, ws, st, RS, Lpad, nmm = se_level0
    ctx = ds.grow_context(gi, P, copy.deepcopy(st), ws, RS, nmm, Lpad,
                          be.S_MAX, be.CHAIN_CAP, "cpu")
    s_hi = int(ctx.wan.max())
    NP = len(ctx.wan)
    args = (ctx.Gf, ctx.rs_dev, torch.from_numpy(ctx.rows),
            torch.from_numpy(ctx.pm), ctx.ft_dev, ctx.ct_dev, ctx.sjt,
            torch.from_numpy(st.fallback.astype(np.int32)), s_hi)
    A_CAP, AMAX = 1 << 14, 1 << 15

    def run(cfg):
        return ds.make_grow_engine2(cfg, AMAX, 1 << 17, A_CAP, NP, ctx.B,
                                    ctx.lmax, int(gi.n_genome), ctx.ntab)(
            *args)

    full = run(ctx.cfg)
    assert full[6] == 0 and full[3] > 0
    # IT_MAX = s_max * (ATOT // A_CAP + 3) + 8 = 8 iterations with s_max 0,
    # fewer than the s_hi steps this level needs: the loop stops early
    assert s_hi > 8
    capped = run(dataclasses.replace(ctx.cfg, s_max=0))
    assert capped[6] == 2 and capped[7] == 8 and capped[3] < full[3]


def test_grow_result_is_independent_of_the_chunk_size(se_level0, pe_level0):
    """the same level grown in chunks of 2^14 and of 64 lanes, and the pe
    golden's in chunks of 2^16 (a W512 chunk on the card) and of 64: the
    same retired lanes, in the same order, and the same fallbacks and
    counts"""
    for level, a_cap in ((se_level0, 1 << 14), (pe_level0, 1 << 16)):
        gi, P, ws, st, RS, Lpad, nmm = level
        ctx = ds.grow_context(gi, P, copy.deepcopy(st), ws, RS, nmm, Lpad,
                              be.S_MAX, be.CHAIN_CAP, "cpu")
        assert ctx.cfg.has_pe == (level is pe_level0)
        NP = len(ctx.wan)
        args = _grow_args(ctx, st)
        out = [ds.make_grow_engine2(ctx.cfg, 1 << 15, 1 << 17, a, NP, ctx.B,
                                    ctx.lmax, int(gi.n_genome), ctx.ntab)(
            *args) for a in (a_cap, 64)]
        assert out[0][6] == out[1][6] == 0 and out[0][3] == out[1][3] > 0
        assert out[1][7] > out[0][7]          # more chunks, more iterations
        for k in (0, 1, 2, 4, 5):
            assert torch.equal(out[0][k], out[1][k]), k


def test_stitch_chunk_on_cpu_takes_the_plain_path(pe_level0):
    """on CPU tensors the grow's chunks run the plain version: each chunk's
    rows and ok are _stitch_chunk_plain's, and the kernel's launch counts
    (LAUNCHES, GROW_STATS chunk_launches) stay where they were"""
    gi, P, ws, st, RS, Lpad, nmm = pe_level0
    n0 = ds.LAUNCHES
    real = ds.stitch_chunk
    calls = []

    def spy(*a):
        want = tuple(torch.zeros_like(t) for t in a[-1])
        ok_w = ds._stitch_chunk_plain(*a[:-1], want)
        ok = real(*a)
        assert torch.equal(ok, ok_w)
        assert all(torch.equal(g, w) for g, w in zip(a[-1], want))
        calls.append(int(ok.sum()))
        return ok
    mp = pytest.MonkeyPatch()
    mp.setattr(ds, "stitch_chunk", spy)
    ds.GROW_STATS.clear()
    try:
        ds.grow_chains_device(gi, P, copy.deepcopy(st), ws, RS, nmm, Lpad,
                              be.S_MAX, be.CHAIN_CAP, "cpu")
    finally:
        mp.undo()
    assert calls and sum(calls) > 0 and ds.LAUNCHES == n0
    gs = ds.GROW_STATS
    assert gs[be.W_MAX, "iterations"] == len(calls)
    assert gs[be.W_MAX, "chunk_launches"] == 0


@pytest.mark.parametrize("s_max,read_len,device,want", [
    (be.S_MAX, 1301, "cpu", 1 << 14), (50, 91, "cpu", 1 << 16),
    (50, 123, "cpu", 1 << 16), (50, 124, "cpu", 1 << 15),
    (50, 201, "cpu", 1 << 15), (50, 252, "cpu", 1 << 14),
    (50, 100_000, "cpu", 1 << 10), (be.S_MAX, 91, "cuda", 1 << 14),
    (be.S_MAX, 1301, "cuda", 1 << 14), (50, 91, "cuda", 1 << 16),
    (50, 201, "cuda", 1 << 16), (50, 303, "cuda", 1 << 16),
    (50, 1301, "cuda", 1 << 16)])
def test_chunk_lanes(s_max, read_len, device, want):
    """level 0 always 2^14; W512 on a CUDA device 2^16 at every read length
    (the kernel holds no scan tensors), on CPU tensors as many lanes as keep
    a chunk's [lanes, 2 * Lpad + 5] int32 scan within CHUNK_SCAN_BYTES"""
    got = ds.chunk_lanes(s_max, read_len + 2, torch.device(device))
    assert got == want
    if s_max > be.S_MAX and want < 1 << 16:
        assert 2 * got * 4 * (2 * (read_len + 2) + 5) > ds.CHUNK_SCAN_BYTES \
            or got == 1 << 10


@pytest.mark.parametrize("a_hard,r_hard,bail", [(1024, 4096, False),
                                                (16, 16, True)],
                         ids=["split", "bail"])
def test_capacity_overflow_retries_splits_and_bails(
        tmp_path, monkeypatch, force_device_grow, a_hard, r_hard, bail):
    """tiny hard caps force the capacity retry and the read-aligned group
    split; caps below one read's chains raise a MemoryError that names the
    read and the caps (the grow never moves to the host on its own)"""
    monkeypatch.setattr(ds, "A_HARD", a_hard)
    monkeypatch.setattr(ds, "R_HARD", r_hard)
    seen = spy_grow(monkeypatch)
    be.FB_STATS.clear()
    if bail:
        with pytest.raises(MemoryError, match="A_HARD=16 .* R_HARD=16"):
            _align_golden(tmp_path, "genome_idx", "se")
        assert be.FB_STATS["dev_retry_capacity"] > 0 and not seen
        return
    prefix = _align_golden(tmp_path, "genome_idx", "se")
    assert be.FB_STATS["dev_retry_capacity"] > 0 and seen
    assert _body(prefix + "Aligned.out.sam") == \
        _body(os.path.join(GOLD, "se", "Aligned.out.sam"))


@pytest.mark.parametrize("s_max,n_rec,off,want", [
    (be.S_MAX, 99_999, False, False), (be.S_MAX, 100_000, False, True),
    (50, 15_999, False, False), (50, 16_000, False, True),
    (50, 10**6, True, False)])
def test_device_grow_gate(monkeypatch, s_max, n_rec, off, want):
    """each level's grow takes the card from its own record count (the
    measured crossover), and STAR_TPU_DEVICE_STITCH=0 turns the card off"""
    if off:
        monkeypatch.setenv("STAR_TPU_DEVICE_STITCH", "0")
    else:
        monkeypatch.delenv("STAR_TPU_DEVICE_STITCH", raising=False)
    gi = GenomeIndex.load(os.path.join(GOLD, "genome_idx"))
    assert be._use_device_stitch(gi, s_max, n_rec) is want
