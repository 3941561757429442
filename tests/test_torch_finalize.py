"""The port's device finalize, select and pack (star_tpu_torch/ops/
device_stitch.py) on the CPU, beyond the golden runs of test_torch_stitch.py
(whose spies hold every level's finalize and select against the numpy
engine): every retired lane of both se levels against numpy finalize_lanes,
the too-many-loci classification where it fires, the integer log2 score,
the PE-overlap check on hand-made mates, and the select's DFS tie-break on
masks that use bit 31."""
import copy
import os
import pickle
import types

import numpy as np
import pytest
import torch

from star_tpu_torch.genome.index import GenomeIndex
from star_tpu_torch.ops import batch_engine as be
from star_tpu_torch.ops import device_stitch as ds
from star_tpu_torch.params import Parameters
from star_tpu_torch.run import align_reads
from tests.conftest import DATA, GOLD
from tests.test_torch_stitch import (  # noqa: F401  (fixtures)
    _align_golden, _body, assert_lanes_equal, check_stitch,
    force_device_grow, one_torch_thread, spy_grow)


def _params(*extra):
    return Parameters(["--genomeDir", os.path.join(GOLD, "genome_idx"),
                       "--readFilesIn", "none.fastq", *extra])


# --------------------------------------------------------------------------
# every retired lane of both se levels, replayed from the dumped batch
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def se_levels(tmp_path_factory):
    """the se golden's grow inputs of both levels: level 0 from its dumped
    stitch inputs, W512 from the reads level 0 leaves in fallback"""
    tmp = tmp_path_factory.mktemp("se_levels")
    mp = pytest.MonkeyPatch()
    mp.setenv("STAR_TPU_DEVICE_STITCH", "0")
    mp.setenv("STAR_TPU_DUMP_STITCH", str(tmp / "dump"))
    try:
        _align_golden(tmp, "genome_idx", "se")
    finally:
        mp.undo()
    with open(tmp / "dump" / "batch_0000.pkl", "rb") as f:
        d = pickle.load(f)
    gi = GenomeIndex.load(os.path.join(GOLD, "genome_idx"))
    P = _params()
    B = len(d["lread"])
    recs = be.expand_hits(gi, P, d["seeds"], d["lread"], B)
    idx = np.arange(B)
    out = {}
    for w_max, s_max, chain_cap in be.LEVELS:
        mask = np.zeros(B, bool)
        mask[idx] = True
        new_index = np.zeros(B, np.int64)
        new_index[idx] = np.arange(len(idx))
        sub = be._slice_seed_recs(recs, mask, new_index)
        ws, st, _, RS, Lpad = be.level_state(gi, P, sub, len(idx),
                                             d["fwd"][idx], d["rc"][idx],
                                             w_max, s_max)
        out[w_max] = (ws, st, RS, Lpad, s_max, chain_cap,
                      d["nmm_max"][idx], d["lread"][idx], d["read_len2"][idx])
        st_c = copy.deepcopy(st)
        be.grow_chains(gi, P, gi.G.view(np.uint8), RS, st_c, ws,
                       d["nmm_max"][idx], Lpad, chain_cap=chain_cap)
        idx = idx[st_c.fallback]
    return gi, P, out


@pytest.mark.parametrize("w_max", [be.W_MAX, 512])
def test_device_finalize_every_lane_equals_numpy(se_levels, w_max):
    """without the select every retired lane comes back: accept and the
    extended LaneState equal numpy finalize_lanes, lane by lane"""
    gi, P, lv = se_levels
    ws, st, RS, Lpad, s_max, chain_cap, nmm, lread, read_len2 = lv[w_max]
    st0 = copy.deepcopy(st)
    got, acc, over = ds.grow_chains_device(
        gi, P, st, ws, RS, nmm, Lpad, s_max, chain_cap, "cpu", lread=lread,
        read_len2=read_len2, classify=False)
    assert over is None and acc.dtype == bool
    want, st_np = check_stitch(gi, P, st0, ws, RS, nmm, Lpad, chain_cap,
                               lread, read_len2, got, acc, over)
    assert np.array_equal(st.fallback, st_np.fallback)
    assert acc.any() and (~acc).any() and len(want.b) > 1000


@pytest.mark.parametrize("w_max", [be.W_MAX, 512])
def test_device_classify_downloads_only_the_assembled_lanes(se_levels, w_max):
    """with the select, a read over the multimap limit comes back as its
    single trBest lane and every other read as its accepted lanes"""
    gi, _, lv = se_levels
    P = _params("--outFilterMultimapNmax", "1")
    ws, st, RS, Lpad, s_max, chain_cap, nmm, lread, read_len2 = lv[w_max]
    st0 = copy.deepcopy(st)
    ds.GROW_STATS.clear()
    got, acc, over = ds.grow_chains_device(
        gi, P, st, ws, RS, nmm, Lpad, s_max, chain_cap, "cpu", lread=lread,
        read_len2=read_len2, classify=True)
    check_stitch(gi, P, st0, ws, RS, nmm, Lpad, chain_cap, lread, read_len2,
                 got, acc, over)
    gs = ds.GROW_STATS
    assert gs[w_max, "downloaded"] == len(got.b) <= gs[w_max, "accepted"] \
        < gs[w_max, "retired"]
    assert gs[w_max, "over"] == int(over.sum())
    if w_max == be.W_MAX:
        assert over.sum() > 0 and len(got.b) < gs[w_max, "accepted"]


def test_over_reads_align_as_the_numpy_engine(tmp_path, monkeypatch,
                                              force_device_grow):
    """--outFilterMultimapNmax 1 on the se reads: the select classifies
    reads over the limit on both levels' device runs (each held against
    the numpy engine by the spy), and SAM and SJ.out.tab equal the run with
    the numpy engine (STAR_TPU_DEVICE_STITCH=0)"""
    seen = spy_grow(monkeypatch)
    gi = GenomeIndex.load(os.path.join(GOLD, "genome_idx"))
    outs = []
    for engine in ("device", "numpy"):
        if engine == "numpy":
            monkeypatch.setenv("STAR_TPU_DEVICE_STITCH", "0")
        prefix = str(tmp_path / engine) + "/"
        P = Parameters(["--genomeDir", os.path.join(GOLD, "genome_idx"),
                        "--readFilesIn", os.path.join(DATA, "reads_se.fastq"),
                        "--outFileNamePrefix", prefix,
                        "--outSAMunmapped", "Within",
                        "--outFilterMultimapNmax", "1"])
        align_reads(P, gi=gi, device="cpu")
        with open(prefix + "SJ.out.tab") as f:
            outs.append((_body(prefix + "Aligned.out.sam"), f.read()))
    assert len(seen) == 2 and seen[0]["over"] > 0
    assert outs[0] == outs[1]


# --------------------------------------------------------------------------
# unit cases
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [-0.25, -1.0, 0.5])
def test_glog2_breakpoints_equal_host_score(scale):
    """f1 + step * (breakpoints <= g) is _glog2_score(g) for every genomic
    length up to 2^20 and for sampled lengths up to 2^32"""
    f1, bounds, step = ds.glog2_breakpoints(scale)
    rng = np.random.default_rng(7)
    g = np.concatenate([np.arange(1, (1 << 20) + 1),
                        rng.integers(1 << 20, 1 << 32, size=200_000),
                        np.array(bounds) - 1, np.array(bounds)])
    got = f1 + step * np.searchsorted(np.array(bounds, np.int64), g,
                                      side="right")
    assert np.array_equal(got, be._glog2_score(g, scale))
    # the device form, on the lengths an int32 holds
    small = g < (1 << 31)
    fval = ds.glog2_dev(torch.from_numpy(g[small].astype(np.int32)),
                        (f1, bounds, step))
    assert np.array_equal(fval.numpy(), got[small])


LREAD = 101          # 2 x 50 bases and the spacer
MATES = [            # (exons (rs, gs, len, frag), junction motifs)
    ([(0, 0, 50, 0), (51, 20, 50, 1)], [-3]),            # consistent overlap
    ([(0, 0, 50, 0), (51, 200, 50, 1)], [-3]),           # no overlap
    ([(0, 0, 50, 0), (51, -100, 50, 1)], [-3]),          # mate 2 before 1
    ([(0, 0, 50, 0), (51, -10, 50, 1)], [-3]),           # protrudes left
    ([(0, 0, 25, 0), (25, 30, 25, 0), (51, 1, 50, 1)],   # protrudes right
     [-1, -3]),
    ([(0, 0, 25, 0), (25, 100, 25, 0), (51, 10, 15, 1),  # same junction
      (66, 100, 35, 1)], [1, -3, 1]),
    ([(0, 0, 25, 0), (25, 100, 25, 0), (51, 10, 15, 1),  # another junction
      (66, 110, 35, 1)], [1, -3, 1]),
    ([(0, 0, 25, 0), (25, 100, 25, 0), (51, 10, 7, 1),   # same one, past an
      (60, 17, 8, 1), (68, 100, 33, 1)], [1, -3, -2, 1]),  # insertion
]


def _mate_lanes():
    """LaneState of the MATES chains, one read each, at genome 1000 +"""
    K = len(MATES)
    k = np.arange(K)
    lanes = be._empty_lanes(k, np.zeros(K), k)
    for i, (exons, cans) in enumerate(MATES):
        for e, (rs, gs, ln, fr) in enumerate(exons):
            lanes.ex_rs[i, e], lanes.ex_gs[i, e] = rs, 1000 + gs
            lanes.ex_len[i, e], lanes.ex_frag[i, e] = ln, fr
        for j, c in enumerate(cans):
            lanes.sj_can[i, j] = c
            lanes.sj_str[i, j] = 2 - c % 2 if c > 0 else 0
        lanes.n_ex[i] = len(exons)
        rs, gs, ln, _ = exons[-1]
        lanes.tR2[i] = rs + ln - 1       # the read ends: no extension runs
        lanes.tG2[i] = 1000 + gs + ln - 1
        lanes.score[i] = 90
        lanes.mask[i] = 1
    return lanes


def _blocks(lanes):
    """a LaneState as device row blocks (SCAL, EX, SJ) of the same lanes"""
    K = len(lanes.b)
    sc = np.zeros((K, ds.NSCAL), np.int32)
    for c, f in ((ds.C_MASK_LO, "mask"), (ds.C_PROW, "prow"),
                 (ds.C_NEX, "n_ex"), (ds.C_NMM, "n_mm"),
                 (ds.C_NMATCH, "n_match"), (ds.C_SCORE, "score"),
                 (ds.C_TR2, "tR2"), (ds.C_TG2, "tG2"), (ds.C_PB, "b"),
                 (ds.C_PW, "w")):
        sc[:, c] = getattr(lanes, f)
    sc[:, ds.C_ROW] = lanes.b
    sc[:, ds.C_NMMMAX] = 10
    sc[:, ds.C_WAN] = 1
    ex = np.stack([lanes.ex_rs, lanes.ex_gs, lanes.ex_len, lanes.ex_frag,
                   lanes.ex_sja], axis=2).reshape(K, ds.NEXB)
    sj = np.stack([lanes.sj_can, lanes.sj_shl, lanes.sj_shr, lanes.sj_annot,
                   lanes.sj_str], axis=2).reshape(K, ds.NSJB)
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32))
            for a in (sc, ex, sj)]


def test_pe_overlap_check_equals_numpy_finalize():
    """hand-made mates (overlapping, apart, contradicting, protruding)
    through the device finalize and the host keep fix give numpy
    finalize_lanes' accept and lanes"""
    P = _params()
    K = len(MATES)
    gi = types.SimpleNamespace(chr_start=np.array([0]),
                               chr_length=np.array([100_000]),
                               n_genome=100_000)
    ws = types.SimpleNamespace(n_reads=K, win_str=np.zeros((K, 1), np.int8),
                               win_chr=np.zeros((K, 1), np.int64))
    lread = np.full(K, LREAD)
    read_len2 = np.full((K, 2), 50)
    Lpad = LREAD + 2
    want = _mate_lanes()
    want_acc = be.finalize_lanes(gi, P, None, None, want, ws,
                                 np.full(K, 10), read_len2, lread, Lpad)

    ntab = 4 * (Lpad + 16)
    floor_tab, ceil_tab = ds.mm_cap_tables(P.outFilterMismatchNoverLmax, ntab)
    tab = lambda a: torch.from_numpy(ds._prep_table(a))
    ctx = types.SimpleNamespace(
        fc=ds.make_final_config(gi, P, Lpad, True), B=K, gi=gi,
        Gf=tab(np.zeros(100_000, np.int8)), lmax=LREAD,
        rs_dev=tab(np.zeros(2 * K * LREAD, np.int8)),
        ft_dev=tab(np.minimum(floor_tab, 65535).astype("<u2")),
        ct_dev=torch.from_numpy(ceil_tab), ntab=ntab,
        cfg=types.SimpleNamespace(Lpad=Lpad))
    sc, ex, sj = _blocks(_mate_lanes())
    lim = int(np.floor(P.alignSplicedMateMapLminOverLmate * 50))
    pm2 = torch.tensor([[0, 100_000, LREAD, lim, lim]] * K, dtype=torch.int32)
    acc, pe = ds._finalize_rows(ctx, sc, ex, sj, torch.zeros(K, dtype=torch.int32),
                                pm2)
    st = types.SimpleNamespace(pb=np.arange(K), pw=np.zeros(K, np.int64),
                               wa_n=np.ones(K, np.int64),
                               fallback=np.zeros(K, bool))
    got, got_acc = ds.lanes_from_blocks(
        sc.numpy(), ex.numpy(), sj.numpy(), np.arange(K), st, 1,
        accept=acc.numpy(), pe=pe.numpy(), P=P, lread=lread)
    assert np.array_equal(got_acc, want_acc)
    assert_lanes_equal(got, want)
    # every branch of the check decides at least one case either way
    assert pe.sum() >= 5 and want_acc.sum() >= 3 and (~want_acc).sum() >= 4


@pytest.mark.parametrize("seed", range(4))
def test_select_tie_break_takes_the_first_lane_in_dfs_order(seed):
    """lanes of one window with equal score and gLength: the select's
    reversed-mask words pick the lane that lanes_from_blocks orders first
    (the unsigned mask), also where seed 31 sets the low word's sign bit"""
    rng = np.random.default_rng(seed)
    n, n_seeds = 64, 50
    masks = rng.choice(1 << n_seeds, size=n, replace=False).astype(np.int64)
    masks[:8] = (1 << 31) | rng.integers(0, 1 << 31, size=8)
    masks[8] = 1 << 31
    masks[9] = 1 << 30
    sc = np.zeros((n, ds.NSCAL), np.int32)
    sc[:, ds.C_MASK_LO] = (masks & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    sc[:, ds.C_MASK_HI] = masks >> 32
    sc[:, ds.C_WAN] = n_seeds
    sc[:, ds.C_SCORE] = 90
    sc[:, ds.C_NEX] = 1
    ex = np.zeros((n, ds.NEXB), np.int32)
    ex[:, ds.EX_LEN] = 100
    pm = torch.zeros((1, 8), dtype=torch.int32)
    ctx = types.SimpleNamespace(B=1, s_max=n_seeds)
    dl, over = ds.select_lanes(ctx, torch.from_numpy(sc),
                               torch.from_numpy(ex),
                               torch.ones(n, dtype=torch.bool), pm, 1, 0)
    assert over.tolist() == [True] and int(dl.sum()) == 1
    st = types.SimpleNamespace(pb=np.zeros(1, np.int64),
                               pw=np.zeros(1, np.int64),
                               wa_n=np.array([n_seeds]),
                               fallback=np.zeros(1, bool))
    order = ds.lanes_from_blocks(sc, ex, np.zeros((n, ds.NSJB), np.int32),
                                 np.zeros(1, np.int64), st, n_seeds)
    assert int(order.mask[0]) == int(masks[int(dl.nonzero()[0, 0])])
