"""EmptyDrops_CR's Monte-Carlo null (star_tpu_torch/solo/mc_null.py) on CPU
tensors, where its plain PyTorch version runs: std::mt19937's words and
libstdc++'s uniforms against utils.rng.MT19937, each candidate's count of
lower simulations against a brute-force count over the rows of the
reference's per-simulation Python loop, empty_drops_cr against star_tpu's,
and the solo_mc span of a traced EmptyDrops_CR job.  Exact equality
throughout, floats included."""
import math
import os
from bisect import bisect_left

import numpy as np
import pytest
import torch

import chip_smoke as cs
from star_tpu_torch.ops import pipeline
from star_tpu_torch.params import Parameters
from star_tpu_torch.run import align_reads
from star_tpu_torch.solo import mc_null
from star_tpu_torch.utils.rng import MT19937
from tests.test_torch_solo import ed_index  # noqa: F401
from tests.test_torch_stitch import one_torch_thread  # noqa: F401

MASK32 = 0xFFFFFFFF
# seeds of simulations 0, 216, 217 (the first past 2^32) and 9,999, the
# generator's default and the largest
SEEDS = [(19760110 * (i + 1)) & MASK32 for i in (0, 216, 217, 9999)] + \
    [5489, MASK32]


@pytest.mark.parametrize("seed", SEEDS)
def test_mt_words_equal_mt19937(seed):
    """1,500 words: past the second twist (624 words, 312 uniforms) into
    the third generation"""
    rng = MT19937(seed)
    want = [rng.next_u32() for _ in range(1500)]
    got = mc_null.mt_words(torch.tensor([seed]), 1500)
    assert got.shape == (1500, 1)
    assert got[:, 0].tolist() == want


@pytest.mark.parametrize("isim", [0, 217, 9999])
def test_uniforms_equal_mt19937(isim):
    """700 uniforms, 1,400 words, of one simulation's stream"""
    seed = (19760110 * (isim + 1)) & MASK32
    rng = MT19937(seed)
    want = [rng.uniform01() for _ in range(700)]
    w = mc_null.mt_words(torch.tensor([seed]), 1400)
    got = mc_null.canonical(w[0::2], w[1::2])[:, 0].tolist()
    assert got == want


def test_canonical_clamps_below_one():
    top = torch.tensor([MASK32])
    assert mc_null.canonical(top, top).item() == math.nextafter(1.0, 0.0)
    assert mc_null.canonical(torch.tensor([0]), torch.tensor([0])).item() == 0


def loop_rows(cp, logp, max_count, sim_n):
    """the rows of the reference's per-simulation loop (star_tpu
    solo/emptydrops.py)"""
    rows = []
    for isim in range(sim_n):
        rng = MT19937((19760110 * (isim + 1)) & MASK32)
        cur = [0] * len(cp)
        row = [0.0] * (max_count + 1)
        for ic in range(1, max_count + 1):
            ig = bisect_left(cp, rng.uniform01())
            if ig >= len(cp):
                ig = len(cp) - 1
            cur[ig] += 1
            row[ic] = row[ic - 1] + logp[ig] + math.log(ic) - math.log(cur[ig])
        rows.append(row)
    return rows


def profile(rng, n_genes):
    """(cp, logp) of a Dirichlet ambient profile, cp summed as the
    reference sums it"""
    p = rng.dirichlet(np.full(n_genes, 0.3)).tolist()
    p = [x for x in p if x > 0]
    psum = sum(p)
    cp, acc = [], 0.0
    for x in p:
        acc += x / psum
        cp.append(acc)
    return cp, [math.log(x / psum) for x in p]


def tensors(cp, logp, max_count, counts, obs):
    """the wrapper's CPU tensors for candidates (counts, obs), and their
    order"""
    gc, go, os_, order = mc_null.group_candidates(counts, obs)
    f64, i32 = torch.float64, torch.int32
    logtab = [0.0] + [math.log(k) for k in range(1, max_count + 1)]
    return (torch.tensor(cp, dtype=f64), torch.tensor(logp, dtype=f64),
            torch.tensor(logtab, dtype=f64), torch.tensor(gc, dtype=i32),
            torch.tensor(go, dtype=i32), torch.tensor(os_, dtype=f64)), order


# (max_count, genes, simulations): one draw; a 10x candidate's ~15; over
# 400 draws, 800 words, past the first twist
NULL_CASES = [(1, 5, 200), (15, 300, 400), (420, 60, 40)]


@pytest.mark.parametrize("max_count,n_genes,sim_n", NULL_CASES,
                         ids=[f"max{c[0]}" for c in NULL_CASES])
def test_n_lower_equals_brute_force(max_count, n_genes, sim_n):
    """candidates at counts 0..max_count, 30 of them sharing one count;
    observed values drawn from the simulations' own rows (ties with a row,
    which the strict < does not count), repeated (tied candidates) and
    random"""
    rng = np.random.default_rng(max_count)
    cp, logp = profile(rng, n_genes)
    rows = loop_rows(cp, logp, max_count, sim_n)
    counts = [0, max_count] + [max(1, max_count // 2)] * 30 + \
        rng.integers(0, max_count + 1, size=40).tolist()
    obs = []
    for i, c in enumerate(counts):
        if i % 3 == 0:
            obs.append(rows[int(rng.integers(sim_n))][c])
        elif i % 3 == 1 and obs:
            obs.append(obs[-1])
        else:
            col = [r[c] for r in rows]
            obs.append(float(rng.uniform(min(col) - 1, max(col) + 1)))
    want = [sum(1 for r in rows if r[c] < o) for c, o in zip(counts, obs)]
    args, order = tensors(cp, logp, max_count, counts, obs)
    got = np.empty(len(counts), dtype=np.int64)
    got[order] = mc_null.n_lower(*args, sim_n)
    assert got.tolist() == want
    assert 0 < sum(want) < sim_n * len(counts)


def test_histogram_has_a_slot_per_candidate_and_group():
    rng = np.random.default_rng(2)
    cp, logp = profile(rng, 40)
    args, _ = tensors(cp, logp, 6, [6, 6, 3], [-5.0, -1.0, -2.0])
    hist = mc_null.null_histogram(*args, 100)
    assert hist.dtype == torch.int32 and hist.shape == (5,)
    # groups: count 3 (one candidate, slots 0-1), count 6 (two, slots
    # 2-4); every simulation falls in one slot of each
    assert hist[:2].sum() == 100 and hist[2:].sum() == 100
    assert mc_null.null_histogram(*args, 0).sum() == 0


def test_wrapper_refuses_bad_inputs():
    rng = np.random.default_rng(3)
    cp, logp = profile(rng, 10)
    args, _ = tensors(cp, logp, 4, [4, 2], [-3.0, -1.0])
    bad = list(args)
    bad[0] = args[0].float()
    with pytest.raises(ValueError, match="cp must be"):
        mc_null.null_histogram(*bad, 10)
    bad = list(args)
    bad[3] = args[3].long()
    with pytest.raises(ValueError, match="group_count must be"):
        mc_null.null_histogram(*bad, 10)
    bad = list(args)
    bad[1] = args[1][:-1]
    with pytest.raises(ValueError, match="one entry per gene"):
        mc_null.null_histogram(*bad, 10)
    bad = list(args)
    bad[4] = args[4][:-1]
    with pytest.raises(ValueError, match="group_off"):
        mc_null.null_histogram(*bad, 10)
    with pytest.raises(ValueError, match="sim_n"):
        mc_null.null_histogram(*args, -1)


class _P:
    """the parameters empty_drops_cr reads"""

    def __init__(self, cell_filter):
        self.soloCellFilter = cell_filter


def small_count_matrix(seed):
    """2,000 barcodes over 200 genes: 100 real cells of 200-800 UMIs, 300
    candidates of 8-24 UMIs (half of an own profile, half ambient) and
    1,600 ambient barcodes of 1-7"""
    rng = np.random.default_rng(seed)
    n_genes = 200
    amb = rng.dirichlet(np.full(n_genes, 0.3))
    counts, n_umi = {}, {}
    for cb in range(2000):
        if cb < 100:
            n = int(rng.integers(200, 800))
            p = rng.dirichlet(np.full(n_genes, 0.3))
        elif cb < 400:
            n = int(rng.integers(8, 25))
            p = rng.dirichlet(np.full(n_genes, 0.3)) if cb % 2 else amb
        else:
            n, p = int(rng.integers(1, 8)), amb
        c = rng.multinomial(n, p)
        counts[cb * 5 + 1] = [(int(g), int(c[g])) for g in np.flatnonzero(c)]
        n_umi[cb * 5 + 1] = int(c.sum())
    return counts, n_umi, n_genes


def test_emptydrops_at_simn_10000_equals_star_tpu():
    """Cell Ranger's 10,000 simulations over ~300 candidates of 8-24 UMIs
    (a 10x candidate's depth): the same cells called as star_tpu's loop"""
    from star_tpu.solo.emptydrops import empty_drops_cr as ej
    from star_tpu_torch.solo.emptydrops import empty_drops_cr as et
    counts, n_umi, n_genes = small_count_matrix(4)
    top = sorted(n_umi, key=lambda k: -n_umi[k])
    simple = set(top[:100])
    P = _P(["EmptyDrops_CR", "100", "0.99", "10", "500", "1800", "8",
            "0.01", "20000", "0.01", "10000"])
    want = ej(counts, n_umi, n_genes, simple, P)
    got = et(counts, n_umi, n_genes, simple, P, "cpu")
    assert got == want
    assert 0 < len(want) < 300


def test_traced_emptydrops_job_spans_solo_mc(tmp_path, ed_index):  # noqa: F811
    """the solo_ed golden traced on the device path on CPU tensors: the
    golden's bytes, one solo_mc span inside solo_filter, no kernel launch"""
    case, gold, _, flags, files = next(c for c in cs.SOLO_GOLDENS
                                       if c[0] == "solo_ed")
    prefix = str(tmp_path) + "/"
    pipeline.TIMERS.clear()
    n0 = mc_null.LAUNCHES
    pipeline.TIMING = True
    try:
        align_reads(Parameters(["--genomeDir", ed_index,
                                "--outFileNamePrefix", prefix, *flags]),
                    device="cpu")
    finally:
        pipeline.TIMING = False
    spans = pipeline.SPANS
    mc = [s for s in spans if s[0] == "solo_mc"]
    assert len(mc) == 1 and spans[mc[0][1]][0] == "solo_filter"
    assert 0 < pipeline.TIMERS["solo_mc"] <= pipeline.TIMERS["solo_filter"]
    assert mc_null.LAUNCHES == n0
    pipeline.TIMERS.clear()
    pipeline.SPANS.clear()
    assert cs.solo_diff(prefix, os.path.join(cs.TESTS, "golden", gold),
                        files) == []
