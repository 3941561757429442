"""The STARsolo layer of star_tpu_torch against star_tpu on the same inputs.

The whole slice: solo3's multimapper config (--soloMultiMappers Uniform
Rescue PropUnique EM, --soloCellReadStats Standard) mapped by
star_tpu.run.align_reads on the host path and by
star_tpu_torch.run.align_reads on the device path on CPU tensors gives
byte-identical Solo.out trees.  Module by module, the same numpy-seeded
inputs go into both packages: collapse_cb for every UMI dedup type, every
MultiGeneUMI filter and the multimapper distributions on CB / UMI / gene
records with planted one-mismatch UMI families; empty_drops_cr on a count
matrix whose parameters reach the Monte-Carlo step; Simple Good-Turing on
frequency counts; and both packages' UnorderedMap against a g++ probe of
libstdc++'s unordered_map.  Exact equality throughout, floats included."""
import os
import random

import numpy as np
import pytest

import chip_smoke as cs
from tests.test_stdhash import probe  # noqa: F401
from tests.test_torch_stitch import one_torch_thread  # noqa: F401


def test_solo3_mm_tree_equals_star_tpu(tmp_path):
    import star_tpu.params
    import star_tpu.run
    import star_tpu_torch.params
    import star_tpu_torch.run
    case, gold, index, flags, files = next(c for c in cs.SOLO_GOLDENS
                                           if c[0] == "solo3_mm")
    a, b = str(tmp_path / "jax") + "/", str(tmp_path / "torch") + "/"
    argv = lambda out: ["--genomeDir", index, "--outFileNamePrefix", out,
                        *flags]
    star_tpu.run.align_reads(star_tpu.params.Parameters(argv(a)),
                             use_device=False)
    star_tpu_torch.run.align_reads(star_tpu_torch.params.Parameters(argv(b)),
                                   device="cpu")
    assert len(os.listdir(a + "Solo.out/Gene")) > 4
    assert cs.tree_diff(b + "Solo.out", a + "Solo.out") == []
    assert cs.tree_diff(a + "Solo.out", b + "Solo.out") == []


def cb_records(rng, n_genes=12, n_umi=40, umi_len=10, multi=True):
    """(gene, umi, iread) records of one cell: UMI families whose members
    sit one base apart, genes sharing UMIs, and multi-gene reads (one
    record per gene, marked with GENE_MULT_MARK)"""
    from star_tpu.solo.collapse import GENE_MULT_MARK
    base = rng.integers(0, 1 << (2 * umi_len), size=n_umi)
    umis = []
    for u in base:
        umis.append(int(u))
        for _ in range(int(rng.integers(0, 3))):   # one-mismatch relatives
            pos = 2 * int(rng.integers(0, umi_len))
            umis.append(int(u) ^ (int(rng.integers(1, 4)) << pos))
    # the genes of a UMI's multi-gene reads: each read maps to the UMI's
    # first gene and one or two others
    umi_genes = {u: [int(g) for g in rng.choice(n_genes, size=4,
                                                replace=False)]
                 for u in umis}
    recs = []
    for _ in range(400):
        u = umis[int(rng.integers(0, len(umis)))]
        if multi and rng.random() < 0.15:
            g0, *rest = umi_genes[u]
            genes = [g0, *rng.choice(rest, size=int(rng.integers(1, 3)),
                                     replace=False)]
            recs += [(int(g) | GENE_MULT_MARK, u, len(recs)) for g in genes]
        else:
            recs.append((int(rng.integers(0, n_genes)), u, len(recs)))
    order = rng.permutation(len(recs))
    return [recs[i] for i in order]


DEDUPS = ["NoDedup", "Exact", "1MM_All", "1MM_Directional", "1MM_CR",
          "1MM_Directional_UMItools"]
COLLAPSE_CASES = (
    [([d], "-", ["Unique"]) for d in DEDUPS]
    + [(DEDUPS, "-", ["Unique"]),
       (DEDUPS, "-", ["Uniform", "Rescue", "PropUnique", "EM"]),
       (["1MM_All", "Exact"], "MultiGeneUMI", ["Unique"]),
       (["1MM_CR"], "MultiGeneUMI_CR", ["Unique"]),
       (["1MM_All"], "MultiGeneUMI_All", ["Uniform", "EM"])])


@pytest.mark.parametrize("dedup,filt,multi", COLLAPSE_CASES,
                         ids=DEDUPS + ["all", "all-multimappers",
                                       "MultiGeneUMI", "MultiGeneUMI_CR",
                                       "MultiGeneUMI_All"])
def test_collapse_cb_equals_star_tpu(dedup, filt, multi):
    from star_tpu.solo import collapse as cj
    from star_tpu_torch.solo import collapse as ct
    rng = np.random.default_rng(5)
    for cell in range(6):
        recs = cb_records(rng, multi=multi != ["Unique"])
        for read_info in (False, True):
            want = cj.collapse_cb(list(recs), cj.DedupConf(dedup, filt, multi,
                                                           10), read_info)
            got = ct.collapse_cb(list(recs), ct.DedupConf(dedup, filt, multi,
                                                          10), read_info)
            assert got == want, (cell, read_info)
    assert want[1] > 0 and want[2] > 0


def test_em_skips_a_umi_whose_reads_share_no_gene():
    """a fault of star_tpu: with EM among the multimappers, a UMI whose
    multi-gene reads share no gene (an empty gene set) makes star_tpu's
    collapse_cb divide by zero; the reference's 1/0 reaches no gene, so the
    port adds nothing for that UMI: its result equals both packages' on the
    records without that UMI's multi-gene reads"""
    from star_tpu.solo import collapse as cj
    from star_tpu_torch.solo import collapse as ct
    mark = ct.GENE_MULT_MARK
    rng = np.random.default_rng(2)
    recs = cb_records(rng)
    n = len(recs)
    planted = [(1 | mark, 7, n), (2 | mark, 7, n), (3 | mark, 7, n + 1),
               (4 | mark, 7, n + 1)]
    conf = (["1MM_All", "Exact"], "-", ["Uniform", "Rescue", "PropUnique",
                                        "EM"], 10)
    with pytest.raises(ZeroDivisionError):
        cj.collapse_cb(recs + planted, cj.DedupConf(*conf), False)
    got = ct.collapse_cb(recs + planted, ct.DedupConf(*conf), False)
    assert got == ct.collapse_cb(recs, ct.DedupConf(*conf), False) == \
        cj.collapse_cb(recs, cj.DedupConf(*conf), False)
    assert got[4]


class _P:
    """the parameters empty_drops_cr reads"""

    def __init__(self, cell_filter):
        self.soloCellFilter = cell_filter


def test_emptydrops_equals_star_tpu():
    """215 real cells over 1,285 ambient barcodes: the ambient window
    (indMin 300, indMax 1,200) lies inside them and the real cells' UMIs
    pass umiMin (150; the ambient barcodes hold 5-119), so the Monte-Carlo
    step runs (simN 300) and calls the cells of their own profile"""
    from star_tpu.solo.emptydrops import empty_drops_cr as ej
    from star_tpu_torch.solo.emptydrops import empty_drops_cr as et
    rng = np.random.default_rng(9)
    n_genes = 300
    amb = rng.dirichlet(np.full(n_genes, 0.3))
    counts, n_umi = {}, {}
    for cb in range(1500):
        real = cb % 7 == 0
        n = int(rng.lognormal(6.0, 0.6) if real else rng.integers(5, 120))
        p = rng.dirichlet(np.full(n_genes, 0.3)) if real and cb % 2 else amb
        c = rng.multinomial(n, p)
        counts[cb * 3] = [(int(g), int(c[g])) for g in np.flatnonzero(c)]
        n_umi[cb * 3] = int(c.sum())
    top = sorted(n_umi, key=lambda k: -n_umi[k])
    simple = set(top[:60])
    P = _P(["EmptyDrops_CR", "60", "0.99", "10", "300", "1200", "150",
            "0.01", "400", "0.01", "300"])
    want = ej(counts, n_umi, n_genes, simple, P)
    got = et(counts, n_umi, n_genes, simple, P)
    assert got == want
    assert 0 < len(want) < 400


def test_sgt_equals_star_tpu():
    from star_tpu.solo.sgt import SGT as SJ
    from star_tpu_torch.solo.sgt import SGT as ST
    rng = np.random.default_rng(3)
    for trial in range(20):
        obs = np.unique(rng.integers(1, 200, size=int(rng.integers(5, 60))))
        freq = rng.geometric(0.05, size=len(obs))
        a, b = SJ(), ST()
        for o, f in zip(obs, freq):
            a.add(int(o), int(f))
            b.add(int(o), int(f))
        assert a.analyse() == b.analyse()
        for o in range(0, int(obs.max()) + 2):
            assert a.estimate(o) == b.estimate(o), (trial, o)


def test_unordered_map_order_equals_g_plus_plus(probe):  # noqa: F811
    """both packages' UnorderedMap iterate in the order of a g++-built
    std::unordered_map over random insert sequences, with and without
    reserve()"""
    import subprocess
    from star_tpu.utils.stdhash import UnorderedMap as UJ
    from star_tpu_torch.utils.stdhash import UnorderedMap as UT
    rng = random.Random(11)
    for trial in range(40):
        n = rng.randrange(1, 300)
        reserve = rng.choice([0, 0, n // 2, n, 2 * n, 77])
        keys = [rng.randrange(0, rng.choice([50, 1000, 1 << 32]))
                for _ in range(n)]
        got = []
        for cls in (UJ, UT):
            um = cls(reserve=reserve)
            for k in keys:
                if um.find(k) is None:
                    um.insert(k, 1)
            got.append([k for k, _ in um.items()])
        res = subprocess.run([probe, str(reserve)] + [str(k) for k in keys],
                             capture_output=True, text=True, check=True)
        want = [int(x) for x in res.stdout.split()]
        assert got[1] == got[0] == want, f"trial {trial}: reserve={reserve}"
