"""The sharded suffix-array index of star_tpu_torch (parallel/mesh.py) on
CPU shards: the sharded MMP against the host oracle mmp_search, star_tpu's
make_sharded_mmp on its 8-device CPU mesh and the port's single-device MMP;
the big (int64, forward-G-only) layout; --tpuShardedIndex 1 end to end
against the goldens; ShardedGeneCounts and psum_merge.  Exact equality
throughout (integer data, text outputs)."""
import functools
import os

import jax
import numpy as np
import pytest
import torch

from star_tpu.align.seed import mmp_search
from star_tpu.genome.index import GenomeIndex as JaxGenomeIndex
from star_tpu.parallel import mesh as jmesh
from star_tpu_torch import run
from star_tpu_torch.ops import pipeline
from star_tpu_torch.ops.sa_search import DeviceIndex, make_mmp_fn
from star_tpu_torch.parallel import mesh as tmesh
from star_tpu_torch.params import Parameters
from tests.conftest import DATA, GOLD
from tests.test_sharding import _make_queries
from tests.test_torch_mmp import _queries, port_index
from tests.test_torch_pipeline import _prepped
from tests.test_torch_stitch import one_torch_thread  # noqa: F401

QL = 128


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    yield


@pytest.fixture(scope="module")
def indexes():
    gj = JaxGenomeIndex.load(os.path.join(GOLD, "genome_idx"))
    return gj, port_index(gj)


def cpu_mesh(dp, ix):
    return tmesh.make_mesh(["cpu"] * (dp * ix), dp=dp, ix=ix)


def run_mmp(mmp, qs, qlens, valid=None):
    out = mmp(torch.from_numpy(qs), torch.from_numpy(qlens),
              None if valid is None else torch.from_numpy(valid))
    assert all(t.dtype == torch.int64 for t in out)
    return np.stack([t.numpy() for t in out], axis=1)


def host(gi, qs, qlens):
    return np.array([mmp_search(gi, qs[b, :qlens[b]]) for b in range(len(qs))])


@pytest.mark.parametrize("dp,ix", [(2, 4), (1, 8), (4, 2)])
def test_sharded_mmp_matches_host_and_jax(indexes, dp, ix):
    """star_tpu's query sets (tests/test_sharding.py) and the port's, with
    absent-prefix queries (tests/test_torch_mmp.py)"""
    gj, gp = indexes
    mmp = tmesh.make_sharded_mmp(
        tmesh.ShardedIndex.build(gp, cpu_mesh(dp, ix), ql=QL))
    qs, qlens = _make_queries(gj, 64, seed=7, ql=QL)
    got = run_mmp(mmp, qs, qlens)
    assert np.array_equal(got, host(gj, qs, qlens))
    jm = jmesh.make_mesh(jax.devices()[:dp * ix], dp=dp, ix=ix)
    want = np.stack([np.asarray(x) for x in jmesh.make_sharded_mmp(
        jmesh.ShardedIndex.build(gj, jm, ql=QL))(qs, qlens)], axis=1)
    assert np.array_equal(got, want)
    qs, qlens = _queries(gj, n=256, seed=dp)
    assert np.array_equal(run_mmp(mmp, qs, qlens), host(gj, qs, qlens))


def test_sharded_mmp_big_layout(indexes):
    """the mammal-scale layout forced on the small genome: int64 SA rows,
    the forward genome alone, every output int64 and equal to the host"""
    gj, gp = indexes
    si = tmesh.ShardedIndex.build(gp, cpu_mesh(2, 4), ql=QL, big=True)
    assert si.g_only and si.big
    assert all(t.numel() >= si.shard_rows * 8 for t in si.sa.values())
    assert all(t.numel() < 2 * gp.n_genome for t in si.text.values())
    qs, qlens = _make_queries(gj, 64, seed=3, ql=QL)
    assert np.array_equal(run_mmp(tmesh.make_sharded_mmp(si), qs, qlens),
                          host(gj, qs, qlens))
    qs, qlens = _queries(gj, n=256, seed=5)
    assert np.array_equal(run_mmp(tmesh.make_sharded_mmp(si), qs, qlens),
                          host(gj, qs, qlens))


def test_big_layout_text_window_equals_doubled_text(indexes):
    """every suffix window of the forward-only text equals the doubled text
    T2 (5 past its end): both strand edges, forward windows that cross into
    the reverse strand, and random positions"""
    _, gp = indexes
    N = gp.n_genome
    si = tmesh.ShardedIndex.build(gp, cpu_mesh(1, 1), ql=QL, big=True)
    edges = [np.arange(0, QL + 2), np.arange(N - QL - 2, N + QL + 2),
             np.arange(2 * N - QL - 2, 2 * N)]
    rng = np.random.default_rng(0)
    pos = np.concatenate(edges + [rng.integers(0, 2 * N, size=2000)])
    # a G of four bases without spacers: the strands meet mid-window
    gp2 = port_index(JaxGenomeIndex.load(os.path.join(GOLD, "genome_idx")))
    gp2.G = rng.integers(0, 5, size=N).astype(np.int8)
    from star_tpu_torch.genome.fasta import build_t2
    gp2.t2 = build_t2(gp2.G)
    for g, s in ((gp, si), (gp2, tmesh.ShardedIndex.build(
            gp2, cpu_mesh(1, 1), ql=QL, big=True))):
        t2 = np.concatenate([g.t2, np.full(QL, 5, np.int8)])
        want = t2[pos[:, None] + np.arange(QL)]
        got = tmesh.text_window(s, s.text[torch.device("cpu")],
                                torch.from_numpy(pos),
                                torch.ones(len(pos), dtype=torch.bool))
        assert np.array_equal(got.numpy(), want)


def test_sharded_mmp_equals_single_device(indexes):
    """a drop-in for make_mmp_fn, lanes not valid included, and the seed
    loop's probe tables through DeviceAligner equal to the single-device
    aligner's"""
    gj, gp = indexes
    qs, qlens = _queries(gj, n=256, seed=9)
    valid = np.random.default_rng(9).random(len(qs)) < 0.8
    single = make_mmp_fn(DeviceIndex.build(gp, ql=QL, device="cpu"))
    sharded = tmesh.make_sharded_mmp(
        tmesh.ShardedIndex.build(gp, cpu_mesh(2, 2), ql=QL))
    assert np.array_equal(run_mmp(sharded, qs, qlens, valid),
                          run_mmp(single, qs, qlens, valid))

    reads = [os.path.join(DATA, "reads_se.fastq")]
    argv = ["--genomeDir", os.path.join(GOLD, "genome_idx"),
            "--readFilesIn", *reads]
    P = Parameters(argv)
    prepped, read_mat, lmax = _prepped(gp, P, reads)
    cargs = pipeline.chain_descriptors(P, prepped)[0][:5]
    tables = []
    for mesh in (None, cpu_mesh(1, 4)):
        da = pipeline.DeviceAligner(gp, P, device="cpu", mesh=mesh)
        da._ensure_kernel(lmax)
        tables.append(da._run_chains_fused(read_mat, *cargs))
    for a, b in zip(*tables):
        assert np.array_equal(a, b)
    assert any(k[0] == "sharded" for k in gp._device_cache)


def golden_argv(prefix, *extra):
    return ["--genomeDir", os.path.join(GOLD, "genome_idx_gtf"),
            "--readFilesIn", os.path.join(DATA, "reads_se.fastq"),
            "--outFileNamePrefix", prefix, "--outSAMunmapped", "Within",
            "--quantMode", "GeneCounts", "--tpuShardedIndex", "1",
            "--tpuBatchSize", "128", *extra]


def assert_sharded_golden(prefix):
    def body(path):
        with open(path) as f:
            return [l for l in f if not l.startswith("@")]
    assert body(prefix + "Aligned.out.sam") == \
        body(os.path.join(GOLD, "se_gtf", "Aligned.out.sam"))
    for f, gold in (("SJ.out.tab", "se_gtf"),
                    ("ReadsPerGene.out.tab", "se_quant")):
        with open(prefix + f) as a, open(os.path.join(GOLD, gold, f)) as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("entry", ["align_reads_8_shards", "main_1_shard"])
def test_sharded_golden_end_to_end(tmp_path, monkeypatch, entry):
    """--tpuShardedIndex 1 --quantMode GeneCounts: SAM, SJ.out.tab and
    ReadsPerGene.out.tab byte-identical to the goldens, through the sharded
    index and MMP and the dp merge of the gene counts, never through the
    single-device index"""
    built, merged = [], []
    real_build, real_merge = tmesh.ShardedIndex.build, tmesh.psum_merge

    def build(gi, mesh, **k):
        built.append((mesh.dp, mesh.ix))
        return real_build(gi, mesh, **k)

    def merge(tables, mesh):
        merged.append((mesh.dp, mesh.ix))
        return real_merge(tables, mesh)

    def no_single(*a, **k):
        raise AssertionError("the single-device index was built")
    monkeypatch.setattr(tmesh.ShardedIndex, "build", build)
    monkeypatch.setattr(tmesh, "psum_merge", merge)
    monkeypatch.setattr(DeviceIndex, "build", no_single)
    prefix = str(tmp_path) + "/"
    if entry == "main_1_shard":
        monkeypatch.setattr(run, "align_reads",
                            functools.partial(run.align_reads, device="cpu"))
        run.main(golden_argv(prefix))
        want = (1, 1)
    else:
        run.align_reads(Parameters(golden_argv(prefix)), device="cpu",
                        mesh=cpu_mesh(2, 4))
        want = (2, 4)
    assert built == [want] and merged and set(merged) == {want}
    assert_sharded_golden(prefix)


def test_sharded_host_oracle_needs_no_card(tmp_path, monkeypatch):
    """--tpuShardedIndex 1 --tpuUseDevice 0 maps on the host without a card:
    no mesh, no sharded index, plain GeneCounts, the goldens' bytes"""
    from star_tpu_torch.quant import transcriptome as tq

    def no_sharding(*a, **k):
        raise AssertionError("the host run made index shards")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tmesh, "make_mesh", no_sharding)
    monkeypatch.setattr(tq, "ShardedGeneCounts", no_sharding)
    monkeypatch.setattr(pipeline, "DeviceAligner", no_sharding)
    prefix = str(tmp_path) + "/"
    run.align_reads(Parameters(golden_argv(prefix, "--tpuUseDevice", "0")))
    assert_sharded_golden(prefix)


def test_sharded_gene_counts_equal_gene_counts(tmp_path, monkeypatch):
    """the reads a GeneCounts run counts, dealt round-robin over four dp
    counters and merged, give the same ReadsPerGene.out.tab"""
    from star_tpu_torch.quant import transcriptome as tq
    calls = []
    real = tq.GeneCounts.add_read

    def add_read(self, transcripts, n_tr):
        calls.append((transcripts, n_tr))
        return real(self, transcripts, n_tr)
    monkeypatch.setattr(tq.GeneCounts, "add_read", add_read)
    prefix = str(tmp_path) + "/"
    argv = golden_argv(prefix)[:-4]
    st = run.align_reads(Parameters(argv), device="cpu")
    monkeypatch.undo()
    trm = tq.Transcriptome.load(os.path.join(GOLD, "genome_idx_gtf"))
    sharded = tq.ShardedGeneCounts(trm, cpu_mesh(4, 1))
    plain = tq.GeneCounts(trm)
    for a in calls:
        sharded.add_read(*a)
        plain.add_read(*a)
    assert all(p.counts.sum() > 0 for p in sharded.parts)
    n_unmapped = (st.unmapped_mm + st.unmapped_short + st.unmapped_other
                  + st.unmapped_multi)
    for c, name in ((plain, "plain"), (sharded, "sharded")):
        c.write(prefix + name, n_unmapped)
    with open(prefix + "plain") as a, open(prefix + "sharded") as b:
        assert a.read() == b.read()
    with open(prefix + "sharded") as a, open(os.path.join(
            GOLD, "se_quant", "ReadsPerGene.out.tab")) as b:
        assert a.read() == b.read()


def test_psum_merge_exact_past_2_32():
    rng = np.random.default_rng(1)
    mesh = cpu_mesh(4, 2)
    tables = (1 << 40) + rng.integers(0, 1 << 33, size=(4, 3, 50))
    got = tmesh.psum_merge(tables, mesh)
    assert got.dtype == np.int64 and np.array_equal(got, tables.sum(axis=0))
    t = tmesh.psum_merge(torch.from_numpy(tables), mesh)
    assert isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), got)
    with pytest.raises(ValueError):
        tmesh.psum_merge(tables[:2], mesh)


def test_sparse_index_with_sharded_takes_host_route(tmp_path, monkeypatch):
    """as in star_tpu, a sparse suffix array maps on the host under
    --tpuShardedIndex 1, and says so in Log.out"""
    def no_device(*a, **k):
        raise AssertionError("the device path was taken")
    monkeypatch.setattr(pipeline, "DeviceAligner", no_device)
    prefix = str(tmp_path) + "/"
    P = Parameters(["--genomeDir", os.path.join(GOLD, "genome_idx_sp2"),
                    "--readFilesIn", os.path.join(DATA, "reads_se.fastq"),
                    "--outFileNamePrefix", prefix, "--outSAMunmapped",
                    "Within", "--tpuShardedIndex", "1",
                    "--readMapNumber", "40"])
    run.align_reads(P, device="cpu")
    with open(prefix + "Log.out") as f:
        assert "--tpuShardedIndex: a sparse suffix array" in f.read()

    def body(path):
        with open(path) as f:
            return [l for l in f if not l.startswith("@")]
    got = body(prefix + "Aligned.out.sam")
    names = {l.split("\t", 1)[0] for l in got}
    want = [l for l in body(os.path.join(GOLD, "se_sp2", "Aligned.out.sam"))
            if l.split("\t", 1)[0] in names]
    assert len(names) == 40 and got == want


def test_make_mesh_layouts(tmp_path, monkeypatch):
    """star_tpu's default split; a split that does not tile the shards, and
    a mesh without its flag, are refused; without CUDA only CPU shards named
    by the caller make a mesh"""
    for n, shape in ((8, (2, 4)), (4, (2, 2)), (2, (2, 1)), (1, (1, 1))):
        m = tmesh.make_mesh(["cpu"] * n)
        assert (m.dp, m.ix) == shape and len(m.shards) == n
        assert [(s.row, s.col) for s in m.shards] == \
            [(k // m.ix, k % m.ix) for k in range(n)]
        assert m.ix_group is None and m.dp_group is None
    with pytest.raises(ValueError):
        tmesh.make_mesh(["cpu"] * 6, dp=4, ix=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    P = Parameters(golden_argv(str(tmp_path) + "/")[:-4])
    with pytest.raises(ValueError, match="needs --tpuShardedIndex 1"):
        run.align_reads(P, device="cpu", mesh=cpu_mesh(1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.align_reads(Parameters(golden_argv(str(tmp_path) + "/")))
