"""The port's seed loop and whole alignment slice against star_tpu:
the query builder against star_tpu's barrel shifter, the probe tables of the
device seed loop against star_tpu's fused seed loop, and SAM / SJ.out.tab
through star_tpu_torch.run.align_reads against the STAR goldens.  Exact
equality throughout (integer data, text outputs)."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from star_tpu.genome.index import GenomeIndex as JaxGenomeIndex
from star_tpu.ops import pipeline as jpipe
from star_tpu.params import Parameters as JaxParameters
from star_tpu_torch.io.fastq import read_pairs_indexed
from star_tpu_torch.ops import pipeline as tpipe
from star_tpu_torch.params import Parameters
from star_tpu_torch.run import align_reads
from tests.conftest import DATA, GOLD
from tests.test_torch_mmp import port_index
from tests.test_torch_stitch import one_torch_thread  # noqa: F401

READS = {"se": ["reads_se.fastq"],
         "pe": ["reads_pe_1.fastq", "reads_pe_2.fastq"]}


def test_build_queries_matches_jax_shift_rows():
    """forward and reverse-complement queries, incl. shifts past the row end
    (-1 fill) and -1-padded read tails"""
    rng = np.random.default_rng(0)
    R, QL = 40, 128
    read_mat = np.full((R, QL), -1, np.int8)
    lens = rng.integers(20, 110, size=R)
    for i, ln in enumerate(lens):
        read_mat[i, :ln] = rng.integers(0, 5, size=ln)
    B = 300
    c_read = rng.integers(0, R, size=B)
    c_dir = rng.integers(0, 2, size=B)
    start = rng.integers(0, QL, size=B)
    slen = np.where(np.arange(B) % 3 == 0, QL, rng.integers(0, 100, size=B))

    rows = read_mat[c_read]
    xrow = jnp.where(jnp.asarray(c_dir)[:, None] == 0, rows,
                     3 - jnp.asarray(rows)[:, ::-1])
    sh = np.where(c_dir == 0, start, QL - 1 - start).astype(np.int32)
    want = np.asarray(jpipe._shift_rows(xrow, jnp.asarray(sh))[:, :QL])
    want = np.where(np.arange(QL)[None, :] < slen[:, None], want, -1)

    t = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    got = tpipe._build_queries(torch.from_numpy(read_mat), t(c_read),
                               t(start), t(slen), t(c_dir), QL)
    assert np.array_equal(got.numpy(), want)


def _prepped(gi, P, reads):
    """the batch as DeviceAligner._align_batch prepares it"""
    host = tpipe.ReadAligner(gi, P)
    prepped = []
    for name, seqs, quals, ftype, _, _ in read_pairs_indexed(
            reads, P.readFilesCommand, sam_mates=P.samInputNmates):
        res, r = host.prepare_read(name, seqs, quals)
        prepped.append((res, r))
    lmax = max(r.lread for r, _ in prepped)
    read_mat = np.full((len(prepped), lmax), -1, np.int8)
    for i, (res, r) in enumerate(prepped):
        read_mat[i, :res.lread] = r[0]
    return prepped, read_mat, lmax


@pytest.mark.parametrize("case,idx", [("se", "genome_idx"),
                                      ("pe", "genome_idx"),
                                      ("se", "genome_idx_sp2")])
def test_probe_tables_match_jax(case, idx):
    genome_dir = os.path.join(GOLD, idx)
    reads = [os.path.join(DATA, r) for r in READS[case]]
    argv = ["--genomeDir", genome_dir, "--readFilesIn", *reads]
    gj = JaxGenomeIndex.load(genome_dir)
    gp = port_index(gj)
    P = Parameters(argv)
    prepped, read_mat, lmax = _prepped(gp, P, reads)
    chains, _ = tpipe.chain_descriptors(P, prepped)
    cargs = chains[:5]

    da = tpipe.DeviceAligner(gp, P, device="cpu")
    da._ensure_kernel(lmax)
    got = da._run_chains_fused(read_mat, *cargs)

    dj = jpipe.DeviceAligner(gj, JaxParameters(argv))
    dj._ensure_kernel(lmax)
    want = dj._run_chains_fused(read_mat, *cargs)
    assert want is not None
    names = ["oml", "onr", "olo", "ohi", "mbest", "nprobes"]
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and np.array_equal(g, w), name
    assert got[5].max() > 1                  # chains ran several rounds


GOLDEN_CASES = [("se", "genome_idx", "se", []),
                ("pe", "genome_idx", "pe", []),
                ("se_gtf", "genome_idx_gtf", "se", []),
                ("se_sp2", "genome_idx_sp2", "se", []),
                ("pe_sp2", "genome_idx_sp2", "pe", []),
                ("se_bysjout", "genome_idx", "se",
                 ["--outFilterType", "BySJout"])]


def _align(tmp_path, idx, reads, extra):
    gp = port_index(JaxGenomeIndex.load(os.path.join(GOLD, idx)))
    prefix = str(tmp_path) + "/"
    P = Parameters(["--genomeDir", os.path.join(GOLD, idx),
                    "--readFilesIn", *[os.path.join(DATA, r)
                                       for r in READS[reads]],
                    "--outFileNamePrefix", prefix, *extra])
    align_reads(P, gi=gp, device="cpu")
    return prefix


@pytest.mark.parametrize("gold,idx,reads,extra", GOLDEN_CASES,
                         ids=[c[0] for c in GOLDEN_CASES])
def test_align_reads_golden(tmp_path, gold, idx, reads, extra):
    prefix = _align(tmp_path, idx, reads, ["--outSAMunmapped", "Within", *extra])

    def body(path):
        with open(path) as f:
            return [l for l in f if not l.startswith("@")]
    assert body(prefix + "Aligned.out.sam") == \
        body(os.path.join(GOLD, gold, "Aligned.out.sam"))
    with open(prefix + "SJ.out.tab") as a, \
            open(os.path.join(GOLD, gold, "SJ.out.tab")) as b:
        assert a.read() == b.read()


def test_unmapped_fastx_golden(tmp_path):
    prefix = _align(tmp_path, "genome_idx", "pe",
                    ["--outReadsUnmapped", "Fastx"])
    for m in ("mate1", "mate2"):
        with open(prefix + "Unmapped.out." + m) as a, \
                open(os.path.join(GOLD, "pe_unm", "Unmapped.out." + m)) as b:
            assert a.read() == b.read(), m
