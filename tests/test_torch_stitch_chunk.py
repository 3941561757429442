"""The grow chunk's kernel source (star_tpu_torch/ops/csrc/stitch_chunk.cu)
on the CPU: built as plain C++ (without nvcc, the lane code runs one lane
after another, one column a step), it must write the plain version's rows
and ok byte for byte on chunks captured from real grows (single-end with
and without annotated junctions, paired-end 2x100 and 2x150, insertions
flushed right, extensions to the end, a mate-gap limit and a tight
mismatch cap) and on the same chunks with their seeds
and positions moved out to the table edges.  The warp form of the same
code runs on the card in tests/test_torch_cuda.py."""
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from star_tpu_torch.genome.index import GenomeIndex
from star_tpu_torch.ops import device_stitch as ds
from star_tpu_torch.params import Parameters
from star_tpu_torch.run import align_reads
from tests.conftest import GOLD, ROOT
from tests.test_torch_cuda import moved_to_edges
from tests.test_torch_stitch import (  # noqa: F401  (fixtures)
    force_device_grow, one_torch_thread)

DATA = os.path.join(ROOT, "tests", "data", "small")
SE = ["reads_se.fastq"]
PE = ["reads_pe_1.fastq", "reads_pe_2.fastq"]
CASES = [("se", "genome_idx", SE, []),
         ("se_sjdb", "genome_idx_gtf", SE, []),
         ("se_flush_right", "genome_idx", SE,
          ["--alignInsertionFlush", "Right"]),
         ("pe", "genome_idx", PE, []),
         ("pe_sjdb_flush_right", "genome_idx_gtf", PE,
          ["--alignInsertionFlush", "Right"]),
         ("pe_end_to_end", "genome_idx", PE, ["--alignEndsType", "EndToEnd"]),
         ("pe_mates_gap_mm_cap", "genome_idx", PE,
          ["--alignMatesGapMax", "150", "--outFilterMismatchNoverLmax",
           "0.04"])]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/stitch_chunk.cu built for the host"""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a C++ compiler is needed to build the kernel's host form"
    so = str(tmp_path_factory.mktemp("stitch_chunk") / "libstitch_host.so")
    src = os.path.join(os.path.dirname(ds.__file__), "csrc", "stitch_chunk.cu")
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.stitch_chunk_host.restype = ctypes.c_int
    lib.stitch_chunk_host.argtypes = [
        p, p, i64, p, i64, p, i64, p, p, i64, p, p, p, p, i64, p, i64, p,
        i64, p, p, p, p, i64, i64]
    ds.check_config_fields(lib)
    return lib


def host_chunk(lib, cfg, Gf, n_g, RSf, lmax, floor16f, ceil_tab, ntab, sjdb,
               sc, ex, sj, rows, pm, fb, s):
    """the kernel's host form on CPU tensors: ((sc, ex, sj) rows, ok)"""
    vals = ds._kernel_config(cfg, n_g, lmax, ntab)
    conf = (ctypes.c_int32 * len(vals))(*vals)
    sjt = (ctypes.c_void_p * 7)(*[t.data_ptr() for t in sjdb])
    out = [torch.full_like(t, -7) for t in (sc, ex, sj)]
    ok = torch.zeros(sc.shape[0], dtype=torch.bool)
    rc = lib.stitch_chunk_host(
        conf, Gf.data_ptr(), Gf.numel(), RSf.data_ptr(), RSf.numel(),
        floor16f.data_ptr(), floor16f.numel(), ceil_tab.data_ptr(), sjt,
        sjdb[0].numel(), sc.data_ptr(), ex.data_ptr(), sj.data_ptr(),
        rows.data_ptr(), rows.shape[0], pm.data_ptr(), pm.shape[0],
        fb.data_ptr(), fb.shape[0], *[t.data_ptr() for t in out],
        ok.data_ptr(), sc.shape[0], s)
    assert rc == 0
    return out, ok


def capture(monkeypatch, run, limit=200_000):
    """run() with every grow chunk recorded: its inputs (the lane rows and
    the fallback flags as they were) and the plain version's rows and ok"""
    real = ds.stitch_chunk
    seen = []
    kept = [0]

    def spy(cfg, Gf, n_g, RSf, lmax, floor16f, ceil_tab, ntab, sjdb, sc, ex,
            sj, rows, pm, fb, s, out):
        args = (sc.clone(), ex.clone(), sj.clone(), rows, pm, fb.clone())
        ok = real(cfg, Gf, n_g, RSf, lmax, floor16f, ceil_tab, ntab, sjdb, sc,
                  ex, sj, rows, pm, fb, s, out)
        if kept[0] < limit:
            kept[0] += sc.shape[0]
            seen.append(((cfg, Gf, n_g, RSf, lmax, floor16f, ceil_tab, ntab,
                          sjdb), args, s,
                         tuple(t.clone() for t in out), ok.clone()))
        return ok

    monkeypatch.setattr(ds, "stitch_chunk", spy)
    run()
    monkeypatch.setattr(ds, "stitch_chunk", real)
    assert seen
    return seen


def map_reads(tmp_path, idx, reads, flags, data=DATA, gi=None):
    P = Parameters(["--genomeDir", idx, "--readFilesIn",
                    *[os.path.join(data, r) for r in reads],
                    "--outFileNamePrefix", str(tmp_path) + "/", *flags])
    align_reads(P, gi=gi or GenomeIndex.load(idx), device="cpu")


def assert_chunks_equal(lib, chunks):
    n_lanes = n_ok = 0
    for tabs, (sc, ex, sj, rows, pm, fb), s, want, ok_w in chunks:
        got, ok = host_chunk(lib, *tabs, sc, ex, sj, rows, pm, fb, s)
        for name, g, w in zip(("sc", "ex", "sj"), got, want):
            bad = (g != w).any(dim=1).nonzero()[:, 0]
            assert bad.numel() == 0, (name, s, bad[:5].tolist())
        assert torch.equal(ok, ok_w), s
        n_lanes += sc.shape[0]
        n_ok += int(ok.sum())
    return n_lanes, n_ok


@pytest.mark.parametrize("case,idx,reads,flags", CASES,
                         ids=[c[0] for c in CASES])
def test_host_build_matches_plain_chunks(host_lib, tmp_path, monkeypatch,
                                         force_device_grow, case, idx, reads,
                                         flags):
    chunks = capture(monkeypatch, lambda: map_reads(
        tmp_path, os.path.join(GOLD, idx), reads, flags))
    cfg = chunks[0][0][0]
    assert cfg.has_pe == (reads == PE) and cfg.has_sjdb == (idx != "genome_idx")
    assert cfg.ins_flush_right == ("Right" in flags)
    n_lanes, n_ok = assert_chunks_equal(host_lib, chunks)
    assert n_ok > 0 and n_lanes > n_ok


def test_host_build_matches_plain_chunks_2x150(host_lib, tmp_path,
                                               monkeypatch, force_device_grow):
    """2x150 pairs: Lpad 303, genome regions of 1,172 bytes"""
    data = tmp_path / "data"
    subprocess.run([sys.executable,
                    os.path.join(ROOT, "tools", "make_test_data.py"),
                    "--out", str(data), "--read-len", "150", "--seed", "5",
                    "--n-reads", "120"], check=True, stdout=subprocess.DEVNULL)
    gi = GenomeIndex.generate([str(data / "genome.fa")], sa_index_nbases=7)
    gi.save(str(tmp_path / "idx"))
    chunks = capture(monkeypatch, lambda: map_reads(
        tmp_path, str(tmp_path / "idx"), PE, [], data=str(data), gi=gi))
    assert chunks[0][0][0].Lpad == 303
    n_lanes, n_ok = assert_chunks_equal(host_lib, chunks)
    assert n_ok > 0


def test_host_build_matches_plain_at_table_edges(host_lib, tmp_path,
                                                 monkeypatch,
                                                 force_device_grow):
    """captured PE chunks on the annotated index with their seeds moved by up
    to a few hundred bases, their mates switched, and lanes whose last exon
    ends at the genome's or the read table's edges, or beyond them, so
    that every region clamps (the plain version's windows at both ends);
    about half the chunks extend their mates to the end (EndToEnd), where
    a genome edge stops the extension (the card test's moved_to_edges)"""
    chunks = capture(monkeypatch, lambda: map_reads(
        tmp_path, os.path.join(GOLD, "genome_idx_gtf"), PE, []), limit=30_000)
    rng = np.random.default_rng(11)
    moved = []
    for tabs, (sc, ex, sj, rows, pm, fb), s, _, _ in chunks:
        tabs, sc, rows = moved_to_edges(ds, rng, tabs, sc, rows)
        out = tuple(torch.zeros_like(t) for t in (sc, ex, sj))
        ok = ds._stitch_chunk_plain(*tabs, sc, ex, sj, rows, pm, fb, s, out)
        moved.append((tabs, (sc, ex, sj, rows, pm, fb), s, out, ok))
    n_lanes, n_ok = assert_chunks_equal(host_lib, moved)
    assert n_ok > 0 and n_lanes > n_ok
