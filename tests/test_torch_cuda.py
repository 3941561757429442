"""Tests of star_tpu_torch that need an NVIDIA GPU: the hand-written CUDA
kernels (fetch_window, fetch_rows, tile_fetch, the grow's stitch_chunk)
against their plain PyTorch versions, the MMP search on the card
against the host oracle, the device grow on the card against the numpy
grow, the device finalize, select and pack on the card against the same
engine on CPU tensors, and two-pass mapping, GeneCounts and BAM output on the
card against the goldens, chimeric detection and the mate-overlap merge on
the card against the goldens, TranscriptomeSAM on the card's device path
against the host oracle (single- and paired-end, soft-clipped alignments
extended), STARsolo counting with CB/UB BAM tags on
the card against the goldens, EmptyDrops_CR's Monte-Carlo null kernel
against its plain version and the solo_ed golden through it, and the
sharded index (four shards on the card) against the host oracle and the
goldens, with the merges of a one-rank NCCL group.  They skip where no card
is present.  This file
imports neither jax nor star_tpu, so on a machine with a card and no jax it
runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from chip_smoke import (ANNOT_GOLDENS, FUSION_GOLDENS, SOLO_GOLDENS,
                        TESTS, bam_records, same_output, solo_diff)
from star_tpu_torch.ops import fetch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "golden", "small")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_raw,rows", [(300_001, 70_000), (1 << 24, 262_144)])
def test_fetch_rows_kernel_matches_plain(cuda, n_raw, rows):
    rng = np.random.default_rng(n_raw)
    raw = rng.integers(-128, 128, size=n_raw, dtype=np.int8)
    tab = torch.from_numpy(fetch.pad_table(raw)).to(cuda)
    off = rng.integers(-n_raw // 8, n_raw, size=rows)
    off[:6] = [-1, 0, 1023, 1024, n_raw - 1, (n_raw // 1024) * 1024 - 1]
    off = torch.from_numpy(off).to(cuda)
    n0 = fetch.ROWS_LAUNCHES
    got = fetch.fetch_rows(tab, off)
    torch.cuda.synchronize()
    assert fetch.ROWS_LAUNCHES == n0 + 1
    want = fetch._fetch_rows_torch(tab, off)
    live = off >= 0
    assert torch.equal(got[live], want[live])


@pytest.mark.cuda
def test_fetch_rows_kernel_refuses_bad_inputs(cuda):
    tab = torch.from_numpy(fetch.pad_table(np.zeros(5000, np.int8))).to(cuda)
    off = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        fetch.fetch_rows(tab[16:], off)             # not a multiple of 1024
    with pytest.raises(ValueError):
        fetch.fetch_rows(tab, off.int())            # int32 offsets
    with pytest.raises(ValueError):
        fetch.fetch_rows(tab, off.cpu())            # offsets on another device
    assert fetch.fetch_rows(tab, off[:0]).shape == (0, fetch.FET)


# the main path's windows (MMP 4, 8, QL; lane rows 96, 400; Lwin, 2 * Lwin,
# RSPAN, GSPAN at 100 bp), a two-row span and the widest window
WIDTHS = [4, 8, 96, 104, 128, 208, 318, 400, 724, 1172, 3072]


@pytest.mark.cuda
@pytest.mark.parametrize("width", WIDTHS)
def test_window_kernel_matches_plain(cuda, width):
    n_raw, rows = 3_000_001, 65_536
    rng = np.random.default_rng(width)
    raw = rng.integers(-128, 128, size=n_raw, dtype=np.int8)
    tab = torch.from_numpy(fetch.pad_table(raw)).to(cuda)
    n = tab.numel()
    s = rng.integers(-n // 8, n + 64, size=rows)
    s[:12] = [-1, 0, 1, 15, 17, n_raw - 1, n - width - 1, n - width,
              n - width + 1, n - 1, n, 1 << 40]
    s = torch.from_numpy(s).to(cuda)
    n0 = fetch.LAUNCHES
    got = fetch.fetch_window(tab, s, width)
    torch.cuda.synchronize()
    assert fetch.LAUNCHES == n0 + 1
    assert got.shape == (rows, width) and got.stride(0) % 16 == 0
    want = fetch._fetch_window_torch(tab, s, width)
    live = s >= 0
    assert torch.equal(got[live], want[live])


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8, 24, 100, 318, 2053])
def test_window_kernel_every_residue(cuda, width):
    """a start in each of the 16 byte residues of a 16-byte vector, across a
    1 KiB tile edge and at the table's last bytes"""
    raw = np.arange(50_000, dtype=np.int64).astype(np.int8)
    tab = torch.from_numpy(fetch.pad_table(raw)).to(cuda)
    s = np.concatenate([1008 + np.arange(32), 7 * 1024 - 8 + np.arange(16),
                        tab.numel() - width - 16 + np.arange(17)])
    s = torch.from_numpy(s).to(cuda)
    got = fetch.fetch_window(tab, s, width)
    want = torch.stack([tab[i:i + width] for i in s.tolist()])
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_window_kernel_refuses_bad_inputs(cuda):
    tab = torch.from_numpy(fetch.pad_table(np.zeros(50_000, np.int8))).to(cuda)
    s = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        fetch.fetch_window(tab, s.int(), 8)                  # int32 starts
    with pytest.raises(ValueError):
        fetch.fetch_window(tab.view(torch.uint8), s, 8)      # uint8 table
    with pytest.raises(ValueError):
        fetch.fetch_window(tab[1:1 + 16 * 1024], s, 8)       # misaligned
    with pytest.raises(ValueError):
        fetch.fetch_window(tab, s, fetch.WINDOW_MAX + 1)     # over the padding
    with pytest.raises(ValueError):
        fetch.fetch_window(tab[:3 * 1024], s, 1100)          # over the table
    assert fetch.fetch_window(tab, s[:0], 96).shape == (0, 96)


@pytest.mark.cuda
def test_mmp_on_card_matches_host(cuda):
    from star_tpu_torch.align.seed import mmp_search
    from star_tpu_torch.genome.index import GenomeIndex
    from star_tpu_torch.ops.sa_search import DeviceIndex, make_mmp_fn
    gi = GenomeIndex.load(os.path.join(GOLD, "genome_idx"))
    rng = np.random.default_rng(0)
    n, ql = 512, 128
    qs = np.full((n, ql), -1, np.int8)
    qlen = rng.integers(1, 100, size=n)
    for b in range(n):
        if b % 2:
            qs[b, :qlen[b]] = rng.integers(0, 4, size=qlen[b])
        else:
            p0 = int(rng.integers(0, gi.n_genome - 200))
            q = gi.G[p0:p0 + qlen[b]]
            qs[b, :qlen[b]] = np.where(q > 3, 0, q)
    mmp = make_mmp_fn(DeviceIndex.build(gi, ql=ql, device=cuda))
    n0 = fetch.LAUNCHES
    got = np.stack([t.cpu().numpy() for t in mmp(
        torch.from_numpy(qs).to(cuda), torch.from_numpy(qlen).to(cuda))], 1)
    assert fetch.LAUNCHES > n0
    host = np.array([mmp_search(gi, qs[b, :qlen[b]]) for b in range(n)])
    assert np.array_equal(got, host)


@pytest.mark.cuda
def test_tile_fetch_kernel_matches_plain(cuda):
    from star_tpu_torch.ops import tile_fetch
    rng = np.random.default_rng(11)
    n_raw, batch = 3_000_001, 65_536
    raw = rng.integers(-128, 128, size=n_raw, dtype=np.int8)
    tab = torch.from_numpy(tile_fetch.pad_table(raw)).to(cuda)
    pos = rng.integers(0, n_raw, size=batch).astype(np.int32)
    pos[:6] = [0, 1023, 1024, n_raw - 1, (n_raw // 1024) * 1024, n_raw - 2048]
    pos = torch.from_numpy(pos).to(cuda)
    fn = tile_fetch.make_tile_fetch(tab, batch)
    n0 = tile_fetch.LAUNCHES
    got = fn(pos)
    torch.cuda.synchronize()
    assert tile_fetch.LAUNCHES == n0 + 1
    assert torch.equal(got, tile_fetch._tile_fetch_torch(tab, pos))
    with pytest.raises(ValueError):
        fn(pos.long())                              # int64 positions
    with pytest.raises(ValueError):
        tile_fetch.make_tile_fetch(tab, batch + 8)  # not a multiple of blk


@pytest.mark.cuda
@pytest.mark.parametrize("case,reads", [
    ("se", ["reads_se.fastq"]),
    ("pe", ["reads_pe_1.fastq", "reads_pe_2.fastq"])])
def test_device_grow_on_card_matches_numpy(cuda, tmp_path, monkeypatch, case,
                                           reads):
    """the grow on the card (through the fetch_window kernel) gives the numpy engine's LaneStates on every level, and the goldens"""
    import copy
    from star_tpu_torch.genome.index import GenomeIndex
    from star_tpu_torch.ops import batch_engine as be
    from star_tpu_torch.ops import device_stitch as ds
    from star_tpu_torch.params import Parameters
    from star_tpu_torch.run import align_reads
    monkeypatch.delenv("STAR_TPU_DEVICE_STITCH", raising=False)
    monkeypatch.setattr(be, "DEVICE_GROW_MIN_RECORDS",
                        {s_max: 0 for _, s_max, _ in be.LEVELS})
    real = ds.grow_chains_device
    grown = []

    def spy(gi, P, st, ws, RS, nmm, Lpad, s_max, chain_cap, device,
            lread=None, read_len2=None, classify=False):
        st_np = copy.deepcopy(st)
        st_cpu = copy.deepcopy(st)
        G = gi.G.view(np.uint8)
        want = be.grow_chains(gi, P, G, RS, st_np, ws, nmm, Lpad,
                              chain_cap=chain_cap)
        n0, c0 = fetch.LAUNCHES, ds.LAUNCHES
        got = real(gi, P, copy.deepcopy(st), ws, RS, nmm, Lpad, s_max,
                   chain_cap, device)[0]
        assert device.type == "cuda" and fetch.LAUNCHES > n0
        assert ds.LAUNCHES > c0
        for k in be._lane_fields():
            assert np.array_equal(getattr(got, k), getattr(want, k)), k
        # grow + finalize (+ select on se) on the card, as the run calls it,
        # against the same engine on CPU tensors
        out = real(gi, P, st, ws, RS, nmm, Lpad, s_max, chain_cap, device,
                   lread=lread, read_len2=read_len2, classify=classify)
        ref = real(gi, P, st_cpu, ws, RS, nmm, Lpad, s_max, chain_cap, "cpu",
                   lread=lread, read_len2=read_len2, classify=classify)
        assert np.array_equal(st.fallback, st_np.fallback)
        assert np.array_equal(st_cpu.fallback, st_np.fallback)
        assert out[1] is not None and (out[2] is None) == (case == "pe")
        for k in be._lane_fields():
            assert np.array_equal(getattr(out[0], k), getattr(ref[0], k)), k
        assert np.array_equal(out[1], ref[1])
        assert (out[2] is None and ref[2] is None) \
            or np.array_equal(out[2], ref[2])
        grown.append(len(want.b))
        return out

    monkeypatch.setattr(ds, "grow_chains_device", spy)
    gi = GenomeIndex.load(os.path.join(GOLD, "genome_idx"))
    prefix = str(tmp_path) + "/"
    P = Parameters(["--genomeDir", os.path.join(GOLD, "genome_idx"),
                    "--readFilesIn",
                    *[os.path.join(ROOT, "tests", "data", "small", r)
                      for r in reads],
                    "--outFileNamePrefix", prefix, "--outSAMunmapped", "Within"])
    align_reads(P, gi=gi, device=cuda)
    assert len(grown) == 2 and min(grown) > 0       # both levels grew chains

    def body(path):
        with open(path) as f:
            return [l for l in f if not l.startswith("@")]
    assert body(prefix + "Aligned.out.sam") == \
        body(os.path.join(GOLD, case, "Aligned.out.sam"))


SE_READS = ["reads_se.fastq"]
PE_READS = ["reads_pe_1.fastq", "reads_pe_2.fastq"]
# (case, index, reads, flags) of the chunk kernel's card test; "2x150" maps
# a generated set of 2x150 pairs on its own index (Lpad 303), "edges" the
# pe set with every chunk also launched with its seeds and positions moved
# out to the table edges, and every other one extended to the end
CHUNK_CASES = [
    ("se", "genome_idx", SE_READS, []),
    ("se_sjdb", "genome_idx_gtf", SE_READS, []),
    ("se_flush_right", "genome_idx", SE_READS,
     ["--alignInsertionFlush", "Right"]),
    ("pe", "genome_idx", PE_READS, []),
    ("pe_sjdb_flush_right", "genome_idx_gtf", PE_READS,
     ["--alignInsertionFlush", "Right"]),
    ("pe_end_to_end", "genome_idx", PE_READS, ["--alignEndsType", "EndToEnd"]),
    ("pe_mates_gap_mm_cap", "genome_idx", PE_READS,
     ["--alignMatesGapMax", "150", "--outFilterMismatchNoverLmax", "0.04"]),
    ("2x150", None, PE_READS, []),
    ("edges", "genome_idx_gtf", PE_READS, [])]


def moved_to_edges(ds, rng, tabs, sc, rows):
    """a chunk's inputs with its seeds moved by up to a few hundred bases,
    some mates switched, and lanes whose last exon ends at (or beyond) the
    genome's or the read table's edges: (tabs, sc, rows)"""
    import dataclasses
    cfg, n_g = tabs[0], tabs[2]
    dev = sc.device
    ri = lambda lo, hi, n: torch.from_numpy(
        rng.integers(lo, hi, n)).int().to(dev)
    rows = rows.clone()
    nw = rows.shape[0]
    rows[:, 0] += ri(-40, 40, nw)
    rows[:, 1] += ri(-400, 400, nw)
    rows[:, 2] = ri(1, cfg.Lpad, nw)
    flip = torch.from_numpy(rng.random(nw) < 0.3).to(dev)
    rows[flip, 3] = 1 - rows[flip, 3]
    sc = sc.clone()
    n = sc.shape[0]
    tg = torch.tensor([-2000, -300, 5, n_g - 5, n_g + 300, n_g + 5000],
                      dtype=torch.int32, device=dev)
    pick = torch.from_numpy(rng.random(n) < 0.5).to(dev)
    sc[pick, ds.C_TG2] = tg[ri(0, 6, n).long()][pick]
    big = 2 * (tabs[3].numel() // tabs[4])
    rv = torch.tensor([0, 1, big // 2 - 1, big], dtype=torch.int32,
                      device=dev)
    pick = torch.from_numpy(rng.random(n) < 0.3).to(dev)
    sc[pick, ds.C_ROW] = rv[ri(0, 4, n).long()][pick]
    if rng.random() < 0.5:
        cfg = dataclasses.replace(cfg, ends_ext=((True, True),) * 2)
    return (cfg, *tabs[1:]), sc, rows


@pytest.mark.cuda
@pytest.mark.parametrize("case,idx,reads,flags", CHUNK_CASES,
                         ids=[c[0] for c in CHUNK_CASES])
def test_stitch_chunk_kernel_matches_plain(cuda, tmp_path, monkeypatch, case,
                                           idx, reads, flags):
    """every grow chunk of a mapping run on the card (the device engine
    forced on every level) launched once through the kernel and held
    against the plain version on the same CUDA tensors: the rows it writes
    (sc, ex, sj) and ok byte for byte; one launch per chunk, and the
    grow's chunk_launches equal to its iterations"""
    import subprocess
    import sys
    from star_tpu_torch.genome.index import GenomeIndex
    from star_tpu_torch.ops import batch_engine as be
    from star_tpu_torch.ops import device_stitch as ds
    from star_tpu_torch.params import Parameters
    from star_tpu_torch.run import align_reads
    monkeypatch.delenv("STAR_TPU_DEVICE_STITCH", raising=False)
    monkeypatch.setattr(be, "DEVICE_GROW_MIN_RECORDS",
                        {s_max: 0 for _, s_max, _ in be.LEVELS})
    data = os.path.join(ROOT, "tests", "data", "small")
    if case == "2x150":
        data = str(tmp_path / "data")
        subprocess.run([sys.executable,
                        os.path.join(ROOT, "tools", "make_test_data.py"),
                        "--out", data, "--read-len", "150", "--seed", "5",
                        "--n-reads", "120"], check=True,
                       stdout=subprocess.DEVNULL)
        gi = GenomeIndex.generate([os.path.join(data, "genome.fa")],
                                  sa_index_nbases=7)
        idx = str(tmp_path / "idx")
        gi.save(idx)
    else:
        idx = os.path.join(GOLD, idx)
        gi = GenomeIndex.load(idx)
    rng = np.random.default_rng(17)
    real = ds.stitch_chunk
    seen = {"chunks": 0, "lanes": 0, "ok": 0, "Lpad": set(), "edges": 0}

    def check(tabs, sc, ex, sj, rows, pm, fb, s):
        want = tuple(torch.full_like(t, -7) for t in (sc, ex, sj))
        ok_w = ds._stitch_chunk_plain(*tabs, sc, ex, sj, rows, pm, fb, s,
                                      want)
        got = tuple(torch.full_like(t, -9) for t in (sc, ex, sj))
        n0 = ds.LAUNCHES
        ok = real(*tabs, sc, ex, sj, rows, pm, fb, s, got)
        assert ds.LAUNCHES == n0 + 1
        for name, g, w in zip(("sc", "ex", "sj"), got, want):
            bad = (g != w).any(dim=1).nonzero()[:, 0]
            assert bad.numel() == 0, (case, name, s, bad[:5].tolist())
        assert torch.equal(ok, ok_w), (case, s)
        return int(ok.sum())

    def spy(*a):
        tabs, (sc, ex, sj, rows, pm, fb, s, out) = a[:9], a[9:]
        assert sc.is_cuda
        # the checks' launches are not the grow's
        n_main = ds.LAUNCHES
        seen["ok"] += check(tabs, sc, ex, sj, rows, pm, fb, s)
        if case == "edges":
            t2, sc2, rows2 = moved_to_edges(ds, rng, tabs, sc, rows)
            check(t2, sc2, ex, sj, rows2, pm, fb, s)
            seen["edges"] += 1
        ds.LAUNCHES = n_main
        seen["chunks"] += 1
        seen["lanes"] += sc.shape[0]
        seen["Lpad"].add(tabs[0].Lpad)
        n0 = ds.LAUNCHES
        ok = real(*a)
        assert ds.LAUNCHES == n0 + 1
        return ok

    monkeypatch.setattr(ds, "stitch_chunk", spy)
    ds.GROW_STATS.clear()
    P = Parameters(["--genomeDir", idx, "--readFilesIn",
                    *[os.path.join(data, r) for r in reads],
                    "--outFileNamePrefix", str(tmp_path) + "/", *flags])
    align_reads(P, gi=gi, device=cuda)
    torch.cuda.synchronize()
    gs = ds.GROW_STATS
    it = sum(v for (w, k), v in gs.items() if k == "iterations")
    launched = sum(v for (w, k), v in gs.items() if k == "chunk_launches")
    assert seen["chunks"] > 0 and seen["ok"] > 0
    assert launched == it == seen["chunks"]
    assert case != "2x150" or seen["Lpad"] == {303}
    assert case != "edges" or seen["edges"] == seen["chunks"]


def synthetic_chunk(ds, device, n=64):
    """a small valid set of the kernel's inputs: random genome and reads,
    zero lanes (first exons) and one seed row"""
    rng = np.random.default_rng(3)
    Lpad, lmax, n_g = 52, 50, 5000
    cfg = ds.StitchConfig(
        Lpad=Lpad, s_max=50, chain_cap=64, has_pe=False, has_sjdb=False,
        ends_ext=((False, False), (False, False)), ins_flush_right=False,
        intron_min=21, intron_max=0, mates_gap_max=0, protrude_max=0,
        score_gap=0, score_gap_noncan=-8, score_gap_gcag=-4,
        score_gap_atac=-8, score_del_open=-2, score_del_base=-2,
        score_ins_open=-2, score_ins_base=-2, sjdb_score=2,
        stitch_sj_shift=1, sjmm=(0, 1, 0, 0))
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    Gf = put(ds._prep_table(rng.integers(0, 4, n_g).astype(np.int8)))
    RSf = put(ds._prep_table(rng.integers(0, 4, 8 * lmax).astype(np.int8)))
    ntab = 4 * (Lpad + 16)
    ft, ct = ds.mm_cap_tables(0.3, ntab)
    F = put(ds._prep_table(ft.astype("<u2")))
    sjdb = (put(np.zeros(1, np.int32)),) * 7
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)
    rows = i32(1, 8)
    rows[0, :3] = torch.tensor([0, 100, 30])
    sc = i32(n, ds.NSCAL)
    sc[:, ds.C_WAN] = 1
    tabs = (cfg, Gf, n_g, RSf, lmax, F, put(ct), ntab, sjdb)
    return tabs, [sc, i32(n, ds.NEXB), i32(n, ds.NSJB), rows, i32(1, 8),
                  i32(4)]


@pytest.mark.cuda
def test_stitch_chunk_kernel_refuses_bad_inputs(cuda):
    from star_tpu_torch.ops import device_stitch as ds
    tabs, ins = synthetic_chunk(ds, cuda)
    out = lambda sc: tuple(torch.empty_like(t) for t in (sc, ins[1], ins[2]))
    n0 = ds.LAUNCHES
    ok = ds.stitch_chunk(*tabs, *ins, 0, out(ins[0]))
    torch.cuda.synchronize()
    assert ds.LAUNCHES == n0 + 1 and bool(ok.all())
    sc, ex, sj, rows, pm, fb = ins

    def refused(tabs_=tabs, ins_=ins, out_=None):
        with pytest.raises(ValueError):
            ds.stitch_chunk(*tabs_, *ins_, 0, out_ or out(ins_[0]))
    refused(ins_=[sc.cpu(), *ins[1:]], out_=out(sc))     # another device
    refused(ins_=[sc, ex, sj, rows, pm, fb.cpu()])       # another device
    refused(ins_=[sc.long(), *ins[1:]], out_=out(sc))    # int64 rows
    refused(tabs_=(tabs[0], tabs[1].view(torch.uint8), *tabs[2:]))
    refused(ins_=[sc, ex[:, :50].contiguous(), *ins[2:]])   # 50 columns
    refused(ins_=[sc, ex, sj[:-1], *ins[3:]])            # fewer lanes
    refused(ins_=[sc, ex.t().contiguous().t(), *ins[2:]])   # not contiguous
    refused(out_=(out(sc)[0][:-1], *out(sc)[1:]))        # output too short
    refused(ins_=[sc, ex, sj, rows[:, :4].contiguous(), pm, fb])
    refused(tabs_=(*tabs[:8], tabs[8][:6]))              # six sjdb tables
    assert ds.LAUNCHES == n0 + 1
    none = [t[:0] for t in (sc, ex, sj)]
    assert ds.stitch_chunk(*tabs, *none, rows, pm, fb, 0,
                           tuple(torch.empty_like(t) for t in none)
                           ).shape == (0,)
    assert ds.LAUNCHES == n0 + 1


@pytest.mark.cuda
def test_device_finalize_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """the se golden's level-0 grow, finalize and select on the card equal
    the same engine on CPU tensors (every retired lane without the select,
    the downloaded lanes with it), with the finalize's and the pack's
    fetch_window launches counted"""
    import copy
    import pickle
    from star_tpu_torch.genome.index import GenomeIndex
    from star_tpu_torch.ops import batch_engine as be
    from star_tpu_torch.ops import device_stitch as ds
    from star_tpu_torch.params import Parameters
    from star_tpu_torch.run import align_reads
    idx = os.path.join(GOLD, "genome_idx")
    monkeypatch.setenv("STAR_TPU_DEVICE_STITCH", "0")
    monkeypatch.setenv("STAR_TPU_DUMP_STITCH", str(tmp_path / "dump"))
    gi = GenomeIndex.load(idx)
    align_reads(Parameters(
        ["--genomeDir", idx, "--readFilesIn",
         os.path.join(ROOT, "tests", "data", "small", "reads_se.fastq"),
         "--outFileNamePrefix", str(tmp_path) + "/"]), gi=gi, device="cpu")
    with open(tmp_path / "dump" / "batch_0000.pkl", "rb") as f:
        d = pickle.load(f)
    # a multimap limit of 1 makes the select classify some reads over
    P = Parameters(["--genomeDir", idx, "--readFilesIn", "none.fastq",
                    "--outFilterMultimapNmax", "1"])
    B = len(d["lread"])
    recs = be.expand_hits(gi, P, d["seeds"], d["lread"], B)
    ws, st, _, RS, Lpad = be.level_state(gi, P, recs, B, d["fwd"], d["rc"],
                                         be.W_MAX, be.S_MAX)
    for classify in (False, True):
        res = {}
        for dev in (cuda, torch.device("cpu")):
            ds.GROW_STATS.clear()
            res[dev.type] = ds.grow_chains_device(
                gi, P, copy.deepcopy(st), ws, RS, d["nmm_max"], Lpad,
                be.S_MAX, be.CHAIN_CAP, dev, lread=d["lread"],
                read_len2=d["read_len2"], classify=classify)
            if dev.type == "cuda":
                gs = dict(ds.GROW_STATS)
        (got, acc, over), (want, acc_c, over_c) = res["cuda"], res["cpu"]
        for k in be._lane_fields():
            assert np.array_equal(getattr(got, k), getattr(want, k)), k
        assert np.array_equal(acc, acc_c) and acc.any()
        assert gs[be.W_MAX, "finalize_launches"] > 0
        if classify:
            assert np.array_equal(over, over_c) and over.any()
            assert gs[be.W_MAX, "pack_launches"] == 3
            assert gs[be.W_MAX, "downloaded"] < gs[be.W_MAX, "accepted"]
        else:
            assert over is None and (~acc).any()


ANNOT_CASES = [c for c in ANNOT_GOLDENS
               if c[0] in ("se_2pass", "se_quant", "se_bam")]


@pytest.mark.cuda
@pytest.mark.parametrize("gold,idx,extra,files", ANNOT_CASES,
                         ids=[c[0] for c in ANNOT_CASES])
def test_annotation_outputs_on_card_match_goldens(cuda, tmp_path, monkeypatch,
                                                  gold, idx, extra, files):
    """two-pass mapping, GeneCounts and BAM output on the card with the
    device stitch engine forced on every level: byte-identical to the
    goldens (BAMs as record streams), each pass launching fetch_window"""
    from star_tpu_torch import run
    from star_tpu_torch.ops import batch_engine as be
    from star_tpu_torch.ops import device_stitch as ds
    from star_tpu_torch.params import Parameters
    from star_tpu_torch.run import _run_mapping, align_reads
    monkeypatch.delenv("STAR_TPU_DEVICE_STITCH", raising=False)
    monkeypatch.setattr(be, "DEVICE_GROW_MIN_RECORDS",
                        {s_max: 0 for _, s_max, _ in be.LEVELS})
    launches = []

    def counted(*a, **k):
        n0, c0 = fetch.LAUNCHES, ds.LAUNCHES
        out = _run_mapping(*a, **k)
        launches.append(min(fetch.LAUNCHES - n0, ds.LAUNCHES - c0))
        return out
    monkeypatch.setattr(run, "_run_mapping", counted)
    prefix = str(tmp_path) + "/"
    P = Parameters(["--genomeDir", os.path.join(GOLD, idx), "--readFilesIn",
                    os.path.join(ROOT, "tests", "data", "small",
                                 "reads_se.fastq"),
                    "--outFileNamePrefix", prefix, *extra])
    align_reads(P, device=cuda)
    assert len(launches) == (2 if "--twopassMode" in extra else 1)
    assert min(launches) > 0
    for f in files:
        assert same_output(prefix, os.path.join(GOLD, gold) + "/", f), f


FUSION_CASES = [c for c in FUSION_GOLDENS if c[0] in ("se_chim", "peov")]


@pytest.mark.cuda
@pytest.mark.parametrize("gold,reads,flags,files", FUSION_CASES,
                         ids=[c[0] for c in FUSION_CASES])
def test_host_finished_features_on_card_match_goldens(cuda, tmp_path,
                                                      monkeypatch, gold, reads,
                                                      flags, files):
    """chimeric detection after the seed loop on the card, and the PE
    mate-overlap merge after the device stitch engine (forced on every
    level): byte-identical to the goldens, with fetch_window launched"""
    from star_tpu_torch.ops import batch_engine as be
    from star_tpu_torch.params import Parameters
    from star_tpu_torch.run import align_reads
    monkeypatch.delenv("STAR_TPU_DEVICE_STITCH", raising=False)
    monkeypatch.setattr(be, "DEVICE_GROW_MIN_RECORDS",
                        {s_max: 0 for _, s_max, _ in be.LEVELS})
    be.LEVEL_STATS.clear()
    prefix = str(tmp_path) + "/"
    P = Parameters(["--genomeDir", os.path.join(GOLD, "genome_idx"),
                    "--readFilesIn",
                    *[os.path.join(ROOT, "tests", "data", "small", r)
                      for r in reads],
                    "--outFileNamePrefix", prefix, *flags])
    n0 = fetch.LAUNCHES
    align_reads(P, device=cuda)
    assert fetch.LAUNCHES > n0
    on_card = sum(v for (w, k), v in be.LEVEL_STATS.items() if k == "device")
    assert on_card > 0 if gold == "peov" else on_card == 0
    for f in files:
        assert same_output(prefix, os.path.join(GOLD, gold) + "/", f), f


SOLO_CASES = [c for c in SOLO_GOLDENS if c[0] in ("solo", "solo_tags")]


@pytest.mark.cuda
@pytest.mark.parametrize("case,gold,index,flags,files", SOLO_CASES,
                         ids=[c[0] for c in SOLO_CASES])
def test_solo_on_card_matches_goldens(cuda, tmp_path, monkeypatch, case, gold,
                                      index, flags, files):
    """STARsolo CB_UMI_Simple after the device stitch engine (forced on
    every level): Solo.out and the CB/UB-tagged sorted BAM identical to the
    goldens, with fetch_window launched in the grow"""
    from star_tpu_torch.ops import batch_engine as be
    from star_tpu_torch.ops import device_stitch as ds
    from star_tpu_torch.params import Parameters
    from star_tpu_torch.run import align_reads
    monkeypatch.delenv("STAR_TPU_DEVICE_STITCH", raising=False)
    monkeypatch.setattr(be, "DEVICE_GROW_MIN_RECORDS",
                        {s_max: 0 for _, s_max, _ in be.LEVELS})
    be.LEVEL_STATS.clear()
    ds.GROW_STATS.clear()
    prefix = str(tmp_path) + "/"
    P = Parameters(["--genomeDir", index, "--outFileNamePrefix", prefix,
                    *flags])
    n0 = fetch.LAUNCHES
    align_reads(P, device=cuda)
    assert fetch.LAUNCHES > n0
    assert sum(v for (w, k), v in ds.GROW_STATS.items()
               if k == "fetch_launches") > 0
    assert sum(v for (w, k), v in ds.GROW_STATS.items()
               if k == "chunk_launches") > 0
    assert sum(v for (w, k), v in be.LEVEL_STATS.items() if k == "device") > 0
    assert solo_diff(prefix, os.path.join(TESTS, "golden", gold), files) == []


def mc_inputs(n_genes, max_count, n_cand, seed):
    """EmptyDrops_CR null inputs as lists: (cp, logp, logtab, counts, obs).
    Candidates at counts 0..max_count, a third of them sharing one count; a
    third of the observed values are rows of the first simulations (ties
    with a row), a third repeat the last value, a third are random"""
    import math
    from bisect import bisect_left
    from star_tpu_torch.utils.rng import MT19937
    rng = np.random.default_rng(seed)
    p = [x for x in rng.dirichlet(np.full(n_genes, 0.3)).tolist() if x > 0]
    psum = sum(p)
    cp, acc = [], 0.0
    for x in p:
        acc += x / psum
        cp.append(acc)
    logp = [math.log(x / psum) for x in p]
    logtab = [0.0] + [math.log(k) for k in range(1, max_count + 1)]
    rows = []
    for isim in range(4):
        mt = MT19937((19760110 * (isim + 1)) & 0xFFFFFFFF)
        cur, row = {}, [0.0]
        for ic in range(1, max_count + 1):
            ig = min(bisect_left(cp, mt.uniform01()), len(cp) - 1)
            cur[ig] = cur.get(ig, 0) + 1
            row.append(row[-1] + logp[ig] + logtab[ic] - logtab[cur[ig]])
        rows.append(row)
    counts = rng.integers(0, max_count + 1, size=n_cand).tolist()
    counts[:n_cand // 3] = [max(1, max_count // 2)] * (n_cand // 3)
    obs = []
    for i, c in enumerate(counts):
        if i % 3 == 0:
            obs.append(rows[i % 4][c])
        elif i % 3 == 1:
            obs.append(obs[-1])
        else:
            obs.append(float(rows[0][c] + rng.normal(0, 3)))
    return cp, logp, logtab, counts, obs


def mc_tensors(device, cp, logp, logtab, counts, obs):
    from star_tpu_torch.solo import mc_null
    gc, go, obs_sorted, _ = mc_null.group_candidates(counts, obs)
    f64 = dict(dtype=torch.float64, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.tensor(cp, **f64), torch.tensor(logp, **f64),
            torch.tensor(logtab, **f64), torch.tensor(gc, **i32),
            torch.tensor(go, **i32), torch.tensor(obs_sorted, **f64))


# (genes, max_count, simulations): a 10x cell's shape in shared memory and
# beyond it (20,000 genes, 320 KB of cp and logp), one draw, and 420 draws
# (840 words: a second generation of the generator)
MC_CASES = [(1000, 15, 10000), (20000, 15, 10000), (5, 1, 10000),
            (1000, 420, 2000)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_genes,max_count,sim_n", MC_CASES,
                         ids=[f"g{c[0]}_max{c[1]}" for c in MC_CASES])
def test_mc_null_kernel_matches_plain(cuda, n_genes, max_count, sim_n):
    from star_tpu_torch.solo import mc_null
    inp = mc_inputs(n_genes, max_count, 300, n_genes + max_count)
    args = mc_tensors(cuda, *inp)
    assert (16 * args[0].numel() <= mc_null.SHARED_BYTES) == (n_genes < 20000)
    n0 = mc_null.LAUNCHES
    got = mc_null.null_histogram(*args, sim_n)
    torch.cuda.synchronize()
    assert mc_null.LAUNCHES == n0 + 1
    want = mc_null.null_histogram(*mc_tensors("cpu", *inp), sim_n)
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)
    n_groups = args[3].numel()
    assert int(want.sum()) == sim_n * n_groups
    mc_null.n_lower(*args, sim_n)
    assert mc_null.LAUNCHES == n0 + 2


@pytest.mark.cuda
def test_mc_null_kernel_refuses_bad_inputs(cuda):
    from star_tpu_torch.solo import mc_null
    args = mc_tensors(cuda, *mc_inputs(50, 8, 20, 1))
    bad = list(args)
    bad[0] = args[0].float()
    with pytest.raises(ValueError, match="cp must be"):
        mc_null.null_histogram(*bad, 100)
    bad = list(args)
    bad[4] = args[4].long()
    with pytest.raises(ValueError, match="group_off must be"):
        mc_null.null_histogram(*bad, 100)
    bad = list(args)
    bad[5] = args[5].cpu()
    with pytest.raises(ValueError, match="obs on cpu"):
        mc_null.null_histogram(*bad, 100)
    bad = list(args)
    bad[0] = args[0].cpu()
    with pytest.raises(ValueError, match="on cuda"):
        mc_null.null_histogram(*bad, 100)


@pytest.mark.cuda
def test_solo_ed_golden_on_card_through_the_kernel(cuda, tmp_path,
                                                   monkeypatch):
    """the EmptyDrops_CR golden on the card with the device stitch engine
    forced: Solo.out identical, its Monte-Carlo null one kernel launch (one
    feature, Gene)"""
    from chip_smoke import SOLO_ED_INDEX, solo_ed_index
    from star_tpu_torch.ops import batch_engine as be
    from star_tpu_torch.params import Parameters
    from star_tpu_torch.run import align_reads
    from star_tpu_torch.solo import mc_null
    case, gold, index, flags, files = next(c for c in SOLO_GOLDENS
                                           if c[0] == "solo_ed")
    assert index == SOLO_ED_INDEX
    idx = str(tmp_path / "idx")
    solo_ed_index(idx)
    monkeypatch.delenv("STAR_TPU_DEVICE_STITCH", raising=False)
    monkeypatch.setattr(be, "DEVICE_GROW_MIN_RECORDS",
                        {s_max: 0 for _, s_max, _ in be.LEVELS})
    prefix = str(tmp_path / "out") + "/"
    n0, f0 = mc_null.LAUNCHES, fetch.LAUNCHES
    align_reads(Parameters(["--genomeDir", idx, "--outFileNamePrefix",
                            prefix, *flags]), device=cuda)
    assert mc_null.LAUNCHES == n0 + 1 and fetch.LAUNCHES > f0
    assert solo_diff(prefix, os.path.join(TESTS, "golden", gold), files) == []


@pytest.mark.cuda
@pytest.mark.parametrize("big", [False, True], ids=["t2", "big"])
def test_sharded_mmp_on_card_matches_host(cuda, big):
    """the suffix array split over four shards on the card, in the doubled
    text layout and in the int64 forward-G-only one"""
    from star_tpu_torch.align.seed import mmp_search
    from star_tpu_torch.genome.index import GenomeIndex
    from star_tpu_torch.parallel import mesh as pm
    gi = GenomeIndex.load(os.path.join(GOLD, "genome_idx"))
    rng = np.random.default_rng(1)
    n, ql = 512, 128
    qs = np.full((n, ql), -1, np.int8)
    qlen = rng.integers(1, 100, size=n)
    for b in range(n):
        if b % 2:
            qs[b, :qlen[b]] = rng.integers(0, 4, size=qlen[b])
        else:
            p0 = int(rng.integers(0, 2 * gi.n_genome - 200))
            q = gi.t2[p0:p0 + qlen[b]]
            qs[b, :qlen[b]] = np.where(q > 3, 0, q)
    si = pm.ShardedIndex.build(gi, pm.make_mesh([cuda] * 4, dp=1, ix=4),
                               ql=ql, big=big)
    n0 = fetch.LAUNCHES
    got = [t.cpu() for t in pm.make_sharded_mmp(si)(
        torch.from_numpy(qs).to(cuda), torch.from_numpy(qlen).to(cuda))]
    assert fetch.LAUNCHES > n0 and all(t.dtype == torch.int64 for t in got)
    host = np.array([mmp_search(gi, qs[b, :qlen[b]]) for b in range(n)])
    assert np.array_equal(np.stack([t.numpy() for t in got], 1), host)


@pytest.mark.cuda
def test_sharded_golden_on_card(cuda, tmp_path):
    """--tpuShardedIndex 1 --quantMode GeneCounts at four shards (2 x 2) on
    the card: se_gtf's SAM and SJ.out.tab, se_quant's ReadsPerGene.out.tab"""
    from chip_smoke import SHARDED_GOLDEN_FLAGS
    from star_tpu_torch.parallel.mesh import make_mesh
    from star_tpu_torch.params import Parameters
    from star_tpu_torch.run import align_reads
    prefix = str(tmp_path) + "/"
    P = Parameters(["--genomeDir", os.path.join(GOLD, "genome_idx_gtf"),
                    "--readFilesIn", os.path.join(ROOT, "tests", "data",
                                                  "small", "reads_se.fastq"),
                    "--outFileNamePrefix", prefix, *SHARDED_GOLDEN_FLAGS])
    n0 = fetch.LAUNCHES
    align_reads(P, device=cuda, mesh=make_mesh([cuda] * 4))
    assert fetch.LAUNCHES > n0
    for f, gold in (("Aligned.out.sam", "se_gtf"), ("SJ.out.tab", "se_gtf"),
                    ("ReadsPerGene.out.tab", "se_quant")):
        assert same_output(prefix, os.path.join(GOLD, gold) + "/", f), f


@pytest.mark.cuda
def test_single_rank_nccl_merges(cuda):
    """psum_merge and merge_keyed_counts over a one-rank NCCL group on CUDA
    tensors, keys and counts past 2^32"""
    import torch.distributed as dist
    from chip_smoke import nccl_merges
    nccl_merges(torch, np)
    assert not dist.is_initialized()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["se", "pe"])
def test_transcriptome_bam_on_card_matches_host(cuda, tmp_path, monkeypatch,
                                                case):
    """--quantMode TranscriptomeSAM with RSEM's default bans on the card's
    device path (the device stitch engine forced on every level, the fast
    finish): Aligned.toTranscriptome.out.bam record for record the host
    oracle's, on reads whose changed ends soft-clip their alignments"""
    import importlib.util
    from star_tpu_torch.ops import batch_engine as be
    # by path: the card's machine may hold another package named tests
    spec = importlib.util.spec_from_file_location(
        "torch_trsam_device", os.path.join(ROOT, "tests",
                                           "test_torch_trsam_device.py"))
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    monkeypatch.delenv("STAR_TPU_DEVICE_STITCH", raising=False)
    monkeypatch.setattr(be, "DEVICE_GROW_MIN_RECORDS",
                        {s_max: 0 for _, s_max, _ in be.LEVELS})
    from star_tpu_torch.ops import device_stitch as ds
    reads = helpers.changed_reads(case, str(tmp_path))
    n0, c0 = fetch.LAUNCHES, ds.LAUNCHES
    dev = helpers.map_trsam(reads, str(tmp_path / "dev") + "/", cuda)
    assert fetch.LAUNCHES > n0 and ds.LAUNCHES > c0
    host = helpers.map_trsam(reads, str(tmp_path / "host") + "/", "cpu",
                             False)
    refs, recs = bam_records(dev)
    assert (refs, recs) == bam_records(host) and len(recs) > 50
