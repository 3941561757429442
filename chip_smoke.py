#!/usr/bin/env python3
"""Chip smoke test of star_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the repository root and needs one CUDA card, nvcc and g++.  Phases,
in order; any failure ends the run with a non-zero exit and no result line:

  1. build   compile every CUDA kernel of ops/csrc/ (one nvcc per source,
             started together) into star_tpu_torch/_build/;
  2. kernel  each kernel against its plain PyTorch version on the card, at
             the main path's shapes (exact equality), and timed beside its
             plain version, one library call and its bandwidth bound;
  3. golden  alignReads on cuda for the bundled se / pe goldens: SAM (header
             stripped) and SJ.out.tab byte-identical;
  4. full    a chr20-scale genome (40 + 20 Mb, SAi depth 12) and one
             16,384-read batch of 100 bp SE reads aligned on cuda: reads/s,
             phase split, kernel launches, peak device memory; 1,024 probes
             held against the host MMP oracle and the first 256 reads'
             SAM against the per-read host path (--tpuUseDevice 0).

Then one JSON line of kernel measurements, the card's name and power limit
(nvidia-smi), and as the last line {"ok": true, "device": {...}}.
Generated data, the index and outputs stay under star_tpu_torch/_build/.
"""
import itertools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "star_tpu_torch", "_build", "chip_smoke")
GOLD = os.path.join(ROOT, "tests", "golden", "small")
DATA = os.path.join(ROOT, "tests", "data", "small")

CHR_LENS = ("40000000", "20000000")   # bench.py's chr20-scale genome
SAI_NBASES = 12                       # bench.py's reference SAi depth
N_READS = 16384                       # one full tpuBatchSize batch
N_PROBES = 1024
N_HOST_READS = 256
FETCH_ROWS = 262144                   # rows of one MMP neighbour fetch
FETCH_TABLE = 128 << 20
DEVICE = "cuda"

HBM_BW = 3.35e12                      # H100 SXM (NVIDIA data sheet), B/s
SXM_NAME = "H100 80GB HBM3"


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=20, warm=3):
    """mean device time of fn() in ms, from CUDA events around `iters` calls"""
    import torch
    for _ in range(warm):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def strip_header(path):
    with open(path) as f:
        return [l for l in f if not l.startswith("@")]


def phase_kernel(torch, np, fetch):
    """fetch_rows kernel vs its plain version at the MMP's widest shape"""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    raw = rng.integers(-128, 128, size=FETCH_TABLE, dtype=np.int8)
    tab = torch.from_numpy(fetch.pad_table(raw)).to(dev)
    off = rng.integers(-FETCH_TABLE // 8, FETCH_TABLE, size=FETCH_ROWS)
    off[:8] = [-1, 0, 1, 1023, 1024, FETCH_TABLE - 1, FETCH_TABLE - 1024,
               FETCH_TABLE - 2048]
    off = torch.from_numpy(off).to(dev)
    got = fetch.fetch_rows(tab, off)
    torch.cuda.synchronize()
    want = fetch._fetch_rows_torch(tab, off)
    live = off >= 0
    err = int((got[live].int() - want[live].int()).abs().max())
    del got, want
    if err != 0:
        raise AssertionError(f"fetch_rows kernel differs from plain: {err}")
    n_live = int(live.sum())
    ms = cuda_ms(lambda: fetch.fetch_rows(tab, off))
    plain_ms = cuda_ms(lambda: fetch._fetch_rows_torch(tab, off))
    library_ms = cuda_ms(lambda: tab.unfold(0, 2048, 1024)[off // 1024])
    # bytes the function must move: each distinct 1 KiB table tile that a
    # live row covers (a row spans its tile and the next) read once, each
    # live row written once, every offset read once
    tile = off[live] // fetch.TILE
    n_tiles = int(torch.unique(torch.cat([tile, tile + 1])).numel())
    read_b = min(n_tiles * fetch.TILE, n_live * fetch.FET)
    bytes_moved = read_b + n_live * fetch.FET + FETCH_ROWS * 8
    bound_ms = bytes_moved / HBM_BW * 1e3
    log(f"kernel fetch_rows: {FETCH_ROWS} rows ({n_live} live, {n_tiles} "
        f"distinct tiles) of a {FETCH_TABLE >> 20} MiB table: max_abs_err 0, "
        f"{ms:.4f} ms (plain {plain_ms:.4f}, library {library_ms:.4f}, bound "
        f"{bound_ms:.4f} ms = {bytes_moved} B at {HBM_BW:.3g} B/s)")
    return {"name": "fetch_rows", "route": "cuda",
            "source": "star_tpu_torch/ops/csrc/fetch_rows.cu",
            "replaces": "star_tpu/ops/fetch.py:83",
            "launches": None, "max_abs_err": err, "max_abs_diff": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": library_ms}


def phase_golden(fetch):
    from star_tpu_torch.genome.index import GenomeIndex
    from star_tpu_torch.params import Parameters
    from star_tpu_torch.run import align_reads
    gi = GenomeIndex.load(os.path.join(GOLD, "genome_idx"))
    for case, reads in (("se", ["reads_se.fastq"]),
                        ("pe", ["reads_pe_1.fastq", "reads_pe_2.fastq"])):
        n0 = fetch.LAUNCHES
        out = os.path.join(WORK, f"golden_{case}") + "/"
        P = Parameters(["--genomeDir", os.path.join(GOLD, "genome_idx"),
                        "--readFilesIn", *[os.path.join(DATA, r) for r in reads],
                        "--outFileNamePrefix", out, "--outSAMunmapped", "Within"])
        t0 = time.time()
        align_reads(P, gi=gi, device=DEVICE)
        if strip_header(out + "Aligned.out.sam") != \
                strip_header(os.path.join(GOLD, case, "Aligned.out.sam")):
            raise AssertionError(f"golden {case}: SAM differs")
        with open(out + "SJ.out.tab") as a, \
                open(os.path.join(GOLD, case, "SJ.out.tab")) as b:
            if a.read() != b.read():
                raise AssertionError(f"golden {case}: SJ.out.tab differs")
        if fetch.LAUNCHES == n0:
            raise AssertionError(f"golden {case}: fetch_rows never launched")
        log(f"golden {case}: SAM and SJ.out.tab identical, "
            f"{fetch.LAUNCHES - n0} fetch_rows launches, "
            f"{time.time() - t0:.2f} s")


def start_data(data):
    """start the chr20-scale data generator unless its output exists"""
    if os.path.exists(os.path.join(data, "reads_se.fastq")):
        return None
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "make_test_data.py"),
         "--out", data, "--chr-lens", *CHR_LENS, "--seed", "11",
         "--n-reads", str(N_READS)], cwd=ROOT, stdout=subprocess.DEVNULL)


def phase_full(torch, np, fetch, data_proc, data):
    from star_tpu_torch.align.seed import mmp_search
    from star_tpu_torch.constants import encode_seq
    from star_tpu_torch.genome.index import GenomeIndex
    from star_tpu_torch.io.fastq import read_pairs
    from star_tpu_torch.ops import pipeline
    from star_tpu_torch.ops.sa_search import make_mmp_fn
    from star_tpu_torch.params import Parameters
    from star_tpu_torch.run import align_reads

    t0 = time.time()
    if data_proc is not None and data_proc.wait() != 0:
        raise RuntimeError("make_test_data.py failed")
    log(f"full: data ready ({time.time() - t0:.1f} s waited)")
    idx = os.path.join(WORK, "idx")
    t0 = time.time()
    if os.path.exists(os.path.join(idx, "star_tpu.idx.npz")):
        gi = GenomeIndex.load(idx)
    else:
        gi = GenomeIndex.generate([os.path.join(data, "genome.fa")],
                                  sa_index_nbases=SAI_NBASES)
        gi.save(idx)
    log(f"full: index n_genome={gi.n_genome} n_sa={gi.n_sa} "
        f"sai_entries={len(gi.sai_val)} ({time.time() - t0:.1f} s)")

    reads = os.path.join(data, "reads_se.fastq")
    out = os.path.join(WORK, "full") + "/"
    P = Parameters(["--genomeDir", idx, "--readFilesIn", reads,
                    "--outFileNamePrefix", out, "--outSAMunmapped", "Within",
                    "--readMapNumber", str(N_READS),
                    "--tpuBatchSize", str(N_READS)])
    pipeline.TIMING = True
    pipeline.TIMERS.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fetch.LAUNCHES = 0                           # counts of the main path
    t0 = time.time()
    stats = align_reads(P, gi=gi, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fetch.LAUNCHES
    pipeline.TIMING = False
    peak = torch.cuda.max_memory_allocated()
    if launches == 0:
        raise AssertionError("full: fetch_rows never launched")
    if stats.read_n != N_READS:
        raise AssertionError(f"full: {stats.read_n} reads aligned, "
                             f"expected {N_READS}")
    log(f"full: {N_READS} reads in {wall:.2f} s = {N_READS / wall:.1f} "
        f"reads/s (index upload included); fetch_rows launches {launches}; "
        f"peak device memory {peak} B")
    log(f"full: phases {pipeline.timing_report()}")

    # ---- 1,024 probes of the batch's reads vs the host oracle
    di = gi._device_cache[next(iter(gi._device_cache))]
    mmp = make_mmp_fn(di)
    rng = np.random.default_rng(5)
    recs = [(name, seqs[0]) for name, seqs, _, _ in
            itertools.islice(read_pairs([reads]), N_READS)]
    qs = np.full((N_PROBES, di.ql), -1, np.int8)
    qlen = np.zeros(N_PROBES, np.int64)
    b = 0
    while b < N_PROBES:
        s = encode_seq(recs[int(rng.integers(0, len(recs)))][1])
        if rng.random() < 0.5:
            s = (3 - s[::-1]).astype(np.int8)
        st = int(rng.integers(0, len(s) - 6))
        q = s[st:st + int(rng.integers(6, len(s) - st + 1))]
        if ((q < 0) | (q > 3)).any():
            continue
        qs[b, :len(q)] = q
        qlen[b] = len(q)
        b += 1
    got = np.stack([t.cpu().numpy() for t in mmp(
        torch.from_numpy(qs).to(DEVICE), torch.from_numpy(qlen).to(DEVICE))],
        axis=1)
    host = np.array([mmp_search(gi, qs[i, :qlen[i]]) for i in range(N_PROBES)])
    if not np.array_equal(got, host):
        bad = int((got != host).any(axis=1).sum())
        raise AssertionError(f"full: {bad} of {N_PROBES} probes differ from "
                             "the host oracle")
    log(f"full: {N_PROBES} probes equal the host mmp_search")

    # ---- the first 256 reads vs the per-read host path
    out_h = os.path.join(WORK, "full_host") + "/"
    P2 = Parameters(["--genomeDir", idx, "--readFilesIn", reads,
                     "--outFileNamePrefix", out_h, "--outSAMunmapped", "Within",
                     "--readMapNumber", str(N_HOST_READS), "--tpuUseDevice", "0"])
    t0 = time.time()
    align_reads(P2, gi=gi)
    names = {n for n, _ in recs[:N_HOST_READS]}
    dev_lines = [l for l in strip_header(out + "Aligned.out.sam")
                 if l.split("\t", 1)[0] in names]
    host_lines = strip_header(out_h + "Aligned.out.sam")
    if dev_lines != host_lines or not host_lines:
        raise AssertionError("full: device SAM of the first reads differs "
                             "from the host path")
    log(f"full: first {N_HOST_READS} reads' SAM ({len(host_lines)} lines) "
        f"identical to --tpuUseDevice 0 ({time.time() - t0:.1f} s)")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from star_tpu_torch.ops import _build, fetch

    if SXM_NAME not in torch.cuda.get_device_name(0):
        raise RuntimeError(f"bounds assume an {SXM_NAME} (SXM) card, found "
                           f"{torch.cuda.get_device_name(0)}")
    os.makedirs(WORK, exist_ok=True)
    data = os.path.join(WORK, "data")
    t_start = time.time()
    data_proc = start_data(data)
    try:
        t0 = time.time()
        _build.build_all(["fetch_rows"])
        log(f"build: fetch_rows.cu in {time.time() - t0:.1f} s")
        for line in _build.BUILD_LOG.get("fetch_rows", "").splitlines():
            if "registers" in line or "spill" in line:
                log("build: " + line.strip())

        kern = phase_kernel(torch, np, fetch)
        phase_golden(fetch)
        kern["launches"] = phase_full(torch, np, fetch, data_proc, data)
    finally:
        if data_proc is not None and data_proc.poll() is None:
            data_proc.kill()
            data_proc.wait()

    log(f"total: {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": [kern]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
