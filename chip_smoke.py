#!/usr/bin/env python3
"""Chip smoke test of star_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the repository root and needs one CUDA card, nvcc and g++.  Phases,
in order; any failure ends the run with a non-zero exit and no result line:

  1. build   compile every CUDA source of ops/csrc/ (fetch_rows.cu, whose
             library holds the window kernel behind its three launchers,
             fetch_window, fetch_rows and tile_fetch, and emptydrops.cu,
             EmptyDrops_CR's Monte-Carlo null; one nvcc per source, started
             together) into star_tpu_torch/_build/;
  2. kernel  each kernel against its plain PyTorch version on the card
             (exact equality), timed beside its plain version, one library
             call and its bytes bound: fetch_window at every width of the
             main path over 262,144 starts of a 128 MiB table, both edges,
             starts past them and negative starts included; fetch_rows and
             tile_fetch at 262,144 rows;
  3. golden  alignReads on cuda for the bundled se / pe goldens with the
             device stitch engine forced on every level (grow, finalize and,
             on se, the too-many-loci select): SAM (header stripped) and
             SJ.out.tab byte-identical, grow and finalize fetch_window
             launches > 0 on every level, reads classified over printed;
  4. full    a chr20-scale genome (40 + 20 Mb, SAi depth 12) and one
             16,384-read batch of 100 bp SE reads aligned on cuda: reads/s,
             phase split, per level the reads / seed records / engine, the
             device engine's grow, finalize, select, download and ordering
             seconds, retired against downloaded lanes, grow iterations and
             launches, fetch_window launches per phase (seed loop, grow,
             finalize, pack), stitch_chunk launches (one per grow
             iteration), peak device memory (each level whose grow ran
             on the card must have finalized there); the grow sweep: each
             level's grow replayed from the batch's dumped inputs on its
             first n reads, numpy engine against the card (seconds, seed
             records, LaneStates equal), which places the device-grow gate
             batch_engine.DEVICE_GROW_MIN_RECORDS; the seed loop and the
             stitch replayed with every fetch_window call recorded (the
             wrapper's host time per call) and launched again per phase,
             each call held against the plain version: the kernel's own
             device time (each call between its own CUDA events,
             queued behind a sleep kernel), the old fetch_rows + cut
             composition, the library call table.unfold(0, W, 1)[start], the
             plain version and the bytes bound; the stitch replayed once
             more with each grow chunk launched again alone on copies of its
             inputs (chunk_replay), the stitch_chunk kernel's rows and ok
             held against the plain version's, its device time beside the
             plain version's and its bytes bound (chunk_bytes, from the
             kernel's branch of each lane); the W512 finalize replayed, numpy finalize_lanes against
             the card (accept and extended lanes equal, both timed); 1,024
             probes held against the host MMP oracle; the first 256 reads'
             SAM against the per-read host path (--tpuUseDevice 0); and the
             first 4,096 reads aligned again with the numpy engine
             (STAR_TPU_DEVICE_STITCH=0): their SAM lines byte-identical
             (phase 5 holds the whole batch against the numpy engine);
  5. annot   the annotation, two-pass and output layer on cuda: the goldens
             se_gtf, se_quant, se_trsam, se_bam and se_2pass with the device
             stitch engine forced on every level (SAM, SJ.out.tab,
             ReadsPerGene.out.tab identical, BAMs record for record; each
             case's fetch_window launches and the lanes whose stitch
             on the card crossed an annotated junction); then the full batch
             on the chr20-scale index with a synthetic annotation (the
             generator's planted genes and 1,000 eleven-exon genes at random
             loci outside the reads' region, ~10,000 junctions) given at
             mapping time, --twopassMode Basic, --quantMode TranscriptomeSAM
             GeneCounts, both BAMs and --sjdbInsertSave All: seconds of each
             insertion (and whether the native rank merge or the full
             re-sort ran), of each _pristine, of each pass (reads/s,
             fetch_window launches, junctions in its index, peak device
             memory) and of the host stages (pipeline.TIMERS sjdb_insert,
             pristine, bam_encode, quant, bam_finish); SJ.out.tab, both BAMs,
             ReadsPerGene.out.tab and the transcriptome BAM identical to a run
             of the same reads and flags with the numpy engine on the index
             pass 2 mapped against (a process of its own, started here and
             held after phase 8, so that it runs beside phases 6-8);
  6. fusion  the host-finished features on cuda: the goldens se_chim,
             chim_mult, chim_samold, chim_wbam_old, chim_wbam_mult, var and
             wasp (the seed loop on the card, the stitch on the host), peov
             with the device stitch engine forced, long on its logged host
             route, and the transformed indexes idx_transform_hap / _dip
             built by the port's genomeGenerate, then tf_hap / tf_dip with
             the device stitch engine forced (each identical, BAMs record for
             record; fetch_window launches per golden); then fusion detection
             at the chr20 scale: 4,096 seeded 2 x 100 pairs (fusion_pairs:
             5 % across 16 planted chr1-chr2 fusions, 30 % with overlapping
             mates) mapped on cuda with STAR-Fusion's STAR flags (FUSION_FLAGS,
             without its --twopassMode Basic: phase 5 runs two passes):
             pairs/s, stages, the PE-merge remap and chimeric detection
             seconds, fetch_window launches, peak device memory, chimeric
             and PE-merged reads; every planted fusion must be reported at
             its breakpoint in Chimeric.out.junction, and the first 512
             pairs mapped on the card and with the host oracle
             (--tpuUseDevice 0) must give the same SAM, SJ.out.tab and
             Chimeric.out.junction; then the generator's 8,192 2 x 100 pairs
             on phase 5's saved pass-2 index with the default flags and the
             device stitch engine forced (pe_chunks): one stitch_chunk
             launch per grow iteration, and the batch's chunks replayed as
             phase 4's are, with some lanes on the mate join, the annotated
             junction join and the annotation lookup;
  7. solo    STARsolo on cuda: every golden of SOLO_GOLDENS (CB_UMI_Simple
             with every UMI dedup type, multimappers, MultiGeneUMI filters,
             EmptyDrops_CR, multi-feature runs, CB/UB-tagged BAMs and
             Transcript3p; CB_UMI_Complex; SmartSeq; CB_samTagOut) with the
             device stitch engine forced on every level, trees byte for
             byte and BAMs record for record, fetch_window launches per
             golden, and --runMode soloCellFiltering through main; then a
             10x Chromium v3 run on phase 5's saved pass-2 index (its 1,000
             eleven-exon synthetic genes): 32,768 seeded 91-base cDNA reads
             and their 28-base barcodes (solo_reads: 1,000 cells, 5,000
             ambient barcodes, a 20,000-barcode whitelist, 10 % of the
             cDNA reads led by a template-switch oligo and 5 % ending in
             polyA), two batches, with
             Cell Ranger 4's STARsolo flags (SOLO_CR4_FLAGS: Gene and
             GeneFull, 1MM_CR, MultiGeneUMI_CR, EmptyDrops_CR, the CellRanger4
             clip, a CB/UB-tagged sorted BAM): reads/s, the stages (TIMERS
             prepare, seed_loop, per level stitch, finish, solo_count,
             solo_process, bam_finish), the device engine's levels,
             fetch_window launches, peak device memory, cells called, median
             UMIs per cell and reads with valid barcodes (Summary.csv); a
             level must run on the card, the grow launch fetch_window, Gene
             and GeneFull count, EmptyDrops_CR's Monte-Carlo null launch
             its kernel once a feature, stitch_chunk launch once per grow
             iteration; the first batch's grow chunks replayed as phase 4's
             are, with some lanes on the annotated junction join and the
             annotation lookup; each mc_null launch again on its
             own inputs, held against the plain version (on the CPU, as a
             host job runs it) and timed beside it, beside one simulation
             alone (the serial chain) and the plain version on the card;
             the first 4,096
             reads prepared with the CellRanger4 clip of a whole batch (the
             device path's) and read by read (the host oracle's) must give
             the same clips and reads (both timed); the first 4,096 reads
             mapped on the card (stitch engine forced) and with the numpy
             engine must give the same Solo.out tree and sorted BAM, and the
             first 1,024 mapped on the card and with the host oracle
             (--tpuUseDevice 0) too;
  8. sharded the sharded suffix-array index (--tpuShardedIndex 1,
             parallel/mesh.py) on cuda: (a) se_gtf's SAM and SJ.out.tab and
             se_quant's ReadsPerGene.out.tab with GeneCounts merged over the
             dp rows, through the command line (one shard on one card) and
             at 4 shards (2 x 2) on the card, never building the
             single-device index; (b) phase 4's 16,384 reads on phase 4's
             index with the suffix array split over 4 shards (1 x 4) on the
             card: SAM and SJ.out.tab byte-identical to phase 4's, reads/s
             beside phase 4's, TIMERS, fetch_window launches (seed loop,
             grow, finalize, pack), the sharded index's bytes and peak
             device memory; the seed loop's fetch_window calls replayed
             from phase 4's dumped inputs, each held against the plain
             window and timed as phase 4's are; (c) the big layout (int64
             SA rows, the forward genome alone) forced on the same index
             and shards: 1,024 probes equal to the host mmp_search; (d) a
             one-rank NCCL group: psum_merge and merge_keyed_counts on CUDA
             tensors, keys and counts past 2^32, equal to numpy, the group
             destroyed after.

Then one JSON line of kernel measurements (launches: those of phase 4's
batch, phase 5's two-pass run, phase 6's pair sets, phase 7's single-cell
run and phase 8's sharded batch; stitch_chunk's replays of phases 4, 6
and 7), the card's name and power limit
(nvidia-smi), and as the last line
{"ok": true, "device": {...}}.
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
N_NUMPY_READS = 4096                  # phase 4's numpy-engine rerun
SWEEP = {8: (4096, 8192, 16384),   # reads replayed per level
         512: (128, 512)}
FETCH_ROWS = 262144                   # rows of one MMP neighbour fetch
FETCH_TABLE = 128 << 20
# the main path's fetch_window widths at 100 bp SE (SA entry, SAi pair,
# the sharded index's int64 SAi pair, lane rows, Lwin, QL, 2 * Lwin, RSPAN,
# GSPAN), the 2x150 PE genome span (two rows) and the widest window
WINDOW_WIDTHS = (4, 8, 16, 96, 104, 128, 208, 318, 400, 724, 1172, 3072)
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


# STAR-Fusion's documented STAR command (STAR-Fusion wiki, "STAR-Fusion:
# running STAR"), without --twopassMode Basic (phase 5 runs two passes)
FUSION_FLAGS = [
    "--outSAMstrandField", "intronMotif", "--outSAMunmapped", "Within",
    "--chimSegmentMin", "12", "--chimJunctionOverhangMin", "8",
    "--chimOutJunctionFormat", "1", "--alignSJDBoverhangMin", "10",
    "--alignMatesGapMax", "100000", "--alignIntronMax", "100000",
    "--alignSJstitchMismatchNmax", "5", "-1", "5", "5",
    "--outSAMattrRGline", "ID:GRPundef", "--chimMultimapScoreRange", "3",
    "--chimScoreJunctionNonGTAG", "-4", "--chimMultimapNmax", "20",
    "--chimNonchimScoreDropMin", "10", "--peOverlapNbasesMin", "12",
    "--peOverlapMMp", "0.1", "--alignInsertionFlush", "Right",
    "--alignSplicedMateMapLminOverLmate", "0", "--alignSplicedMateMapLmin",
    "30"]
FUSION_SHARE = 0.05       # pairs from a fusion transcript, across its junction
OVERLAP_SHARE = 0.30      # pairs whose mates overlap (insert 120-190 bp)
FUSION_EXON = 300         # bases of each partner in a fusion transcript


def read_fasta(path):
    """{name: sequence} of a FASTA file, upper case"""
    with open(path) as f:
        recs = f.read().split(">")[1:]
    return {r.split("\n", 1)[0].split()[0]:
            r.split("\n", 1)[1].replace("\n", "").upper() for r in recs}


def fusion_pairs(np, genome_fa, out1, out2, n_pairs, n_fusions, seed):
    """a seeded paired-end 2 x 100 set from the first two chromosomes of
    genome_fa, written to out1 / out2 as FASTQ: n_fusions fusions join a
    chr1 donor exon ending before a GT to a chr2 acceptor exon starting after
    an AG; FUSION_SHARE of the pairs come from these fusion transcripts, in
    turn, and span the junction: every other round of turns inside the first
    mate (20-80 bases in), the others anywhere 20 bases or more from the
    fragment's ends (inside a mate or between the mates); OVERLAP_SHARE
    have overlapping mates (insert 120-190 bp); the rest are ordinary pairs
    (insert 250-500 bp).  1 % of the bases are substituted.  Returns the
    planted fusions as (chr1 name, donor's last exon base, chr2 name,
    acceptor's first exon base), 1-based."""
    rng = np.random.default_rng(seed)
    chrs = read_fasta(genome_fa)
    (ca, sa), (cb, sb) = list(chrs.items())[:2]
    comp = str.maketrans("ACGTN", "TGCAN")
    rc = lambda s: s.translate(comp)[::-1]

    def locus(seq, motif, donor):
        while True:
            p = int(rng.integers(FUSION_EXON + 1000,
                                 len(seq) - FUSION_EXON - 1000))
            if (seq[p:p + 2] if donor else seq[p - 2:p]) == motif:
                return p
    fusions, transcripts = [], []
    for _ in range(n_fusions):
        a, b = locus(sa, "GT", True), locus(sb, "AG", False)
        fusions.append((ca, a, cb, b + 1))
        transcripts.append(sa[a - FUSION_EXON:a] + sb[b:b + FUSION_EXON])

    def mutate(s):
        s = np.frombuffer(s.encode(), np.uint8).copy()
        hit = rng.random(len(s)) < 0.01
        s[hit] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, hit.sum())]
        return s.tobytes().decode()
    n_fus = 0
    with open(out1, "w") as f1, open(out2, "w") as f2:
        for i in range(n_pairs):
            u = rng.random()
            if u < FUSION_SHARE:
                k, turn = n_fus % n_fusions, n_fus // n_fusions
                n_fus += 1
                ins = int(rng.integers(150, 2 * FUSION_EXON - 40))
                if turn % 2 == 0:
                    s = FUSION_EXON - int(rng.integers(20, 81))
                    ins = min(ins, 2 * FUSION_EXON - s)
                else:
                    s = int(rng.integers(max(0, FUSION_EXON - ins + 20),
                                         FUSION_EXON - 20 + 1))
                frag, name = transcripts[k][s:s + ins], f"r{i}_fusion{k}"
            else:
                ins = int(rng.integers(120, 191) if u < FUSION_SHARE
                          + OVERLAP_SHARE else rng.integers(250, 501))
                seq = sa if rng.random() < len(sa) / (len(sa) + len(sb)) \
                    else sb
                s = int(rng.integers(1000, len(seq) - ins - 1000))
                frag = seq[s:s + ins]
                name = f"r{i}_" + ("overlap" if ins <= 190 else "pair")
            m1, m2 = frag[:100], rc(frag[-100:])
            if rng.random() < 0.5:
                m1, m2 = m2, m1
            q = "I" * 100
            f1.write(f"@{name}\n{mutate(m1)}\n+\n{q}\n")
            f2.write(f"@{name}\n{mutate(m2)}\n+\n{q}\n")
    return fusions


def row_bytes(torch, starts, n_rows, idx_bytes, fet, tile):
    """bytes a row fetch must move: each distinct 1 KiB table tile that a
    row covers (a row spans its tile and the next) read once, each row
    written once, each row's index read once"""
    t = starts // tile
    n_tiles = int(torch.unique(torch.cat([t, t + 1])).numel())
    return (min(n_tiles * tile, n_rows * fet) + n_rows * fet
            + n_rows * idx_bytes), n_tiles


def queued_ms(torch, items, prep, run, chunk=32):
    """device time in ms of run(prep(item), item) over items, summed per
    call from a pair of CUDA events just around it.  Each chunk of calls is
    queued behind a sleep kernel, so the card runs them back to back and an
    event pair brackets its own call's kernels, not the host's time to issue
    them; a chunk the card caught up with is queued again behind a longer
    sleep."""
    def event():
        return torch.cuda.Event(enable_timing=True)
    cycles, total, i = 1 << 24, 0.0, 0
    while i < len(items):
        part = items[i:i + chunk]
        args = [prep(it) for it in part]
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        slept = torch.cuda.Event()
        slept.record()
        pairs = []
        for it, x in zip(part, args):
            a, b = event(), event()
            a.record()
            run(x, it)
            b.record()
            pairs.append((a, b))
        if slept.query():
            if cycles >= 1 << 34:
                raise RuntimeError("queued_ms: the host cannot keep ahead")
            cycles *= 4
            continue
        torch.cuda.synchronize()
        total += sum(a.elapsed_time(b) for a, b in pairs)
        i += chunk
    return total


def profiler_kernels(torch, fn, match):
    """how many kernels whose name contains `match` torch.profiler reports
    for fn(): a check of the profiler, which has been seen to drop kernel
    events on the H100 machines this script runs on (PERF.md)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == DeviceType.CUDA and match in e.name)


def window_bytes(torch, start, width, n):
    """bytes a window fetch must move: each distinct 32-byte sector that its
    live windows cover read once, each live window written once, 8 B per
    start"""
    live = start[start >= 0].clamp(max=n - width)
    if live.numel() == 0:
        return start.numel() * 8
    s = torch.sort(live).values
    a, b = s // 32, (s + width - 1) // 32
    prev = torch.cat([b.new_full((1,), -1), torch.cummax(b, 0).values[:-1]])
    sectors = int((b - torch.maximum(a, prev + 1) + 1).clamp(min=0).sum())
    return sectors * 32 + live.numel() * width + start.numel() * 8


def old_fetch_cut(torch, fetch, table, start, width):
    """the composition fetch_window replaced: aligned fetch_rows rows (as
    many as the width needs, FET apart, one launch) and one gather"""
    m = fetch._rows_for(width)
    if m == 1:
        rows = fetch.fetch_rows(table, start)
    else:
        offs = start[:, None] + fetch.FET * torch.arange(m,
                                                         device=start.device)
        rows = fetch.fetch_rows(
            table, offs.clamp_(max=table.numel() - fetch.FET).reshape(-1))
        rows = rows.reshape(start.numel(), m * fetch.FET)
    return fetch.realign(rows, start % fetch.TILE, width)


def phase_kernel(torch, np, fetch):
    """fetch_rows kernel vs its plain version at the MMP's widest shape"""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)
    raw = rng.integers(-128, 128, size=FETCH_TABLE, dtype=np.int8)
    tab = torch.from_numpy(fetch.pad_table(raw)).to(dev)
    off = rng.integers(-FETCH_TABLE // 8, FETCH_TABLE, size=FETCH_ROWS)
    off[:8] = [-1, 0, 1, 1023, 1024, FETCH_TABLE - 1, FETCH_TABLE - 1024,
               FETCH_TABLE - 2048]
    off = torch.from_numpy(off).to(dev)
    live = off >= 0
    want = fetch._fetch_rows_torch(tab, off)[live]
    got = fetch.fetch_rows(tab, off)
    torch.cuda.synchronize()
    err = int((got[live].int() - want.int()).abs().max())
    del got, want
    if err != 0:
        raise AssertionError(f"fetch_rows kernel differs from plain: {err}")
    n_live = int(live.sum())
    ms = cuda_ms(lambda: fetch.fetch_rows(tab, off))
    ms2 = cuda_ms(lambda: fetch.fetch_rows(tab, off))
    plain_ms = cuda_ms(lambda: fetch._fetch_rows_torch(tab, off))
    library_ms = cuda_ms(lambda: tab.unfold(0, 2048, 1024)[off // 1024])
    # live rows move data; every offset is read once
    live_b, n_tiles = row_bytes(torch, off[live], n_live, 0, fetch.FET,
                                fetch.TILE)
    bytes_moved = live_b + FETCH_ROWS * 8
    bound_ms = bytes_moved / HBM_BW * 1e3
    log(f"kernel fetch_rows: {FETCH_ROWS} rows ({n_live} live, {n_tiles} "
        f"distinct tiles) of a {FETCH_TABLE >> 20} MiB table: max_abs_err "
        f"{err}, "
        f"{ms:.4f} / {ms2:.4f} ms (plain {plain_ms:.4f}, library "
        f"{library_ms:.4f}, bound {bound_ms:.4f} ms = {bytes_moved} B at "
        f"{HBM_BW:.3g} B/s)")
    return {"name": "fetch_rows", "route": "cuda",
            "source": "star_tpu_torch/ops/csrc/fetch_rows.cu",
            "replaces": "star_tpu/ops/fetch.py:83",
            "launches": None, "on_main_path": False,
            "max_abs_err": err, "max_abs_diff": err,
            "ms": ms, "ms_again": ms2,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": library_ms}


def phase_window_kernel(torch, np, fetch):
    """fetch_window kernel vs its plain version, byte for byte, at every
    width of the main path: 262,144 starts over a 128 MiB table, both table
    edges, starts past them and negative starts, each timed beside its plain
    version, one library call and its bytes bound.  Returns (max_abs_err,
    {width: timings})"""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(2)
    raw = rng.integers(-128, 128, size=FETCH_TABLE, dtype=np.int8)
    tab = torch.from_numpy(fetch.pad_table(raw)).to(dev)
    n = tab.numel()
    out, max_err = {}, 0
    for width in WINDOW_WIDTHS:
        s = rng.integers(-n // 8, n + 64, size=FETCH_ROWS)
        s[:14] = [-1, -(1 << 40), 0, 1, 15, 17, FETCH_TABLE - 1,
                  n - width - 1, n - width, n - width + 1, n - 1, n,
                  1 << 40, 4096 + 9]
        s = torch.from_numpy(s).to(dev)
        live = s >= 0
        got = fetch.fetch_window(tab, s, width)
        torch.cuda.synchronize()
        want = fetch._fetch_window_torch(tab, s, width)
        err = int((got[live].int() - want[live].int()).abs().max())
        del got, want
        if err != 0:
            raise AssertionError(f"fetch_window kernel differs from plain at "
                                 f"width {width}: {err}")
        max_err = max(max_err, err)
        lc = s[live].clamp(max=n - width)
        reps = [None] * 20

        def timed(f):
            return queued_ms(torch, reps, lambda _: None,
                             lambda _, __: f()) / len(reps)
        t = {"ms": timed(lambda: fetch.fetch_window(tab, s, width)),
             "plain_ms": timed(lambda: fetch._fetch_window_torch(
                 tab, s, width)),
             "library_ms": timed(lambda: tab.unfold(0, width, 1)[lc])}
        nb = window_bytes(torch, s, width, n)
        t.update(bound_ms=nb / HBM_BW * 1e3, bytes=nb)
        out[width] = t
        log(f"kernel fetch_window W={width}: {FETCH_ROWS} starts "
            f"({int(live.sum())} live) of a {FETCH_TABLE >> 20} MiB table: "
            f"max_abs_err {err}, {t['ms']:.4f} ms (plain "
            f"{t['plain_ms']:.4f}, library {t['library_ms']:.4f}, bound "
            f"{t['bound_ms']:.4f} ms = {nb} B at {HBM_BW:.3g} B/s)")
    return max_err, out


def phase_tile_kernel(torch, np, tile_fetch):
    """tile_fetch kernel vs its plain version: 262,144 positions of a
    128 MiB table, both table edges included"""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(1)
    raw = rng.integers(-128, 128, size=FETCH_TABLE, dtype=np.int8)
    tab = torch.from_numpy(tile_fetch.pad_table(raw)).to(dev)
    pos = rng.integers(0, FETCH_TABLE, size=FETCH_ROWS).astype(np.int32)
    pos[:8] = [0, 1, 1023, 1024, 2047, FETCH_TABLE - 2048, FETCH_TABLE - 1024,
               FETCH_TABLE - 1]
    pos = torch.from_numpy(pos).to(dev)
    fn = tile_fetch.make_tile_fetch(tab, FETCH_ROWS)
    got = fn(pos)
    torch.cuda.synchronize()
    want = tile_fetch._tile_fetch_torch(tab, pos)
    err = int((got.int() - want.int()).abs().max())
    del got, want
    if err != 0:
        raise AssertionError(f"tile_fetch kernel differs from plain: {err}")
    ms = cuda_ms(lambda: fn(pos))
    plain_ms = cuda_ms(lambda: tile_fetch._tile_fetch_torch(tab, pos))
    library_ms = cuda_ms(lambda: tab.unfold(0, 2048, 1024)[pos // 1024])
    bytes_moved, n_tiles = row_bytes(torch, pos.long(), FETCH_ROWS, 4,
                                     tile_fetch.FET, tile_fetch.TILE)
    bound_ms = bytes_moved / HBM_BW * 1e3
    log(f"kernel tile_fetch: {FETCH_ROWS} positions ({n_tiles} distinct "
        f"tiles) of a {FETCH_TABLE >> 20} MiB table: max_abs_err {err}, "
        f"{ms:.4f} ms (plain {plain_ms:.4f}, library {library_ms:.4f}, bound "
        f"{bound_ms:.4f} ms = {bytes_moved} B at {HBM_BW:.3g} B/s)")
    return {"name": "tile_fetch", "route": "cuda",
            "source": "star_tpu_torch/ops/csrc/fetch_rows.cu",
            "replaces": "star_tpu/ops/pallas_fetch.py:66",
            "launches": None, "on_main_path": False,
            "max_abs_err": err, "max_abs_diff": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": library_ms}


def levels(be):
    """{w_max: (runs, runs with the grow on the card)} of the escalation
    levels run since LEVEL_STATS was cleared"""
    ls = be.LEVEL_STATS
    return {w: (ls[w, "runs"], ls[w, "device"]) for w in sorted({w for w, _
                                                               in ls})}


def check_card_levels(ds, be, label):
    """every level whose grow ran on the card finalized there too: its
    finalize launched fetch_window and accepted chains"""
    gs = ds.GROW_STATS
    for w, (runs, dev) in levels(be).items():
        if dev and (gs[w, "finalize_launches"] == 0
                    or gs[w, "accepted"] == 0):
            raise AssertionError(f"{label}: level W{w} grew on the card but "
                                 "did not finalize there")


def grow_report(ds, be, pipeline, label):
    ls = be.LEVEL_STATS
    gs = ds.GROW_STATS
    t = pipeline.TIMERS
    for w, (runs, dev) in levels(be).items():
        log(f"{label}: level W{w}: {ls[w, 'reads']} reads, "
            f"{ls[w, 'records']} seed records, stitch engine on the card in "
            f"{dev} of {runs} runs")
        if not dev:
            log(f"{label}: level W{w}: numpy grow {t[f'grow_host_W{w}']:.3f}"
                f" s, numpy finalize {t[f'finalize_W{w}']:.3f} s, assemble "
                f"{t[f'assemble_W{w}']:.3f} s")
            continue
        log(f"{label}: level W{w}: grow_dev {t[f'grow_dev_W{w}']:.3f} s ("
            + ", ".join(f"dev_{k} {t[f'dev_{k}_W{w}']:.3f} s" for k in
                        ("upload", "grow", "finalize", "select", "download",
                         "order"))
            + f"), finalize_W{w} {t[f'finalize_W{w}']:.3f} s, assemble_W{w} "
            f"{t[f'assemble_W{w}']:.3f} s; {gs[w, 'iterations']} "
            f"iterations, {gs[w, 'steps']} steps; {gs[w, 'retired']} lanes "
            f"retired, {gs[w, 'accepted']} accepted, {gs[w, 'downloaded']} "
            f"downloaded, {gs[w, 'over']} reads over the multimap limit; "
            f"fetch_window launches: grow {gs[w, 'fetch_launches']}, finalize "
            f"{gs[w, 'finalize_launches']}, pack {gs[w, 'pack_launches']}")
    log(f"{label}: FB_STATS {dict(sorted(be.FB_STATS.items()))}")


def stitch_launches(ds):
    """fetch_window launches of the stitch engine: {grow, finalize, pack}"""
    gs = ds.GROW_STATS
    return {k: sum(v for (w, n), v in gs.items() if n == f"{k}_launches")
            for k in ("fetch", "finalize", "pack")}


def reset_launches(fetch, tile_fetch):
    """zero the kernels' launch counters before a main path"""
    from star_tpu_torch.ops import device_stitch
    fetch.LAUNCHES = fetch.ROWS_LAUNCHES = tile_fetch.LAUNCHES = 0
    device_stitch.LAUNCHES = 0


def main_launches(fetch, tile_fetch):
    """the kernels' launches since reset_launches"""
    from star_tpu_torch.ops import device_stitch
    return {"fetch_window": fetch.LAUNCHES,
            "fetch_rows": fetch.ROWS_LAUNCHES,
            "tile_fetch": tile_fetch.LAUNCHES,
            "stitch_chunk": device_stitch.LAUNCHES}


def reset_counts(ds, be, pipeline):
    be.LEVEL_STATS.clear()
    be.FB_STATS.clear()
    ds.GROW_STATS.clear()
    pipeline.TIMERS.clear()


def phase_golden(fetch):
    from star_tpu_torch.genome.index import GenomeIndex
    from star_tpu_torch.ops import batch_engine as be
    from star_tpu_torch.ops import device_stitch as ds
    from star_tpu_torch.ops import pipeline
    from star_tpu_torch.params import Parameters
    from star_tpu_torch.run import align_reads
    gi = GenomeIndex.load(os.path.join(GOLD, "genome_idx"))
    gate = be.DEVICE_GROW_MIN_RECORDS
    be.DEVICE_GROW_MIN_RECORDS = {s: 0 for _, s, _ in be.LEVELS}  # every level
    pipeline.TIMING = True
    try:
        for case, reads in (("se", ["reads_se.fastq"]),
                            ("pe", ["reads_pe_1.fastq", "reads_pe_2.fastq"])):
            reset_counts(ds, be, pipeline)
            n0 = fetch.LAUNCHES
            out = os.path.join(WORK, f"golden_{case}") + "/"
            P = Parameters(["--genomeDir", os.path.join(GOLD, "genome_idx"),
                            "--readFilesIn",
                            *[os.path.join(DATA, r) for r in reads],
                            "--outFileNamePrefix", out,
                            "--outSAMunmapped", "Within"])
            t0 = time.time()
            align_reads(P, gi=gi, device=DEVICE)
            if strip_header(out + "Aligned.out.sam") != \
                    strip_header(os.path.join(GOLD, case, "Aligned.out.sam")):
                raise AssertionError(f"golden {case}: SAM differs")
            with open(out + "SJ.out.tab") as a, \
                    open(os.path.join(GOLD, case, "SJ.out.tab")) as b:
                if a.read() != b.read():
                    raise AssertionError(f"golden {case}: SJ.out.tab differs")
            lv = levels(be)
            if not lv or any(dev != runs for runs, dev in lv.values()):
                raise AssertionError(f"golden {case}: a level's grow did not "
                                     "run on the card")
            check_card_levels(ds, be, f"golden {case}")
            sl = stitch_launches(ds)
            if sl["fetch"] == 0:
                raise AssertionError(f"golden {case}: the grow launched no "
                                     "fetch_window")
            n_over = sum(v for (w, k), v in ds.GROW_STATS.items()
                         if k == "over")
            log(f"golden {case}: SAM and SJ.out.tab identical, "
                f"{fetch.LAUNCHES - n0} fetch_window launches (grow "
                f"{sl['fetch']}, finalize {sl['finalize']}, pack "
                f"{sl['pack']}), {n_over} reads classified over the multimap "
                f"limit on the card, {time.time() - t0:.2f} s")
            grow_report(ds, be, pipeline, f"golden {case}")
    finally:
        be.DEVICE_GROW_MIN_RECORDS = gate
        pipeline.TIMING = False


def start_data(data):
    """start the chr20-scale data generator unless its output exists"""
    if os.path.exists(os.path.join(data, "reads_se.fastq")):
        return None
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "make_test_data.py"),
         "--out", data, "--chr-lens", *CHR_LENS, "--seed", "11",
         "--n-reads", str(N_READS)], cwd=ROOT, stdout=subprocess.DEVNULL)


def load_dump(gi, P, dump):
    import pickle
    from star_tpu_torch.ops import batch_engine as be
    with open(dump, "rb") as f:
        d = pickle.load(f)
    d["recs"] = be.expand_hits(gi, P, d["seeds"], d["lread"], len(d["lread"]))
    return d


def level_reach(np, gi, P, d):
    """{w_max: the reads of the batch that reach the level}: all reads
    reach level 0, and those it leaves in fallback the W512 level"""
    from star_tpu_torch.ops import batch_engine as be
    B = len(d["lread"])
    fb0, _ = be._stitch_level(gi, P, d["recs"], d["lread"], d["fwd"], d["rc"],
                              d["read_len2"], d["nmm_max"], be.W_MAX,
                              be.S_MAX, be.CHAIN_CAP, lazy=True,
                              device=DEVICE)
    return {be.W_MAX: np.arange(B), 512: np.nonzero(fb0)[0]}


def sub_level(np, gi, P, d, idx, w_max, s_max):
    """the grow inputs of one level on the reads idx of the dumped batch:
    (ws, st, seed records, RS, Lpad)"""
    from star_tpu_torch.ops import batch_engine as be
    B = len(d["lread"])
    mask = np.zeros(B, bool)
    mask[idx] = True
    new_index = np.zeros(B, np.int64)
    new_index[idx] = np.arange(len(idx))
    sub = be._slice_seed_recs(d["recs"], mask, new_index)
    return be.level_state(gi, P, sub, len(idx), d["fwd"][idx], d["rc"][idx],
                          w_max, s_max)


def grow_sweep(np, gi, P, d, reach):
    """each level's grow replayed on the first n reads that reach it, numpy
    engine against the card (LaneStates and fallbacks equal).  Returns
    {w_max: [(reads, seed records, numpy s, card s), ...]}; the card's time
    is the best of two calls"""
    import copy
    import torch
    from star_tpu_torch.ops import batch_engine as be
    from star_tpu_torch.ops import device_stitch as ds
    out = {}
    for w_max, s_max, chain_cap in be.LEVELS:
        rows = out[w_max] = []
        for n in SWEEP[w_max]:
            idx = reach[w_max][:n]
            ws, st, n_rec, RS, Lpad = sub_level(np, gi, P, d, idx, w_max,
                                                s_max)
            nmm = d["nmm_max"][idx]
            st_np = copy.deepcopy(st)
            t0 = time.time()
            want = be.grow_chains(gi, P, gi.G.view(np.uint8), RS, st_np, ws,
                                  nmm, Lpad, chain_cap=chain_cap)
            t_np = time.time() - t0
            t_dev = []
            for _ in range(2):
                st_d = copy.deepcopy(st)
                torch.cuda.synchronize()
                t0 = time.time()
                got = ds.grow_chains_device(gi, P, st_d, ws, RS, nmm, Lpad,
                                            s_max, chain_cap, DEVICE)[0]
                torch.cuda.synchronize()
                t_dev.append(time.time() - t0)
                if not np.array_equal(st_d.fallback, st_np.fallback):
                    raise AssertionError(f"grow sweep W{w_max} n={n}: "
                                         "fallback differs")
                for k in be._lane_fields():
                    if not np.array_equal(getattr(got, k), getattr(want, k)):
                        raise AssertionError(f"grow sweep W{w_max} n={n}: "
                                             f"card lanes differ in {k}")
            rows.append((len(idx), n_rec, t_np, min(t_dev)))
            log(f"full: grow sweep W{w_max}: {len(idx)} reads, {n_rec} seed "
                f"records, {len(want.b)} chains: numpy {t_np:.4f} s, card "
                f"{min(t_dev):.4f} s (calls {t_dev[0]:.4f}, {t_dev[1]:.4f}); "
                "LaneStates equal")
            if len(idx) < n:
                break
        gate = be.DEVICE_GROW_MIN_RECORDS[s_max]
        lose = [r for _, r, tn, tc in rows if tc > tn]
        win = [r for _, r, tn, tc in rows if tc <= tn]
        log(f"full: grow sweep W{w_max}: the card lost at "
            f"{max(lose) if lose else 'no point'} and won from "
            f"{min(win) if win else 'no point'} seed records; gate {gate}")
    return out


def finalize_replay(np, gi, P, d, reach, pipeline):
    """the W512 level's finalize replayed on every read that reaches it:
    the card's grow + finalize with every retired lane downloaded, against
    the card's grow alone followed by numpy finalize_lanes; accept and the
    extended LaneStates must be equal.  Returns (numpy s, card s)"""
    import copy
    import torch
    from star_tpu_torch.ops import batch_engine as be
    from star_tpu_torch.ops import device_stitch as ds
    w_max, s_max, chain_cap = be.LEVELS[1]
    idx = reach[w_max]
    ws, st, n_rec, RS, Lpad = sub_level(np, gi, P, d, idx, w_max, s_max)
    nmm, lread, read_len2 = (d[k][idx] for k in ("nmm_max", "lread",
                                                 "read_len2"))
    st_h = copy.deepcopy(st)
    lanes_h = ds.grow_chains_device(gi, P, st_h, ws, RS, nmm, Lpad, s_max,
                                    chain_cap, DEVICE)[0]
    t0 = time.time()
    acc_h = be.finalize_lanes(gi, P, gi.G.view(np.uint8), RS, lanes_h, ws,
                              nmm, read_len2, lread, Lpad)
    t_np = time.time() - t0
    pipeline.TIMING = True
    pipeline.TIMERS.clear()
    try:
        lanes_d, acc_d, _ = ds.grow_chains_device(
            gi, P, st, ws, RS, nmm, Lpad, s_max, chain_cap, DEVICE,
            lread=lread, read_len2=read_len2, classify=False)
        torch.cuda.synchronize()
    finally:
        pipeline.TIMING = False
    t_card = pipeline.TIMERS[f"dev_finalize_W{w_max}"]
    if not np.array_equal(st.fallback, st_h.fallback) \
            or not np.array_equal(acc_d, acc_h):
        raise AssertionError("finalize replay W512: accept differs")
    for k in be._lane_fields():
        if not np.array_equal(getattr(lanes_d, k), getattr(lanes_h, k)):
            raise AssertionError(f"finalize replay W512: lanes differ in {k}")
    log(f"full: finalize replay W{w_max}: {len(idx)} reads, {n_rec} seed "
        f"records, {len(acc_h)} chains, {int(acc_h.sum())} accepted: numpy "
        f"finalize_lanes {t_np:.3f} s, card dev_finalize {t_card:.3f} s; "
        "accept and extended LaneStates equal")
    return t_np, t_card


# the function whose fetch_window calls are each phase's (found from the
# caller's frames): the seed loop's MMP, then the stitch engine's grow,
# finalize and pack
FETCH_PHASES = {"mmp": "seed", "_finalize_rows": "finalize",
                "pack_rows": "pack", "grow": "grow"}
PHASES = ("seed", "grow", "finalize", "pack")


def record_fetches(torch, fetch, run):
    """run() with every fetch_window call recorded: (phase, weak reference
    to the table, table bytes, starts, width, the wrapper's host seconds)"""
    import weakref
    calls = []
    real = fetch.fetch_window

    def phase():
        f = sys._getframe(2)
        while f is not None:
            if f.f_code.co_name in FETCH_PHASES:
                return FETCH_PHASES[f.f_code.co_name]
            f = f.f_back
        raise AssertionError("a fetch_window call outside the known phases")

    def recorded(table, start, width):
        t0 = time.perf_counter()
        out = real(table, start, width)
        dt = time.perf_counter() - t0
        if start.numel():
            calls.append((phase(), weakref.ref(table), table.numel(),
                          start.clone(), int(width), dt))
        return out

    fetch.fetch_window = recorded
    try:
        run()
        torch.cuda.synchronize()
    finally:
        fetch.fetch_window = real
    return calls


def time_calls(torch, fetch, calls):
    """the recorded calls of one phase launched again: each call's kernel
    output held against the plain version (its live rows, byte for byte),
    then back to back the window kernel's own device time (twice, before
    and after the rest), the
    old composition (fetch_rows + cut), the library call
    table.unfold(0, W, 1)[start], the plain version, and the bytes bound.
    A table the run has freed since is stood in for by an uninitialised one
    of the same size (the same addresses relative to its start, so the same
    access pattern)."""
    import collections
    subs = collections.OrderedDict()

    def table(c):
        t = c[1]()
        if t is None:
            t = subs.pop(c[2], None)
            if t is None:
                t = torch.empty(c[2], dtype=torch.int8, device=DEVICE)
            subs[c[2]] = t
            while len(subs) > 12:
                subs.popitem(last=False)
        return t

    items = [(c, c[3][c[3] >= 0].clamp(max=c[2] - c[4])) for c in calls]
    err = 0
    for c in calls:
        t, live = table(c), c[3] >= 0
        if live.any():
            got = fetch._fetch_window_cuda(t, c[3], c[4])[live].int()
            want = fetch._fetch_window_torch(t, c[3], c[4])[live].int()
            err = max(err, int((got - want).abs().max()))
    if err:
        raise AssertionError(f"fetch_window kernel differs from plain on a "
                             f"recorded call: {err}")

    def timed(f):
        return queued_ms(torch, items, lambda it: table(it[0]),
                         lambda t, it: f(t, *it))
    kern = timed(lambda t, c, lc: fetch._fetch_window_cuda(t, c[3], c[4]))
    r = {"ms": kern, "max_abs_err": err}
    r["old_ms"] = timed(
        lambda t, c, lc: old_fetch_cut(torch, fetch, t, c[3], c[4]))
    r["library_ms"] = timed(lambda t, c, lc: t.unfold(0, c[4], 1)[lc])
    r["plain_ms"] = timed(
        lambda t, c, lc: fetch._fetch_window_torch(t, c[3], c[4]))
    r["ms_again"] = timed(
        lambda t, c, lc: fetch._fetch_window_cuda(t, c[3], c[4]))

    def relaunch():
        for c in calls:
            fetch._fetch_window_cuda(table(c), c[3], c[4])
    r["profiler_saw"] = profiler_kernels(torch, relaunch, "window_kernel")
    nb = sum(window_bytes(torch, c[3], c[4], c[2]) for c in calls)
    r["bound_ms"] = nb / HBM_BW * 1e3
    r["bytes"] = nb
    r["launches"] = len(calls)
    r["rows"] = sum(c[3].numel() for c in calls)
    r["widths"] = sorted({c[4] for c in calls})
    r["host_us_per_call"] = sum(c[5] for c in calls) / len(calls) * 1e6
    return r


def replay_fetches(torch, np, gi, P, d, fetch, want):
    """the batch's seed loop and stitch again from its dumped inputs, with
    every fetch_window call recorded and then timed per phase (seed loop,
    grow, finalize, pack) by time_calls.  want: the main path's launches per
    phase, which the replay must repeat.  Returns {phase: timings}."""
    from star_tpu_torch.ops import batch_engine as be
    from star_tpu_torch.ops import pipeline
    from star_tpu_torch.ops.sa_search import make_mmp_fn
    di = gi._device_cache[next(k for k in gi._device_cache
                               if k[0] != "stitch")]
    D = int(getattr(gi, "sa_sparse_d", 1)) or 1
    put = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=DEVICE)

    def run():
        pipeline.make_fused_seed_fn(make_mmp_fn(di), di.ql, D)(
            torch.as_tensor(d["read_mat"], device=DEVICE),
            *[put(a) for a in d["chains"]], int(P.seedMapMin))
        be.stitch_batch(gi, P, d["seeds"], d["fwd"], d["rc"], d["lread"],
                        d["read_len2"], d["nmm_max"], lazy=True,
                        device=DEVICE)
    calls = record_fetches(torch, fetch, run)
    out = {}
    for ph in PHASES:
        cs = [c for c in calls if c[0] == ph]
        if len(cs) != want[ph]:
            raise AssertionError(f"fetch replay: {len(cs)} {ph} fetch_window "
                                 f"calls, the main path made {want[ph]}")
        r = out[ph] = time_calls(torch, fetch, cs)
        log(f"full: the {ph}'s fetch_window calls (replayed): {r['launches']} "
            f"launches, {r['rows']} rows, widths {r['widths']}: kernel "
            f"{r['ms']:.3f} / {r['ms_again']:.3f} ms (torch.profiler saw "
            f"{r['profiler_saw']} of its {r['launches']} kernels), "
            f"bound {r['bound_ms']:.3f} ms ({r['bytes']} B at "
            f"{HBM_BW:.3g} B/s), library {r['library_ms']:.3f} ms, old "
            f"fetch_rows + cut {r['old_ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms; wrapper host "
            f"{r['host_us_per_call']:.1f} us per call")
    return out


def chunk_branches(torch, ds, cfg, sc, ex, rows, pm, s):
    """each lane's branch in the chunk kernel, taken in its order
    (csrc/stitch_chunk.cu, stitch): "join" the annotated-junction joins,
    which stage no region; "same" the same-fragment lanes that stage the
    read region and the donor's genome region (those rejected before, on
    their spans or intron_max, stage none); "dels" those of them that stage
    the acceptor's genome region too; "mate" the mate joins past the
    protrusion and mates-gap checks, with "win1" / "win2" the Lpad + 2 byte
    windows that each of their two extensions stages (4, or 2 to the end)"""
    prow = sc[:, ds.C_PROW].long().clamp(0, pm.shape[0] - 1)
    seed = rows[(pm[:, 0][prow] + s).long().clamp(0, rows.shape[0] - 1)]
    nE = sc[:, ds.C_NEX]
    last = (nE - 1).clamp(0, ds.E - 1).long()

    def ex_last(f):
        return ex.gather(1, (last * 5 + f)[:, None])[:, 0]
    rB, gB, L, fragB, sjA = (seed[:, k] for k in range(5))
    ra, ga = sc[:, ds.C_TR2], sc[:, ds.C_TG2]
    last_frag = ex_last(ds.EX_FRAG)
    live = (nE > 0) & (nE < ds.E)
    join = (live & (sjA != -1) & (ex_last(ds.EX_SJA) == sjA)
            & (last_frag == fragB) & (rB == ra + 1) & (ga + 1 < gB))
    trim = (ra + 1 - rB).clamp(min=0)
    g_gap, r_gap = gB + trim - ga - 1, rB + trim - ra - 1
    same = (live & ~join & (last_frag == fragB) & (rB + L - 1 > ra)
            & (gB + L - 1 > ga) & (g_gap != r_gap))
    if cfg.intron_max > 0:
        same &= ~((g_gap > r_gap) & (g_gap - r_gap > cfg.intron_max))
    dels = same & (g_gap > r_gap)
    rs0, gs0 = ex[:, ds.EX_RS], ex[:, ds.EX_GS]
    mate = (live & ~join & (last_frag != fragB)
            & ((gB + rs0 + cfg.protrude_max >= gs0) | (gs0 < rs0)))
    if not cfg.has_pe:
        mate = torch.zeros_like(mate)
    if cfg.mates_gap_max > 0:
        mate &= gB <= (ex_last(ds.EX_GS) + ex_last(ds.EX_LEN)
                       + cfg.mates_gap_max)
    to_end = torch.tensor([cfg.ends_ext[0][1], cfg.ends_ext[1][1]],
                          device=sc.device)
    return {"join": join, "same": same, "dels": dels, "mate": mate,
            "win1": 4 - 2 * to_end[last_frag.clamp(0, 1).long()].int(),
            "win2": 4 - 2 * to_end[fragB.clamp(0, 1).long()].int()}


def chunk_bytes(ds, cfg, n, br):
    """bytes a grow chunk of n lanes must move (br: chunk_branches): each
    lane's row in and out (896 B each way), its seed row and ok; the
    regions of the lanes that stage them; the mate joins' windows"""
    rspan, gspan = ds.region_spans(cfg.Lpad)
    wins = int(((br["win1"] + br["win2"]) * br["mate"]).sum())
    return (n * (2 * 4 * (ds.NSCAL + ds.NEXB + ds.NSJB) + 32 + 1)
            + int(br["same"].sum()) * (rspan + gspan)
            + int(br["dels"].sum()) * gspan + wins * (cfg.Lpad + 2))


def chunk_replay(torch, np, gi, P, d, label, need=()):
    """the batch's stitch again from its dumped inputs, the device grow on
    every level, each grow chunk launched once more on copies of its
    inputs: the kernel's rows and ok held against the plain version's
    (torch.equal), the kernel's device time (its own CUDA events, queued
    behind a sleep kernel), the plain version's (events around its
    launches), the bytes bound and the lanes of each branch ("joins",
    "same", "mates"; "found": same-fragment lanes accepted across a junction
    that the annotation lookup found).  Each key of need must count some
    lane.  Returns {level W: totals}."""
    from star_tpu_torch.ops import batch_engine as be
    from star_tpu_torch.ops import device_stitch as ds
    real = ds.stitch_chunk
    per = {}

    def event():
        return torch.cuda.Event(enable_timing=True)

    def spy(*a):
        tabs, ins, s = a[:9], [t.clone() for t in a[9:15]], a[15]
        ok = real(*a)
        got = tuple(torch.empty_like(t) for t in ins[:3])
        want = tuple(torch.empty_like(t) for t in ins[:3])
        torch.cuda.synchronize()
        torch.cuda._sleep(1 << 22)
        k0, k1, p0, p1 = event(), event(), event(), event()
        k0.record()
        ok_k = real(*tabs, *ins, s, got)
        k1.record()
        torch.cuda.synchronize()
        p0.record()
        ok_p = ds._stitch_chunk_plain(*tabs, *ins, s, want)
        p1.record()
        torch.cuda.synchronize()
        if not (torch.equal(ok_k, ok_p) and torch.equal(ok_k, ok)
                and all(torch.equal(g, w) for g, w in zip(got, want))
                and all(torch.equal(g, o) for g, o in zip(got, a[16]))):
            raise AssertionError(f"{label}: stitch_chunk kernel differs from "
                                 f"plain at step {s} (Lpad {tabs[0].Lpad})")
        cfg, sc = tabs[0], ins[0]
        br = chunk_branches(torch, ds, cfg, sc, ins[1], ins[3], ins[4], s)
        nE = sc[:, ds.C_NEX]
        last = (nE - 1).clamp(0, ds.E - 1).long()
        annot = got[2].gather(1, (last * 5 + ds.SJ_ANNOT)[:, None])[:, 0]
        found = br["same"] & ok_k & (got[0][:, ds.C_NEX] > nE) & (annot == 1)
        key = "W512" if cfg.s_max > be.S_MAX else f"W{be.W_MAX}"
        r = per.setdefault(key, {"Lpad": cfg.Lpad, "has_pe": cfg.has_pe,
                                 "has_sjdb": cfg.has_sjdb, "launches": 0,
                                 "lanes": 0, "max_lanes": 0, "ms": 0.0,
                                 "plain_ms": 0.0, "bytes": 0, "joins": 0,
                                 "same": 0, "mates": 0, "found": 0})
        r["launches"] += 1
        r["lanes"] += sc.shape[0]
        r["max_lanes"] = max(r["max_lanes"], sc.shape[0])
        r["ms"] += k0.elapsed_time(k1)
        r["plain_ms"] += p0.elapsed_time(p1)
        r["bytes"] += chunk_bytes(ds, cfg, sc.shape[0], br)
        for k, m in (("joins", br["join"]), ("same", br["same"]),
                     ("mates", br["mate"]), ("found", found)):
            r[k] += int(m.sum())
        return ok

    n0 = ds.LAUNCHES
    gate = be.DEVICE_GROW_MIN_RECORDS
    be.DEVICE_GROW_MIN_RECORDS = {s: 0 for _, s, _ in be.LEVELS}
    ds.stitch_chunk = spy
    try:
        be.stitch_batch(gi, P, d["seeds"], d["fwd"], d["rc"], d["lread"],
                        d["read_len2"], d["nmm_max"], lazy=True,
                        device=DEVICE)
        torch.cuda.synchronize()
    finally:
        ds.stitch_chunk = real
        be.DEVICE_GROW_MIN_RECORDS = gate
    for key, r in per.items():
        r["bound_ms"] = r["bytes"] / HBM_BW * 1e3
        log(f"{label}: the {key} grow's chunks (replayed, Lpad {r['Lpad']}, "
            f"pe {r['has_pe']}, sjdb {r['has_sjdb']}): {r['launches']} "
            f"launches, {r['lanes']} lanes (at most {r['max_lanes']} a "
            f"chunk; {r['joins']} annotated joins, {r['same']} same-fragment "
            f"stitches with regions, {r['found']} of them accepted across a "
            f"junction the annotation lookup found, {r['mates']} mate joins),"
            f" each held against the plain version: kernel {r['ms']:.3f} ms "
            f"({r['ms'] / r['launches']:.4f} ms a chunk), bound "
            f"{r['bound_ms']:.3f} ms ({r['bytes']} B at {HBM_BW:.3g} B/s), "
            f"plain {r['plain_ms']:.3f} ms")
    ds.LAUNCHES = n0
    missing = [k for k in need if not sum(r[k] for r in per.values())]
    if missing or not per:
        raise AssertionError(f"{label}: no replayed lane counted {missing} "
                             f"(levels {sorted(per)})")
    return per


def check_chunk_launches(ds, be, launches, label):
    """one stitch_chunk launch per grow iteration on every level since
    reset_counts, and at least one; returns {level: (launches, grow
    iterations)}"""
    chunks = {w: (ds.GROW_STATS[w, "chunk_launches"],
                  ds.GROW_STATS[w, "iterations"]) for w in levels(be)}
    if launches["stitch_chunk"] != sum(c for c, _ in chunks.values()) or \
            any(c != it for c, it in chunks.values()) or \
            launches["stitch_chunk"] <= 0:
        raise AssertionError(f"{label}: stitch_chunk launches "
                             f"{launches['stitch_chunk']}, per level "
                             f"(launches, grow iterations) {chunks}")
    return chunks


def probe_set(np, reads, ql):
    """N_PROBES seeded probes cut from the batch's reads, half of them
    reverse-complemented: ([N_PROBES, ql] int8, -1 padded; lengths)"""
    from star_tpu_torch.constants import encode_seq
    from star_tpu_torch.io.fastq import read_pairs
    rng = np.random.default_rng(5)
    recs = [seqs[0] for _, seqs, _, _ in
            itertools.islice(read_pairs([reads]), N_READS)]
    qs = np.full((N_PROBES, ql), -1, np.int8)
    qlen = np.zeros(N_PROBES, np.int64)
    b = 0
    while b < N_PROBES:
        s = encode_seq(recs[int(rng.integers(0, len(recs)))])
        if rng.random() < 0.5:
            s = (3 - s[::-1]).astype(np.int8)
        st = int(rng.integers(0, len(s) - 6))
        q = s[st:st + int(rng.integers(6, len(s) - st + 1))]
        if ((q < 0) | (q > 3)).any():
            continue
        qs[b, :len(q)] = q
        qlen[b] = len(q)
        b += 1
    return qs, qlen


def phase_full(torch, np, fetch, data_proc, data):
    from star_tpu_torch.align.seed import mmp_search
    from star_tpu_torch.genome.index import GenomeIndex
    from star_tpu_torch.io.fastq import read_pairs
    from star_tpu_torch.ops import batch_engine as be
    from star_tpu_torch.ops import device_stitch as ds
    from star_tpu_torch.ops import pipeline, tile_fetch
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
    dump = os.path.join(WORK, "dump")
    argv = ["--genomeDir", idx, "--readFilesIn", reads,
            "--outFileNamePrefix", out, "--outSAMunmapped", "Within",
            "--readMapNumber", str(N_READS), "--tpuBatchSize", str(N_READS)]
    P = Parameters(argv)
    if os.path.isdir(dump):
        for f in os.listdir(dump):
            os.remove(os.path.join(dump, f))
    os.environ["STAR_TPU_DUMP_STITCH"] = dump
    pipeline.TIMING = True
    reset_counts(ds, be, pipeline)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fetch, tile_fetch)       # counts of the main path
    t0 = time.time()
    try:
        stats = align_reads(P, gi=gi, device=DEVICE)
        torch.cuda.synchronize()
    finally:
        del os.environ["STAR_TPU_DUMP_STITCH"]
    wall = time.time() - t0
    launches = main_launches(fetch, tile_fetch)
    pipeline.TIMING = False
    peak = torch.cuda.max_memory_allocated()
    sl = stitch_launches(ds)
    per_phase = {"seed": launches["fetch_window"] - sum(sl.values()),
                 "grow": sl["fetch"], "finalize": sl["finalize"],
                 "pack": sl["pack"]}
    if min(per_phase["seed"], per_phase["grow"], per_phase["finalize"]) <= 0:
        raise AssertionError(f"full: a phase never launched fetch_window: "
                             f"{per_phase}")
    chunks = check_chunk_launches(ds, be, launches, "full")
    if stats.read_n != N_READS:
        raise AssertionError(f"full: {stats.read_n} reads aligned, "
                             f"expected {N_READS}")
    log(f"full: {N_READS} reads in {wall:.2f} s = {N_READS / wall:.1f} "
        f"reads/s (index upload included); fetch_window launches "
        f"{launches['fetch_window']} (seed loop {per_phase['seed']}, grow "
        f"{sl['fetch']}, finalize {sl['finalize']}, pack {sl['pack']}), "
        f"stitch_chunk {launches['stitch_chunk']} (per level: launches, "
        f"grow iterations {chunks}), fetch_rows {launches['fetch_rows']}, "
        f"tile_fetch {launches['tile_fetch']}; peak device memory {peak} B")
    log(f"full: phases {pipeline.timing_report()}")
    grow_report(ds, be, pipeline, "full")
    check_card_levels(ds, be, "full")
    lv = levels(be)
    gate = {w: be.DEVICE_GROW_MIN_RECORDS[s] for w, s, _ in be.LEVELS}
    for w, (runs, dev) in lv.items():
        want = runs if be.LEVEL_STATS[w, "records"] >= gate[w] else 0
        if dev != want:
            raise AssertionError(f"full: level W{w} grew on the card in {dev} "
                                 f"of {runs} runs, the gate ({gate[w]} seed "
                                 f"records) says {want}")
    if not any(dev for _, dev in lv.values()):
        raise AssertionError("full: no level grew on the card")
    for f in ("Aligned.out.sam", "SJ.out.tab"):
        os.replace(out + f, out + f + ".device")

    d = load_dump(gi, P, os.path.join(dump, sorted(os.listdir(dump))[0]))
    reach = level_reach(np, gi, P, d)
    replay = {"reads_s": N_READS / wall, "timers": dict(pipeline.TIMERS),
              "sweep": grow_sweep(np, gi, P, d, reach),
              "fetches": replay_fetches(torch, np, gi, P, d, fetch,
                                        per_phase),
              "chunks": chunk_replay(torch, np, gi, P, d, "full"),
              "finalize": finalize_replay(np, gi, P, d, reach, pipeline),
              "seed_in": (d["read_mat"], d["chains"])}
    del d

    # ---- 1,024 probes of the batch's reads vs the host oracle
    di = gi._device_cache[next(k for k in gi._device_cache
                               if k[0] != "stitch")]
    mmp = make_mmp_fn(di)
    qs, qlen = probe_set(np, reads, di.ql)
    got = np.stack([t.cpu().numpy() for t in mmp(
        torch.from_numpy(qs).to(DEVICE), torch.from_numpy(qlen).to(DEVICE))],
        axis=1)
    host = np.array([mmp_search(gi, qs[i, :qlen[i]]) for i in range(N_PROBES)])
    if not np.array_equal(got, host):
        bad = int((got != host).any(axis=1).sum())
        raise AssertionError(f"full: {bad} of {N_PROBES} probes differ from "
                             "the host oracle")
    log(f"full: {N_PROBES} probes equal the host mmp_search")
    recs = [(name, seqs[0]) for name, seqs, _, _ in
            itertools.islice(read_pairs([reads]), N_READS)]

    # ---- the first 256 reads vs the per-read host path
    out_h = os.path.join(WORK, "full_host") + "/"
    P2 = Parameters(["--genomeDir", idx, "--readFilesIn", reads,
                     "--outFileNamePrefix", out_h, "--outSAMunmapped", "Within",
                     "--readMapNumber", str(N_HOST_READS), "--tpuUseDevice", "0"])
    t0 = time.time()
    align_reads(P2, gi=gi)
    names = {n for n, _ in recs[:N_HOST_READS]}
    dev_lines = [l for l in strip_header(out + "Aligned.out.sam.device")
                 if l.split("\t", 1)[0] in names]
    host_lines = strip_header(out_h + "Aligned.out.sam")
    if dev_lines != host_lines or not host_lines:
        raise AssertionError("full: device SAM of the first reads differs "
                             "from the host path")
    log(f"full: first {N_HOST_READS} reads' SAM ({len(host_lines)} lines) "
        f"identical to --tpuUseDevice 0 ({time.time() - t0:.1f} s)")

    # ---- the batch's first reads again with the numpy engine on every level
    # (phase 5 holds the whole batch against the numpy engine)
    os.environ["STAR_TPU_DEVICE_STITCH"] = "0"
    pipeline.TIMING = True
    pipeline.TIMERS.clear()
    argv_np = argv[:argv.index("--readMapNumber")] + [
        "--readMapNumber", str(N_NUMPY_READS), "--tpuBatchSize", str(N_READS)]
    t0 = time.time()
    try:
        align_reads(Parameters(argv_np), gi=gi, device=DEVICE)
    finally:
        del os.environ["STAR_TPU_DEVICE_STITCH"]
        pipeline.TIMING = False
    wall_np = time.time() - t0
    log("full: numpy-engine run: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in sorted(pipeline.TIMERS.items())
        if k.startswith(("grow_", "finalize_", "stitch_level_"))))
    names = {n for n, _ in recs[:N_NUMPY_READS]}
    dev_lines = [l for l in strip_header(out + "Aligned.out.sam.device")
                 if l.split("\t", 1)[0] in names]
    np_lines = strip_header(out + "Aligned.out.sam")
    if dev_lines != np_lines or not np_lines:
        raise AssertionError("full: SAM of the device engine differs from "
                             "the numpy engine")
    log(f"full: the first {N_NUMPY_READS} reads' SAM ({len(np_lines)} lines) "
        f"byte-identical to the numpy-engine run of them (device engine "
        f"{wall:.2f} s = {N_READS / wall:.1f} reads/s for the batch, numpy "
        f"engine {wall_np:.2f} s = {N_NUMPY_READS / wall_np:.1f} reads/s)")
    return launches, replay


def bam_records(path):
    """the reference names of a BAM file's header and its records, from the
    decompressed stream (BGZF block boundaries are not compared)"""
    import gzip
    import struct
    with open(path, "rb") as f:
        data = gzip.decompress(f.read())
    if data[:4] != b"BAM\x01":
        raise AssertionError(f"{path}: not a BAM file")
    off = 8 + struct.unpack("<i", data[4:8])[0]
    n_ref = struct.unpack("<i", data[off:off + 4])[0]
    off += 4
    refs = []
    for _ in range(n_ref):
        ln = struct.unpack("<i", data[off:off + 4])[0]
        refs.append(data[off + 4:off + 4 + ln - 1])
        off += 4 + ln + 4
    recs = []
    while off < len(data):
        sz = struct.unpack("<I", data[off:off + 4])[0]
        recs.append(data[off + 4:off + 4 + sz])
        off += 4 + sz
    return refs, recs


def same_output(a, b, f):
    """file f of two output prefixes equal: SAM without its header, BAM as
    (reference names, records), anything else byte for byte"""
    if f.endswith(".bam"):
        return bam_records(a + f) == bam_records(b + f)
    if f.endswith(".sam"):
        return strip_header(a + f) == strip_header(b + f)
    with open(a + f, "rb") as x, open(b + f, "rb") as y:
        return x.read() == y.read()


class Spy:
    """wraps module attributes for the length of a with-block: each wrapper
    gets the real function first, then its arguments"""

    def __init__(self, *patches):
        self.patches = patches

    def __enter__(self):
        self.saved = []
        for mod, name, wrap in self.patches:
            real = getattr(mod, name)
            self.saved.append((mod, name, real))
            setattr(mod, name, lambda *a, _w=wrap, _r=real, **k:
                    _w(_r, *a, **k))
        return self

    def __exit__(self, *exc):
        for mod, name, real in reversed(self.saved):
            setattr(mod, name, real)


# the bundled goldens of the annotation layer: (golden, index, flags, files)
ANNOT_GOLDENS = [
    ("se_gtf", "genome_idx_gtf", ["--outSAMunmapped", "Within"],
     ["Aligned.out.sam", "SJ.out.tab"]),
    ("se_quant", "genome_idx_gtf",
     ["--outSAMunmapped", "Within", "--quantMode", "GeneCounts"],
     ["ReadsPerGene.out.tab", "SJ.out.tab"]),
    ("se_trsam", "genome_idx_gtf", ["--quantMode", "TranscriptomeSAM"],
     ["Aligned.toTranscriptome.out.bam"]),
    ("se_bam", "genome_idx",
     ["--outSAMunmapped", "Within",
      "--outSAMtype", "BAM", "Unsorted", "SortedByCoordinate"],
     ["Aligned.out.bam", "Aligned.sortedByCoord.out.bam"]),
    ("se_2pass", "genome_idx",
     ["--outSAMunmapped", "Within", "--twopassMode", "Basic"],
     ["Aligned.out.sam", "SJ.out.tab", "_STARpass1/SJ.out.tab"]),
]
ANNOT_GENES = 1000        # synthetic genes of the at-scale annotation
ANNOT_EXONS = 11          # exons per synthetic gene: 10 junctions each
ANNOT_FROM = 100_000      # first base of their loci (the reads come from the
                          # first 50 kb of chr1 and 35 kb of chr2)
TR_FILES = ("exonInfo.tab", "transcriptInfo.tab", "geneInfo.tab",
            "exonGeTrInfo.tab", "sjdbList.fromGTF.out.tab")


def annot_goldens(fetch):
    """the annotation layer's goldens on the card with the device stitch
    engine forced on every level; each case's fetch_window launches and the
    lanes that the grow's chunk kernel stitched across an annotated
    junction (its junction lookup or an annotated seed's join: the new
    junction's annotated flag)"""
    import shutil
    from star_tpu_torch.ops import batch_engine as be
    from star_tpu_torch.ops import device_stitch as ds
    from star_tpu_torch.params import Parameters
    from star_tpu_torch.run import align_reads
    found = []

    def chunk(real, *a):
        ok = real(*a)
        sc, (sc_out, _, sj_out) = a[9], a[16]
        nE = sc[:, ds.C_NEX]
        last = (nE - 1).clamp(0, ds.E - 1).long()
        annot = sj_out.gather(1, (last * 5 + ds.SJ_ANNOT)[:, None])[:, 0]
        grew = (nE > 0) & (sc_out[:, ds.C_NEX] > nE)
        found.append(int((ok & grew & (annot == 1)).sum()))
        return ok
    gate = be.DEVICE_GROW_MIN_RECORDS
    be.DEVICE_GROW_MIN_RECORDS = {s: 0 for _, s, _ in be.LEVELS}  # every level
    try:
        with Spy((ds, "stitch_chunk", chunk)):
            for gold, idx, flags, files in ANNOT_GOLDENS:
                out = os.path.join(WORK, "annot_" + gold) + "/"
                shutil.rmtree(out, ignore_errors=True)
                P = Parameters(["--genomeDir", os.path.join(GOLD, idx),
                                "--readFilesIn",
                                os.path.join(DATA, "reads_se.fastq"),
                                "--outFileNamePrefix", out, *flags])
                found.clear()
                n0 = fetch.LAUNCHES
                t0 = time.time()
                align_reads(P, device=DEVICE)
                for f in files:
                    if not same_output(out, os.path.join(GOLD, gold) + "/", f):
                        raise AssertionError(f"annot golden {gold}: {f} "
                                             "differs")
                if fetch.LAUNCHES == n0:
                    raise AssertionError(f"annot golden {gold}: no "
                                         "fetch_window launch")
                if idx != "genome_idx" or "--twopassMode" in flags:
                    if not found or sum(found) == 0:
                        raise AssertionError(f"annot golden {gold}: no lane "
                                             "found an annotated junction")
                log(f"annot: golden {gold}: {', '.join(files)} identical; "
                    f"{fetch.LAUNCHES - n0} fetch_window launches, "
                    f"{len(found)} grow chunks on the card, "
                    f"{sum(found)} lanes found an annotated junction, "
                    f"{time.time() - t0:.2f} s")
    finally:
        be.DEVICE_GROW_MIN_RECORDS = gate


def write_annotation(np, src, path, chr_len):
    """the generator's planted genes (src) and ANNOT_GENES synthetic genes
    of ANNOT_EXONS exons at random loci from ANNOT_FROM on, from a fixed
    seed.  Returns the number of distinct junctions written"""
    rng = np.random.default_rng(13)
    with open(src) as f:
        text = [f.read()]
    junctions = set()
    names = sorted(chr_len)
    for g in range(ANNOT_GENES):
        c = names[int(rng.integers(0, len(names)))]
        ex = rng.integers(50, 300, size=ANNOT_EXONS)
        intr = rng.integers(80, 5000, size=ANNOT_EXONS - 1)
        span = int(ex.sum() + intr.sum())
        s = int(rng.integers(ANNOT_FROM, chr_len[c] - span - 1000))
        strand = "+-"[int(rng.integers(0, 2))]
        gid = f"SG{g + 1}"
        attr = f'gene_id "{gid}"; transcript_id "{gid}.1";'
        text.append(f"{c}\tsynth\tgene\t{s + 1}\t{s + span}\t.\t{strand}\t.\t"
                    f'gene_id "{gid}";\n')
        text.append(f"{c}\tsynth\ttranscript\t{s + 1}\t{s + span}\t.\t"
                    f"{strand}\t.\t{attr}\n")
        p = s
        for i in range(ANNOT_EXONS):
            text.append(f"{c}\tsynth\texon\t{p + 1}\t{p + int(ex[i])}\t.\t"
                        f"{strand}\t.\t{attr}\n")
            p += int(ex[i])
            if i < ANNOT_EXONS - 1:
                junctions.add((c, p + 1, p + int(intr[i])))
                p += int(intr[i])
    with open(path, "w") as f:
        f.write("".join(text))
    return len(junctions) + 3


ANNOT_OUT = os.path.join(WORK, "annot") + "/"
ANNOT_NUMPY_OUT = os.path.join(WORK, "annot_numpy") + "/"


def annot_scale(torch, np, fetch, tile_fetch, idx, data):
    """a two-pass run of the chr20-scale batch with a GTF given at mapping
    time, GeneCounts, TranscriptomeSAM and both BAMs, through the port's
    entry point on the card; then a run of the same reads and flags with the
    numpy stitch engine on the index pass 2 mapped against (saved by
    --sjdbInsertSave All) is started in a process of its own, which
    annot_oracle holds.  Returns (the main run's launches, that process)"""
    import shutil
    from star_tpu_torch import run
    from star_tpu_torch.genome import native, sjdb
    from star_tpu_torch.genome.index import GenomeIndex
    from star_tpu_torch.ops import pipeline
    from star_tpu_torch.params import Parameters
    gi0 = GenomeIndex.load(idx)
    gtf = os.path.join(WORK, "annot_scale.gtf")
    n_sj = write_annotation(
        np, os.path.join(data, "annot.gtf"), gtf,
        {n: int(l) for n, l in zip(gi0.chr_name, gi0.chr_length)})
    del gi0
    out, out_np = ANNOT_OUT, ANNOT_NUMPY_OUT
    for d in (out, out_np):
        for x in ("", "_STARtmp", "_STARpass1", "_STARgenome"):
            shutil.rmtree(d + x if x else d, ignore_errors=True)
    reads = os.path.join(data, "reads_se.fastq")
    flags = ["--readFilesIn", reads, "--readMapNumber", str(N_READS),
             "--tpuBatchSize", str(N_READS), "--sjdbOverhang", "99",
             "--quantMode", "TranscriptomeSAM", "GeneCounts",
             "--outSAMtype", "BAM", "Unsorted", "SortedByCoordinate"]
    P = Parameters(["--genomeDir", idx, "--outFileNamePrefix", out,
                    "--sjdbGTFfile", gtf, "--twopassMode", "Basic",
                    "--sjdbInsertSave", "All", *flags])
    passes, inserts, branch = [], [], []

    def mapping(real, P_, gi, *a, **k):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = fetch.LAUNCHES
        t0 = time.time()
        stats = real(P_, gi, *a, **k)
        torch.cuda.synchronize()
        passes.append({"s": time.time() - t0, "reads": stats.read_n,
                       "launches": fetch.LAUNCHES - n0, "sjdb_n": gi.sjdb_n,
                       "peak": torch.cuda.max_memory_allocated()})
        return stats

    def insert(real, *a, **k):
        branch.append("full re-sort")
        t0 = time.time()
        gi = real(*a, **k)
        inserts.append((time.time() - t0, gi.sjdb_n, branch[-1]))
        return gi

    def positions(real, *a, **k):
        sa = real(*a, **k)
        if sa is not None:
            branch[-1] = "native rank merge"
        return sa

    pristine = []

    def pristine_timed(real, gi):
        t0 = time.time()
        base = real(gi)
        pristine.append((time.time() - t0, gi.sjdb_n))
        return base

    pipeline.TIMING = True
    pipeline.TIMERS.clear()
    reset_launches(fetch, tile_fetch)       # counts of this slice's main path
    t0 = time.time()
    try:
        with Spy((run, "_run_mapping", mapping),
                 (sjdb, "insert_junctions", insert),
                 (native, "sa_insert_positions", positions),
                 (run, "_pristine", pristine_timed)):
            run.align_reads(P, device=DEVICE)
        torch.cuda.synchronize()
    finally:
        pipeline.TIMING = False
    wall = time.time() - t0
    launches = main_launches(fetch, tile_fetch)
    t = pipeline.TIMERS
    log(f"annot: the annotation {gtf}: {ANNOT_GENES} synthetic genes of "
        f"{ANNOT_EXONS} exons and the 3 planted genes, {n_sj} distinct "
        "junctions")
    for i, (s, n, how) in enumerate(inserts):
        log(f"annot: insertion {i + 1}: {n} junctions in the index, "
            f"{how}, {s:.2f} s")
    for i, (s, n) in enumerate(pristine):
        log(f"annot: _pristine before insertion {i + 1}: an index of {n} "
            f"junctions, {s:.2f} s" + (" (no re-sort)" if n == 0 else
                                       " (whole suffix array re-sorted)"))
    for i, p in enumerate(passes):
        log(f"annot: pass {i + 1}: {p['reads']} reads in {p['s']:.2f} s = "
            f"{p['reads'] / p['s']:.1f} reads/s (index upload included), "
            f"{p['launches']} fetch_window launches, an index of "
            f"{p['sjdb_n']} junctions, peak device memory {p['peak']} B")
    log(f"annot: host stages (TIMERS): " + ", ".join(
        f"{k} {t[k]:.3f} s" for k in ("sjdb_insert", "pristine", "bam_encode",
                                      "quant", "bam_finish")))
    log(f"annot: two-pass run {wall:.2f} s; fetch_window launches "
        f"{launches['fetch_window']}, fetch_rows {launches['fetch_rows']}, "
        f"tile_fetch {launches['tile_fetch']}")

    if len(passes) != 2 or len(inserts) != 2 or len(pristine) != 2:
        raise AssertionError(f"annot: {len(passes)} passes, {len(inserts)} "
                             f"insertions, {len(pristine)} pristine calls")
    if min(p["launches"] for p in passes) <= 0:
        raise AssertionError("annot: a pass launched no fetch_window")
    if passes[0]["reads"] != passes[1]["reads"] or passes[1]["reads"] <= 0:
        raise AssertionError(f"annot: {passes[0]['reads']} reads in pass 1, "
                             f"{passes[1]['reads']} in pass 2")
    if not 0 < passes[0]["sjdb_n"] <= passes[1]["sjdb_n"]:
        raise AssertionError("annot: pass 2's index lost junctions of "
                             "pass 1's")

    # ---- the same reads and flags with the numpy engine, on pass 2's index,
    # beside phases 6-8
    gdir = out + "_STARgenome"
    for f in TR_FILES:
        shutil.copy(out + "_STARtmp/" + f, gdir)
    with open(out_np.rstrip("/") + ".log", "wb") as err:
        oracle = subprocess.Popen(
            [sys.executable, "-m", "star_tpu_torch", "--genomeDir", gdir,
             "--outFileNamePrefix", out_np, *flags], cwd=ROOT,
            env={**os.environ, "STAR_TPU_DEVICE_STITCH": "0"},
            stdout=subprocess.DEVNULL, stderr=err)
    oracle.t0 = time.time()
    return launches, oracle


def annot_oracle(oracle):
    """phase 5's check, held after phase 8: SJ.out.tab, both BAMs,
    ReadsPerGene.out.tab and the transcriptome BAM of the two-pass run
    identical to the numpy-engine run on pass 2's index"""
    if oracle.wait() != 0:
        with open(ANNOT_NUMPY_OUT.rstrip("/") + ".log") as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"annot: the numpy-engine run failed "
                             f"({oracle.returncode}):\n{tail}")
    t = time.time() - oracle.t0
    out, out_np = ANNOT_OUT, ANNOT_NUMPY_OUT
    files = ["SJ.out.tab", "Aligned.out.bam", "Aligned.sortedByCoord.out.bam",
             "ReadsPerGene.out.tab", "Aligned.toTranscriptome.out.bam"]
    for f in files:
        if not same_output(out, out_np, f):
            raise AssertionError(f"annot: {f} of the two-pass run differs "
                                 "from the numpy-engine run")
    n_rec = len(bam_records(out + "Aligned.out.bam")[1])
    n_tr = len(bam_records(out + "Aligned.toTranscriptome.out.bam")[1])
    log(f"annot: {', '.join(files)} identical to the numpy-engine run on "
        f"pass 2's index ({t:.2f} s, beside phases 6-8); {n_rec} BAM "
        f"records, {n_tr} transcriptome records")


WBAM = ["--outSAMtype", "BAM", "Unsorted"]
VCF = ["--outSAMtype", "BAM", "Unsorted",
       "--varVCFfile", os.path.join(DATA, "var.vcf")]
# the bundled goldens of the host-finished features: (golden, reads, flags,
# files); peov also runs with the device stitch engine forced, long on its
# host route
FUSION_GOLDENS = [
    ("se_chim", ["reads_chim.fastq"],
     ["--outSAMunmapped", "Within", "--chimSegmentMin", "12"],
     ["Chimeric.out.junction", "Aligned.out.sam"]),
    ("chim_mult", ["reads_chim.fastq"],
     ["--outSAMunmapped", "Within", "--chimSegmentMin", "20",
      "--chimMultimapNmax", "20", "--chimOutType", "Junctions"],
     ["Chimeric.out.junction", "Aligned.out.sam"]),
    ("chim_samold", ["reads_chim.fastq"],
     ["--outSAMunmapped", "Within", "--chimSegmentMin", "20",
      "--chimOutType", "SeparateSAMold"],
     ["Chimeric.out.sam"]),
    ("chim_wbam_old", ["reads_chim.fastq"],
     ["--outSAMunmapped", "Within", *WBAM, "--chimSegmentMin", "12",
      "--chimOutType", "WithinBAM",
      "--outSAMattributes", "NH", "HI", "AS", "nM", "ch"],
     ["Aligned.out.bam"]),
    ("chim_wbam_mult", ["reads_chim.fastq"],
     ["--outSAMunmapped", "Within", *WBAM, "--chimSegmentMin", "20",
      "--chimMultimapNmax", "20", "--chimOutType", "WithinBAM", "Junctions",
      "--outSAMattributes", "NH", "HI", "AS", "nM", "NM", "ch"],
     ["Aligned.out.bam"]),
    ("var", ["reads_se.fastq"],
     [*VCF, "--outSAMattributes", "NH", "HI", "AS", "nM", "vA", "vG"],
     ["Aligned.out.bam"]),
    ("wasp", ["reads_se.fastq"],
     [*VCF, "--outSAMattributes", "NH", "HI", "AS", "nM", "vA", "vG", "vW",
      "--waspOutputMode", "SAMtag"],
     ["Aligned.out.bam"]),
    ("peov", ["reads_peov_1.fastq", "reads_peov_2.fastq"],
     ["--outSAMunmapped", "Within", "--peOverlapNbasesMin", "10"],
     ["Aligned.out.sam", "SJ.out.tab"]),
    ("long", ["reads_long.fastq"],
     ["--outSAMunmapped", "Within", "--tpuLongReads", "1"],
     ["Aligned.out.sam", "SJ.out.tab"]),
]
# --genomeTransformType: (its index golden, its mapping golden, extra flags)
TRANSFORM_GOLDENS = {
    "Haploid": ("idx_transform_hap", "tf_hap", []),
    "Diploid": ("idx_transform_dip", "tf_dip",
                ["--outSAMattributes", "NH", "HI", "AS", "nM", "ha"])}
TRANSFORM_INDEX_FILES = ("transformGenomeBlocks.tsv", "chrStart.txt",
                         "chrLength.txt", "chrName.txt", "exonInfo.tab",
                         "transcriptInfo.tab", "geneInfo.tab",
                         "sjdbList.out.tab")
N_FUSION_PAIRS = 4096     # phase 6's pair set at the chr20 scale (halved
                          # to keep the script inside the card's 1,200 s)
N_FUSIONS = 16            # planted chr1-chr2 fusions in it
N_FUSION_HOST = 512       # its first pairs, held against the host oracle
LONG_ROUTE = "--tpuLongReads: long reads map on the host"


def transform_index(ttype, out):
    """the port's genomeGenerate of the small genome with transform.vcf"""
    from star_tpu_torch.run import main as star_main
    star_main(["--runMode", "genomeGenerate", "--genomeDir", out,
               "--genomeFastaFiles", os.path.join(DATA, "genome.fa"),
               "--genomeSAindexNbases", "8", "--genomeTransformType", ttype,
               "--genomeTransformVCF", os.path.join(DATA, "transform.vcf"),
               "--sjdbGTFfile", os.path.join(DATA, "annot.gtf"),
               "--sjdbOverhang", "99"])


def fusion_goldens(fetch):
    """phase 6 (a): the goldens of the host-finished features on the card:
    chimeric detection, SNP tags and WASP (the seed loop on the card, the
    stitch on the host), peov (the device stitch engine forced), long reads
    on their host route, and the genome transform (the port's
    genomeGenerate, then tf_hap / tf_dip with the device stitch engine
    forced); each case's fetch_window launches"""
    import shutil
    from star_tpu_torch.ops import batch_engine as be
    from star_tpu_torch.params import Parameters
    from star_tpu_torch.run import align_reads
    cases = [(g, r, f, x, os.path.join(GOLD, "genome_idx"), g == "peov")
             for g, r, f, x in FUSION_GOLDENS]
    for ttype, (gidx, gold, extra) in TRANSFORM_GOLDENS.items():
        idx = os.path.join(WORK, gidx)
        shutil.rmtree(idx, ignore_errors=True)
        t0 = time.time()
        transform_index(ttype, idx)
        for f in TRANSFORM_INDEX_FILES:
            if not same_output(idx + "/", os.path.join(GOLD, gidx) + "/", f):
                raise AssertionError(f"fusion: {gidx}: {f} differs")
        log(f"fusion: {gidx} built by the port's genomeGenerate: "
            f"{', '.join(TRANSFORM_INDEX_FILES)} identical "
            f"({time.time() - t0:.2f} s)")
        cases.append((gold, ["reads_se.fastq"],
                      ["--outSAMunmapped", "Within",
                       "--genomeTransformOutput", "SAM", *extra],
                      ["Aligned.out.sam", "SJ.out.tab"], idx, True))
    gate = be.DEVICE_GROW_MIN_RECORDS
    try:
        for gold, reads, flags, files, idx, forced in cases:
            be.DEVICE_GROW_MIN_RECORDS = (
                {s: 0 for _, s, _ in be.LEVELS} if forced else gate)
            out = os.path.join(WORK, "fusion_" + gold) + "/"
            shutil.rmtree(out, ignore_errors=True)
            P = Parameters(["--genomeDir", idx, "--readFilesIn",
                            *[os.path.join(DATA, r) for r in reads],
                            "--outFileNamePrefix", out, *flags])
            be.LEVEL_STATS.clear()
            n0 = fetch.LAUNCHES
            t0 = time.time()
            align_reads(P, device=DEVICE)
            for f in files:
                if not same_output(out, os.path.join(GOLD, gold) + "/", f):
                    raise AssertionError(f"fusion golden {gold}: {f} differs")
            n = fetch.LAUNCHES - n0
            on_card = sum(v for (w, k), v in be.LEVEL_STATS.items()
                          if k == "device")
            if gold == "long":
                with open(out + "Log.out") as f:
                    if n != 0 or LONG_ROUTE not in f.read():
                        raise AssertionError("fusion golden long: not on its "
                                             "logged host route")
            elif n == 0 or (forced and on_card == 0):
                raise AssertionError(f"fusion golden {gold}: {n} fetch_window "
                                     f"launches, {on_card} levels on the "
                                     "device stitch engine")
            log(f"fusion: golden {gold}: {', '.join(files)} identical; "
                f"{n} fetch_window launches"
                + (f", {on_card} levels on the device stitch engine"
                   if forced else "")
                + (" (host route, logged)" if gold == "long" else "")
                + f", {time.time() - t0:.2f} s")
    finally:
        be.DEVICE_GROW_MIN_RECORDS = gate


def junction_rows(path):
    """the chimeric junction rows of a Chimeric.out.junction file"""
    with open(path) as f:
        return [l.rstrip("\n").split("\t") for l in f
                if not l.startswith(("chr_donorA", "#"))]


def fusion_scale(torch, np, fetch, tile_fetch, idx, data):
    """phase 6 (b): fusion detection with STAR-Fusion's flags on the
    chr20-scale index: a seeded 2 x 100 pair set (fusion_pairs) mapped on the
    card through the port's entry point; every planted fusion must be
    reported in Chimeric.out.junction, and the set's first N_FUSION_HOST
    pairs, mapped again on the card and with the host oracle, must give the
    same SAM, SJ.out.tab and Chimeric.out.junction.  Returns the main run's
    launches"""
    import shutil
    from star_tpu_torch.align import chimeric, engine
    from star_tpu_torch.genome.index import GenomeIndex
    from star_tpu_torch.ops import device_stitch as ds
    from star_tpu_torch.ops import pipeline
    from star_tpu_torch.params import Parameters
    from star_tpu_torch.run import align_reads
    t0 = time.time()
    r1, r2 = (os.path.join(WORK, f"fusion_{m}.fastq") for m in (1, 2))
    fusions = fusion_pairs(np, os.path.join(data, "genome.fa"), r1, r2,
                           N_FUSION_PAIRS, N_FUSIONS, seed=17)
    gi = GenomeIndex.load(idx)
    log(f"fusion: {N_FUSION_PAIRS} pairs with {N_FUSIONS} planted fusions "
        f"made, index loaded ({time.time() - t0:.1f} s)")
    outs = {k: os.path.join(WORK, "fusion_" + k) + "/"
            for k in ("scale", "card", "host")}
    for d in outs.values():
        shutil.rmtree(d, ignore_errors=True)
    argv = lambda k, *x: Parameters(["--genomeDir", idx, "--readFilesIn", r1,
                                     r2, "--outFileNamePrefix", outs[k],
                                     *FUSION_FLAGS, *x])
    spent = {"chimeric": 0.0, "pe_merge": 0.0}
    merged = []

    def timed(key):
        def wrap(real, *a, **k):
            t = time.time()
            out = real(*a, **k)
            spent[key] += time.time() - t
            return out
        return wrap

    def merge(real, self, res, reads):
        t = time.time()
        real(self, res, reads)
        spent["pe_merge"] += time.time() - t
        merged.append(res.pe_ov_yes)

    pipeline.TIMING = True
    pipeline.TIMERS.clear()
    ds.GROW_STATS.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fetch, tile_fetch)       # counts of this slice's main path
    t0 = time.time()
    try:
        with Spy((chimeric, "detect_chimeric_mult", timed("chimeric")),
                 (chimeric, "detect_chimeric_old", timed("chimeric")),
                 (engine.ReadAligner, "_pe_overlap_merge_map", merge)):
            stats = align_reads(argv("scale"), gi=gi, device=DEVICE)
        torch.cuda.synchronize()
    finally:
        pipeline.TIMING = False
    wall = time.time() - t0
    launches = main_launches(fetch, tile_fetch)
    peak = torch.cuda.max_memory_allocated()
    t = pipeline.TIMERS
    rows = junction_rows(outs["scale"] + "Chimeric.out.junction")
    log(f"fusion: {stats.read_n} pairs in {wall:.2f} s = "
        f"{stats.read_n / wall:.1f} pairs/s (index upload included); "
        f"fetch_window launches {launches['fetch_window']} (all in the seed "
        f"loop: chimeric configs stitch on the host), fetch_rows "
        f"{launches['fetch_rows']}, tile_fetch {launches['tile_fetch']}; "
        f"peak device memory {peak} B")
    log(f"fusion: stages (TIMERS): " + ", ".join(
        f"{k} {t[k]:.3f} s" for k in ("prepare", "seed_loop", "replay",
                                      "finish") if k in t)
        + f"; of finish the PE-merge remap {spent['pe_merge']:.3f} s; "
        f"chimeric detection {spent['chimeric']:.3f} s")
    log(f"fusion: {stats.chimeric_all} chimeric reads "
        f"({len(rows)} junction rows), {sum(merged)} PE-merged reads (mates "
        f"merged, remapped and kept) of {len(merged)} pairs tried")
    if (stats.read_n != N_FUSION_PAIRS or launches["fetch_window"] <= 0
            or any(stitch_launches(ds).values())):
        raise AssertionError(f"fusion: {stats.read_n} pairs mapped, "
                             f"{launches['fetch_window']} launches, stitch "
                             f"engine {stitch_launches(ds)}")
    if sum(merged) == 0 or stats.chimeric_all == 0:
        raise AssertionError("fusion: no merged mates or no chimeric read")

    # ---- check 1: every planted fusion in Chimeric.out.junction, at its
    # breakpoint (the donor's first intron base, the acceptor's last), from
    # a read whose own sequence crosses it (junction type >= 1)
    seen = {}
    for r in rows:
        if int(r[6]) >= 1:
            key = frozenset({(r[0], int(r[1])), (r[3], int(r[4]))})
            seen[key] = seen.get(key, 0) + 1
    per = [seen.get(frozenset({(ca, a + 1), (cb, b - 1)}), 0)
           for ca, a, cb, b in fusions]
    if min(per) == 0:
        raise AssertionError(f"fusion: planted fusions without a junction "
                             f"row: {[f for f, n in zip(fusions, per) if not n]}")
    log(f"fusion: all {N_FUSIONS} planted fusions reported at their "
        f"breakpoints, {min(per)}-{max(per)} junction-crossing reads each")

    # ---- check 2: the first pairs on the card and with the host oracle
    sub = ["--readMapNumber", str(N_FUSION_HOST)]
    pipeline.TIMING = True
    pipeline.TIMERS.clear()
    t0 = time.time()
    try:
        align_reads(argv("card", *sub), gi=gi, device=DEVICE)
    finally:
        pipeline.TIMING = False
    t_card = time.time() - t0
    t0 = time.time()
    align_reads(argv("host", *sub, "--tpuUseDevice", "0"), gi=gi)
    t_host = time.time() - t0
    files = ["Aligned.out.sam", "SJ.out.tab", "Chimeric.out.junction"]
    for f in files:
        if not same_output(outs["card"], outs["host"], f):
            raise AssertionError(f"fusion: {f} of the first {N_FUSION_HOST} "
                                 "pairs differs from the host oracle")
    log(f"fusion: the first {N_FUSION_HOST} pairs' {', '.join(files)} "
        f"identical to the host oracle (--tpuUseDevice 0; card {t_card:.2f} "
        f"s ({', '.join(f'{k} {v:.3f}' for k, v in sorted(t.items()))}), "
        f"host {t_host:.2f} s, "
        f"{len(junction_rows(outs['host'] + 'Chimeric.out.junction'))} "
        "junction rows)")
    return launches



def pe_chunks(torch, np, fetch, tile_fetch, data):
    """phase 6 (c): the generator's 2 x 100 pairs (reads_pe_1 / _2.fastq,
    30 % across its planted introns) on phase 5's saved pass-2 index with
    the default flags and the device stitch engine forced on every level,
    so that it runs the mate join and the annotated junctions: pairs/s, one
    stitch_chunk launch per grow iteration, and the batch's chunks replayed against the plain version
    (chunk_replay).  Returns (the run's launches, the replay)"""
    import shutil
    from star_tpu_torch.genome.index import GenomeIndex
    from star_tpu_torch.ops import batch_engine as be
    from star_tpu_torch.ops import device_stitch as ds
    from star_tpu_torch.ops import pipeline
    from star_tpu_torch.params import Parameters
    from star_tpu_torch.run import align_reads
    idx = ANNOT_OUT + "_STARgenome"
    out = os.path.join(WORK, "pe_annot") + "/"
    dump = os.path.join(WORK, "dump_pe")
    for x in (out, dump):
        shutil.rmtree(x, ignore_errors=True)
    gi = GenomeIndex.load(idx)
    P = Parameters(["--genomeDir", idx, "--readFilesIn",
                    *(os.path.join(data, f"reads_pe_{m}.fastq")
                      for m in (1, 2)),
                    "--outFileNamePrefix", out, "--outSAMtype", "None",
                    "--tpuBatchSize", str(N_READS)])
    reset_counts(ds, be, pipeline)
    reset_launches(fetch, tile_fetch)       # counts of this slice's main path
    os.environ["STAR_TPU_DUMP_STITCH"] = dump
    gate = be.DEVICE_GROW_MIN_RECORDS
    be.DEVICE_GROW_MIN_RECORDS = {s: 0 for _, s, _ in be.LEVELS}  # every level
    t0 = time.time()
    try:
        stats = align_reads(P, gi=gi, device=DEVICE)
        torch.cuda.synchronize()
    finally:
        del os.environ["STAR_TPU_DUMP_STITCH"]
        be.DEVICE_GROW_MIN_RECORDS = gate
    wall = time.time() - t0
    launches = main_launches(fetch, tile_fetch)
    chunks = check_chunk_launches(ds, be, launches, "pe")
    log(f"pe: {stats.read_n} pairs on the annotated index ({gi.sjdb_n} "
        f"junctions) in {wall:.2f} s = {stats.read_n / wall:.1f} pairs/s "
        f"(no output); levels {levels(be)}; stitch_chunk "
        f"{launches['stitch_chunk']} (per level: launches, grow iterations "
        f"{chunks}), fetch_window {launches['fetch_window']}")
    d = load_dump(gi, P, os.path.join(dump, sorted(os.listdir(dump))[0]))
    return launches, chunk_replay(torch, np, gi, P, d, "pe",
                                  need=("joins", "found", "mates"))


# ---- phase 7: STARsolo
TESTS = os.path.join(ROOT, "tests")
S3 = os.path.join(TESTS, "data", "solo3")
SC = os.path.join(TESTS, "data", "soloC")
SOLO_BC = ["--soloCBstart", "1", "--soloCBlen", "16", "--soloUMIstart", "17",
           "--soloUMIlen", "12"]
SMALL_SOLO = ["--readFilesIn", os.path.join(DATA, "solo_cdna.fastq"),
              os.path.join(DATA, "solo_bc.fastq"), "--soloType",
              "CB_UMI_Simple", "--soloCBwhitelist",
              os.path.join(DATA, "solo_wl.txt"), *SOLO_BC]
SOLO3 = ["--readFilesIn", os.path.join(S3, "cdna.fastq"),
         os.path.join(S3, "bc.fastq"), "--soloType", "CB_UMI_Simple",
         "--soloCBwhitelist", os.path.join(S3, "wl.txt"), *SOLO_BC,
         "--outSAMtype", "None"]
SOLO_COMPLEX = ["--readFilesIn", os.path.join(SC, "cdna.fastq"),
                os.path.join(SC, "bc.fastq"), "--soloType", "CB_UMI_Complex",
                "--soloCBwhitelist", os.path.join(SC, "wl1.txt"),
                os.path.join(SC, "wl2.txt"),
                "--soloCBposition", "0_0_2_-1", "3_1_3_8",
                "--soloUMIposition", "3_9_3_14",
                "--soloAdapterSequence", "GAGTGATTGCTT",
                "--outSAMtype", "None", "--soloCellFilter", "TopCells", "6"]
SOLO_ATTRS = ["--outSAMattributes", "NH", "HI", "AS", "nM", "CR", "CY", "UR",
              "UY", "GX", "GN"]
IDX_GTF = os.path.join(GOLD, "genome_idx_gtf")
IDX_S3 = os.path.join(TESTS, "golden", "solo3", "idx")
SOLO_ED_INDEX = "solo_ed"      # built by solo_ed_index (genome.fa + annot2.gtf)
# the STARsolo goldens: (case, golden directory under tests/golden, index,
# flags, files).  A file ending in "/" is a tree, compared file by file; a
# pair is (output, golden) where their names differ.
SOLO_GOLDENS = [
    ("solo", "small/solo", IDX_GTF, [*SMALL_SOLO, "--outSAMtype", "None"],
     ["Solo.out/"]),
    ("solo3_dedup", "solo3/dedup", IDX_S3,
     [*SOLO3, "--soloCellFilter", "TopCells", "8", "--soloUMIdedup",
      "NoDedup", "Exact", "1MM_All", "1MM_Directional", "1MM_CR",
      "1MM_Directional_UMItools"], ["Solo.out/"]),
    ("solo3_mm", "solo3/mm", IDX_S3,
     [*SOLO3, "--soloCellFilter", "TopCells", "8", "--soloMultiMappers",
      "Uniform", "Rescue", "PropUnique", "EM", "--soloCellReadStats",
      "Standard"], ["Solo.out/"]),
    ("solo3_mgumi", "solo3/mgumi", IDX_S3,
     [*SOLO3, "--soloCellFilter", "TopCells", "8", "--soloUMIfiltering",
      "MultiGeneUMI"], ["Solo.out/"]),
    ("solo3_mgumicr", "solo3/mgumicr", IDX_S3,
     [*SOLO3, "--soloCellFilter", "TopCells", "8", "--soloUMIfiltering",
      "MultiGeneUMI_CR", "--soloUMIdedup", "1MM_CR"], ["Solo.out/"]),
    ("solo_ed", "small/solo_ed", SOLO_ED_INDEX,
     ["--readFilesIn", os.path.join(DATA, "solo2_cdna.fastq"),
      os.path.join(DATA, "solo2_bc.fastq"), "--soloType", "CB_UMI_Simple",
      "--soloCBwhitelist", os.path.join(DATA, "solo2_wl.txt"), *SOLO_BC,
      "--outSAMtype", "None", "--soloCellFilter", "EmptyDrops_CR", "60",
      "0.99", "10", "100", "400", "10", "0.01", "200", "0.01", "300"],
     ["Solo.out/"]),
    ("solo_feat", "small/solo_feat", IDX_GTF,
     [*SMALL_SOLO, "--outSAMtype", "None", "--soloFeatures", "Gene",
      "GeneFull", "GeneFull_ExonOverIntron", "GeneFull_Ex50pAS", "SJ",
      "Velocyto", "--soloCellReadStats", "Standard"], ["Solo.out/"]),
    ("solo_tags", "small/solo_tags", IDX_GTF,
     [*SMALL_SOLO, "--outSAMtype", "BAM", "SortedByCoordinate",
      *SOLO_ATTRS, "CB", "UB"],
     ["Aligned.sortedByCoord.out.bam", "Solo.out/"]),
    ("solo_tags_unsorted", "small/solo_tags", IDX_GTF,
     [*SMALL_SOLO, "--outSAMtype", "BAM", "Unsorted", "--outSAMunmapped",
      "Within", *SOLO_ATTRS, "gx", "gn"],
     [("Aligned.out.bam", "un_Aligned.out.bam")]),
    ("cb_samtag", "small/cb_samtag", IDX_GTF,
     ["--readFilesIn", os.path.join(DATA, "solo_cdna.fastq"),
      os.path.join(DATA, "solo_bc.fastq"), "--soloType", "CB_samTagOut",
      "--soloCBwhitelist", os.path.join(DATA, "solo_wl.txt"), *SOLO_BC,
      "--soloCBmatchWLtype", "1MM", "--outSAMattributes", "NH", "HI", "AS",
      "nM", "CR", "CY", "CB", "--outSAMtype", "BAM", "Unsorted",
      "--outSAMunmapped", "Within"], ["Aligned.out.bam"]),
    ("soloC_mm1", "soloC/mm1", IDX_S3,
     [*SOLO_COMPLEX, "--soloCBmatchWLtype", "1MM"], ["Solo.out/"]),
    ("soloC_exact", "soloC/exact", IDX_S3,
     [*SOLO_COMPLEX, "--soloCBmatchWLtype", "Exact"], ["Solo.out/"]),
    ("soloC_ed2", "soloC/ed2", IDX_S3,
     [*SOLO_COMPLEX, "--soloCBmatchWLtype", "EditDist_2"], ["Solo.out/"]),
    ("smartseq", "smartseq", IDX_GTF,
     ["--readFilesManifest",
      os.path.join(TESTS, "data", "smartseq", "manifest.tsv"),
      "--soloType", "SmartSeq", "--soloUMIdedup", "Exact", "NoDedup",
      "--soloStrand", "Unstranded", "--soloFeatures", "Gene",
      "--soloCellFilter", "None", "--outSAMtype", "None"], ["Solo.out/"]),
    ("solo3_tr3p", "solo3/tr3p", IDX_S3,
     [*SOLO3, "--soloFeatures", "Gene", "Transcript3p", "--soloCellFilter",
      "None", "--soloClusterCBfile", os.path.join(S3, "clusters.tsv")],
     [("Solo.out/Transcript3p/" + f, f) for f in
      ("matrix.mtx", "features.tsv",
       "transcriptEndDistanceDistribution.txt")]),
]
# --runMode soloCellFiltering of solo3/mgumi's raw matrix (EmptyDrops_CR)
SOLO_CELLFILT = ["--soloCellFilter", "EmptyDrops_CR", "8", "0.99", "10", "100",
                 "400", "10", "0.01", "200", "0.01", "300"]


def solo_ed_index(out):
    """the solo_ed golden's index: the port's genomeGenerate of the small
    genome with annot2.gtf"""
    from star_tpu_torch.run import main as star_main
    star_main(["--runMode", "genomeGenerate", "--genomeDir", out,
               "--genomeFastaFiles", os.path.join(DATA, "genome.fa"),
               "--genomeSAindexNbases", "8", "--sjdbGTFfile",
               os.path.join(DATA, "annot2.gtf"), "--sjdbOverhang", "79"])


def file_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def golden_file(path):
    """path, or, for a golden symlink into a checkout's tests/golden
    (Solo.out/SJ/raw/features.tsv links to its run's SJ.out.tab by an
    absolute path), the same file in this checkout, whether or not the
    link's own target exists"""
    if os.path.islink(path):
        target = os.readlink(path)
        if "/tests/golden/" in target:
            return os.path.join(TESTS, "golden",
                                target.split("/tests/golden/", 1)[1])
    return path


def tree_diff(a, b):
    """the files of tree b that are missing from tree a or differ"""
    out = []
    for root, _, files in os.walk(b):
        for fn in sorted(files):
            rel = os.path.relpath(os.path.join(root, fn), b)
            if not os.path.exists(os.path.join(a, rel)):
                out.append(rel + " (missing)")
            elif file_bytes(os.path.join(a, rel)) != \
                    file_bytes(golden_file(os.path.join(b, rel))):
                out.append(rel)
    return out


def solo_diff(out, gold, files):
    """the files of a solo case's output prefix that differ from its golden
    (trees file by file, BAMs record for record)"""
    bad = []
    for f in files:
        o, g = f if isinstance(f, tuple) else (f, f)
        if o.endswith("/"):
            bad += [o + x for x in tree_diff(out + o, os.path.join(gold, g))]
        elif not os.path.exists(out + o) or not (
                bam_records(out + o) == bam_records(os.path.join(gold, g))
                if o.endswith(".bam") else
                file_bytes(out + o) == file_bytes(os.path.join(gold, g))):
            bad.append(o)
    return bad


def solo_cellfilt(out):
    """--runMode soloCellFiltering through the port's main on solo3/mgumi's
    raw matrix; the files that differ from the cellfilt golden"""
    from star_tpu_torch.run import main as star_main
    gold = os.path.join(TESTS, "golden", "solo3")
    star_main(["--runMode", "soloCellFiltering",
               os.path.join(gold, "mgumi", "Solo.out", "Gene", "raw"),
               out + "out_", *SOLO_CELLFILT, "--outFileNamePrefix",
               out + "log_"])
    return [f for f in ("barcodes.tsv", "features.tsv", "matrix.mtx")
            if file_bytes(out + "out_" + f)
            != file_bytes(os.path.join(gold, "cellfilt", "out_" + f))]



N_SOLO_READS = 32768      # phase 7's cDNA reads: two full tpuBatchSize batches
N_SOLO_ORACLE = 4096      # its first reads, held against the numpy engine
N_SOLO_HOST = 1024        # its first reads, held against the host oracle
SOLO_CELLS = 1000         # cells of the single-cell run
SOLO_AMBIENT = 5000       # other whitelist barcodes, holding ambient reads
SOLO_WL = 20000           # whitelist size
SOLO_TYPES = 8            # cell types, each with its own gene profile
SOLO_CDNA = 91            # read 2 of 10x Chromium v3
SOLO_TAIL = 1000          # the transcript bases the cDNA reads come from (3')
SOLO_TSO_SHARE = 0.10     # cDNA reads starting with a template-switch oligo
SOLO_POLYA_SHARE = 0.05   # cDNA reads ending in a polyA tail
SOLO_SIM_N = 10000        # EmptyDrops_CR Monte-Carlo simulations (Cell Ranger's)
# STARsolo's documented flags for matching Cell Ranger 4.x / 5.x (STARsolo
# README, "Matching CellRanger 4.x.x and 5.x.x results") with Gene and
# GeneFull; EmptyDrops_CR is given its parameters so that its ambient window
# (indMin, indMax) lies inside the generated barcodes and its umiMin below
# the simple filter's cut at ~28 reads a cell (Cell Ranger's: 45,000, 90,000
# and 500, for runs of thousands of reads a cell)
SOLO_CR4_FLAGS = [
    "--soloType", "CB_UMI_Simple", "--soloUMIlen", "12",
    "--soloCBmatchWLtype", "1MM_multi_Nbase_pseudocounts",
    "--soloUMIfiltering", "MultiGeneUMI_CR", "--soloUMIdedup", "1MM_CR",
    "--clipAdapterType", "CellRanger4", "--outFilterScoreMin", "30",
    "--soloFeatures", "Gene", "GeneFull",
    "--soloCellFilter", "EmptyDrops_CR", str(SOLO_CELLS), "0.99", "10",
    "1500", "6000", "5", "0.01", "20000", "0.01", str(SOLO_SIM_N),
    "--outSAMattributes", "NH", "HI", "nM", "AS", "CR", "UR", "CB", "UB",
    "GX", "GN", "--outSAMtype", "BAM", "SortedByCoordinate"]


def solo_reads(np, genome_fa, gtf, out_cdna, out_bc, out_wl, n_reads, seed):
    """a seeded 10x Chromium v3 run over the synthetic genes of gtf (source
    'synth'), written as FASTQ (cDNA read 2 to out_cdna, 28-base barcode
    read 1 to out_bc) with its whitelist (out_wl).  The cDNA reads
    (SOLO_CDNA bases, 1 % substituted) are in the gene's sense, from the
    last SOLO_TAIL transcript bases (3'-biased, spliced across exons); 5 %
    are intronic and 5 % intergenic.  85 % of the reads come from
    SOLO_CELLS cells of log-normal sizes, each of one of SOLO_TYPES types
    with its own gene profile; 15 % are ambient, spread over SOLO_AMBIENT
    other whitelist barcodes with the types' mixed profile.  20 % of a
    barcode's reads repeat one of its molecules (same UMI, gene and
    position; a quarter of them with one UMI base changed).  Of the cDNA
    reads, SOLO_TSO_SHARE start with the last 20-30 bases of the 10x
    template-switch oligo and SOLO_POLYA_SHARE end in 20-40 As, the
    artefacts --clipAdapterType CellRanger4 clips.  3 % of the CBs carry
    one substitution and 0.5 % an N.  Returns counts of the kinds"""
    import bisect
    from star_tpu_torch.align.clip import CR4_TSO
    rng = np.random.default_rng(seed)
    chrs = read_fasta(genome_fa)
    comp = str.maketrans("ACGTN", "TGCAN")
    rc = lambda x: x.translate(comp)[::-1]
    genes = {}
    with open(gtf) as f:
        for line in f:
            c = line.split("\t")
            if len(c) > 8 and c[1] == "synth" and c[2] == "exon":
                g = genes.setdefault(c[8].split('"')[1], (c[0], c[6], []))
                g[2].append((int(c[3]) - 1, int(c[4])))
    tx, introns, spans = [], [], {}
    for c, strand, ex in genes.values():
        t = "".join(chrs[c][a:b] for a, b in ex)
        ins = [(ex[i][1], ex[i + 1][0]) for i in range(len(ex) - 1)
               if ex[i + 1][0] - ex[i][1] >= SOLO_CDNA]
        tx.append((t if strand == "+" else rc(t), strand))
        introns.append((c, strand, ins))
        spans.setdefault(c, []).append((ex[0][0], ex[-1][1]))
    for c in spans:
        spans[c].sort()
    n_genes = len(tx)
    pop = rng.lognormal(0.0, 1.0, n_genes)
    prof = pop[None, :] * rng.lognormal(0.0, 1.5, (SOLO_TYPES, n_genes))
    cum = np.cumsum(prof / prof.sum(1, keepdims=True), axis=1)
    wl = set()
    while len(wl) < SOLO_WL:
        wl.add("".join("ACGT"[i] for i in rng.integers(0, 4, 16)))
    wl = sorted(wl)
    order = rng.permutation(SOLO_WL)
    cells = [wl[i] for i in order[:SOLO_CELLS]]
    ambient = [wl[i] for i in order[SOLO_CELLS:SOLO_CELLS + SOLO_AMBIENT]]
    ctype = rng.integers(0, SOLO_TYPES, SOLO_CELLS)
    csize = np.cumsum(rng.lognormal(0.0, 0.8, SOLO_CELLS))
    csize /= csize[-1]
    names = sorted(chrs)

    def molecule(t):
        """(kind, sequence) of a new molecule of a cell of type t"""
        u = rng.random()
        if u < 0.95:
            g = min(int(np.searchsorted(cum[t], rng.random())), n_genes - 1)
            if u < 0.90:
                seq = tx[g][0][-SOLO_TAIL:]
                p = int(rng.integers(0, len(seq) - SOLO_CDNA + 1))
                return "exonic", seq[p:p + SOLO_CDNA]
            c, strand, ins = introns[g]
            if ins:
                a, b = ins[int(rng.integers(0, len(ins)))]
                p = int(rng.integers(a, b - SOLO_CDNA + 1))
                seq = chrs[c][p:p + SOLO_CDNA]
                return "intronic", seq if strand == "+" else rc(seq)
        while True:                    # intergenic: outside every gene span
            c = names[int(rng.integers(0, len(names)))]
            p = int(rng.integers(0, len(chrs[c]) - SOLO_CDNA))
            sp = spans.get(c, [])
            k = bisect.bisect_right(sp, (p + SOLO_CDNA, 1 << 62))
            if all(b <= p for _, b in sp[max(0, k - 30):k]):
                seq = chrs[c][p:p + SOLO_CDNA]
                return "intergenic", seq if rng.random() < 0.5 else rc(seq)

    def mutate(x, rate):
        x = np.frombuffer(x.encode(), np.uint8).copy()
        hit = rng.random(len(x)) < rate
        x[hit] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4,
                                                                hit.sum())]
        return x.tobytes().decode()

    def one_off(x, base=None):
        """x with one base changed (to base, or to another nucleotide)"""
        j = int(rng.integers(0, len(x)))
        b = base or "ACGT".replace(x[j], "")[int(rng.integers(0, 3))]
        return x[:j] + b + x[j + 1:]
    made = {"exonic": 0, "intronic": 0, "intergenic": 0, "repeat": 0,
            "cell": 0, "ambient": 0, "cb_mm": 0, "cb_n": 0, "tso": 0,
            "polya": 0}
    mols = {}
    with open(out_cdna, "w") as fc, open(out_bc, "w") as fb:
        for i in range(n_reads):
            if rng.random() < 0.85:
                k = min(int(np.searchsorted(csize, rng.random())),
                        SOLO_CELLS - 1)
                cb, t = cells[k], int(ctype[k])
                made["cell"] += 1
            else:
                cb = ambient[int(rng.integers(0, SOLO_AMBIENT))]
                t = int(rng.integers(0, SOLO_TYPES))
                made["ambient"] += 1
            seen = mols.setdefault(cb, [])
            if seen and rng.random() < 0.2:
                kind, seq, umi = seen[int(rng.integers(0, len(seen)))]
                made["repeat"] += 1
                if rng.random() < 0.25:
                    umi = one_off(umi)
            else:
                kind, seq = molecule(t)
                umi = "".join("ACGT"[j] for j in rng.integers(0, 4, 12))
                seen.append((kind, seq, umi))
            made[kind] += 1
            u = rng.random()
            if u < 0.005:
                cb = one_off(cb, "N")
                made["cb_n"] += 1
            elif u < 0.035:
                cb = one_off(cb)
                made["cb_mm"] += 1
            if rng.random() < SOLO_TSO_SHARE:
                k = int(rng.integers(20, 31))
                seq = CR4_TSO[-k:] + seq[:SOLO_CDNA - k]
                made["tso"] += 1
            if rng.random() < SOLO_POLYA_SHARE:
                k = int(rng.integers(20, 41))
                seq = seq[:SOLO_CDNA - k] + "A" * k
                made["polya"] += 1
            fc.write(f"@solo{i}\n{mutate(seq, 0.01)}\n+\n{'F' * SOLO_CDNA}\n")
            fb.write(f"@solo{i}\n{cb}{umi}\n+\n{'F' * 28}\n")
    with open(out_wl, "w") as f:
        f.write("".join(w + "\n" for w in wl))
    return made


def summary(path):
    """{row: value} of a Solo.out Summary.csv"""
    with open(path) as f:
        return dict(l.rstrip("\n").split(",", 1) for l in f if "," in l)


def mtx_entries(path):
    """the non-zero entries a Matrix Market file declares"""
    with open(path) as f:
        rows = [l for l in f if not l.startswith("%")]
    return int(rows[0].split()[2])


def mc_kernel(torch, mc_null, inputs):
    """each captured call of mc_null.null_histogram (the 10x run's Gene and
    GeneFull) launched again: the kernel against the plain version on the
    CPU (exact), the kernel's device time beside one simulation alone (the
    serial chain that bounds it), the plain version's host time on the CPU
    and its device time on the card.  Returns the kernel table's entry"""
    rows = []
    for a in inputs:
        *tens, sim_n = a
        cpu = [t.cpu() for t in tens]
        got = mc_null.null_histogram(*tens, sim_n)
        torch.cuda.synchronize()
        t0 = time.time()
        want = mc_null.null_histogram(*cpu, sim_n)
        plain_cpu_s = time.time() - t0
        if not torch.equal(got.cpu(), want):
            raise AssertionError("mc_null kernel differs from its plain "
                                 f"version at {len(cpu[0])} genes")
        ms = cuda_ms(lambda: mc_null.null_histogram(*tens, sim_n))
        chain_ms = cuda_ms(lambda: mc_null.null_histogram(*tens, 1))
        plain_ms = cuda_ms(lambda: mc_null._null_histogram_torch(*tens, sim_n),
                           iters=2, warm=1)
        shape = {"genes": tens[0].numel(), "max_count": tens[2].numel() - 1,
                 "groups": tens[3].numel(), "candidates": tens[5].numel(),
                 "sim_n": sim_n}
        log(f"kernel mc_null: {shape}: identical to the plain version; "
            f"{ms:.4f} ms (one simulation alone {chain_ms:.4f} ms; plain on "
            f"the card {plain_ms:.2f} ms, on the CPU {plain_cpu_s * 1e3:.2f} "
            f"ms)")
        rows.append({**shape, "ms": ms, "chain_ms": chain_ms,
                     "plain_ms": plain_ms, "plain_cpu_ms": plain_cpu_s * 1e3})
    return rows


def solo_goldens(fetch):
    """phase 7 (a): every STARsolo golden on the card with the device
    stitch engine forced on every level, then --runMode soloCellFiltering
    through the port's main; each case's fetch_window launches"""
    import shutil
    from star_tpu_torch.ops import batch_engine as be
    from star_tpu_torch.params import Parameters
    from star_tpu_torch.run import align_reads
    from star_tpu_torch.solo import mc_null
    ed = os.path.join(WORK, "solo_ed_idx")
    shutil.rmtree(ed, ignore_errors=True)
    solo_ed_index(ed)
    gate = be.DEVICE_GROW_MIN_RECORDS
    be.DEVICE_GROW_MIN_RECORDS = {s: 0 for _, s, _ in be.LEVELS}  # every level
    try:
        for case, gold, idx, flags, files in SOLO_GOLDENS:
            out = os.path.join(WORK, "solo_" + case) + "/"
            shutil.rmtree(out, ignore_errors=True)
            P = Parameters(["--genomeDir", ed if idx == SOLO_ED_INDEX else idx,
                            "--outFileNamePrefix", out, *flags])
            be.LEVEL_STATS.clear()
            n0 = fetch.LAUNCHES
            mc0 = mc_null.LAUNCHES
            t0 = time.time()
            align_reads(P, device=DEVICE)
            bad = solo_diff(out, os.path.join(TESTS, "golden", gold), files)
            if bad:
                raise AssertionError(f"solo golden {case}: {bad} differ")
            mc = mc_null.LAUNCHES - mc0
            if mc != (1 if "EmptyDrops_CR" in flags else 0):
                raise AssertionError(f"solo golden {case}: {mc} launches of "
                                     "the EmptyDrops_CR kernel")
            n = fetch.LAUNCHES - n0
            on_card = sum(v for (w, k), v in be.LEVEL_STATS.items()
                          if k == "device")
            if n == 0 or on_card == 0:
                raise AssertionError(f"solo golden {case}: {n} fetch_window "
                                     f"launches, {on_card} levels on the "
                                     "device stitch engine")
            log(f"solo: golden {case}: "
                f"{', '.join(f if isinstance(f, str) else f[0] for f in files)} "
                f"identical; {n} fetch_window launches, {on_card} levels on "
                f"the device stitch engine, {mc} EmptyDrops_CR kernel "
                f"launches, {time.time() - t0:.2f} s")
    finally:
        be.DEVICE_GROW_MIN_RECORDS = gate
    out = os.path.join(WORK, "solo_cellfilt") + "/"
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    bad = solo_cellfilt(out)
    if bad:
        raise AssertionError(f"solo: soloCellFiltering: {bad} differ")
    log("solo: --runMode soloCellFiltering (main): barcodes.tsv, "
        "features.tsv, matrix.mtx identical")


def solo_scale(torch, np, fetch, tile_fetch, data):
    """phase 7 (b): a 10x Chromium v3 run (solo_reads) with Cell Ranger 4's
    STARsolo flags on phase 5's saved pass-2 index, through the port's entry
    point on the card; then its first N_SOLO_ORACLE reads mapped on the card
    (stitch engine forced) and with the numpy engine must give the same
    Solo.out tree and sorted BAM records, their prepare must clip alike with
    the TSO clip of the batch and read by read, and the first N_SOLO_HOST
    reads mapped on the card must equal the host oracle's.  Returns the
    main run's launches"""
    import shutil
    from star_tpu_torch.genome.index import GenomeIndex
    from star_tpu_torch.ops import batch_engine as be
    from star_tpu_torch.ops import device_stitch as ds
    from star_tpu_torch.ops import pipeline
    from star_tpu_torch.params import Parameters
    from star_tpu_torch.run import align_reads
    from star_tpu_torch.solo import emptydrops, mc_null
    idx = os.path.join(WORK, "annot") + "/_STARgenome"
    t0 = time.time()
    cdna, bc, wl = (os.path.join(WORK, f) for f in
                    ("solo_cdna.fastq", "solo_bc.fastq", "solo_wl.txt"))
    made = solo_reads(np, os.path.join(data, "genome.fa"),
                      os.path.join(WORK, "annot_scale.gtf"), cdna, bc, wl,
                      N_SOLO_READS, seed=19)
    gi = GenomeIndex.load(idx)
    log(f"solo: {N_SOLO_READS} reads of {SOLO_CELLS} cells and "
        f"{SOLO_AMBIENT} ambient barcodes made ({made}), index loaded "
        f"({time.time() - t0:.1f} s)")
    outs = {k: os.path.join(WORK, "solo_" + k) + "/"
            for k in ("scale", "card", "numpy", "first", "host")}
    for d in outs.values():
        shutil.rmtree(d, ignore_errors=True)
    argv = lambda k, *x: Parameters(["--genomeDir", idx, "--readFilesIn",
                                     cdna, bc, "--soloCBwhitelist", wl,
                                     "--outFileNamePrefix", outs[k],
                                     "--tpuBatchSize",
                                     str(N_SOLO_READS // 2),
                                     *SOLO_CR4_FLAGS, *x])
    ed = {"sims": 0, "s": 0.0, "called": 0, "inputs": []}

    def null(real, *a):
        ed["sims"] += a[6]
        ed["inputs"].append(a)
        return real(*a)

    def ed_proc(real, *a, **k):
        t = time.time()
        out = real(*a, **k)
        ed["s"] += time.time() - t
        ed["called"] += int(out.sum() - a[1].sum())
        return out

    dump = os.path.join(WORK, "dump_solo")
    shutil.rmtree(dump, ignore_errors=True)
    os.environ["STAR_TPU_DUMP_STITCH"] = dump
    pipeline.TIMING = True
    reset_counts(ds, be, pipeline)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fetch, tile_fetch)       # counts of this slice's main path
    mc0 = mc_null.LAUNCHES
    t0 = time.time()
    try:
        with Spy((mc_null, "null_histogram", null),
                 (emptydrops, "empty_drops_cr_proc", ed_proc)):
            stats = align_reads(argv("scale"), gi=gi, device=DEVICE)
        torch.cuda.synchronize()
    finally:
        pipeline.TIMING = False
        del os.environ["STAR_TPU_DUMP_STITCH"]
    wall = time.time() - t0
    launches = {**main_launches(fetch, tile_fetch),
                "mc_null": mc_null.LAUNCHES - mc0}
    peak = torch.cuda.max_memory_allocated()
    t = pipeline.TIMERS
    sl = stitch_launches(ds)
    lv = levels(be)
    log(f"solo: {stats.read_n} reads in {wall:.2f} s = "
        f"{stats.read_n / wall:.1f} reads/s (index upload included); "
        f"fetch_window launches {launches['fetch_window']} (grow "
        f"{sl['fetch']}, finalize {sl['finalize']}, pack {sl['pack']}), "
        f"fetch_rows {launches['fetch_rows']}, tile_fetch "
        f"{launches['tile_fetch']}; peak device memory {peak} B")
    log("solo: stages (TIMERS): " + ", ".join(
        f"{k} {t[k]:.3f} s" for k in
        ("prepare", "seed_loop", "replay", "stitch_batch",
         *(f"stitch_level_W{w}" for w in lv), "finish", "solo_count",
         "bam_encode", "solo_process", "bam_finish") if k in t)
        + f"; of solo_process EmptyDrops_CR {ed['s']:.3f} s, its "
        f"Monte-Carlo null (solo_mc) {t.get('solo_mc', 0.0):.3f} s")
    grow_report(ds, be, pipeline, "solo")
    check_card_levels(ds, be, "solo")
    chunks = check_chunk_launches(ds, be, launches, "solo")
    log(f"solo: stitch_chunk {launches['stitch_chunk']} (per level: "
        f"launches, grow iterations {chunks})")
    sums = {ft: summary(outs["scale"] + f"Solo.out/{ft}/Summary.csv")
            for ft in ("Gene", "GeneFull")}
    nnz = {ft: mtx_entries(outs["scale"] + f"Solo.out/{ft}/raw/matrix.mtx")
           for ft in ("Gene", "GeneFull")}
    for ft, sm in sums.items():
        log(f"solo: {ft}: {sm['Estimated Number of Cells']} cells called, "
            f"median UMIs per cell {sm['Median UMI per Cell']}, reads with "
            f"valid barcodes {sm['Reads With Valid Barcodes']}, "
            f"sequencing saturation {sm['Sequencing Saturation']}, "
            f"{nnz[ft]} raw matrix entries")
    log(f"solo: EmptyDrops_CR: {ed['sims']} simulations in "
        f"{launches['mc_null']} kernel launches, {ed['called']} cells called "
        f"beyond the simple filter, {ed['s']:.2f} s")
    if stats.read_n != N_SOLO_READS or lv.get(8, (0, 0))[0] != 2:
        raise AssertionError(f"solo: {stats.read_n} reads, levels {lv}")
    if sl["fetch"] <= 0 or not any(dev for _, dev in lv.values()):
        raise AssertionError(f"solo: no level on the card ({lv}) or no "
                             f"fetch_window in the grow ({sl})")
    if min(nnz.values()) <= 0 or ed["sims"] != 2 * SOLO_SIM_N \
            or launches["mc_null"] != 2:
        raise AssertionError(f"solo: raw matrix entries {nnz}, "
                             f"{ed['sims']} EmptyDrops simulations in "
                             f"{launches['mc_null']} kernel launches")
    launches["mc_kernel"] = mc_kernel(torch, mc_null, ed["inputs"])
    # the first batch's grow chunks, each against the plain version
    P = argv("scale")
    d = load_dump(gi, P, os.path.join(dump, sorted(os.listdir(dump))[0]))
    launches["chunks"] = chunk_replay(torch, np, gi, P, d, "solo",
                                      need=("joins", "found"))
    del d

    # ---- the first reads on the card (engine forced) and with numpy
    sub = ["--readMapNumber", str(N_SOLO_ORACLE)]
    gate = be.DEVICE_GROW_MIN_RECORDS
    be.DEVICE_GROW_MIN_RECORDS = {s: 0 for _, s, _ in be.LEVELS}
    be.LEVEL_STATS.clear()
    t0 = time.time()
    try:
        align_reads(argv("card", *sub), gi=gi, device=DEVICE)
    finally:
        be.DEVICE_GROW_MIN_RECORDS = gate
    t_card = time.time() - t0
    on_card = sum(v for (w, k), v in be.LEVEL_STATS.items() if k == "device")
    os.environ["STAR_TPU_DEVICE_STITCH"] = "0"
    t0 = time.time()
    try:
        align_reads(argv("numpy", *sub), gi=gi, device=DEVICE)
    finally:
        del os.environ["STAR_TPU_DEVICE_STITCH"]
    t_np = time.time() - t0
    bad = (tree_diff(outs["card"] + "Solo.out", outs["numpy"] + "Solo.out")
           + tree_diff(outs["numpy"] + "Solo.out", outs["card"] + "Solo.out"))
    if on_card == 0 or bad or not same_output(
            outs["card"], outs["numpy"], "Aligned.sortedByCoord.out.bam"):
        raise AssertionError(f"solo: the first {N_SOLO_ORACLE} reads differ "
                             f"from the numpy engine: {bad or 'the BAM'} "
                             f"({on_card} levels on the card)")
    n_rec = len(bam_records(outs["card"] + "Aligned.sortedByCoord.out.bam")[1])
    log(f"solo: the first {N_SOLO_ORACLE} reads' Solo.out tree and sorted "
        f"BAM ({n_rec} records) identical to the numpy engine (card "
        f"{t_card:.2f} s, {on_card} levels on the device stitch engine; "
        f"numpy {t_np:.2f} s)")

    # ---- the first reads' prepare: the clip of a batch and read by read
    from star_tpu_torch.align.engine import ReadAligner
    with open(cdna) as f:
        seqs = [x.rstrip("\n") for x in
                itertools.islice(f, 1, 4 * N_SOLO_ORACLE, 4)]

    def prepare(batched):
        """(clips and read of each read, seconds) of a new host aligner's
        prepare_read, its 5p clip given the batch first where batched"""
        a = ReadAligner(gi, argv("scale"))
        t0 = time.time()
        if batched:
            a.clip_batch([[x] for x in seqs])
        out = [(r.clips, rd[0].tobytes()) for r, rd in
               (a.prepare_read(f"solo{i}", [x], ["F" * len(x)])
                for i, x in enumerate(seqs))]
        return out, time.time() - t0
    per_read, t_read = prepare(False)
    batch, t_batch = prepare(True)
    n5 = sum(1 for c, _ in per_read if c[0][0])
    n3 = sum(1 for c, _ in per_read if c[0][1])
    if batch != per_read or not n5 or not n3:
        raise AssertionError(f"solo: the first {N_SOLO_ORACLE} reads' "
                             f"prepare: batch clip equal {batch == per_read}"
                             f", {n5} TSO and {n3} polyA clips")
    log(f"solo: the first {N_SOLO_ORACLE} reads' prepare (CellRanger4 clip: "
        f"{n5} TSO, {n3} polyA clipped): the TSO clip of the batch "
        f"{t_batch:.3f} s, read by read {t_read:.3f} s; clips and reads "
        "identical")

    # ---- the first reads on the card and with the host oracle
    sub = ["--readMapNumber", str(N_SOLO_HOST)]
    t0 = time.time()
    align_reads(argv("first", *sub), gi=gi, device=DEVICE)
    t_card = time.time() - t0
    t0 = time.time()
    align_reads(argv("host", *sub, "--tpuUseDevice", "0"), gi=gi)
    t_host = time.time() - t0
    bad = (tree_diff(outs["first"] + "Solo.out", outs["host"] + "Solo.out")
           + tree_diff(outs["host"] + "Solo.out", outs["first"] + "Solo.out"))
    if bad or not same_output(outs["first"], outs["host"],
                              "Aligned.sortedByCoord.out.bam"):
        raise AssertionError(f"solo: the first {N_SOLO_HOST} reads differ "
                             f"from the host oracle: {bad or 'the BAM'}")
    log(f"solo: the first {N_SOLO_HOST} reads' Solo.out tree and sorted BAM "
        f"identical to the host oracle (--tpuUseDevice 0, the per-read "
        f"clip; card {t_card:.2f} s, host {t_host:.2f} s)")
    return launches


# ---- phase 8: the sharded suffix-array index
SHARDS = 4                # index shards laid on the one card
SHARDED_GOLDEN_FLAGS = ["--outSAMunmapped", "Within", "--quantMode",
                        "GeneCounts", "--tpuShardedIndex", "1",
                        "--tpuBatchSize", "128"]


def sharded_goldens(fetch):
    """phase 8 (a): the sharded check of star_tpu on cuda: se_gtf's SAM and
    SJ.out.tab and se_quant's ReadsPerGene.out.tab through --tpuShardedIndex
    1, through the command line (its default mesh: one shard on one card)
    and at SHARDS shards (the default 2 x 2 split) on the one card; the
    single-device index is never built"""
    from star_tpu_torch import run
    from star_tpu_torch.ops.sa_search import DeviceIndex
    from star_tpu_torch.parallel import mesh as pm
    from star_tpu_torch.params import Parameters
    shapes = []

    def build(real, gi, mesh, **k):
        shapes.append((mesh.dp, mesh.ix))
        return real(gi, mesh, **k)

    def single(real, *a, **k):
        raise AssertionError("sharded: the single-device index was built")
    with Spy((pm.ShardedIndex, "build", build), (DeviceIndex, "build", single)):
        for n, want in ((1, (1, 1)), (SHARDS, (2, SHARDS // 2))):
            out = os.path.join(WORK, f"sharded_golden_{n}") + "/"
            argv = ["--genomeDir", os.path.join(GOLD, "genome_idx_gtf"),
                    "--readFilesIn", os.path.join(DATA, "reads_se.fastq"),
                    "--outFileNamePrefix", out, *SHARDED_GOLDEN_FLAGS]
            shapes.clear()
            n0 = fetch.LAUNCHES
            t0 = time.time()
            if n == 1:
                run.main(argv)
            else:
                run.align_reads(Parameters(argv), device=DEVICE,
                                mesh=pm.make_mesh([DEVICE] * n))
            for f, gold in (("Aligned.out.sam", "se_gtf"),
                            ("SJ.out.tab", "se_gtf"),
                            ("ReadsPerGene.out.tab", "se_quant")):
                if not same_output(out, os.path.join(GOLD, gold) + "/", f):
                    raise AssertionError(f"sharded golden, {n} shards: {f} "
                                         "differs")
            if shapes != [want] or fetch.LAUNCHES == n0:
                raise AssertionError(f"sharded golden, {n} shards: meshes "
                                     f"{shapes}, {fetch.LAUNCHES - n0} "
                                     "fetch_window launches")
            log(f"sharded: golden se_gtf + se_quant at {n} shards "
                f"({want[0]} x {want[1]}"
                f"{', the command line' if n == 1 else ''}): SAM, SJ.out.tab"
                f" and ReadsPerGene.out.tab identical; "
                f"{fetch.LAUNCHES - n0} fetch_window launches, "
                f"{time.time() - t0:.2f} s")


def sharded_scale(torch, np, fetch, tile_fetch, data, full):
    """phase 8 (b): phase 4's batch on phase 4's index through
    --tpuShardedIndex 1 with the suffix array split over SHARDS shards on
    the card: SAM and SJ.out.tab byte-identical to phase 4's, and its seed
    loop's fetch_window calls replayed (replay_sharded_seed); (c): the big
    (int64, forward-G-only) layout forced on the same index and shards,
    N_PROBES probes equal to the host mmp_search.  full: phase 4's
    readings.  Returns (the main run's launches, the replay's timings)."""
    from star_tpu_torch.align.seed import mmp_search
    from star_tpu_torch.genome.index import GenomeIndex
    from star_tpu_torch.ops import batch_engine as be
    from star_tpu_torch.ops import device_stitch as ds
    from star_tpu_torch.ops import pipeline
    from star_tpu_torch.parallel import mesh as pm
    from star_tpu_torch.params import Parameters
    from star_tpu_torch.run import align_reads

    idx = os.path.join(WORK, "idx")
    gi = GenomeIndex.load(idx)
    mesh = pm.make_mesh([DEVICE] * SHARDS, dp=1, ix=SHARDS)
    reads = os.path.join(data, "reads_se.fastq")
    out = os.path.join(WORK, "sharded") + "/"
    P = Parameters(["--genomeDir", idx, "--readFilesIn", reads,
                    "--outFileNamePrefix", out, "--outSAMunmapped", "Within",
                    "--readMapNumber", str(N_READS),
                    "--tpuBatchSize", str(N_READS), "--tpuShardedIndex", "1"])
    pipeline.TIMING = True
    reset_counts(ds, be, pipeline)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fetch, tile_fetch)       # counts of the main path
    t0 = time.time()
    try:
        stats = align_reads(P, gi=gi, device=DEVICE, mesh=mesh)
        torch.cuda.synchronize()
    finally:
        pipeline.TIMING = False
    wall = time.time() - t0
    launches = main_launches(fetch, tile_fetch)
    peak = torch.cuda.max_memory_allocated()
    sl = stitch_launches(ds)
    seed = launches["fetch_window"] - sum(sl.values())
    keys = [k for k in gi._device_cache if k[0] != "stitch"]
    if [k[:4] for k in keys] != [("sharded", 128, 1, SHARDS)] or seed <= 0:
        raise AssertionError(f"sharded: device index entries {keys}, "
                             f"{seed} seed-loop fetch_window launches")
    si = gi._device_cache[keys[0]][0]
    idx_bytes = sum(t.numel() for d in (si.text, si.sai, si.sa)
                    for t in d.values())
    if stats.read_n != N_READS:
        raise AssertionError(f"sharded: {stats.read_n} reads aligned")
    full_out = os.path.join(WORK, "full") + "/"
    if strip_header(out + "Aligned.out.sam") != \
            strip_header(full_out + "Aligned.out.sam.device"):
        raise AssertionError("sharded: SAM differs from phase 4's")
    with open(out + "SJ.out.tab", "rb") as a, \
            open(full_out + "SJ.out.tab.device", "rb") as b:
        if a.read() != b.read():
            raise AssertionError("sharded: SJ.out.tab differs from phase 4's")
    tm = pipeline.TIMERS
    log(f"sharded: {N_READS} reads on {SHARDS} shards (1 x {SHARDS}, "
        f"{si.shard_rows} SA rows each) in {wall:.2f} s = "
        f"{N_READS / wall:.1f} reads/s (phase 4, one index: "
        f"{full['reads_s']:.1f}), index upload included; SAM and SJ.out.tab "
        f"byte-identical to phase 4's; seed loop {tm['seed_loop']:.2f} s "
        f"(phase 4: {full['timers'].get('seed_loop', 0):.2f} s); "
        f"fetch_window launches {launches['fetch_window']} (seed loop {seed},"
        f" grow {sl['fetch']}, finalize {sl['finalize']}, pack {sl['pack']})"
        f"; sharded index {idx_bytes} B on the card; peak device memory "
        f"{peak} B")
    log(f"sharded: phases {pipeline.timing_report()}")
    replayed = replay_sharded_seed(torch, np, fetch, gi, P,
                                   gi._device_cache[keys[0]][1], si.ql,
                                   full["seed_in"], seed)

    # ---- (c) the big layout forced on the same index and shards
    t0 = time.time()
    big = pm.ShardedIndex.build(gi, mesh, ql=128, big=True)
    t_build = time.time() - t0
    if not big.g_only or any(t.numel() < big.shard_rows * 8
                             for t in big.sa.values()):
        raise AssertionError("sharded: the big layout is not int64 / G-only")
    mmp = pm.make_sharded_mmp(big)
    qs, qlen = probe_set(np, reads, 128)
    n0 = fetch.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.time()
    got = [t.cpu() for t in mmp(torch.from_numpy(qs).to(DEVICE),
                                torch.from_numpy(qlen).to(DEVICE))]
    t_card = time.time() - t0
    if any(t.dtype != torch.int64 for t in got):
        raise AssertionError("sharded: big-layout results are not int64")
    got = np.stack([t.numpy() for t in got], axis=1)
    host = np.array([mmp_search(gi, qs[i, :qlen[i]]) for i in range(N_PROBES)])
    if not np.array_equal(got, host):
        bad = int((got != host).any(axis=1).sum())
        raise AssertionError(f"sharded: {bad} of {N_PROBES} big-layout "
                             "probes differ from the host oracle")
    log(f"sharded: big layout (int64 SA rows, G alone: "
        f"{sum(t.numel() for t in big.text.values())} text bytes) on "
        f"{SHARDS} shards, built in {t_build:.1f} s: {N_PROBES} probes equal "
        f"the host mmp_search ({t_card:.3f} s on the card, "
        f"{fetch.LAUNCHES - n0} fetch_window launches)")
    gi._device_cache.clear()
    return launches, replayed


def replay_sharded_seed(torch, np, fetch, gi, P, mmp, ql, seed_in, want):
    """the sharded batch's seed loop again, from phase 4's dumped inputs
    (the same reads), with every fetch_window call recorded; each call held
    against the plain window and timed by time_calls.  want: the main
    run's seed-loop launches, which the replay must repeat"""
    from star_tpu_torch.ops import pipeline
    read_mat, chains = seed_in
    D = int(getattr(gi, "sa_sparse_d", 1)) or 1
    put = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=DEVICE)

    def run():
        pipeline.make_fused_seed_fn(mmp, ql, D)(
            torch.as_tensor(read_mat, device=DEVICE),
            *[put(a) for a in chains], int(P.seedMapMin))
    calls = record_fetches(torch, fetch, run)
    if len(calls) != want or any(c[0] != "seed" for c in calls):
        raise AssertionError(f"sharded replay: {len(calls)} fetch_window "
                             f"calls, the main path's seed loop made {want}")
    r = time_calls(torch, fetch, calls)
    log(f"sharded: the seed loop's fetch_window calls (replayed): "
        f"{r['launches']} launches, {r['rows']} rows, widths {r['widths']}: "
        f"each equal to the plain window; kernel {r['ms']:.3f} / "
        f"{r['ms_again']:.3f} ms (torch.profiler saw {r['profiler_saw']} of "
        f"its {r['launches']} kernels), bound {r['bound_ms']:.3f} ms "
        f"({r['bytes']} B at {HBM_BW:.3g} B/s), library "
        f"{r['library_ms']:.3f} ms, old fetch_rows + cut {r['old_ms']:.3f} "
        f"ms, plain {r['plain_ms']:.3f} ms; wrapper host "
        f"{r['host_us_per_call']:.1f} us per call")
    return r


def nccl_merges(torch, np):
    """phase 8 (d): a single-rank NCCL group on the card: psum_merge over a
    2 x 2 mesh's dp rows and merge_keyed_counts on CUDA tensors, keys and
    counts past 2^32, against numpy; the group is destroyed after"""
    import socket
    import torch.distributed as dist
    from star_tpu_torch.parallel import dist as pdist
    from star_tpu_torch.parallel import mesh as pm
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    t0 = time.time()
    devices = pdist.init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = pm.make_mesh(devices * SHARDS)
        if dist.get_backend() != "nccl" or mesh.comm_device.type != "cuda" \
                or mesh.dp_group is None:
            raise AssertionError(f"nccl: backend {dist.get_backend()}, "
                                 f"collectives on {mesh.comm_device}")
        rng = np.random.default_rng(23)
        tables = (1 << 40) + rng.integers(0, 1 << 33, size=(mesh.dp, 3, 1000))
        got = pm.psum_merge(torch.from_numpy(tables).to(DEVICE), mesh)
        if not got.is_cuda or not np.array_equal(got.cpu().numpy(),
                                                 tables.sum(axis=0)):
            raise AssertionError("nccl: psum_merge differs from numpy")
        keys = (1 << 33) + rng.integers(0, 5000, size=4000) * (1 << 20)
        cnts = (1 << 32) + rng.integers(1, 9, size=(4000, 2))
        all_keys, merged = pdist.merge_keyed_counts(
            torch.from_numpy(keys).to(DEVICE),
            torch.from_numpy(cnts).to(DEVICE), mesh)
        want_keys, inv = np.unique(keys, return_inverse=True)
        want = np.zeros((len(want_keys), 2), np.int64)
        np.add.at(want, inv, cnts)
        if not (all_keys.is_cuda and np.array_equal(all_keys.cpu().numpy(),
                                                     want_keys)
                and np.array_equal(merged.cpu().numpy(), want)):
            raise AssertionError("nccl: merge_keyed_counts differs from numpy")
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    log(f"nccl: single-rank group on {devices[0]}: psum_merge of "
        f"{tables.shape} int64 tables and merge_keyed_counts of {len(keys)} "
        f"keys ({len(want_keys)} distinct, past 2^32) equal numpy; group "
        f"destroyed ({time.time() - t0:.2f} s)")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from star_tpu_torch.ops import _build, fetch, tile_fetch

    if SXM_NAME not in torch.cuda.get_device_name(0):
        raise RuntimeError(f"bounds assume an {SXM_NAME} (SXM) card, found "
                           f"{torch.cuda.get_device_name(0)}")
    os.makedirs(WORK, exist_ok=True)
    data = os.path.join(WORK, "data")
    t_start = time.time()
    data_proc = start_data(data)
    oracle = None
    try:
        t0 = time.time()
        sources = ["fetch_rows", "emptydrops", "stitch_chunk"]
        _build.build_all(sources)
        log(f"build: {', '.join(k + '.cu' for k in sources)} in "
            f"{time.time() - t0:.1f} s")
        for k in sources:
            for line in _build.BUILD_LOG.get(k, "").splitlines():
                if "Compiling entry" in line or "registers" in line \
                        or "spill" in line:
                    log(f"build: {k}: " + line.strip())

        t_phase = [t_start]

        def phase_done(name):
            t_phase.append(time.time())
            log(f"phase {name}: {t_phase[-1] - t_phase[-2]:.1f} s")
        phase_done("build")
        win_err, widths = phase_window_kernel(torch, np, fetch)
        kern = [phase_kernel(torch, np, fetch),
                phase_tile_kernel(torch, np, tile_fetch)]
        phase_done("kernel")
        phase_golden(fetch)
        phase_done("golden")
        launches, replay = phase_full(torch, np, fetch, data_proc, data)
        phase_done("full")
        annot_goldens(fetch)
        annot, oracle = annot_scale(torch, np, fetch, tile_fetch,
                                    os.path.join(WORK, "idx"), data)
        phase_done("annot")
        fusion_goldens(fetch)
        fusion = fusion_scale(torch, np, fetch, tile_fetch,
                              os.path.join(WORK, "idx"), data)
        phase_done("fusion")
        pe, pe_chunk = pe_chunks(torch, np, fetch, tile_fetch, data)
        phase_done("pe chunks")
        solo_goldens(fetch)
        solo = solo_scale(torch, np, fetch, tile_fetch, data)
        phase_done("solo")
        sharded_goldens(fetch)
        sharded, sharded_seed = sharded_scale(torch, np, fetch, tile_fetch,
                                              data, replay)
        nccl_merges(torch, np)
        phase_done("sharded")
        annot_oracle(oracle)
        phase_done("annot's numpy-engine check")
        launches = {k: v + annot[k] + fusion[k] + pe[k] + solo[k]
                    + sharded[k] for k, v in launches.items()}
        for k in kern:
            k["launches"] = launches[k["name"]]
        ph = replay["fetches"]
        kern.insert(0, {
            "name": "fetch_window", "route": "cuda",
            "source": "star_tpu_torch/ops/csrc/fetch_rows.cu",
            "replaces": "star_tpu/ops/fetch.py:83",
            "launches": launches["fetch_window"],
            "max_abs_err": max(win_err, sharded_seed["max_abs_err"],
                               *(r["max_abs_err"] for r in ph.values())),
            # phase 4's calls, all its phases, launched again back to back
            **{k: sum(r[k] for r in ph.values())
               for k in ("ms", "ms_again", "plain_ms", "bound_ms",
                         "library_ms", "old_ms")},
            "bound_by": "bytes", "phases": {**ph,
                                            "sharded_seed": sharded_seed},
            "widths_262144_starts": widths})
        # the chunks of phase 4's batch (100-base reads, no annotation), of
        # the pairs on the annotated index (phase 6) and of the 10x run's
        # first batch (91-base reads, annotated; phase 7), each launched
        # again alone
        ch = {"se100": replay["chunks"], "pe2x100_sjdb": pe_chunk,
              "se91_sjdb_10x": solo["chunks"]}
        kern.append({
            "name": "stitch_chunk", "route": "cuda",
            "source": "star_tpu_torch/ops/csrc/stitch_chunk.cu",
            "replaces": None, "launches": launches["stitch_chunk"],
            "bound_by": "bytes",
            **{k: sum(r[k] for c in ch.values() for r in c.values())
               for k in ("ms", "plain_ms", "bound_ms")},
            "replays": ch})
        kern.append({
            "name": "mc_null", "route": "cuda",
            "source": "star_tpu_torch/ops/csrc/emptydrops.cu",
            "replaces": None, "launches": solo["mc_null"],
            "bound_by": "serial chain", "calls": solo["mc_kernel"]})
    finally:
        for p in (data_proc, oracle):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()

    log(f"total: {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kern}))
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
