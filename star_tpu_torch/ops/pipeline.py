"""Device-accelerated alignment pipeline.

Reads are processed in large batches.  The whole seed loop — the reference's
per-read `while unmapped > seedMapMin` MMP iteration
(reference: ReadAlign_mapOneRead.cpp:65-78) — runs on the device: every read
contributes a set of probe *chains* (piece x direction x staggered start),
a round loop advances all live chains together (each round = one batched MMP
over the suffix array, ops/sa_search.py), and each round writes its probe
records straight into fixed-shape tables on the device, downloaded once per
batch.  A vectorized numpy replay then rebuilds the reference-order piece
tables (reference: ReadAlign_storeAligns.cpp) so the downstream
window/stitch stages see bit-identical input.

Windows/stitch/extend run as fixed-shape vectorized array stages over the
whole batch (ops/batch_engine.py); reads outside the static envelope fall
back to the per-read host oracle (align/windows.py + align/stitch.py),
keeping every output byte-identical.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..align.engine import ReadAligner, ReadResult
from ..align.seed import SeedResult, quality_split
from .fetch import resolve_device
from .sa_search import DeviceIndex, make_mmp_fn

MAXP = 64  # probes per chain cap (matches the round-1 64-round cap)

# Host spans, on with STAR_TPU_TIMING=1 or pipeline.TIMING = True.  Each
# _tick records (key, parent index, batch index, t0_ns, t1_ns) in SPANS on
# time.time_ns(), torch.profiler's clock, and adds its seconds to
# TIMERS[key], which callers clear.  Keys: job_open (run.py: outputs,
# Transcriptome.load, Solo(...)), read_input (filling a batch from the
# reader), prepare, batch_arrays (the read matrix and chain descriptors; the
# stitch's fwd / rc / nmm_max arrays), index_upload (a device index built on
# a cache miss), seed_loop, replay, stitch_batch, finish with host_path
# inside it (the per-read host finish_read); per escalation level
# stitch_level_W<w> with its parts windows_W<w>, the stitch engine
# (grow_dev_W<w> on the device: grow, finalize and select; else
# grow_host_W<w> and the numpy finalize_W<w>) and assemble_W<w>; the device
# engine's parts dev_upload_W<w>, dev_grow_W<w>, dev_finalize_W<w>,
# dev_select_W<w>, dev_download_W<w> (with the pack) and dev_order_W<w>
# (the host's DFS ordering of the downloaded chains); run.py's per-read
# emit, solo_count, quant, bam_encode and its end of job (see run.py);
# solo_process with solo_collapse, solo_raw_out, solo_filter and
# solo_stats inside it (solo/solo.py Solo.process), and solo_mc inside
# solo_filter (EmptyDrops_CR's Monte-Carlo null, solo/emptydrops.py); trsam
# inside quant (quant/trsam.py quant_transcriptome: the bans, the soft-clip
# extension and the projection); bysj_stage2 (run.py: BySJout's junction
# filter and the held reads mapped again, with their output).  A job (_job,
# around run.align_reads) adds the seconds no top-level span covers to
# TIMERS["untimed"].  No span stays open across a yield, and code outside
# this module and run.py looks _tick up here at call time, so that a caller
# may stand a subclass in for it.
# Counters, kept in COUNTS under the same switch and cleared with SPANS by
# the job: bysj_held (reads held for BySJout's stage 2), trsam_records
# (records written to Aligned.toTranscriptome.out.bam) and trsam_banned
# (alignments --quantTranscriptomeBan kept out of it).
# STAR_TPU_DUMP_STITCH=<dir> pickles each batch's stitch inputs there, with
# the read matrix and chain descriptors its seed loop ran on.
import collections as _collections
import itertools as _itertools
import os as _os
import time as _time
TIMING = bool(_os.environ.get("STAR_TPU_TIMING"))
TIMERS = _collections.defaultdict(float)
SPANS = []      # (key, parent index or -1, batch index, t0_ns, t1_ns)
COUNTS = _collections.defaultdict(int)
_OPEN = []      # indices into SPANS of the open spans, innermost last
BATCH = -1      # the job's batch last begun (DeviceAligner._align_batch)


class _tick:
    """one span of the host's work under `key` (see above)"""
    _i = None           # this span's slot in SPANS while it is open

    def __init__(self, key):
        self.key = key

    def __enter__(self):
        if TIMING:
            self._i = len(SPANS)
            SPANS.append((self.key, _OPEN[-1] if _OPEN else -1, BATCH,
                          _time.time_ns(), None))
            _OPEN.append(self._i)

    def __exit__(self, *a):
        i = self._i
        if i is not None:
            t1 = _time.time_ns()
            key, parent, batch, t0, _ = SPANS[i]
            SPANS[i] = (key, parent, batch, t0, t1)
            del _OPEN[_OPEN.index(i):]
            TIMERS[key] += (t1 - t0) / 1e9


def _count(key):
    """add 1 to COUNTS[key] while tracing"""
    if TIMING:
        COUNTS[key] += 1


class _job:
    """the scope of one mapping job (run.align_reads): clears SPANS and
    COUNTS when it opens and adds to TIMERS["untimed"] the job's seconds
    outside every top-level span when it closes.  Not a _tick, so a recorder
    of _tick spans never sees a span that covers the whole job."""
    _t0 = None

    def __enter__(self):
        global BATCH
        if TIMING:
            SPANS.clear()
            COUNTS.clear()
            _OPEN.clear()
            BATCH = -1
            self._t0 = _time.time_ns()

    def __exit__(self, *a):
        if self._t0 is not None:
            t1 = _time.time_ns()
            _OPEN.clear()
            top = sum(s[4] - s[3] for s in SPANS
                      if s[1] == -1 and s[4] is not None)
            TIMERS["untimed"] += max(t1 - self._t0 - top, 0) / 1e9


def timing_report() -> str:
    return " ".join(f"{k}={v:.2f}s" for k, v in sorted(TIMERS.items()))


def make_fused_seed_fn(mmp, QL: int, D: int):
    """the whole reference seed loop (ReadAlign_mapOneRead.cpp:65-78) as one
    round loop over device tensors: chains stay on the device, each round
    probes every live chain (x D sparse phase offsets) with mmp (the
    single-device sa_search.make_mmp_fn or the sharded
    parallel.mesh.make_sharded_mmp, QL its query window) and writes its
    probe records into [NC, MAXP, D] tables at column k; entries of rounds a
    chain never ran stay 0.  Returns
        fused(read_mat [R, RW] int8, c_read, c_pstart, c_plen, c_dir,
              c_istl [NC] int64, smin)
          -> (oml, onr, olo, ohi [NC, MAXP, D], mbest [NC, MAXP],
              nprobes [NC]) int64 tensors."""

    def fused(read_mat, c_read, c_pstart, c_plen, c_dir, c_istl, smin):
        NC = c_read.shape[0]
        dev = read_mat.device
        i64 = torch.int64
        oml = torch.zeros((NC, MAXP, D), dtype=i64, device=dev)
        onr = torch.zeros_like(oml)
        olo = torch.zeros_like(oml)
        ohi = torch.zeros_like(oml)
        mbest = torch.zeros((NC, MAXP), dtype=i64, device=dev)
        nprobes = torch.zeros(NC, dtype=i64, device=dev)
        l_mapped = torch.zeros(NC, dtype=i64, device=dev)
        active = c_istl + smin < c_plen
        for k in range(MAXP):
            # only the live chains are probed: a chain's MMP is independent
            # of the other lanes, and dead chains store nothing
            idx = active.nonzero()[:, 0]
            if idx.numel() == 0:
                break
            cr, cps, cpl = c_read[idx], c_pstart[idx], c_plen[idx]
            cd, cis, lm = c_dir[idx], c_istl[idx], l_mapped[idx]
            mb = torch.full_like(idx, -1)
            for d in range(D):
                adv = cis + lm + d
                start = torch.where(cd == 0, cps + adv, cps + cpl - 1 - adv)
                slen = cpl - lm - cis - d
                q = _build_queries(read_mat, cr, start, slen, cd, QL)
                maxl, nrep, lo, hi = mmp(q, slen.clamp(min=0), valid=slen > 0)
                val = d < slen
                maxl = torch.where(val, maxl, 0)
                oml[idx, k, d] = maxl
                onr[idx, k, d] = nrep
                olo[idx, k, d] = lo
                ohi[idx, k, d] = hi
                mb = torch.maximum(mb, torch.where(val, maxl + d, -1))
            mb = mb.clamp(min=0)
            mbest[idx, k] = mb
            nprobes[idx] += 1
            l_mapped[idx] = lm + mb
            active[idx] = (mb > 0) & (cis + lm + mb + smin < cpl)
        return oml, onr, olo, ohi, mbest, nprobes

    return fused


class DeviceAligner:
    def __init__(self, gi, P, batch_size: int = None, device=None, mesh=None):
        """device: where the batch and the stitch engine run (default
        cuda).  mesh: the shards of the row-sharded index the seed search
        runs on (parallel/mesh.py; run.py makes it for --tpuShardedIndex 1),
        else one index on device."""
        self.gi = gi
        self.P = P
        self.batch_size = batch_size or P.tpuBatchSize
        self.device = resolve_device(device)
        self.host = ReadAligner(gi, P)
        self.mesh = mesh
        self.mmp = None
        self._ql = None

    def _ensure_kernel(self, max_read_len: int):
        """the MMP over device index tables for queries up to max_read_len;
        the tables are cached on the genome index object itself, so repeated
        align_reads calls in one process share one upload and a new index
        never meets a stale entry.  The sharded index (with its MMP) is
        keyed by the mesh's shape and shards."""
        ql = ((max_read_len + 2 + 127) // 128) * 128
        if self.mmp is None or ql > self._ql:
            cache = self.gi._device_cache
            if self.mesh is not None:
                from ..parallel.mesh import ShardedIndex, make_sharded_mmp
                m = self.mesh
                key = ("sharded", ql, m.dp, m.ix,
                       tuple((s.row, s.col, str(s.device)) for s in m.shards))
                if key not in cache:
                    with _tick("index_upload"):
                        si = ShardedIndex.build(self.gi, m, ql=ql)
                        cache[key] = (si, make_sharded_mmp(si))
                self.mmp = cache[key][1]
            else:
                key = (ql, str(self.device))
                if key not in cache:
                    with _tick("index_upload"):
                        cache[key] = DeviceIndex.build(self.gi, ql=ql,
                                                       device=self.device)
                self.mmp = make_mmp_fn(cache[key])
            self._ql = ql

    # -------------------------------------------------------------- batching
    def align_stream(self, reader, stats) -> Iterator[ReadResult]:
        reader = iter(reader)
        left = self.P.readMapNumber         # -1: every read
        while left != 0:
            n = self.batch_size if left < 0 else min(self.batch_size, left)
            with _tick("read_input"):
                batch = list(_itertools.islice(reader, n))
            if not batch:
                break
            if left > 0:
                left -= len(batch)
            yield from self._align_batch(batch, stats)

    def _align_batch(self, batch, stats) -> Iterator[ReadResult]:
        global BATCH
        BATCH += 1
        P = self.P
        with _tick("prepare"):
            prepped = []
            self.host.clip_batch([b[1] for b in batch])
            for name, seqs, quals, ftype in batch:
                res, reads = self.host.prepare_read(name, seqs, quals)
                res.read_file_type = ftype
                prepped.append((res, reads))
        lmax = max(r.lread for r, _ in prepped)
        self._ensure_kernel(lmax)

        with _tick("batch_arrays"):
            # read matrix [R, lmax] padded with -1
            R = len(prepped)
            read_mat = np.full((R, lmax), -1, dtype=np.int8)
            for i, (res, reads) in enumerate(prepped):
                read_mat[i, :res.lread] = reads[0]
            chains, per_read_pieces = chain_descriptors(P, prepped)
        c_read, c_pstart, c_plen, c_dir, c_istl, c_ifrag, c_piece = chains

        probes = None
        if len(c_read):
            with _tick("seed_loop"):
                probes = self._run_chains_fused(read_mat, c_read, c_pstart,
                                                c_plen, c_dir, c_istl)

        with _tick("replay"):
            seeds_by_read, seed_flat = _replay_store_aligns(
                P, R, c_read, c_pstart, c_plen, c_dir, c_istl, c_ifrag,
                c_piece, probes)

        # ---- batched windows + stitch + extend (ops/batch_engine.py);
        # per-read host fallback for shapes outside the static envelope
        from . import batch_engine as be
        results = {}
        fb = np.ones(R, bool)
        fast_fin = False
        if be.fast_path_config_ok(self.gi, P) and len(seed_flat.read):
            fast_fin = be.fast_finish_config_ok(P)
            with _tick("batch_arrays"):
                lread = np.asarray([r.lread for r, _ in prepped], np.int64)
                read_len2 = np.asarray([r.read_length[:2]
                                        for r, _ in prepped], np.int64)
                nmm_max = np.minimum(
                    P.outFilterMismatchNmax,
                    (P.outFilterMismatchNoverReadLmax
                     * (read_len2[:, 0] + read_len2[:, 1])).astype(np.int64))
                fwd = read_mat.astype(np.uint8)  # -1 pad -> 255 (PAD_BASE)
                k = np.arange(lmax)
                src = np.clip(lread[:, None] - 1 - k[None, :], 0, lmax - 1)
                rcv = np.take_along_axis(read_mat, src, axis=1)
                rc = np.where(k[None, :] < lread[:, None],
                              np.where(rcv < 4, 3 - rcv, rcv),
                              -1).astype(np.uint8)
            dump_dir = _os.environ.get("STAR_TPU_DUMP_STITCH")
            if dump_dir:
                _os.makedirs(dump_dir, exist_ok=True)
                import pickle
                nb = len(_os.listdir(dump_dir))
                with open(f"{dump_dir}/batch_{nb:04d}.pkl", "wb") as f:
                    pickle.dump(dict(seeds=seed_flat, fwd=fwd, rc=rc,
                                     lread=lread, read_len2=read_len2,
                                     nmm_max=nmm_max, read_mat=read_mat,
                                     chains=(c_read, c_pstart, c_plen, c_dir,
                                             c_istl)), f)
            with _tick("stitch_batch"):
                fb, results = be.stitch_batch(self.gi, P, seed_flat, fwd, rc,
                                              lread, read_len2, nmm_max,
                                              lazy=fast_fin,
                                              device=self.device)

        with _tick("finish"):
            outs = []
            for i, (res, reads) in enumerate(prepped):
                pieces, lgood = per_read_pieces[i]
                seeds = seeds_by_read[i]
                seeds.max_good_piece = lgood
                seeds.n_split = len(pieces)
                pre = results.get(i) if not fb[i] else None
                if pre is None and hasattr(seeds, "_fill_pc"):
                    seeds._fill_pc(i)
                if pre is not None and fast_fin:
                    out = _fast_finish(self.host, res, seeds, pre,
                                       P, self.gi)
                    if P.quantModeTrSAM:
                        # quant_transcriptome's soft-clip extension reads
                        # the encoded read, as finish_read leaves it
                        out.read1, out.read1rc = reads[0], reads[2]
                else:
                    with _tick("host_path"):
                        out = self.host.finish_read(res, reads, seeds,
                                                    precomputed=pre)
                stats.add_read(out)
                outs.append(out)
        yield from outs

    def _run_chains_fused(self, read_mat, c_read, c_pstart, c_plen, c_dir,
                          c_istl):
        """the seed loop on the device (make_fused_seed_fn); returns the probe
        tables as numpy int32: (oml, onr, olo, ohi [NC, MAXP, D],
        max_best [NC, MAXP], nprobes [NC]).

        Sparse suffix arrays (--genomeSAsparseD > 1): every round probes D
        phase offsets per chain (reference
        ReadAlign_maxMappableLength2strands.cpp:18-113); the chain advances
        by the best maxL + offset, and all offset-winning probes are stored."""
        D = int(getattr(self.gi, "sa_sparse_d", 1)) or 1
        dev = self.device
        put = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        fused = make_fused_seed_fn(self.mmp, self._ql, D)
        out = fused(torch.as_tensor(read_mat, device=dev),
                    *[put(a) for a in (c_read, c_pstart, c_plen, c_dir,
                                       c_istl)],
                    int(self.P.seedMapMin))
        return tuple(t.cpu().numpy().astype(np.int32) for t in out)


def chain_descriptors(P, prepped):
    """flat chain descriptors of a batch (reference seed-loop structure,
    ReadAlign_mapOneRead.cpp:65-78): one chain per (piece, direction,
    staggered start).  Returns ((c_read, c_pstart, c_plen, c_dir, c_istl,
    c_ifrag, c_piece) int32 arrays, per-read (pieces, lgood))."""
    chains = [[] for _ in range(7)]
    per_read_pieces = []
    for i, (res, reads) in enumerate(prepped):
        pieces, lgood = quality_split(reads[0], res.lread, P.maxNsplit,
                                      P.seedSplitMin)
        per_read_pieces.append((pieces, lgood))
        ssl = min(P.seedSearchStartLmax,
                  int(P.seedSearchStartLmaxOverLread * (res.lread - 1)))
        for ip, (p_start, p_len, ifrag) in enumerate(pieces):
            n_start = p_len // ssl + 1 \
                if (P.seedSearchStartLmax > 0 and ssl < p_len) else 1
            l_start = p_len // n_start
            for i_dir in range(2):
                for istart in range(n_start):
                    for c, v in zip(chains, (i, p_start, p_len, i_dir,
                                             istart * l_start, ifrag, ip)):
                        c.append(v)
    return tuple(np.asarray(c, np.int32) for c in chains), per_read_pieces


def _fast_finish(host, res, seeds, pre, P, gi):
    """array-native finish_read for batched reads (fast_finish_config_ok):
    multMapSelect + mappedFilter over _LaneTr proxies; Transcript objects are
    materialized only for the alignments the output consumes (reference:
    ReadAlign_multMapSelect.cpp:8-95, ReadAlign_mappedFilter.cpp:3-21)."""
    from ..align.transcript import Transcript
    from ..constants import (MARKER_NO_GOOD_PIECES, MARKER_NO_GOOD_WINDOW,
                             MARKER_READ_TOO_SHORT,
                             MARKER_ALL_PIECES_EXCEED_seedMultimapNmax,
                             UNMAP_TOO_SHORT, UNMAP_TOO_MANY_MM,
                             UNMAP_MULTIMAP)
    lread = res.lread
    tr_init = Transcript()
    tr_init.Lread = lread
    res.tr_best = tr_init
    if lread < P.outFilterMatchNmin:
        res.map_marker = MARKER_READ_TOO_SHORT
        host._finish_unmapped(res)
        return res
    if seeds.n_split == 0:
        res.map_marker = MARKER_NO_GOOD_PIECES
        host._finish_unmapped(res)
        return res
    if seeds.nA == 0:
        res.map_marker = MARKER_ALL_PIECES_EXCEED_seedMultimapNmax
        host._finish_unmapped(res)
        return res

    win_list, msm = pre[0], pre[1]
    over = len(pre) > 2 and pre[2]
    tb = None
    for win in win_list:
        w0 = win[0]
        if tb is None or w0.maxScore > tb.maxScore \
                or (w0.maxScore == tb.maxScore and w0.gLength < tb.gLength):
            tb = w0
    if tb is None or tb.maxScore == 0:
        res.map_marker = MARKER_NO_GOOD_WINDOW
        host._finish_unmapped(res)
        return res

    max_score = tb.maxScore
    rng = P.outFilterMultimapScoreRange
    if over:
        # device-classified too-many-loci read (ops/device_stitch.py
        # select_lanes): n_tr provably exceeds the cap; its exact value is
        # not consumed anywhere downstream
        prox = []
        n_tr = P.outFilterMultimapNmax + 1
    else:
        prox = [t for win in win_list for t in win
                if t.maxScore + rng >= max_score]
        n_tr = len(prox)
    res.n_tr = n_tr
    res.all_win_tr = []

    if not (n_tr > P.outFilterMultimapNmax or n_tr == 0):
        trs = []
        tb_m = None
        cs = gi.chr_start
        for t in prox:
            o = t.materialize(gi, P)
            o.cStart = o.gStart - cs[o.Chr]
            trs.append(o)
            if t is tb:
                tb_m = o
        res.transcripts = trs
        if n_tr == 1:
            trs[0].primaryFlag = True
        else:
            if P.outMultimapperOrderRandom or P.outSAMmultNmax != -1:
                nbest = 0
                for i in range(len(trs)):
                    if trs[i].maxScore == max_score:
                        trs[i], trs[nbest] = trs[nbest], trs[i]
                        nbest += 1
                trs[0].primaryFlag = True
            elif P.outSAMprimaryFlag == "AllBestScore":
                for tr in trs:
                    if tr.maxScore == max_score:
                        tr.primaryFlag = True
            else:
                tb_m.primaryFlag = True
        res.tr_best = tb_m
    else:
        res.transcripts = []
        res.tr_best = tb.materialize(gi, P)

    mm_max = min(P.outFilterMismatchNmax,
                 int(P.outFilterMismatchNoverReadLmax
                     * (res.read_length[0] + res.read_length[1])))
    if (tb.maxScore < P.outFilterScoreMin
            or tb.maxScore < int(P.outFilterScoreMinOverLread * (lread - 1))
            or tb.nMatch < P.outFilterMatchNmin
            or tb.nMatch < int(P.outFilterMatchNminOverLread * (lread - 1))):
        res.unmap_type = UNMAP_TOO_SHORT
    elif (tb.nMM > mm_max
          or (tb.mappedLength > 0
              and tb.nMM / tb.mappedLength > P.outFilterMismatchNoverLmax)):
        res.unmap_type = UNMAP_TOO_MANY_MM
    elif n_tr > P.outFilterMultimapNmax:
        res.unmap_type = UNMAP_MULTIMAP
    else:
        res.unmap_type = -1
    return res


def _empty_seed_arrays():
    from .batch_engine import SeedArrays
    z64 = np.zeros(0, np.int64)
    return SeedArrays(read=np.zeros(0, np.int32), r_start=z64, length=z64,
                      idir=np.zeros(0, np.int8), nrep=z64, lo=z64, hi=z64,
                      ifrag=np.zeros(0, np.int8))


def _replay_store_aligns(P, n_reads, c_read, c_pstart, c_plen, c_dir,
                         c_istl, c_ifrag, c_piece, probes):
    """vectorized replay of the reference's storeAligns bookkeeping
    (reference: ReadAlign_storeAligns.cpp): builds each read's sorted piece
    table from the device probe arrays, preserving reference insertion
    order, dedup and multimap accounting."""
    seeds = [SeedResult(pc=[], nA=0, nUM=(0, 0), mult_nmin=0,
                        mult_nmin_l=0, max_good_piece=0, n_split=0)
             for _ in range(n_reads)]
    if probes is None:
        return seeds, _empty_seed_arrays()
    oml, onr, olo, ohi, mbest, nprobes = probes
    NC = len(c_read)
    if NC == 0:
        return seeds, _empty_seed_arrays()

    # flatten probes chain-major, chronological within chain
    np_max = int(nprobes.max()) if NC else 0
    if np_max == 0:
        return seeds, _empty_seed_arrays()
    k = np.arange(np_max)
    keep = k[None, :] < nprobes[:, None]              # [NC, np_max]
    ci, ki = np.nonzero(keep)
    # chain advance per round is the best (maxL + offset); lm_before gives
    # each round's start within the piece
    lm_before = np.zeros_like(mbest[:, :np_max])
    lm_before[:, 1:] = np.cumsum(mbest[:, :np_max - 1], axis=1)
    # sparse phase offsets: every offset-winning probe of a round is stored
    # (reference maxMappableLength2strands.cpp:18-113); offsets past the
    # remaining seed length were never probed
    D = oml.shape[2]
    dists = np.arange(D, dtype=np.int64)
    slen_r = c_plen[ci] - c_istl[ci] - lm_before[ci, ki]
    win = (dists[None, :] < slen_r[:, None]) \
        & (oml[ci, ki] + dists[None, :] == mbest[ci, ki][:, None])
    pi, di_ = np.nonzero(win)     # round-major, offset-minor (storeAligns order)
    ci = ci[pi]
    ki = ki[pi]
    maxl = oml[ci, ki, di_]
    nrep = onr[ci, ki, di_]
    lo = olo[ci, ki, di_]
    hi = ohi[ci, ki, di_]
    adv = c_istl[ci] + lm_before[ci, ki] + di_
    shift = np.where(c_dir[ci] == 0,
                     c_pstart[ci] + adv,
                     c_pstart[ci] + c_plen[ci] - 1 - adv)

    # reference skip rule: if the piece's (dir0, istart0) chain mapped the
    # whole piece in its first probe, the (dir1, istart0) chain is skipped.
    # The reference compares Shift+L (absolute read position, including the
    # piece start) against the piece LENGTH (ReadAlign_mapOneRead.cpp:74) —
    # so for N-split pieces with p_start>0 the skip almost never fires;
    # replicate that quirk exactly.
    is_d0i0 = (c_dir == 0) & (c_istl == 0)
    first_full = np.zeros(NC, dtype=bool)
    first_full[is_d0i0] = (nprobes[is_d0i0] > 0) & \
        (c_pstart[is_d0i0] + mbest[is_d0i0, 0] == c_plen[is_d0i0])
    piece_key = c_read.astype(np.int64) * (c_piece.max() + 1) + c_piece
    full_by_piece = {}
    for c in np.nonzero(is_d0i0 & first_full)[0]:
        full_by_piece[piece_key[c]] = True
    skip_chain = np.zeros(NC, dtype=bool)
    is_d1i0 = (c_dir == 1) & (c_istl == 0)
    for c in np.nonzero(is_d1i0)[0]:
        if full_by_piece.get(piece_key[c]):
            skip_chain[c] = True
    kept = ~skip_chain[ci]
    ci, maxl, nrep, lo, hi, shift = \
        ci[kept], maxl[kept], nrep[kept], lo[kept], hi[kept], shift[kept]

    read = c_read[ci]
    idir = c_dir[ci]
    ifrag = c_ifrag[ci]

    # multimap cap: dropped probes only update (mult_nmin, mult_nmin_l)
    over = nrep > P.seedMultimapNmax
    if over.any():
        ro, no, lo_ = read[over], nrep[over], maxl[over]
        order = np.lexsort((np.arange(len(ro)), no, ro))
        ro_s, no_s, l_s = ro[order], no[order], lo_[order]
        firsts = np.ones(len(ro_s), dtype=bool)
        firsts[1:] = ro_s[1:] != ro_s[:-1]
        for r, n_, l_ in zip(ro_s[firsts], no_s[firsts], l_s[firsts]):
            seeds[r].mult_nmin = int(n_)
            seeds[r].mult_nmin_l = int(l_)
    read, idir, ifrag, maxl, nrep, lo, hi, shift = [
        a[~over] for a in (read, idir, ifrag, maxl, nrep, lo, hi, shift)]

    # accounting (reference nUM / nA counters)
    uniq = nrep == 1
    add0 = np.bincount(read[uniq], weights=nrep[uniq], minlength=n_reads)
    add1 = np.bincount(read[~uniq], weights=nrep[~uniq], minlength=n_reads)
    addA = np.bincount(read, weights=nrep, minlength=n_reads)
    for r in range(n_reads):
        seeds[r].nUM = (int(add0[r]), int(add1[r]))
        seeds[r].nA = int(addA[r])

    # sorted-insert + dedup == stable sort by (rStart asc, Length desc,
    # insertion order) then drop later (rStart, Length) duplicates
    r_start = np.where(idir == 0, shift, shift + 1 - maxl)
    order = np.lexsort((np.arange(len(read)), -maxl, r_start, read))
    rs, ln, rd = r_start[order], maxl[order], read[order]
    dup = np.zeros(len(order), dtype=bool)
    dup[1:] = (rd[1:] == rd[:-1]) & (rs[1:] == rs[:-1]) & (ln[1:] == ln[:-1])
    order = order[~dup]
    counts = np.bincount(read[order], minlength=n_reads)
    if (counts > P.seedPerReadNmax).any():
        raise RuntimeError(
            "too many pieces per read; increase --seedPerReadNmax")
    # pc row lists are only consumed by the per-read host oracle; build them
    # lazily for just the fallback reads (the append loop over every read
    # was ~4% of wall time)
    starts = np.zeros(n_reads + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    pc_rows = np.stack([r_start[order], maxl[order], idir[order],
                        nrep[order], lo[order], hi[order],
                        ifrag[order]], axis=1)

    def fill_pc(i):
        if not seeds[i].pc:
            seeds[i].pc = pc_rows[starts[i]:starts[i + 1]].tolist()

    for r in range(n_reads):
        seeds[r]._fill_pc = fill_pc
    from .batch_engine import SeedArrays
    flat = SeedArrays(
        read=read[order].astype(np.int32),
        r_start=r_start[order].astype(np.int64),
        length=maxl[order].astype(np.int64),
        idir=idir[order].astype(np.int8),
        nrep=nrep[order].astype(np.int64),
        lo=lo[order].astype(np.int64), hi=hi[order].astype(np.int64),
        ifrag=ifrag[order].astype(np.int8))
    return seeds, flat


def _build_queries(read_mat, read_i, shifts, seed_lens, dirs, QL):
    """probe descriptors -> [B, QL] int8 queries padded with -1, on the
    device.  dir==1 probes read backwards complemented (reference: the
    reverse-search query is complement(read[shift-k])).  A position outside
    the read matrix row reads -1 (the fill of star_tpu's barrel shifter
    _shift_rows); every position at or past the seed length is -1."""
    RW = read_mat.shape[1]
    k = torch.arange(QL, device=read_mat.device)[None, :]
    rev = dirs[:, None] == 1
    pos = shifts[:, None] + torch.where(rev, -k, k)
    q = read_mat[read_i[:, None], pos.clamp(0, RW - 1)]
    q = torch.where(rev, 3 - q, q)
    q = torch.where((pos >= 0) & (pos < RW), q, -1)
    return torch.where(k < seed_lens[:, None], q, -1).to(torch.int8)
