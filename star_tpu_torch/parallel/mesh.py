"""Sharded layout: data-parallel probe batches x a row-sharded suffix array.

The reference scales by shared-memory threads on one node (reference:
source/mapThreadsSpawn.cpp, source/SharedMemory.cpp); the port's analog is a
2-D grid of index shards:

  * axis "dp": probe batches are data-parallel (each dp row takes its slice
    of the batch);
  * axis "ix": the suffix array is row-sharded over "ix" (the 26 GB human SA
    does not fit one device).  Every shard bisects its own rows for every
    probe of its dp row; per-shard candidates are combined with a max / min
    over the row's shards and, where a row spans ranks, with
    torch.distributed all_reduce over the ranks of the row.

A shard is a (rank, torch.device) slot.  Several shards may share one device
(four shards on one H100, eight on the CPU in the tests); the text and the
SAi are then held once per device, and the SA rows once per (device, column).

Correctness of the combine: for rows sorted lexicographically, the longest
common prefix with a query is unimodal around the query's insertion point, so
each shard's boundary-clipped insertion neighbourhood contains its shard-max
lcp, and the global best interval is the contiguous union of per-shard equal
ranges of the best prefix.  Results equal the host oracle mmp_search and the
single-device make_mmp_fn (tests/test_torch_sharding.py).

Every random access is one ops.fetch.fetch_window call (the SAi pair, the SA
row, the suffix text), as in the single-device MMP, and each bisection runs
until every lane has converged.  Dropped from star_tpu/parallel/mesh.py, all
TPU workarounds: the fixed-count fori_loop bisection, the host barrel shift
of make_sharded_seed_round (the port's seed loop takes the sharded MMP
directly: ops/pipeline.py make_fused_seed_fn), and the 16-bit limbs of
psum_merge (JAX runs with x64 off; the port sums in int64).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..ops import fetch
from ..ops.fetch import TILE, pad_table
from ..ops.sa_search import (SAI64, neighbour_lcp, prefix_bounds,
                              resolve_mmp, sai_descent)

BIG = 1 << 62    # +inf / -inf of the equal-range combine


@dataclass(frozen=True)
class Shard:
    row: int                 # dp row
    col: int                 # ix column: SA rows [col * S, (col + 1) * S)
    device: torch.device


@dataclass
class Mesh:
    """a dp x ix grid of index shards; this rank holds `shards`.  ix_group:
    the ranks holding the other columns of this rank's row (None where the
    rank holds whole rows); dp_group: the ranks whose rows make up the dp
    axis once each (None outside torch.distributed)."""
    dp: int
    ix: int
    shards: tuple
    ix_group: object
    dp_group: object
    comm_device: torch.device

    @property
    def rows(self) -> list:
        """this rank's dp rows, ascending"""
        return sorted({s.row for s in self.shards})


def _local_devices(devices):
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: star_tpu_torch runs on the GPU "
                "unless CPU shards are passed (make_mesh(['cpu'] * n))")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    return out


def make_mesh(devices=None, dp: int = None, ix: int = None) -> Mesh:
    """devices: this rank's shards (default: one per visible CUDA device).
    Inside torch.distributed every rank passes as many shards, and the
    global shard k = rank * len(devices) + j sits at (k // ix, k % ix).
    The default split is star_tpu's: ix = n // 2, dp = n // ix."""
    devs = _local_devices(devices)
    on = dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if on else (1, 0)
    L = len(devs)
    n = world * L
    if dp is None or ix is None:
        ix = max(1, n // 2) if n > 1 else 1
        dp = n // ix
    if dp * ix != n:
        raise ValueError(f"a {dp} x {ix} mesh needs {dp * ix} shards, "
                         f"got {world} x {L}")
    if ix % L and L % ix:
        raise ValueError(f"{L} shards a rank tile neither whole rows of "
                         f"{ix} nor a part of one")
    shards = tuple(Shard(k // ix, k % ix, devs[k - rank * L])
                   for k in range(rank * L, (rank + 1) * L))
    ix_group = dp_group = None
    comm = torch.device("cpu")
    if on:
        # every rank creates every group, in the same order
        span = max(ix // L, 1)          # ranks that share a row
        if span > 1:
            for g in range(world // span):
                ranks = list(range(g * span, (g + 1) * span))
                grp = dist.new_group(ranks)
                if rank in ranks:
                    ix_group = grp
        for c in range(span):
            ranks = list(range(c, world, span))
            grp = dist.new_group(ranks)
            if rank in ranks:
                dp_group = grp
        if dist.get_backend() == "nccl":
            comm = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dp, ix, shards, ix_group, dp_group, comm)


def pack_sai64(gi) -> np.ndarray:
    """SAi (value, absent, nbit) planes -> one int64 entry per slot
    (layout sa_search.SAI64: value in bits 0-61, N flag bit 62, absent
    the sign bit)"""
    u = gi.sai_val.astype(np.uint64)
    u |= gi.sai_nbit.astype(np.uint64) << np.uint64(62)
    u |= gi.sai_absent.astype(np.uint64) << np.uint64(63)
    return u.view(np.int64)


@dataclass
class ShardedIndex:
    """genome index laid out over a mesh.

    Mammal scale (2*nGenome or nSA >= 2^31, or big=True): SA rows are int64
    and only the forward genome G is stored, behind ql bytes of 5; a
    reverse-strand suffix at p >= N is complement(G[2N-1-p-k]), fetched as
    the forward window that ends at 2N-1-p, flipped.  Otherwise the text is
    the doubled text T2 and SA rows are int32.  SAi entries are int64 in
    both (pack_sai64).  The suffix array is padded to ix * S rows and
    row-sharded over "ix": every shard's rows point anywhere in the genome,
    so the text is device-local for the bisection to stay
    communication-free (SURVEY.md section 2.3)."""
    mesh: Mesh
    text: dict           # device -> padded text bytes
    sai: dict            # device -> padded SAi bytes
    sa: dict             # (device, col) -> padded bytes of the column's rows
    g_only: bool         # text holds G alone; reverse strand derived on fetch
    n_genome: int
    level_start: tuple
    n_sa: int
    n_levels: int
    ql: int
    shard_rows: int      # S = SA rows per shard
    big: bool            # SA rows int64

    @classmethod
    def build(cls, gi, mesh: Mesh, ql: int = 256, big: bool = None):
        if ql > TILE:
            raise ValueError("query window must fit one fetch tile")
        ix = mesh.ix
        S = -(-gi.n_sa // ix)
        if big is None:
            big = 2 * gi.n_genome >= 2**31 or gi.n_sa >= 2**31
        sa_pad = np.full(ix * S, gi.n_sa - 1,
                         dtype=np.int64 if big else np.int32)
        sa_pad[:gi.n_sa] = gi.sa
        text = pad_table(np.concatenate([np.full(ql, 5, np.int8), gi.G])
                         if big else gi.t2)
        sai = pad_table(pack_sai64(gi))
        devs = list(dict.fromkeys(s.device for s in mesh.shards))
        cols = list(dict.fromkeys((s.device, s.col) for s in mesh.shards))
        put = lambda a, d: torch.from_numpy(a).to(d)
        return cls(
            mesh=mesh,
            text={d: put(text, d) for d in devs},
            sai={d: put(sai, d) for d in devs},
            sa={(d, c): put(pad_table(sa_pad[c * S:(c + 1) * S]), d)
                for d, c in cols},
            g_only=big, n_genome=gi.n_genome,
            level_start=tuple(int(x) for x in gi.sai_level_start),
            n_sa=gi.n_sa, n_levels=gi.sa_index_nbases, ql=ql,
            shard_rows=S, big=big)


def _all_reduce_max(t, mesh):
    """elementwise max over the ranks of this rank's row"""
    if mesh.ix_group is None:
        return t
    x = t.to(mesh.comm_device)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.ix_group)
    return x.to(t.device)


def text_window(si: ShardedIndex, text, pos, run):
    """suffix bytes [B, si.ql] of the doubled text at positions pos (lanes
    not in run are skipped: junk), from a device's text table"""
    QL, N = si.ql, si.n_genome
    if not si.g_only:
        return fetch.fetch_window(text, torch.where(run, pos, -1), QL)
    # G alone behind QL bytes of 5: the forward window at QL + p, and the
    # window ending at 2N-1-p read backwards and complemented (its front
    # padding gives the 5s past 2N); a forward suffix that crosses N needs
    # both, one launch for the two
    B = pos.shape[0]
    w = fetch.fetch_window(text, torch.cat([
        torch.where(run & (pos < N), QL + pos, -1),
        torch.where(run & (pos + QL > N), 2 * N - pos, -1)]), QL)
    rev = w[B:].flip(1)
    rev = torch.where(rev < 4, 3 - rev, rev)
    k = torch.arange(QL, device=pos.device)
    return torch.where(pos[:, None] + k < N, w[:B], rev)


def make_sharded_mmp(si: ShardedIndex):
    """the sharded counterpart of ops.sa_search.make_mmp_fn:
        mmp(queries [B, QL] int8 (-1 padded), qlen [B], valid=None)
            -> (maxL, nrep, lo, hi) each [B] int64 on the queries' device.
    The queries are this rank's lanes: its dp rows' slices of the batch, in
    row order (one rank alone: the whole batch, split over dp).  The cases
    are make_mmp_fn's (sa_search.resolve_mmp); each search runs on every
    shard of the row over its clip of the rows, and the shards' answers
    are combined (star_tpu/parallel/mesh.py:201-233)."""
    mesh = si.mesh
    L, S = si.n_levels, si.shard_rows
    dtype = torch.int64 if si.big else torch.int32
    esize = 8 if si.big else 4

    def suffix_windows(sh):
        """shard-local SA rows -> suffix byte windows [B, QL]; lanes not in
        run are skipped (junk)"""
        sa, text = si.sa[sh.device, sh.col], si.text[sh.device]

        def suffix_window(rows, run):
            w = fetch.fetch_window(sa, torch.where(run, rows * esize, -1),
                                   esize)
            return text_window(si, text, w.view(dtype)[:, 0].long(), run)
        return suffix_window

    windows = {sh: suffix_windows(sh) for sh in mesh.shards}

    def row_mmp(row, q, qlen, valid):
        dev = q.device
        shards = [s for s in mesh.shards if s.row == row]
        on = {}           # device -> (q, qlen) there
        for sh in shards:
            on.setdefault(sh.device, (q.to(sh.device), qlen.to(sh.device)))

        def clip(sh, lo, hi, lanes):
            """a shard's clip of the rows [lo, hi), in its local rows"""
            d, base = sh.device, sh.col * S
            return ((lo.to(d) - base).clamp(0, S),
                    (hi.to(d) - base).clamp(0, S), lanes.to(d))

        def best_lcp(q, qlen, lo, hi, lanes):
            best = torch.zeros_like(lo)
            for sh in shards:
                qd, ld = on[sh.device]
                b = neighbour_lcp(windows[sh], qd, ld,
                                  *clip(sh, lo, hi, lanes))
                best = torch.maximum(best, b.to(dev))
            return _all_reduce_max(best, mesh)

        def equal_range(q, best, lo, hi, lanes):
            # shards without rows of the prefix give +BIG / -BIG
            first = torch.full_like(lo, BIG)
            end = torch.full_like(lo, -BIG)
            for sh in shards:
                qd, _ = on[sh.device]
                b0, b1 = prefix_bounds(windows[sh], qd, best.to(sh.device),
                                       *clip(sh, lo, hi, lanes))
                has = b0 < b1
                base = sh.col * S
                first = torch.minimum(first, torch.where(
                    has, b0 + base, BIG).to(dev))
                end = torch.maximum(end, torch.where(
                    has, b1 + base, -BIG).to(dev))
            neg, end = _all_reduce_max(torch.cat([-first, end]), mesh).chunk(2)
            return -neg, end

        # the SAi is on every device of the row: descend on the first
        d0 = shards[0].device
        desc = tuple(x.to(dev) for x in sai_descent(
            si.sai[d0], SAI64, si.level_start, si.n_sa, *on[d0],
            valid.to(d0)))
        return resolve_mmp(L, q, qlen, valid, desc, best_lcp, equal_range)

    def mmp(queries, qlen, valid=None):
        q = queries.clamp(min=-1)
        qlen = qlen.long()
        if valid is None:
            valid = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
        rows = mesh.rows
        outs = [row_mmp(r, *a) for r, a in zip(rows, zip(
            q.tensor_split(len(rows)), qlen.tensor_split(len(rows)),
            valid.tensor_split(len(rows))))]
        return tuple(torch.cat(x) for x in zip(*outs))

    return mmp


def psum_merge(tables, mesh: Mesh):
    """merge per-dp-row partial count tables (the analog of the reference's
    thread-0 gene-count reduction, source/STAR.cpp:258-265): the sum of this
    rank's rows, then an all_reduce(SUM) over the dp group.  tables: [dp,
    ...] numpy array or tensor -> summed [...] of the same kind, exact in
    int64."""
    t = tables if isinstance(tables, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(tables))
    if t.shape[0] != mesh.dp:
        raise ValueError(f"psum_merge: {t.shape[0]} tables for dp={mesh.dp}")
    part = t[mesh.rows].to(mesh.comm_device).sum(dim=0).to(t.dtype)
    if mesh.dp_group is not None:
        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=mesh.dp_group)
    return part.to(t.device) if isinstance(tables, torch.Tensor) \
        else part.cpu().numpy()
