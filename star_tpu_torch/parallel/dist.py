"""Multi-process runtime: batch sharding over ranks + keyed table merges.

The reference scales only by threads in one process (SURVEY.md section 2.3);
multi-node was "run independent STAR processes per sample".  The port's
scale-out is a torch.distributed program: every rank feeds its dp rows'
slice of the probe batch, the suffix-array shards live on the "ix" axis
(parallel/mesh.py), and the result tables that the reference merges
thread-0-wise (SJ junction counts, solo per-CB counts, gene counts —
source/STAR.cpp:258-265, outputSJ.cpp, SoloFeature_sumThreads.cpp) are
merged with collectives: NCCL between cards, gloo between CPU processes.
Keys and counts travel as int64 (star_tpu's two-int32-limb and 16-bit-limb
encodings exist only because JAX runs with x64 off).

tests/test_torch_distributed.py launches two ranks of _worker_main with four
CPU shards each and requires results equal to the host oracle:

    python -m star_tpu_torch.parallel.dist <host:port> <n_proc> <rank> \\
        <index dir> <queries .npz> <out .npz> [ix]
"""
from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from ..ops.fetch import resolve_device


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     local_device_count: int = None, device=None):
    """join the process group at tcp://coordinator: NCCL when this rank runs
    on a card (the default; card process_id % device_count), gloo on the
    CPU (device='cpu').  Returns this rank's shards for make_mesh:
    local_device_count (default 1) slots on its device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return [dev] * (local_device_count or 1)


def _tensor(x, device):
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=torch.int64)


def _like(x, t):
    """t back in the kind, dtype and device of x"""
    if isinstance(x, torch.Tensor):
        return t.to(device=x.device, dtype=x.dtype)
    return t.cpu().numpy().astype(np.asarray(x).dtype)


def merge_keyed_counts(local_keys, local_counts, mesh):
    """merge per-rank keyed count tables (SJ junction counts, solo per-CB
    counts): every rank's key set is all-gathered and unioned, and the
    counts, dense over the union, are summed with all_reduce — the
    multi-process analog of the reference's thread-0 merges (outputSJ.cpp:
    20-80, SoloFeature_sumThreads.cpp).  Each rank's table counts once.
    Returns (all_keys sorted unique, merged counts [K, ...]), identical on
    every rank, in the kind of the inputs (numpy arrays or tensors); the
    collectives run on mesh.comm_device."""
    dev = mesh.comm_device
    keys = _tensor(local_keys, dev)
    counts = _tensor(local_counts, dev)
    on = dist.is_initialized()
    if on:
        world = dist.get_world_size()
        n = torch.tensor([keys.numel()], dtype=torch.int64, device=dev)
        lens = [torch.zeros_like(n) for _ in range(world)]
        dist.all_gather(lens, n)
        lens = [int(m) for m in lens]
        kp = torch.zeros(max(max(lens), 1), dtype=torch.int64, device=dev)
        kp[:keys.numel()] = keys
        got = [torch.empty_like(kp) for _ in range(world)]
        dist.all_gather(got, kp)
        all_keys = torch.unique(torch.cat([g[:m] for g, m in zip(got, lens)]))
    else:
        all_keys = torch.unique(keys)
    merged = torch.zeros((all_keys.numel(),) + tuple(counts.shape[1:]),
                         dtype=torch.int64, device=dev)
    merged.index_add_(0, torch.searchsorted(all_keys, keys), counts)
    if on:
        dist.all_reduce(merged, op=dist.ReduceOp.SUM)
    return _like(local_keys, all_keys), _like(local_counts, merged)


def _worker_main(argv):
    """test worker: sharded MMP over a batch-sharded query set + a keyed
    merge, from one of N gloo ranks with four CPU shards each"""
    coordinator, n_proc, pid = argv[0], int(argv[1]), int(argv[2])
    idx_dir, query_file, out_file = argv[3], argv[4], argv[5]
    ix = int(argv[6]) if len(argv) > 6 else 4
    torch.set_num_threads(1)
    devices = init_distributed(coordinator, n_proc, pid,
                               local_device_count=4, device="cpu")
    try:
        from ..genome.index import GenomeIndex
        from .mesh import ShardedIndex, make_mesh, make_sharded_mmp
        gi = GenomeIndex.load(idx_dir)
        mesh = make_mesh(devices, dp=4 * n_proc // ix, ix=ix)
        mmp = make_sharded_mmp(ShardedIndex.build(gi, mesh, ql=128))

        # this rank's lanes: its dp rows' slices of the batch
        z = np.load(query_file)
        qs, qlens = z["qs"], z["qlens"]
        split = np.array_split(np.arange(len(qs)), mesh.dp)
        lanes = np.concatenate([split[r] for r in mesh.rows])
        out = [t.numpy() for t in mmp(torch.from_numpy(qs[lanes]),
                                      torch.from_numpy(qlens[lanes]))]

        # keyed merge: per-rank partial tables with overlapping key sets,
        # keys and summed counts past 2^32 -> identical totals on every rank
        rng = np.random.default_rng(100 + pid)
        keys = (1 << 33) + np.unique(rng.integers(0, 40, size=12)) * (1 << 28)
        cnts = (1 << 32) + rng.integers(1, 9, size=(len(keys), 2))
        all_keys, merged = merge_keyed_counts(keys, cnts, mesh)
        np.savez(out_file, lanes=lanes, maxl=out[0], nrep=out[1], lo=out[2],
                 hi=out[3], keys=keys, cnts=cnts, all_keys=all_keys,
                 merged=merged)
    finally:
        dist.destroy_process_group()
    print(f"worker {pid} done", flush=True)


if __name__ == "__main__":
    _worker_main(sys.argv[1:])
