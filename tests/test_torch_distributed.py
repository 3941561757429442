"""Two gloo ranks of star_tpu_torch.parallel.dist, four CPU shards each:
the sharded MMP over a batch sharded across the ranks equals the host
oracle, where the ranks split dp (2 x 4) and where one ix row spans both
(1 x 8), and both ranks' keyed merges equal the host union merge (keys and
counts past 2^32)."""
import os
import subprocess
import sys

import numpy as np
import pytest

from star_tpu.align.seed import mmp_search
from tests.conftest import GOLD, ROOT
from tests.test_distributed import _free_port
from tests.test_sharding import _make_queries


@pytest.mark.parametrize("dp,ix", [(2, 4), (1, 8)])
def test_two_rank_sharded_mmp_and_keyed_merge(tmp_path, genome_index, dp, ix):
    gi = genome_index
    qs, qlens = _make_queries(gi, 64, seed=11, ql=128)
    qfile = str(tmp_path / "q.npz")
    np.savez(qfile, qs=qs, qlens=qlens)
    coord = f"127.0.0.1:{_free_port()}"
    outs = [str(tmp_path / f"out{r}.npz") for r in range(2)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "star_tpu_torch.parallel.dist", coord, "2",
         str(r), os.path.join(GOLD, "genome_idx"), qfile, outs[r], str(ix)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, lg[-3000:]

    z = [np.load(o) for o in outs]
    # each rank answered its dp rows' lanes; with one row both hold all
    split = np.array_split(np.arange(len(qs)), dp)
    for r, zr in enumerate(z):
        assert np.array_equal(zr["lanes"], split[r] if dp == 2
                              else np.arange(len(qs)))
    want = np.array([mmp_search(gi, qs[b, :qlens[b]])
                     for b in range(len(qs))])
    for zr in z:
        got = np.stack([zr[k] for k in ("maxl", "nrep", "lo", "hi")], axis=1)
        assert np.array_equal(got, want[zr["lanes"]])

    union = {}
    for zr in z:
        for k, c in zip(zr["keys"], zr["cnts"]):
            union[int(k)] = union.get(int(k), 0) + c
    keys = sorted(union)
    assert keys[-1] > 1 << 32 and max(map(max, union.values())) > 1 << 33
    for zr in z:
        assert zr["all_keys"].dtype == np.int64
        assert list(zr["all_keys"]) == keys
        assert np.array_equal(zr["merged"], np.array([union[k] for k in keys]))
