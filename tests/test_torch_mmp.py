"""Batched MMP search of star_tpu_torch against star_tpu's jitted MMP kernel
and the host oracle mmp_search, on the dense and the sparse golden index.
Exact equality of (maxL, nrep, lo, hi)."""
import os

import numpy as np
import pytest
import torch

from star_tpu.align.seed import mmp_search
from star_tpu.genome.index import GenomeIndex as JaxGenomeIndex
from star_tpu.ops.sa_search import DeviceIndex as JaxDeviceIndex
from star_tpu.ops.sa_search import make_mmp_kernel
from star_tpu_torch.genome.index import GenomeIndex
from star_tpu_torch.ops.sa_search import DeviceIndex, make_mmp_fn
from tests.conftest import GOLD

QL = 128


def port_index(gi_jax):
    """the port's GenomeIndex built from the same arrays as star_tpu's"""
    from dataclasses import fields
    return GenomeIndex.from_arrays(
        {f.name: getattr(gi_jax, f.name) for f in fields(gi_jax)})


def _queries(gi, n=512, seed=0):
    """genomic substrings (some mutated), random sequences, short queries,
    and queries that start with an L-prefix absent from the SAi (the descent
    stops early: cases 1 and 4)"""
    rng = np.random.default_rng(seed)
    L = gi.sa_index_nbases
    ls = gi.sai_level_start
    absent = np.nonzero(gi.sai_absent[ls[L - 1]:ls[L]])[0]
    qs = np.full((n, QL), -1, dtype=np.int8)
    qlens = np.zeros(n, dtype=np.int32)
    for b in range(n):
        kind = b % 4
        ln = int(rng.integers(L + 1, 100))
        if kind == 0:
            p0 = int(rng.integers(0, 2 * gi.n_genome - 200))
            q = gi.t2[p0:p0 + ln].copy()
            if (q >= 4).any():
                q = rng.integers(0, 4, size=ln).astype(np.int8)
            elif b % 8 == 0:
                q[int(rng.integers(2, ln - 2))] = int(rng.integers(0, 4))
        elif kind == 1:
            q = rng.integers(0, 4, size=ln).astype(np.int8)
        elif kind == 2:
            q = rng.integers(0, 4, size=int(rng.integers(1, L + 2))).astype(np.int8)
        else:
            v = int(absent[int(rng.integers(0, len(absent)))])
            pre = [(v >> (2 * (L - 1 - i))) & 3 for i in range(L)]
            q = np.concatenate([pre, rng.integers(0, 4, size=ln - L)]).astype(np.int8)
        qs[b, :len(q)] = q
        qlens[b] = len(q)
    return qs, qlens


@pytest.mark.parametrize("idx", ["genome_idx", "genome_idx_sp2"])
def test_mmp_matches_jax_and_host(idx):
    gj = JaxGenomeIndex.load(os.path.join(GOLD, idx))
    gp = port_index(gj)
    qs, qlens = _queries(gj)

    mmp = make_mmp_fn(DeviceIndex.build(gp, ql=QL, device="cpu"))
    got = np.stack([t.numpy() for t in mmp(torch.from_numpy(qs),
                                           torch.from_numpy(qlens))], axis=1)
    kern = make_mmp_kernel(JaxDeviceIndex.build(gj, ql=QL))
    want = np.stack([np.asarray(x) for x in kern(qs, qlens)], axis=1)
    host = np.array([mmp_search(gj, qs[b, :qlens[b]]) for b in range(len(qs))])
    assert np.array_equal(got, host)
    # star_tpu's kernel resolves an N-flagged SAi block of a query no longer
    # than the SAi depth as one equal range (its case 4 lacks the no_n
    # check) and then differs from the host oracle; the port follows the
    # host there and equals star_tpu everywhere else
    jax_ok = (want == host).all(axis=1)
    assert jax_ok[qlens > gj.sa_index_nbases].all()
    assert np.array_equal(got[jax_ok], want[jax_ok])
    # the absent-prefix queries stop the descent below the SAi depth
    assert (got[3::4, 0] < gj.sa_index_nbases).any()


def test_mmp_lane_independent_of_batch():
    """the lockstep loops run until the slowest lane converges; a lane's
    result must not depend on which other lanes share its batch"""
    gj = JaxGenomeIndex.load(os.path.join(GOLD, "genome_idx"))
    qs, qlens = _queries(gj, n=64, seed=3)
    mmp = make_mmp_fn(DeviceIndex.build(port_index(gj), ql=QL, device="cpu"))
    full = np.stack([t.numpy() for t in mmp(torch.from_numpy(qs),
                                            torch.from_numpy(qlens))], axis=1)
    perm = np.random.default_rng(4).permutation(len(qs))[:21]
    part = np.stack([t.numpy() for t in mmp(torch.from_numpy(qs[perm]),
                                            torch.from_numpy(qlens[perm]))],
                    axis=1)
    assert np.array_equal(part, full[perm])


def test_argmax_returns_first_maximum():
    """lcp_lt takes the first mismatch as argmax over a 0/1 row"""
    rng = np.random.default_rng(7)
    m = rng.random((256, QL)) < 0.05
    got = torch.from_numpy(m).to(torch.uint8).argmax(dim=1).numpy()
    assert np.array_equal(got, np.argmax(m, axis=1))
