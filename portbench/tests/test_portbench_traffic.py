"""The traffic generators: the same reads for a seed, other reads for
another, the shares of each cell's file, and truth blocks that hold the
read."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

from portbench_tiny import tiny  # noqa: F401

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _traffic(pb, cell, seed):
    from portbench.harness import cache
    from portbench.harness.feeder import make_traffic
    wl = json.load(open(os.path.join(pb, "workloads", cell + ".json")))
    cfg = json.load(open(os.path.join(pb, "configs", wl["config"] + ".json")))
    gdir = cache.genome_dir(cfg["genome"], pb)
    return make_traffic({"root": os.path.dirname(pb), "model_dir": gdir,
                         "seed": seed, "params": wl["params"],
                         "traffic_file": os.path.join(
                             pb, "traffic", wl["traffic"] + ".py")}), wl


BULK = sorted(f[:-5] for f in os.listdir(os.path.join(PB, "workloads"))
              if json.load(open(os.path.join(PB, "workloads", f)))["traffic"]
              == "bulk_rnaseq")


@pytest.mark.parametrize("cell", BULK)
def test_bulk_deterministic_per_seed(tiny, cell):
    a, _ = _traffic(tiny, cell, 2**31 + 7)
    b, _ = _traffic(tiny, cell, 2**31 + 7)
    c, _ = _traffic(tiny, cell, 2**31 + 8)
    assert a.batch(1) == b.batch(1)
    assert a.batch(1)[0] != c.batch(1)[0]
    assert a.batch(0)[0] != a.batch(0, stream=1)[0]


@pytest.mark.parametrize("cell", BULK)
def test_bulk_shares_and_truth(tiny, cell):
    t, wl = _traffic(tiny, cell, 12345)
    reads, truth = t.window_reads(4 * int(wl["params"]["batch_reads"]))
    n = len(truth)
    kinds = [v[0] for v in truth.values()]
    for k, share in wl["params"]["shares"].items():
        got = kinds.count(k) / n
        assert abs(got - share) < 4 * np.sqrt(share * (1 - share) / n) + 1e-9
    comp = str.maketrans("ACGT", "TGCA")
    seq = t.m.seq
    mism = 0
    for name, (kind, c, fwd, blocks) in truth.items():
        r = reads[name][0]
        f = r if fwd else r.translate(comp)[::-1]
        assert len(f) == t.L
        for g, q, ln in blocks:
            want = "".join("ACGT"[x] for x in seq[g:g + ln])
            mism += sum(x != y for x, y in zip(f[q:q + ln], want))
    # substitutions only: about sub_rate of the bases
    rate = mism / (n * t.L)
    assert rate < 3 * wl["params"]["sub_rate"] + 1e-3
