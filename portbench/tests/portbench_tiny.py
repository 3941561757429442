"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark's
folder with a tiny genome and small batches, in which the port runs on CPU
tensors (the kernels' plain versions)."""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
for p in (ROOT, PB):
    if p not in sys.path:
        sys.path.insert(0, p)

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELLS = tuple(w["name"] for w in json.load(_f)["workloads"])
# cells whose files are kept for when the program can run them, outside
# BENCHMARK.json (PERF.md, Open questions)
PARKED = tuple(sorted(n[:-5] for n in os.listdir(os.path.join(PB, "workloads"))
                      if n[:-5] not in CELLS))


def make_tiny(dest):
    """a copy of portbench (and BENCHMARK.json, with the parked cells in
    it) whose cells run on a 1.8 Mb genome of 30 genes in 512-read batches
    (a 20,000-barcode whitelist and 100 cells for 10x traffic); returns its
    portbench dir"""
    pb = os.path.join(dest, "portbench")
    shutil.copytree(PB, pb, ignore=shutil.ignore_patterns(
        "cache", "out", "__pycache__", "tests"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for cell in PARKED:
        cfg = json.load(open(os.path.join(pb, "workloads", cell + ".json")))["config"]
        if cfg not in [c["name"] for c in bench["configs"]]:
            bench["configs"].append({"name": cfg,
                                     "file": f"portbench/configs/{cfg}.json"})
        bench["workloads"].append({"name": cell, "config": cfg, "chips": 1})
    json.dump(bench, open(os.path.join(dest, "BENCHMARK.json"), "w"))
    g = json.load(open(os.path.join(pb, "genomes", "chr20_scale_repeats.json")))
    g["chromosomes"] = [["chr1", 1200000], ["chr2", 600000]]
    g["genes"].update(n=30, intron_max=8000, chr_margin=5000)
    g["repeats"]["segdup"]["copy_len"] = [2000, 8000]
    json.dump(g, open(os.path.join(pb, "genomes", "tiny.json"), "w"))
    for name in os.listdir(os.path.join(pb, "configs")):
        cp = os.path.join(pb, "configs", name)
        c = json.load(open(cp))
        c["genome"] = "tiny"
        c["index_flags"] = ["--sjdbOverhang", "99", "--genomeSAindexNbases",
                            "9"]
        if "--soloCellFilter" in c["flags"]:        # 100 expected cells
            c["flags"][c["flags"].index("--soloCellFilter") + 2] = "100"
        json.dump(c, open(cp, "w"))
    for name in os.listdir(os.path.join(pb, "workloads")):
        wp = os.path.join(pb, "workloads", name)
        w = json.load(open(wp))
        w["params"]["batch_reads"] = 256
        if w["traffic"] == "tenx_v3":
            w["params"].update(whitelist=20000, cells=100, ambient=500)
        w["warmup_reads"] = 256
        w["window_reads"] = 7680             # 1,024 reads at --seconds 4
        w["flags"] = ["--tpuBatchSize", "512"]
        json.dump(w, open(wp, "w"))
    return pb


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    import torch
    torch.set_num_threads(2)
    return make_tiny(str(tmp_path_factory.mktemp("tiny")))


@pytest.fixture(scope="session")
def run_mod():
    import run
    return run
