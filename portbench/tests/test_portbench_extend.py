"""A cell, a configuration, a traffic mix or a metric is added with new
files and new entries in BENCHMARK.json alone: in a copy of the folder, a
new cell file and its entry load, with the metrics that name it."""
from __future__ import annotations

import json
import os
import shutil

import portbench_tiny  # noqa: F401  (puts the benchmark on sys.path)

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)


def test_new_cell_and_metric_load_from_files_alone(tmp_path):
    import run
    pb = tmp_path / "portbench"
    shutil.copytree(PB, pb, ignore=shutil.ignore_patterns(
        "cache", "out", "__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    before = {p: open(p, "rb").read() for p in map(str, pb.rglob("*.*"))}
    # a new traffic mix of an existing generator, and a metric of it alone
    wl = json.load(open(pb / "workloads" / "solo_cr4_10xv3.pbmc.json"))
    wl["params"]["ambient_share"] = 0.6
    json.dump(wl, open(pb / "workloads" / "solo_cr4_10xv3.nuclei.json", "w"))
    (pb / "metrics" / "nuclei_share.py").write_text(
        "def read(rec):\n    return 1.0\n")
    bench["workloads"].append({"name": "solo_cr4_10xv3.nuclei",
                               "config": "solo_cr4_10xv3",
                               "traffic": "nuclei", "chips": 1,
                               "why": "more ambient reads"})
    bench["per_layer"].append({"name": "nuclei_share", "unit": "%",
                               "better": "higher", "source": "program_counter",
                               "layer": "single-cell counting (solo/)", "moves":
                               "reads_per_s",
                               "workloads": ["solo_cr4_10xv3.nuclei"]})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    cell = run.Cell("solo_cr4_10xv3.nuclei", str(pb))
    assert cell.wl["params"]["ambient_share"] == 0.6
    assert cell.cfg["name"] == "solo_cr4_10xv3"
    names = [m["name"] for m in cell.metrics(True)]
    assert "nuclei_share" in names and "solo_process_s" not in names
    pbmc = run.Cell("solo_cr4_10xv3.pbmc", str(pb))
    assert "nuclei_share" not in [m["name"] for m in pbmc.metrics(True)]
    assert [m["name"] for m in pbmc.metrics(False)] == \
        ["reads_per_s", "peak_mem_gib", "setup_s"]
    # no file that was there changed
    for p, b in before.items():
        assert open(p, "rb").read() == b, p
