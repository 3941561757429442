"""The per-layer readers' arithmetic on a hand-made record."""
from __future__ import annotations

import importlib.util
import json
import os

import pytest

import portbench_tiny  # noqa: F401  (puts the benchmark on sys.path)

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name, os.path.join(PB, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


REC = {"reads": 200000, "window_s": 40.0, "busy_s": 1.5,
       "timers": {"prepare": 1.0, "seed_loop": 0.5, "stitch_level_W8": 2.0,
                  "stitch_level_W512": 8.0, "dev_grow_W8": 0.25,
                  "dev_grow_W512": 1.75, "finish": 3.0, "bam_encode": 2.0,
                  "bam_finish": 0.5, "quant": 0.4},
       "fetch": {"kernel_ms": 20.0, "bound_ms": 5.0, "bytes": 1, "calls": 3}}

WANT = {"prepare_s_per_mread": 5.0, "seed_loop_s_per_mread": 2.5,
        "stitch_w8_s_per_mread": 10.0, "stitch_w512_s_per_mread": 40.0,
        "dev_grow_s_per_mread": 10.0, "finish_s_per_mread": 15.0,
        "bam_s_per_mread": 12.5, "quant_s_per_mread": 2.0,
        "fetch_window_roofline_pct": 25.0, "device_idle_pct": 96.25,
        "solo_count_s_per_mread": None, "solo_process_s": None}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader(name):
    got = _reader(name)(REC)
    if WANT[name] is None:
        assert got is None          # nothing to read: left out, never 0
    else:
        assert got == pytest.approx(WANT[name])


def test_every_metric_has_a_reader():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(PB, "metrics", m["name"] + ".py"))


def test_roofline_reads_nothing_without_calls():
    assert _reader("fetch_window_roofline_pct")(
        dict(REC, fetch={"kernel_ms": 0.0, "bound_ms": 0.0, "bytes": 0,
                         "calls": 0})) is None
    assert _reader("device_idle_pct")({k: v for k, v in REC.items()
                                       if k != "busy_s"}) is None
