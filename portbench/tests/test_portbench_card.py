"""The benchmark on the card, and its refusal without one.  The card's
case carries the `cuda` marker and decides in a fixture whether there is a
card; run it on the card with

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda portbench/tests/test_portbench_card.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

import portbench_tiny  # noqa: F401  (puts the benchmark on sys.path)

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs on the card only")


def test_no_card_no_result(monkeypatch, capsys):
    """without CUDA the run exits with another code than 0 and prints no
    result, and never falls back to the CPU"""
    import torch
    import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "solo_cr4_10xv3.pbmc", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_cell_runs_on_the_card(card):
    r = subprocess.run([sys.executable, os.path.join(PB, "run.py"),
                        "--workload", "solo_cr4_10xv3.pbmc", "--seed",
                        str(2**31 + 99), "--seconds", "5", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"reads_per_s", "peak_mem_gib", "setup_s"}
