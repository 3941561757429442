"""The PE mate-overlap merge and long reads through star_tpu_torch against
the STAR goldens.  peov (--peOverlapNbasesMin 10) on the host oracle, on the
device path on CPU tensors and with the device stitch engine forced: the
overlap merge-remap runs in ReadAligner.finish_read after the device stitch
(batch_engine.fast_finish_config_ok).  long (--tpuLongReads 1) maps on the
host seed-chain DP by design, as in star_tpu, and says so in Log.out."""
import os

import pytest
import torch

from chip_smoke import FUSION_GOLDENS, LONG_ROUTE
from star_tpu_torch.align import peoverlap
from star_tpu_torch.ops import pipeline
from star_tpu_torch.params import Parameters
from star_tpu_torch.run import align_reads
from tests.conftest import DATA, GOLD
from tests.test_torch_chimeric import assert_files, run_port
from tests.test_torch_stitch import force_device_grow, one_torch_thread  # noqa: F401

CASES = {c[0]: c[1:] for c in FUSION_GOLDENS if c[0] in ("peov", "long")}


@pytest.mark.parametrize("engine", ["host", "device", "forced"])
def test_pe_overlap_golden(tmp_path, monkeypatch, request, engine):
    if engine == "forced":
        request.getfixturevalue("force_device_grow")
    merged = []
    real = peoverlap.pe_merge_mates

    def spy(*a):
        out = real(*a)
        merged.append(out[0] > 0)
        return out
    monkeypatch.setattr(peoverlap, "pe_merge_mates", spy)
    reads, flags, files = CASES["peov"]
    prefix = run_port(tmp_path, reads, flags, engine)
    assert_files(prefix, "peov", files)
    assert sum(merged) > 0          # the merge-remap ran on overlapping mates


def test_long_reads_golden(tmp_path):
    reads, flags, files = CASES["long"]
    prefix = run_port(tmp_path, reads, flags, "host")
    assert_files(prefix, "long", files)


def test_long_reads_take_the_host_route(tmp_path, monkeypatch):
    """long reads asked of the device path (the default, cuda) map on the
    host without touching a device, log the route, and equal the golden"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_device(*a, **k):
        raise AssertionError("long reads reached the device path")
    monkeypatch.setattr(pipeline, "DeviceAligner", no_device)
    reads, flags, files = CASES["long"]
    prefix = str(tmp_path) + "/"
    P = Parameters(["--genomeDir", os.path.join(GOLD, "genome_idx"),
                    "--readFilesIn", *[os.path.join(DATA, r) for r in reads],
                    "--outFileNamePrefix", prefix, *flags])
    align_reads(P)
    assert LONG_ROUTE in open(prefix + "Log.out").read()
    assert_files(prefix, "long", files)
