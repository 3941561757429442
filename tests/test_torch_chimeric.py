"""Chimeric detection through star_tpu_torch against the STAR goldens:
Chimeric.out.junction (old and multimapping detection, with its column
header), Chimeric.out.sam (SeparateSAMold) and the WithinBAM records, on the
host oracle and on the device path on CPU tensors, where the seed loop runs
on the device and the stitch on the host (batch_engine.fast_path_config_ok
sends chimeric configs there, as in star_tpu).  Exact equality throughout.
The cases are those of chip_smoke.FUSION_GOLDENS, which phase 6 runs on
the card.

run_port is the helper of the other test_torch_* files of this slice."""
import os
from unittest import mock

import pytest

from chip_smoke import FUSION_GOLDENS
from star_tpu_torch.ops import batch_engine as be
from star_tpu_torch.ops import pipeline
from star_tpu_torch.params import Parameters
from star_tpu_torch.run import align_reads
from tests.conftest import DATA, GOLD
from tests.test_bam import read_bam_records
from tests.test_torch_stitch import force_device_grow, one_torch_thread  # noqa: F401


def _sam_body(path, skip=("@",)):
    with open(path) as f:
        return [l for l in f if not l.startswith(skip)]


def run_port(tmp_path, reads, flags, engine, idx=None):
    """map reads through star_tpu_torch.run.align_reads and return the output
    prefix.  engine: 'host' (the per-read host oracle), 'device' (the device
    path on CPU tensors: the seed loop must run there) or 'forced' (the
    device path with the stitch engine forced on every level by the fixture
    force_device_grow, which must then take at least one level)"""
    prefix = str(tmp_path) + "/"
    P = Parameters(["--genomeDir", idx or os.path.join(GOLD, "genome_idx"),
                    "--readFilesIn", *[os.path.join(DATA, r) for r in reads],
                    "--outFileNamePrefix", prefix, *flags])
    if engine == "host":
        align_reads(P, use_device=False)
        return prefix
    real = pipeline.DeviceAligner._run_chains_fused
    be.LEVEL_STATS.clear()
    with mock.patch.object(pipeline.DeviceAligner, "_run_chains_fused",
                           autospec=True, side_effect=real) as seed_loop:
        align_reads(P, device="cpu")
    assert seed_loop.call_count > 0
    if engine == "forced":
        assert sum(v for (w, k), v in be.LEVEL_STATS.items()
                   if k == "device") > 0
    return prefix


def assert_files(prefix, gold, files):
    for f in files:
        want = os.path.join(GOLD, gold, f)
        if f.endswith(".bam"):
            assert read_bam_records(prefix + f) == read_bam_records(want), f
        elif f.endswith(".sam"):
            # the @PG/@CO lines name the command line; @HD/@SQ must agree
            skip = ("@PG", "@CO") if f.startswith("Chimeric") else ("@",)
            assert _sam_body(prefix + f, skip) == _sam_body(want, skip), f
        else:
            with open(prefix + f) as a, open(want) as b:
                assert a.read() == b.read(), f


CHIM_CASES = [c for c in FUSION_GOLDENS if "chim" in c[0]]


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("gold,reads,flags,files", CHIM_CASES,
                         ids=[c[0] for c in CHIM_CASES])
def test_chimeric_golden(tmp_path, gold, reads, flags, files, engine):
    prefix = run_port(tmp_path, reads, flags, engine)
    assert_files(prefix, gold, files)
    if "Chimeric.out.junction" in files:
        # the chimeric reads are counted in Log.final.out too (the junction
        # file has one line per read, or several per multimapping read)
        names = {l.split("\t")[9] for l in open(prefix + "Chimeric.out.junction")
                 if not l.startswith(("chr_donorA", "#"))}
        row = next(l for l in open(prefix + "Log.final.out")
                   if "Number of chimeric reads" in l)
        assert int(row.split("|")[1]) == len(names) > 0
