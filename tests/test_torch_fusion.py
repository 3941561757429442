"""The slice as a whole against star_tpu: a seeded paired-end 2 x 100 set on
the small genome with planted chr1-chr2 fusions and overlapping mates
(chip_smoke.fusion_pairs, which phase 6 of chip_smoke.py runs at the
chr20 scale), mapped with STAR-Fusion's STAR flags (chimeric detection with
multimapping chimeras, the mate-overlap merge) through star_tpu's host
oracle and through star_tpu_torch: the SAM, SJ.out.tab and
Chimeric.out.junction byte-identical.  No golden covers PE chimeric
detection with the overlap merge."""
import os

import numpy as np
import pytest

from chip_smoke import FUSION_FLAGS, fusion_pairs
from star_tpu.params import Parameters as JaxParameters
from star_tpu.run import align_reads as jax_align_reads
from star_tpu_torch.align import engine
from tests.conftest import DATA, GOLD
from tests.test_torch_chimeric import run_port
from tests.test_torch_stitch import one_torch_thread  # noqa: F401

N_PAIRS = 400
FILES = ["Aligned.out.sam", "SJ.out.tab", "Chimeric.out.junction"]


@pytest.fixture(scope="module")
def fusion_set(tmp_path_factory):
    """the pair set and star_tpu's outputs for it"""
    d = tmp_path_factory.mktemp("fusion")
    r1, r2 = str(d / "r_1.fastq"), str(d / "r_2.fastq")
    fusions = fusion_pairs(np, os.path.join(DATA, "genome.fa"), r1, r2,
                           N_PAIRS, 4, seed=7)
    prefix = str(d / "jax") + "/"
    jax_align_reads(JaxParameters(
        ["--genomeDir", os.path.join(GOLD, "genome_idx"),
         "--readFilesIn", r1, r2, "--outFileNamePrefix", prefix,
         *FUSION_FLAGS]), use_device=False)
    return (r1, r2), fusions, prefix


@pytest.mark.parametrize("engine_", ["host", "device"])
def test_fusion_set_matches_star_tpu(tmp_path, monkeypatch, fusion_set,
                                     engine_):
    reads, fusions, want = fusion_set
    merged = []
    real = engine.ReadAligner._pe_overlap_merge_map

    def spy(self, res, reads_):
        real(self, res, reads_)
        merged.append(res.pe_ov_yes)
    monkeypatch.setattr(engine.ReadAligner, "_pe_overlap_merge_map", spy)
    got = run_port(tmp_path, reads, FUSION_FLAGS, engine_)
    for f in FILES:
        with open(got + f) as a, open(want + f) as b:
            assert a.read() == b.read(), f
    # the set exercises what it is for: merged mates, and chimeric
    # junctions (type >= 1: inside a mate) at planted fusions
    assert sum(merged) > N_PAIRS // 10
    lines = [l.split("\t") for l in open(got + "Chimeric.out.junction")
             if not l.startswith(("chr_donorA", "#"))]
    planted = {(c, p) for ca, a, cb, b in fusions
               for c, p in ((ca, a + 1), (cb, b - 1))}
    spanning = [l for l in lines if int(l[6]) >= 1]
    assert spanning and all({(l[0], int(l[1])), (l[3], int(l[4]))} <= planted
                            for l in spanning)
