"""SNP tags and WASP through star_tpu_torch against the STAR goldens:
--varVCFfile with vA/vG tags (var) and --waspOutputMode SAMtag with vW tags
(wasp), BAM records equal, on the host oracle and on the device path on CPU
tensors, where the seed loop runs on the device and the stitch on the host
(batch_engine.fast_path_config_ok), as in star_tpu.  The loaded variants
equal star_tpu's."""
import os

import numpy as np
import pytest

from chip_smoke import FUSION_GOLDENS
from star_tpu.align.variation import Variation as JaxVariation
from star_tpu.params import Parameters as JaxParameters
from star_tpu_torch.align.variation import Variation
from star_tpu_torch.genome.index import GenomeIndex
from star_tpu_torch.params import Parameters
from tests.conftest import DATA, GOLD
from tests.test_torch_chimeric import assert_files, run_port
from tests.test_torch_stitch import one_torch_thread  # noqa: F401

CASES = [c for c in FUSION_GOLDENS if c[0] in ("var", "wasp")]


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("gold,reads,flags,files", CASES,
                         ids=[c[0] for c in CASES])
def test_variation_golden(tmp_path, gold, reads, flags, files, engine):
    prefix = run_port(tmp_path, reads, flags, engine)
    assert_files(prefix, gold, files)


def test_variants_load_as_in_star_tpu():
    argv = ["--genomeDir", os.path.join(GOLD, "genome_idx"),
            "--readFilesIn", "none.fastq",
            "--varVCFfile", os.path.join(DATA, "var.vcf")]
    gi = GenomeIndex.load(os.path.join(GOLD, "genome_idx"))
    ids = {n: i for i, n in enumerate(gi.chr_name)}
    got = Variation(Parameters(argv), gi.chr_start, ids)
    want = JaxVariation(JaxParameters(argv), gi.chr_start, ids)
    assert got.yes and want.yes and len(want.loci) > 0
    keys = sorted(k for k, v in vars(want).items() if isinstance(v, np.ndarray))
    assert keys and keys == sorted(k for k, v in vars(got).items()
                                   if isinstance(v, np.ndarray))
    for k in keys:
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
