"""The STARconsensus genome transform through star_tpu_torch against the
STAR goldens: the port's genomeGenerate with --genomeTransformVCF (haploid
and diploid) gives the conversion blocks, chromosomes and transformed
annotation of idx_transform_{hap,dip} and the same index arrays as
star_tpu's; mapping with --genomeTransformOutput SAM converts every
alignment back to the original genome (tf_hap, tf_dip: SAM with its @SQ
lines and SJ.out.tab) on the host oracle and on the device path on CPU
tensors, where the seed loop and the stitch engine run on the device and
the back-conversion on the host."""
import os

import pytest

from chip_smoke import (TRANSFORM_GOLDENS, TRANSFORM_INDEX_FILES,
                        transform_index)
from star_tpu.genome.index import GenomeIndex as JaxGenomeIndex
from star_tpu_torch.genome.index import GenomeIndex
from star_tpu_torch.params import Parameters
from star_tpu_torch.run import align_reads
from tests.conftest import DATA, GOLD
from tests.test_torch_annot import assert_index_equal
from tests.test_torch_chimeric import assert_files, run_port
from tests.test_torch_stitch import force_device_grow, one_torch_thread  # noqa: F401
from tests.test_transform import META_FILES

TYPES = TRANSFORM_GOLDENS


@pytest.fixture(scope="module")
def port_idx(tmp_path_factory):
    """both transformed indexes, built by the port's command line"""
    out = {}
    for ttype in TYPES:
        out[ttype] = str(tmp_path_factory.mktemp("tf_" + ttype))
        transform_index(ttype, out[ttype])
    return out


@pytest.mark.parametrize("ttype", TYPES)
def test_transform_index_matches_reference(port_idx, ttype):
    idx = port_idx[ttype]
    assert set(TRANSFORM_INDEX_FILES) == set(META_FILES)
    for f in META_FILES:
        with open(os.path.join(idx, f)) as a, \
                open(os.path.join(GOLD, TYPES[ttype][0], f)) as b:
            assert a.read() == b.read(), f
    # the arrays the mapping reads equal those star_tpu builds from the same
    # FASTA and VCF (tests/test_transform.py builds them there)
    from star_tpu.params import Parameters as JaxParameters
    from star_tpu.run import genome_generate as jax_generate
    got = GenomeIndex.load(idx)
    assert got.transform_type == (1 if ttype == "Haploid" else 2)
    assert os.path.exists(os.path.join(idx, "OriginalGenome", "chrName.txt"))
    jdir = idx + "_jax"
    jax_generate(JaxParameters(
        ["--runMode", "genomeGenerate", "--genomeDir", jdir,
         "--genomeFastaFiles", os.path.join(DATA, "genome.fa"),
         "--genomeSAindexNbases", "8", "--genomeTransformType", ttype,
         "--genomeTransformVCF", os.path.join(DATA, "transform.vcf"),
         "--sjdbGTFfile", os.path.join(DATA, "annot.gtf"),
         "--sjdbOverhang", "99"]))
    assert_index_equal(got, JaxGenomeIndex.load(jdir))


@pytest.mark.parametrize("engine", ["host", "device", "forced"])
@pytest.mark.parametrize("ttype", TYPES)
def test_transform_output_golden(port_idx, tmp_path, request, ttype, engine):
    if engine == "forced":
        request.getfixturevalue("force_device_grow")
    _, gold, extra = TYPES[ttype]
    prefix = run_port(tmp_path, ["reads_se.fastq"],
                      ["--outSAMunmapped", "Within",
                       "--genomeTransformOutput", "SAM", *extra],
                      engine, idx=port_idx[ttype])
    assert_files(prefix, gold, ["Aligned.out.sam", "SJ.out.tab"])
    # the @SQ header reports the original chromosomes
    sq = lambda p: [l for l in open(p) if l.startswith("@SQ")]
    assert sq(prefix + "Aligned.out.sam") == \
        sq(os.path.join(GOLD, gold, "Aligned.out.sam"))


def test_transform_output_needs_a_transformed_genome(tmp_path):
    P = Parameters(["--genomeDir", os.path.join(GOLD, "genome_idx"),
                    "--readFilesIn", os.path.join(DATA, "reads_se.fastq"),
                    "--outFileNamePrefix", str(tmp_path) + "/",
                    "--genomeTransformOutput", "SAM"])
    with pytest.raises(SystemExit, match="generated without transformation"):
        align_reads(P, use_device=False)
