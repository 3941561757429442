"""The port's annotation layer against star_tpu and the STAR goldens: GTF
parsing, junction insertion (incremental and re-sorted), index generation
with and without a GTF, mapping-time insertion and two-pass mapping through
star_tpu_torch.run, on the host oracle, the device path on CPU tensors and
the device stitch engine forced on every level.  Exact equality throughout
(integer arrays, text outputs)."""
import dataclasses
import os

import numpy as np
import pytest

from star_tpu.genome import gtf as jgtf
from star_tpu.genome import native as jnative
from star_tpu.genome import sjdb as jsjdb
from star_tpu.genome.index import GenomeIndex as JaxGenomeIndex
from star_tpu.params import Parameters as JaxParameters
from star_tpu_torch.genome import gtf, native, sjdb
from star_tpu_torch.genome.index import GenomeIndex
from star_tpu_torch.params import Parameters
from star_tpu_torch.run import align_reads, main
from tests.conftest import DATA, GOLD
from tests.test_torch_mmp import port_index
from tests.test_torch_stitch import force_device_grow  # noqa: F401
from tests.test_torch_stitch import one_torch_thread  # noqa: F401

TR_FILES = ["geneInfo.tab", "transcriptInfo.tab", "exonInfo.tab",
            "exonGeTrInfo.tab", "sjdbList.fromGTF.out.tab"]
SJDB_FILES = ["sjdbInfo.txt", "sjdbList.out.tab"]
INDEX_ARRAYS = ["G", "sa", "sai_level_start", "sai_val", "sai_absent",
                "sai_nbit", "chr_start", "chr_length", "sj_dstart",
                "sj_astart", "sjdb_start", "sjdb_end", "sjdb_motif",
                "sjdb_shift_left", "sjdb_shift_right", "sjdb_strand"]
INDEX_INTS = ["chr_bin_nbits", "sa_index_nbases", "sa_sparse_d", "sjdb_n",
              "sj_gstart", "sjdb_overhang"]


def assert_index_equal(got, want, arrays=INDEX_ARRAYS):
    for k in arrays:
        a, b = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
        assert a.shape == b.shape and np.array_equal(a, b), k
    for k in INDEX_INTS:
        assert int(getattr(got, k)) == int(getattr(want, k)), k
    assert list(got.chr_name) == list(want.chr_name)


def same_text(a, b):
    with open(a) as fa, open(b) as fb:
        return fa.read() == fb.read()


@pytest.mark.parametrize("gtf_file,n_junctions", [("annot.gtf", 3),
                                                  ("annot2.gtf", 0)])
def test_parse_gtf_matches_jax(tmp_path, gtf_file, n_junctions):
    """exon / transcript / gene tables, the GTF junction list and the
    transcript-info files, from both packages on the same GTF (annot2.gtf
    holds single-exon genes only)"""
    argv = ["--genomeDir", os.path.join(GOLD, "genome_idx"),
            "--sjdbGTFfile", os.path.join(DATA, gtf_file)]
    gj = JaxGenomeIndex.load(os.path.join(GOLD, "genome_idx"))
    gp = port_index(gj)
    out = {}
    for name, mod, gi, P in (("jax", jgtf, gj, JaxParameters(argv)),
                             ("port", gtf, gp, Parameters(argv))):
        ann = mod.parse_gtf(P.sjdbGTFfile, gi, P)
        loci = mod.SjdbLoci()
        d = tmp_path / name
        d.mkdir()
        mod.transcript_gene_sj(ann, gi, str(d), loci)
        out[name] = (ann, loci, d)
    (aj, lj, dj), (ap, lp, dp) = out["jax"], out["port"]
    for f in dataclasses.fields(aj):
        a, b = getattr(ap, f.name), getattr(aj, f.name)
        if isinstance(b, np.ndarray):
            assert a.shape == b.shape and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    assert len(aj.exon_loci) > 0
    assert dataclasses.asdict(lp) == dataclasses.asdict(lj)
    assert len(lj.chr) == n_junctions
    assert sorted(os.listdir(dp)) == sorted(os.listdir(dj))
    for f in os.listdir(dj):
        assert same_text(dp / f, dj / f), f


def _random_loci(mod):
    loci = mod.SjdbLoci()
    rng = np.random.default_rng(3)
    for _ in range(20):
        s = int(rng.integers(1000, 30000))
        loci.chr.append("chr1")
        loci.start.append(s)
        loci.end.append(s + int(rng.integers(80, 900)))
        loci.str_.append(".")
        loci.gene.append(set())
        loci.priority.append(0)
    return loci


@pytest.mark.parametrize("branch", ["native", "resort"])
def test_insert_junctions_matches_jax(tmp_path, monkeypatch, branch):
    """20 random junctions inserted by both packages: the genome with its
    junction region, the SA, the SAi and the sjdb tables equal, through the
    incremental native rank merge or the forced full re-sort; the port's
    index carried over from star_tpu's by from_arrays equals its own"""
    if branch == "resort":
        monkeypatch.setattr(native, "sa_insert_positions",
                            lambda *a, **k: None)
        monkeypatch.setattr(jnative, "sa_insert_positions",
                            lambda *a, **k: None)
    else:
        assert native.native_available() and jnative.native_available()
    argv = ["--genomeDir", "x", "--readFilesIn", "y"]
    gj = JaxGenomeIndex.load(os.path.join(GOLD, "genome_idx"))
    gp = port_index(gj)
    gj.sjdb_overhang = gp.sjdb_overhang = 100
    want = jsjdb.insert_junctions(gj, _random_loci(jgtf), JaxParameters(argv),
                                  out_dir=str(tmp_path / "jax"))
    got = sjdb.insert_junctions(gp, _random_loci(gtf), Parameters(argv),
                                out_dir=str(tmp_path / "port"))
    assert got.sjdb_n == 20 and got.n_genome > gp.n_genome
    assert_index_equal(got, want)
    assert np.array_equal(got.t2, want.t2)
    assert_index_equal(port_index(want), got)
    for f in SJDB_FILES:
        assert same_text(tmp_path / "port" / f, tmp_path / "jax" / f), f


@pytest.mark.parametrize("ref,extra", [
    ("genome_idx", []),
    ("genome_idx_gtf", ["--sjdbGTFfile", os.path.join(DATA, "annot.gtf"),
                        "--sjdbOverhang", "99"])], ids=["plain", "gtf"])
def test_genome_generate_matches_reference_index(tmp_path, ref, extra):
    """--runMode genomeGenerate through the port: the arrays of STAR's own
    index and, with a GTF, its junction and transcript files"""
    out = str(tmp_path / "idx")
    main(["--runMode", "genomeGenerate", "--genomeDir", out,
          "--genomeFastaFiles", os.path.join(DATA, "genome.fa"),
          "--genomeSAindexNbases", "8", *extra])
    got = GenomeIndex.load(out)
    want = GenomeIndex.load_reference_dir(os.path.join(GOLD, ref))
    assert_index_equal(got, want, arrays=INDEX_ARRAYS[:8] + (
        ["sjdb_start", "sjdb_end", "sjdb_motif", "sjdb_shift_left",
         "sjdb_shift_right", "sjdb_strand"] if extra else []))
    assert (got.sjdb_n > 0) == bool(extra)
    if extra:
        for f in SJDB_FILES + TR_FILES[:4]:
            assert same_text(os.path.join(out, f),
                             os.path.join(GOLD, ref, f)), f


def _body(path):
    with open(path) as f:
        return [l for l in f if not l.startswith("@")]


def _run(tmp_path, extra, engine, idx="genome_idx"):
    """align the se reads through the port: the host oracle, the device
    path on CPU tensors, or the device path with the device stitch engine
    forced on every level (the fixture force_device_grow)"""
    prefix = str(tmp_path) + "/"
    P = Parameters(["--genomeDir", os.path.join(GOLD, idx),
                    "--readFilesIn", os.path.join(DATA, "reads_se.fastq"),
                    "--outFileNamePrefix", prefix, *extra])
    if engine == "host":
        align_reads(P, use_device=False)
    else:
        align_reads(P, device="cpu")
    return prefix


ENGINES = ["host", "device", "forced"]


@pytest.fixture
def sjdb_found():
    """per junction lookup on the device (_sjdb_find_dev) of a forced run,
    the lanes that found an annotated junction"""
    return []


@pytest.fixture(params=ENGINES)
def engine(request, monkeypatch, sjdb_found):
    if request.param == "forced":
        from star_tpu_torch.ops import device_stitch as ds
        request.getfixturevalue("force_device_grow")
        real = ds._sjdb_find_dev

        def spy(*a):
            ind = real(*a)
            sjdb_found.append(int((ind >= 0).sum()))
            return ind
        monkeypatch.setattr(ds, "_sjdb_find_dev", spy)
    return request.param


def test_gtf_at_mapping_time_golden(tmp_path, engine, sjdb_found):
    """--sjdbGTFfile at mapping time on the plain index gives the se_gtf
    golden (STAR's run on the index built with the GTF); the transcript
    tables go to <prefix>_STARtmp"""
    prefix = _run(tmp_path, ["--outSAMunmapped", "Within",
                             "--sjdbGTFfile", os.path.join(DATA, "annot.gtf"),
                             "--sjdbOverhang", "99"], engine)
    assert _body(prefix + "Aligned.out.sam") == \
        _body(os.path.join(GOLD, "se_gtf", "Aligned.out.sam"))
    assert same_text(prefix + "SJ.out.tab",
                     os.path.join(GOLD, "se_gtf", "SJ.out.tab"))
    for f in SJDB_FILES + TR_FILES[:4]:
        assert same_text(prefix + "_STARtmp/" + f,
                         os.path.join(GOLD, "genome_idx_gtf", f)), f
    assert (sum(sjdb_found) > 0) == (engine == "forced")


def test_twopass_golden(tmp_path, monkeypatch, engine, sjdb_found):
    """--twopassMode Basic: the final SAM and SJ.out.tab and pass 1's
    SJ.out.tab equal se_2pass.  On the device path each pass uploads its
    own index, and pass 1's device tables are dropped before pass 2"""
    from star_tpu_torch.ops import pipeline
    built = []
    real = pipeline.DeviceIndex.build

    def build(gi, *a, **k):
        built.append(gi)
        return real(gi, *a, **k)
    monkeypatch.setattr(pipeline.DeviceIndex, "build", build)
    prefix = _run(tmp_path, ["--outSAMunmapped", "Within",
                             "--twopassMode", "Basic"], engine)
    assert _body(prefix + "Aligned.out.sam") == \
        _body(os.path.join(GOLD, "se_2pass", "Aligned.out.sam"))
    assert same_text(prefix + "SJ.out.tab",
                     os.path.join(GOLD, "se_2pass", "SJ.out.tab"))
    assert same_text(prefix + "_STARpass1/SJ.out.tab",
                     os.path.join(GOLD, "se_2pass", "_STARpass1", "SJ.out.tab"))
    assert (sum(sjdb_found) > 0) == (engine == "forced")
    if engine == "host":
        assert built == []
    else:
        assert len(built) == 2 and built[0] is not built[1]
        assert built[0].sjdb_n == 0 and built[1].sjdb_n > 0
        assert built[0]._device_cache == {}
        assert len(built[1]._device_cache) > 0


def test_sjdb_insert_save_all(tmp_path):
    """--sjdbInsertSave All keeps the junction-augmented index under
    <prefix>_STARgenome, equal to star_tpu's from the same flags"""
    sj = tmp_path / "sj.tab"
    sj.write_text("chr1\t30001\t30500\t+\nchr2\t20001\t20800\t+\n")
    saved = {}
    for name, P_cls, run in (
            ("jax", JaxParameters, None), ("port", Parameters, align_reads)):
        pre = str(tmp_path / name) + "/"
        P = P_cls(["--genomeDir", os.path.join(GOLD, "genome_idx"),
                   "--readFilesIn", os.path.join(DATA, "reads_se.fastq"),
                   "--sjdbFileChrStartEnd", str(sj),
                   "--sjdbInsertSave", "All", "--readMapNumber", "8",
                   "--outFileNamePrefix", pre])
        if run is None:
            from star_tpu.run import align_reads as run
        run(P, use_device=False)
        saved[name] = pre + "_STARgenome"
    got = GenomeIndex.load(saved["port"])
    assert got.sjdb_n == 2
    assert_index_equal(got, port_index(JaxGenomeIndex.load(saved["jax"])))
