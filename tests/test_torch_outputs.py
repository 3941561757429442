"""The port's output layer against star_tpu and the STAR goldens: GeneCounts,
the transcriptome projection and the BAM record encoder on the same
alignments in both packages; BAM (unsorted, coordinate-sorted, spill sort),
ReadsPerGene.out.tab, Aligned.toTranscriptome.out.bam and bedGraph signal
through star_tpu_torch.run on the host oracle and the device path on CPU
tensors; and the inputAlignmentsFromBAM (signal, duplicate removal) and
liftOver run modes.  Exact equality throughout (BAMs as decompressed record
streams, text outputs)."""
import copy
import glob
import os

import pytest

from star_tpu.genome.index import GenomeIndex as JaxGenomeIndex
from star_tpu.io import bam as jbam
from star_tpu.params import Parameters as JaxParameters
from star_tpu.quant import transcriptome as jtrm
from star_tpu.quant import trsam as jtrsam
from star_tpu.utils import rng as jrng
from star_tpu_torch.align.engine import ReadAligner
from star_tpu_torch.io import bam
from star_tpu_torch.io.fastq import read_pairs
from star_tpu_torch.params import Parameters
from star_tpu_torch.quant import transcriptome as trm
from star_tpu_torch.quant import trsam
from star_tpu_torch.run import main
from star_tpu_torch.utils import rng
from tests.conftest import DATA, GOLD
from tests.test_bam import read_bam_records
from tests.test_torch_annot import _run
from tests.test_torch_mmp import port_index
from tests.test_torch_stitch import one_torch_thread  # noqa: F401

IDX_GTF = os.path.join(GOLD, "genome_idx_gtf")
ARGV = ["--genomeDir", IDX_GTF,
        "--readFilesIn", os.path.join(DATA, "reads_se.fastq")]


@pytest.fixture(scope="module")
def se_results():
    """every se read aligned by the port's host oracle on the GTF index,
    with both packages' index, parameters and transcriptome"""
    gj = JaxGenomeIndex.load(IDX_GTF)
    gp = port_index(gj)
    P = Parameters(ARGV)
    aligner = ReadAligner(gp, P)
    res = [aligner.align_read(name, seqs, quals)
           for name, seqs, quals, _ in read_pairs(P.readFilesIn)]
    return {"port": (gp, P, trm.Transcriptome.load(IDX_GTF)),
            "jax": (gj, JaxParameters(ARGV), jtrm.Transcriptome.load(IDX_GTF)),
            "res": res}


def test_gene_counts_match_jax(tmp_path, se_results):
    mapped = [r for r in se_results["res"] if r.unmap_type < 0]
    assert len(mapped) > 100
    out = {}
    for name, mod in (("port", trm), ("jax", jtrm)):
        gc = mod.GeneCounts(se_results[name][2])
        for r in mapped:
            gc.add_read(r.transcripts, r.n_tr)
        gc.write(str(tmp_path / name), 7)
        out[name] = (tmp_path / name).read_text()
    assert out["port"] == out["jax"]
    assert sum(int(l.split("\t")[1]) for l in out["port"].splitlines()[4:]) > 0


def test_transcriptome_projection_and_encoding_match_jax(se_results):
    """quant_transcriptome with each package's MT19937 stream, and the BAM
    records encode_mapped makes of its transcript alignments and of every
    genomic alignment: the same bytes"""
    recs = {}
    n_tr_out = 0
    for name, q, b, r in (("port", trsam, bam, rng),
                          ("jax", jtrsam, jbam, jrng)):
        gi, P, tr = se_results[name]
        shim = q.TrGenomeShim(tr)
        stream = r.MT19937(P.runRNGseed)
        out = recs[name] = []
        for res in copy.deepcopy(se_results["res"]):
            if res.unmap_type >= 0:
                continue
            for i_tr in range(res.n_tr):
                out += b.encode_mapped(res.transcripts[i_tr], res, res.n_tr,
                                       i_tr, gi, P)
            al_t = q.quant_transcriptome(res, tr, gi, P, stream, 10)
            n_tr_out += len(al_t)
            for i_t, at in enumerate(al_t):
                at.roStr = 0
                out += [x[0] for x in b.encode_mapped(
                    at, res, len(al_t), i_t, shim, P,
                    attrs_order=["NH", "HI"])]
    assert recs["port"] == recs["jax"]
    assert n_tr_out > 0


# STAR_RSEM.sh's mismatch limits: the extension's re-check bans more
ENCODE_MM = ["--outFilterMismatchNmax", "999",
             "--outFilterMismatchNoverReadLmax", "0.04"]


@pytest.mark.parametrize("case", ["se", "pe"])
def test_device_path_transcriptome_on_clipped_reads_matches_jax(
        tmp_path, monkeypatch, case):
    """reads with changed ends, mapped on the device path (CPU tensors), so
    that many alignments are soft-clipped (mates joined by the spacer in the
    pair case): each read as run.py hands it to quant_transcriptome, with
    the encoded read the fast finish sets, is projected by both packages
    with each one's MT19937 stream under RSEM's ban IndelSoftclipSingleend;
    the transcriptome records are the same bytes"""
    from portbench.reference.bam import read_bam
    from tests.test_torch_trsam_device import changed_reads, map_trsam
    seen = []
    real = trsam.quant_transcriptome

    def keep(res, tr, gi, P, stream, mm_max):
        seen.append((copy.deepcopy(res), mm_max))
        return real(res, tr, gi, P, stream, mm_max)
    monkeypatch.setattr(trsam, "quant_transcriptome", keep)
    reads = changed_reads(case, str(tmp_path))
    prefix = str(tmp_path / "dev") + "/"
    map_trsam(reads, prefix, "cpu", extra=ENCODE_MM)
    clipped = [r for r in read_bam(prefix + "Aligned.out.bam")[2]
               if any(op == "S" for op, _ in r.cigar)]
    assert len(clipped) > 20 and len(seen) > 50
    assert all(res.read1 is not None for res, _ in seen)
    argv = ["--genomeDir", IDX_GTF, "--readFilesIn", *reads, *ENCODE_MM,
            "--quantMode", "TranscriptomeSAM"]
    gj = JaxGenomeIndex.load(IDX_GTF)
    both = {"port": (trsam, bam, rng, port_index(gj), Parameters(argv),
                     trm.Transcriptome.load(IDX_GTF)),
            "jax": (jtrsam, jbam, jrng, gj, JaxParameters(argv),
                    jtrm.Transcriptome.load(IDX_GTF))}
    recs = {}
    for name, (q, b, r, gi, P, tr) in both.items():
        q = real if name == "port" else q.quant_transcriptome
        shim = (trsam if name == "port" else jtrsam).TrGenomeShim(tr)
        stream = r.MT19937(P.runRNGseed)
        out = recs[name] = []
        for res, mm_max in copy.deepcopy(seen):
            al_t = q(res, tr, gi, P, stream, mm_max)
            for i_t, at in enumerate(al_t):
                at.roStr = 0
                out += [x[0] for x in b.encode_mapped(
                    at, res, len(al_t), i_t, shim, P,
                    attrs_order=["NH", "HI"])]
    assert recs["port"] == recs["jax"]
    assert len(recs["port"]) > 50


GOLDEN_CASES = [
    # (golden, index, flags, files compared)
    ("se_quant", "genome_idx_gtf",
     ["--outSAMunmapped", "Within", "--quantMode", "GeneCounts"],
     ["ReadsPerGene.out.tab", "SJ.out.tab"]),
    ("se_trsam", "genome_idx_gtf", ["--quantMode", "TranscriptomeSAM"],
     ["Aligned.toTranscriptome.out.bam"]),
    ("se_bam", "genome_idx",
     ["--outSAMunmapped", "Within",
      "--outSAMtype", "BAM", "Unsorted", "SortedByCoordinate"],
     ["Aligned.out.bam", "Aligned.sortedByCoord.out.bam", "SJ.out.tab"]),
    ("se_wig", "genome_idx",
     ["--outSAMtype", "BAM", "SortedByCoordinate", "--outWigType", "bedGraph"],
     ["Aligned.sortedByCoord.out.bam", "Signal.Unique.str1.out.bg",
      "Signal.Unique.str2.out.bg", "Signal.UniqueMultiple.str1.out.bg",
      "Signal.UniqueMultiple.str2.out.bg"]),
]


def assert_outputs(prefix, gold, files):
    for f in files:
        want = os.path.join(GOLD, gold, f)
        if f.endswith(".bam"):
            assert read_bam_records(prefix + f) == read_bam_records(want), f
        else:
            with open(prefix + f) as a, open(want) as b:
                assert a.read() == b.read(), f


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("gold,idx,extra,files", GOLDEN_CASES,
                         ids=[c[0] for c in GOLDEN_CASES])
def test_outputs_golden(tmp_path, gold, idx, extra, files, engine):
    assert_outputs(_run(tmp_path, extra, engine, idx), gold, files)


def test_gene_counts_gtf_at_mapping_time(tmp_path):
    """GeneCounts with the GTF given at mapping time read the transcript
    tables back from <prefix>_STARtmp, and equal the GTF index's golden"""
    prefix = _run(tmp_path, ["--quantMode", "GeneCounts", "TranscriptomeSAM",
                             "--sjdbGTFfile", os.path.join(DATA, "annot.gtf"),
                             "--sjdbOverhang", "99"], "device")
    assert os.path.exists(prefix + "_STARtmp/transcriptInfo.tab")
    assert_outputs(prefix, "se_quant", ["ReadsPerGene.out.tab"])
    assert_outputs(prefix, "se_trsam", ["Aligned.toTranscriptome.out.bam"])


def test_bam_sort_spill(tmp_path, monkeypatch):
    """the genome-bin spill sort at 256 bytes per bin gives the in-memory
    sort's record stream, and removes its spill directory"""
    monkeypatch.setattr(bam.BamCollector, "SPILL_BYTES_PER_BIN", 256)
    prefix = _run(tmp_path, ["--outSAMunmapped", "Within",
                             "--outSAMtype", "BAM", "SortedByCoordinate"],
                  "host")
    assert_outputs(prefix, "se_bam", ["Aligned.sortedByCoord.out.bam"])
    assert not os.path.exists(prefix + "_STARtmp")


@pytest.mark.parametrize("argv,gold,files", [
    (["--runMode", "inputAlignmentsFromBAM", "--inputBAMfile",
      os.path.join(GOLD, "dedup", "Aligned.sortedByCoord.out.bam"),
      "--bamRemoveDuplicatesType", "UniqueIdentical"],
     "dedup", ["Processed.out.bam"]),
    (["--runMode", "inputAlignmentsFromBAM", "--inputBAMfile",
      os.path.join(GOLD, "dedup", "Aligned.sortedByCoord.out.bam"),
      "--bamRemoveDuplicatesType", "UniqueIdenticalNotMulti"],
     "dedup", ["nm_Processed.out.bam"]),
    (["--runMode", "inputAlignmentsFromBAM", "--inputBAMfile",
      os.path.join(GOLD, "se_wig", "Aligned.sortedByCoord.out.bam"),
      "--outWigType", "bedGraph"],
     "se_wig", [os.path.basename(f) for f in
                sorted(glob.glob(os.path.join(GOLD, "se_wig", "Signal*")))]),
    (["--runMode", "liftOver",
      "--genomeChainFiles", os.path.join(DATA, "lift.chain"),
      "--sjdbGTFfile", os.path.join(DATA, "lift.gtf")],
     "liftover", ["GTFliftOver_1.gtf", "GTFliftOver_1.gtf.unlifted"]),
], ids=["dedup", "dedup_not_multi", "signal_from_bam", "liftover"])
def test_run_modes_golden(tmp_path, argv, gold, files):
    prefix = str(tmp_path) + "/" + ("nm_" if files[0].startswith("nm_")
                                    else "")
    main(argv + ["--outFileNamePrefix", prefix])
    assert_outputs(str(tmp_path) + "/", gold, files)
