"""--quantMode TranscriptomeSAM on the port's device path (seed loop and
batched stitch on CPU tensors, the array-native finish): with RSEM's default
--quantTranscriptomeBan IndelSoftclipSingleend the soft-clip extension reads
the encoded read, which the fast finish hands on as finish_read does, so
Aligned.toTranscriptome.out.bam is the host oracle's record for record, single-
and paired-end (the mate-joined read with its spacer).  The reads are the
small goldens' with bases at their ends changed, so that many transcriptomic
alignments are soft-clipped; a run that keeps soft clips (ban Singleend) shows
that they are.  Chimeric detection, which reads the encoded read too, stays
on the host stitch.  The file imports neither jax nor star_tpu:
tests/test_torch_cuda.py takes its reads for the same check on the card."""
import os

import pytest
import torch

from chip_smoke import bam_records
from portbench.reference.bam import read_bam
from star_tpu_torch.genome.index import GenomeIndex
from star_tpu_torch.ops import batch_engine as be
from star_tpu_torch.ops import pipeline
from star_tpu_torch.params import Parameters
from star_tpu_torch.run import align_reads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "small")
GOLD = os.path.join(ROOT, "tests", "golden", "small")
IDX_GTF = os.path.join(GOLD, "genome_idx_gtf")
COMP = {"A": "C", "C": "G", "G": "T", "T": "A", "N": "A"}
FILES = {"se": ["reads_se.fastq"],
         "pe": ["reads_pe_1.fastq", "reads_pe_2.fastq"]}


def ends_changed(src, dst):
    """the FASTQ src with 0-4 bases changed near each read's 3' end (every
    other base from the last) and every seventh read's first base"""
    lines = open(src).read().split("\n")
    for k, i in enumerate(range(1, len(lines), 4)):
        s = list(lines[i])
        for j in range(k % 5):
            s[-1 - 2 * j] = COMP[s[-1 - 2 * j]]
        if k % 7 == 3:
            s[0] = COMP[s[0]]
        lines[i] = "".join(s)
    with open(dst, "w") as f:
        f.write("\n".join(lines))


def changed_reads(case, d):
    """the case's FASTQ files with their ends changed, written into d"""
    out = []
    for f in FILES[case]:
        ends_changed(os.path.join(DATA, f), os.path.join(d, f))
        out.append(os.path.join(d, f))
    return out


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("reads"))
    return {case: changed_reads(case, d) for case in FILES}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def map_trsam(reads, prefix, device, use_device=True, extra=()):
    """the reads mapped with --quantMode TranscriptomeSAM on the device path
    (on `device`) or the host oracle; the transcriptome BAM's path"""
    P = Parameters(["--genomeDir", IDX_GTF, "--readFilesIn", *reads,
                    "--quantMode", "TranscriptomeSAM", "--outSAMtype", "BAM",
                    "Unsorted", "--tpuUseDevice", str(int(use_device)),
                    "--tpuBatchSize", "128", *extra,
                    "--outFileNamePrefix", prefix])
    align_reads(P, device=device)
    return prefix + "Aligned.toTranscriptome.out.bam"


@pytest.mark.parametrize("case", sorted(FILES))
def test_device_path_transcriptome_bam_is_the_host_paths(tmp_path, reads,
                                                         monkeypatch, case):
    calls = []
    real = pipeline._fast_finish

    def fast_finish(*a):
        calls.append(1)
        return real(*a)
    monkeypatch.setattr(pipeline, "_fast_finish", fast_finish)
    dev = map_trsam(reads[case], str(tmp_path / "dev") + "/", "cpu")
    assert calls, "the reads took the fast finish"
    host = map_trsam(reads[case], str(tmp_path / "host") + "/", "cpu", False)
    refs, recs = bam_records(dev)
    assert (refs, recs) == bam_records(host)
    assert len(recs) > 50
    # the same reads keep soft clips in the transcriptome BAM when only
    # alignments of one mate are banned: the extension had work to do
    kept = map_trsam(reads[case], str(tmp_path / "kept") + "/", "cpu",
                     extra=["--quantTranscriptomeBan", "Singleend"])
    clipped = [r for r in read_bam(kept)[2]
               if any(op == "S" for op, _ in r.cigar)]
    assert len(clipped) > 20
    assert not [r for r in read_bam(dev)[2]
                if any(op == "S" for op, _ in r.cigar)]


def test_chimeric_detection_stays_on_the_host_stitch(tmp_path, monkeypatch):
    """run.py's chimeric(res) reads res.read1 / res.read1rc, which only the
    host stitch (finish_read) sets for every read: --chimSegmentMin keeps the
    batched stitch and the fast finish off"""
    P = Parameters(["--genomeDir", os.path.join(GOLD, "genome_idx"),
                    "--readFilesIn", os.path.join(DATA, "reads_chim.fastq"),
                    "--chimSegmentMin", "12", "--outSAMunmapped", "Within",
                    "--outFileNamePrefix", str(tmp_path) + "/"])
    gi = GenomeIndex.load(P.genomeDir)
    assert not be.fast_path_config_ok(gi, P)

    def refused(*a):
        raise AssertionError("the fast finish ran on a chimeric job")
    monkeypatch.setattr(pipeline, "_fast_finish", refused)
    align_reads(P, gi=gi, device="cpu")
    with open(tmp_path / "Chimeric.out.junction") as f, open(os.path.join(
            GOLD, "se_chim", "Chimeric.out.junction")) as g:
        assert f.read() == g.read()
