"""Inputs the port's main path already took without a test of their own,
held against the STAR goldens through star_tpu_torch on the device path on
CPU tensors and with the device stitch engine forced: 3' adapter and fixed
clipping and the CellRanger4 clip (clip/ham_*, clip/cr4_*), reads from a SAM
file (--readFilesType SAM SE), multi-line FASTA reads, and Log.final.out of
the se golden without its time lines."""
import os

import pytest

from tests.conftest import GOLD, ROOT
from tests.test_torch_chimeric import run_port
from tests.test_torch_stitch import force_device_grow, one_torch_thread  # noqa: F401

EXTRA = os.path.join(ROOT, "tests", "data", "small_extra")
CASES = [
    # (name, reads, flags, golden files (compared with prefix's files))
    ("clip_ham", ["reads_clip.fastq"],
     ["--clip3pAdapterSeq", "AGATCGGAAGAGC", "--clip5pNbases", "3",
      "--clip3pNbases", "2", "--clip3pAfterAdapterNbases", "1"],
     {"clip/ham_Aligned.out.sam": "Aligned.out.sam",
      "clip/ham_SJ.out.tab": "SJ.out.tab"}),
    ("clip_cr4", ["reads_clip.fastq"], ["--clipAdapterType", "CellRanger4"],
     {"clip/cr4_Aligned.out.sam": "Aligned.out.sam",
      "clip/cr4_SJ.out.tab": "SJ.out.tab"}),
    ("sam_input", [os.path.join(EXTRA, "input_se.sam")],
     ["--readFilesType", "SAM", "SE"],
     {"sam_input/Aligned.out.sam": "Aligned.out.sam",
      "sam_input/SJ.out.tab": "SJ.out.tab"}),
    ("fasta_ml", [os.path.join(EXTRA, "reads_ml.fa")], [],
     {"fasta_ml/Aligned.out.sam": "Aligned.out.sam"}),
    ("log_final", ["reads_se.fastq"], [],
     {"se/Log.final.out": "Log.final.out"}),
]


def _body(path):
    with open(path) as f:
        lines = f.readlines()
    if path.endswith("Log.final.out"):
        return lines[4:]            # the started / finished / speed lines
    return [l for l in lines if not l.startswith("@")]


@pytest.mark.parametrize("engine", ["device", "forced"])
@pytest.mark.parametrize("name,reads,flags,files", CASES,
                         ids=[c[0] for c in CASES])
def test_input_golden(tmp_path, request, name, reads, flags, files, engine):
    if engine == "forced":
        request.getfixturevalue("force_device_grow")
    prefix = run_port(tmp_path, reads, ["--outSAMunmapped", "Within", *flags],
                      engine)
    for gold, f in files.items():
        assert _body(prefix + f) == _body(os.path.join(GOLD, gold)), f
