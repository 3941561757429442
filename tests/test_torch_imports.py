"""The port stands alone: no module of star_tpu_torch, and not chip_smoke.py,
imports jax or star_tpu; and its entry points run on CUDA unless the caller
asks for the CPU."""
import ast
import os

import pytest
import torch

from tests.conftest import DATA, GOLD, ROOT


def _sources():
    pkg = os.path.join(ROOT, "star_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_star_tpu():
    srcs = list(_sources())
    assert len(srcs) > 20
    bad = [(os.path.relpath(p, ROOT), m) for p in srcs for m in _imported(p)
           if m.split(".")[0] in ("jax", "jaxlib", "star_tpu")]
    assert bad == []


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from star_tpu_torch.genome.index import GenomeIndex
    from star_tpu_torch.ops.pipeline import DeviceAligner
    from star_tpu_torch.ops.sa_search import DeviceIndex
    from star_tpu_torch.params import Parameters
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gi = GenomeIndex.load(os.path.join(GOLD, "genome_idx"))
    P = Parameters(["--genomeDir", os.path.join(GOLD, "genome_idx"),
                    "--readFilesIn", "none.fastq"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceAligner(gi, P)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceIndex.build(gi, ql=128)
    assert DeviceAligner(gi, P, device="cpu").device.type == "cpu"


# options of the slices ported so far that an earlier slice refused
PORTED = [
    ["--chimSegmentMin", "12"],
    ["--varVCFfile", os.path.join(DATA, "var.vcf")],
    ["--varVCFfile", os.path.join(DATA, "var.vcf"),
     "--waspOutputMode", "SAMtag", "--outSAMtype", "BAM", "Unsorted"],
    ["--genomeTransformOutput", "SAM"],
    ["--peOverlapNbasesMin", "5"],
    ["--tpuLongReads", "1"],
    ["--soloType", "CB_UMI_Simple"],
    ["--tpuShardedIndex", "1"],
]


@pytest.mark.parametrize("flags", PORTED, ids=[f[0] for f in PORTED[:2]]
                         + ["--waspOutputMode"] + [f[0] for f in PORTED[3:]])
def test_ported_options_pass_the_gate(flags, monkeypatch):
    """every option that an earlier slice refused reaches the mapping:
    nothing refuses it"""
    from star_tpu_torch import run
    from star_tpu_torch.params import Parameters
    reached = []
    monkeypatch.setattr(run, "_run_mapping",
                        lambda P, *a: reached.append(P.outFileNamePrefix))
    P = Parameters(["--genomeDir", os.path.join(GOLD, "genome_idx"),
                    "--readFilesIn", "none.fastq",
                    "--outFileNamePrefix", "gate/", *flags])
    run.align_reads(P, device="cpu")
    assert reached == ["gate/"]


def test_port_modules_import_without_jax_or_star_tpu():
    """every module of star_tpu_torch imports in a fresh interpreter, and
    neither jax nor star_tpu is in sys.modules after"""
    import subprocess
    import sys
    mods = sorted(
        "star_tpu_torch." + os.path.relpath(p, os.path.join(ROOT, "star_tpu_torch"))
        [:-3].replace(os.sep, ".").replace(".__init__", "")
        for p in _sources() if p.endswith(".py") and "star_tpu_torch" in p
        and not p.endswith("__main__.py"))
    assert {"star_tpu_torch.genome.sjdb", "star_tpu_torch.io.bam",
            "star_tpu_torch.quant.trsam", "star_tpu_torch.utils.rng",
            "star_tpu_torch.io.liftover", "star_tpu_torch.align.peoverlap",
            "star_tpu_torch.align.chimeric", "star_tpu_torch.align.variation",
            "star_tpu_torch.genome.transform", "star_tpu_torch.solo.annotate",
            "star_tpu_torch.solo.collapse", "star_tpu_torch.solo.emptydrops",
            "star_tpu_torch.solo.feature", "star_tpu_torch.solo.sgt",
            "star_tpu_torch.solo.solo",
            "star_tpu_torch.utils.stdhash",
            "star_tpu_torch.parallel.mesh",
            "star_tpu_torch.parallel.dist"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'star_tpu'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_kernel_modules_build_nothing_at_import():
    """the modules with CUDA kernels import on a machine without nvcc and
    without a card; their kernels are built only at the first CUDA launch"""
    srcs = {os.path.relpath(p, ROOT) for p in _sources()}
    assert {"star_tpu_torch/ops/device_stitch.py",
            "star_tpu_torch/ops/tile_fetch.py",
            "star_tpu_torch/ops/fetch.py"} <= srcs
    from star_tpu_torch.ops import device_stitch, fetch, tile_fetch
    assert fetch._LIB is None          # one library holds every launcher
    assert device_stitch.fetch is fetch and tile_fetch._fetch is fetch
