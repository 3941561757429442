"""The port's host spans (ops/pipeline.py _tick, _job, SPANS, TIMERS) on a
golden single-end run and a CB_UMI_Simple STARsolo run, on the device path
on CPU tensors: tracing changes no output byte, spans nest inside their
parents on torch.profiler's clock, the job's scope leaves little untimed
and is never a _tick, tracing off stores nothing, and the benchmark's
readers of the new spans give the values expected.  On paired-end jobs
with BySJout and TranscriptomeSAM, the counters (pipeline.COUNTS) count what
the job did, each job anew, and the bysj_stage2 and trsam spans sit where
they belong."""
import importlib.util
import math
import os
import time

import pytest
import torch

from portbench.harness.trace import Spans
from star_tpu_torch import run
from star_tpu_torch.align.engine import ReadAligner
from star_tpu_torch.ops import batch_engine as be
from star_tpu_torch.ops import pipeline
from star_tpu_torch.params import Parameters
from tests.conftest import DATA, GOLD, ROOT
from tests.test_torch_stitch import one_torch_thread  # noqa: F401

BATCH = 128
CASES = {
    "se": ["--genomeDir", os.path.join(GOLD, "genome_idx"), "--readFilesIn",
           os.path.join(DATA, "reads_se.fastq"), "--outSAMunmapped",
           "Within"],
    "solo": ["--genomeDir", os.path.join(GOLD, "genome_idx_gtf"),
             "--readFilesIn", os.path.join(DATA, "solo_cdna.fastq"),
             os.path.join(DATA, "solo_bc.fastq"), "--soloType",
             "CB_UMI_Simple", "--soloCBwhitelist",
             os.path.join(DATA, "solo_wl.txt"), "--outSAMtype", "None"],
}
N_READS = {"se": 315, "solo": 2834}
# the spans this tracer adds, and those each case must show
NEW_KEYS = {"job_open", "read_input", "batch_arrays", "index_upload",
            "host_path", "emit", "job_close"}
SOLO_KEYS = {"solo_collapse", "solo_raw_out", "solo_filter", "solo_stats"}
# Log.final.out lines that hold the clock
CLOCK_LINES = ("Started job on", "Started mapping on", "Finished on",
               "Mapping speed")


def _reset():
    pipeline.TIMERS.clear()
    pipeline.SPANS.clear()
    pipeline.COUNTS.clear()


@pytest.fixture
def tracing():
    _reset()
    pipeline.TIMING = True
    yield
    pipeline.TIMING = False
    _reset()


def _run(case, prefix):
    """one job of the case on the device path on CPU tensors; its wall
    seconds"""
    P = Parameters([*CASES[case], "--tpuBatchSize", str(BATCH),
                    "--outFileNamePrefix", prefix])
    t = time.time()
    stats = run.align_reads(P, device="cpu")
    assert stats.read_n == N_READS[case]
    return time.time() - t


def _outputs(prefix):
    """every output file under prefix, Log.final.out without its clock
    lines; the logs that hold the clock throughout are left out"""
    out = {}
    for d, _, files in os.walk(prefix):
        for f in files:
            if f in ("Log.out", "Log.progress.out"):
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                data = fh.read()
            if f == "Log.final.out":
                data = b"".join(l for l in data.splitlines(True)
                                if not any(c.encode() in l
                                           for c in CLOCK_LINES))
            out[os.path.relpath(p, prefix)] = data
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_tracing_changes_no_output(tmp_path, case):
    _reset()
    _run(case, str(tmp_path / "off") + "/")
    pipeline.TIMING = True
    try:
        _run(case, str(tmp_path / "on") + "/")
    finally:
        pipeline.TIMING = False
    off = _outputs(str(tmp_path / "off") + "/")
    on = _outputs(str(tmp_path / "on") + "/")
    assert off and sorted(off) == sorted(on)
    assert [f for f in off if off[f] != on[f]] == []


@pytest.mark.parametrize("case,host_finish", [("se", False), ("se", True),
                                              ("solo", False)])
def test_spans_nest_in_their_job(tmp_path, tracing, monkeypatch, case,
                                 host_finish):
    """every span closed inside its parent, the stack empty after the job,
    one batch index per batch, each new key present and the job's untimed
    seconds under a tenth of it.  host_finish: the fast finish off, so every
    batched read takes the per-read host finish (host_path)"""
    calls = []
    real = ReadAligner.finish_read

    def finish_read(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)
    monkeypatch.setattr(ReadAligner, "finish_read", finish_read)
    if host_finish:
        monkeypatch.setattr(be, "fast_finish_config_ok", lambda P: False)
    wall = _run(case, str(tmp_path) + "/")

    spans = pipeline.SPANS
    assert spans and pipeline._OPEN == []
    for i, (key, parent, batch, t0, t1) in enumerate(spans):
        assert t1 is not None and t0 <= t1, key
        if parent >= 0:
            assert parent < i
            _, _, _, p0, p1 = spans[parent]
            assert p0 <= t0 and t1 <= p1, (key, spans[parent][0])
    keys = {s[0] for s in spans}
    want = NEW_KEYS - ({"host_path"} if not calls else set())
    assert want <= keys
    assert ("host_path" in keys) == bool(calls)
    if host_finish:
        assert calls
    if case == "solo":
        assert SOLO_KEYS <= keys
        # Solo.process's parts lie inside solo_process
        for key, parent, *_ in spans:
            if key in SOLO_KEYS:
                assert spans[parent][0] == "solo_process"
    n_batches = math.ceil(N_READS[case] / BATCH)
    assert [s[2] for s in spans if s[0] == "prepare"] == list(range(n_batches))
    # a batch's read_input runs before it begins: the batch last begun
    assert [s[2] for s in spans if s[0] == "read_input"] == \
        list(range(-1, n_batches))
    for key, parent, *_ in spans:
        if key == "host_path":
            assert spans[parent][0] == "finish"
    t = pipeline.TIMERS
    assert 0 <= t["untimed"] < 0.1 * wall
    # TIMERS holds each key's inclusive seconds, from the same spans
    for k in keys:
        assert t[k] == pytest.approx(sum(s[4] - s[3] for s in spans
                                         if s[0] == k) / 1e9)


def test_tracing_off_stores_nothing(tmp_path):
    _reset()
    assert not pipeline.TIMING
    _run("se", str(tmp_path) + "/")
    assert pipeline.SPANS == [] and dict(pipeline.TIMERS) == {}
    assert pipeline._OPEN == [] and dict(pipeline.COUNTS) == {}


def test_tick_encloses_the_profilers_events(tracing):
    """a span's [t0_ns, t1_ns] is on torch.profiler's clock: it encloses the
    profiler's event of the op run inside it"""
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(96, 96)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pipeline._tick("mm"):
            torch.mm(a, a)
    key, parent, _, t0, t1 = pipeline.SPANS[-1]
    assert key == "mm" and parent == -1
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert t0 <= e.start_ns() <= e.end_ns() <= t1


def test_the_benchmarks_recorder_sees_the_spans_not_the_job(tmp_path,
                                                             tracing):
    """portbench's Spans stands a recording subclass in for _tick in
    ops/pipeline.py and run.py: it records every span of the job, those of
    solo/solo.py too, and never the job's scope"""
    with Spans([pipeline, run]) as rec:
        _run("solo", str(tmp_path) + "/")
    assert pipeline._tick is rec.base and run._tick is rec.base
    got = sorted(k for k, _, _ in rec.spans)
    assert got == sorted(s[0] for s in pipeline.SPANS)
    assert {"emit", "read_input", "solo_filter"} <= set(got)
    # nothing recorded covers the whole job
    s0 = min(a for _, a, _ in rec.spans)
    s1 = max(b for _, _, b in rec.spans)
    assert not [k for k, a, b in rec.spans if a <= s0 and b >= s1]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name, os.path.join(ROOT, "portbench", "metrics",
                                       name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


REC = {"reads": 50000, "window_s": 80.0,
       "timers": {"untimed": 2.0, "read_input": 0.5, "batch_arrays": 1.0,
                  "host_path": 0.25, "emit": 3.0, "job_open": 1.5,
                  "solo_collapse": 4.0, "solo_filter": 6.0, "solo_mc": 0.05,
                  "trsam": 0.75, "bysj_stage2": 1.25}}
READERS = {"untimed_pct": ("untimed", 2.5),
           "input_s_per_mread": ("read_input", 10.0),
           "batch_arrays_s_per_mread": ("batch_arrays", 20.0),
           "host_path_s_per_mread": ("host_path", 5.0),
           "emit_s_per_mread": ("emit", 60.0),
           "job_open_s": ("job_open", 1.5),
           "solo_collapse_s": ("solo_collapse", 4.0),
           "solo_filter_s": ("solo_filter", 6.0),
           "solo_mc_s": ("solo_mc", 0.05),
           "trsam_s_per_mread": ("trsam", 15.0),
           "bysj_stage2_s_per_mread": ("bysj_stage2", 25.0)}


@pytest.mark.parametrize("name", sorted(READERS))
def test_new_span_reader(name):
    key, want = READERS[name]
    read = _reader(name)
    assert read(REC) == pytest.approx(want)
    # a program without the span reads nothing
    old = {k: v for k, v in REC["timers"].items()
           if k not in (key, "untimed")}
    assert read(dict(REC, timers=old)) is None


def test_host_path_reader_reads_zero_without_host_reads():
    """a traced job in which no read took the host path reads 0, not
    nothing: the job's scope shows the tracer ran"""
    t = {k: v for k, v in REC["timers"].items() if k != "host_path"}
    assert _reader("host_path_s_per_mread")(dict(REC, timers=t)) == 0.0


def test_solo_mc_reader_reads_zero_without_a_monte_carlo_step(monkeypatch):
    """a traced job in which no EmptyDrops_CR Monte-Carlo step ran reads 0;
    a program without the span (no solo/mc_null.py) reads nothing"""
    t = {k: v for k, v in REC["timers"].items() if k != "solo_mc"}
    read = _reader("solo_mc_s")
    assert read(dict(REC, timers=t)) == 0.0
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    assert read(dict(REC, timers=t)) is None
    assert read(REC) == pytest.approx(0.05)


def test_bysj_stage2_reader_reads_zero_without_held_reads(monkeypatch):
    """a traced job that held no read for BySJout's stage 2 reads 0; a
    program without the span (no pipeline.COUNTS) reads nothing"""
    t = {k: v for k, v in REC["timers"].items() if k != "bysj_stage2"}
    read = _reader("bysj_stage2_s_per_mread")
    assert read(dict(REC, timers=t)) == 0.0
    monkeypatch.delattr(pipeline, "COUNTS")
    assert read(dict(REC, timers=t)) is None
    assert read(REC) == pytest.approx(25.0)


COUNT_CASES = {
    # every junction of this index is novel: BySJout holds reads
    "bysj": ("genome_idx", ["--outFilterType", "BySJout"]),
    # every junction annotated: nothing held; the transcriptome BAM
    "trsam": ("genome_idx_gtf", ["--outFilterType", "BySJout", "--quantMode",
                                 "TranscriptomeSAM", "--outSAMtype", "BAM",
                                 "Unsorted"]),
}


@pytest.mark.parametrize("case", sorted(COUNT_CASES))
def test_counters_and_their_spans(tmp_path, tracing, monkeypatch, case):
    """bysj_held is the reads mapped again in stage 2, under one top-level
    bysj_stage2 span that holds their output; trsam_records is the
    transcriptome BAM's records and trsam_banned the alignments the default
    bans kept out of it, with every trsam span inside quant; a second job
    counts from 0 again"""
    from portbench.reference.bam import read_bam
    from tests.test_torch_trsam_device import ends_changed
    idx, extra = COUNT_CASES[case]
    reads = []
    for f in ("reads_pe_1.fastq", "reads_pe_2.fastq"):
        ends_changed(os.path.join(DATA, f), str(tmp_path / f))
        reads.append(str(tmp_path / f))
    remapped = []
    real = ReadAligner.align_read

    def align_read(self, *a, **k):
        remapped.append(1)
        return real(self, *a, **k)
    monkeypatch.setattr(ReadAligner, "align_read", align_read)
    counts = []
    for job in ("a", "b"):
        prefix = str(tmp_path / job) + "/"
        P = Parameters(["--genomeDir", os.path.join(GOLD, idx), "--readFilesIn",
                        *reads, *extra, "--tpuBatchSize", str(BATCH),
                        "--outFileNamePrefix", prefix])
        run.align_reads(P, device="cpu")
        counts.append(dict(pipeline.COUNTS))
    assert counts[0] == counts[1]
    c = counts[0]
    spans = pipeline.SPANS
    keys = [s[0] for s in spans]
    if case == "bysj":
        assert c == {"bysj_held": len(remapped) // 2} and c["bysj_held"] > 5
        (i,) = [k for k, s in enumerate(spans) if s[0] == "bysj_stage2"]
        assert spans[i][1] == -1
        inside = [s[0] for s in spans[i + 1:] if s[1] == i]
        assert inside.count("emit") == 2 * c["bysj_held"]
        assert "trsam" not in keys
    else:
        n_rec = len(read_bam(prefix + "Aligned.toTranscriptome.out.bam")[2])
        assert c["trsam_records"] == n_rec > 50
        assert c["trsam_banned"] > 5 and "bysj_held" not in c
        assert not remapped and "bysj_stage2" not in keys
        tr = [s for s in spans if s[0] == "trsam"]
        assert tr and all(spans[s[1]][0] == "quant" for s in tr)
