"""The benchmark of star_tpu_torch, the PyTorch and CUDA port of the aligner.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with an NVIDIA GPU.  One run is
one mapping job of the cell's deployment, timed from the outside:

1. Set-up (`setup_s`, from the start of the process to the window): the
   cell's genome and annotation (portbench/genomes/), the aligner's index of
   them built by its own genomeGenerate with the GTF inserted (cached in
   portbench/cache/ after a checkout's first run), the index loaded into a
   GenomeIndex and a short warm-up job on reads the window never sees, which
   uploads the index to the card and builds the CUDA kernel.
2. The window: one call of star_tpu_torch.run.align_reads(P, gi=gi) with the
   deployment's flags, its reads streamed through named pipes by a feeder
   process (harness/feeder.py) that makes them during set-up.  The job's
   size is fixed, the same for every seed: the workload's window_reads at
   BENCHMARK.json's run_seconds, in proportion at another --seconds, in
   whole batches of the aligner (at least one).  The call is the whole job,
   from reading to the last output file, and lasts as long as the job
   takes: on the card some two to three times --seconds.  On the card the
   feeder runs on a core of its own and the job on the others, with one
   host thread for its numerical libraries (STAR's --runThreadN 1).
3. The check: the job's outputs judged by the plain reference of the
   configuration (portbench/reference/), which imports nothing of the port.
4. The last line of standard output: one JSON object.  --trace 0 gives the
   cell's end-to-end metrics, --trace 1 its per-layer metrics (each read by
   portbench/metrics/<metric>.py from the traced window) and a breakdown.

Everything a cell is made of is found by name: BENCHMARK.json names the cell
and its configuration, portbench/workloads/<cell>.json its traffic generator
(portbench/traffic/<generator>.py) and parameters, portbench/configs/<config>.json
its flags, genome and reference.  Adding a cell, a configuration, a generator
or a metric adds files and entries; no file here changes.
"""
from __future__ import annotations

import time

_T0 = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

PB = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB)
for _p in (ROOT,):
    if _p not in sys.path:
        sys.path.insert(0, _p)

FORBIDDEN = ("jax", "jaxlib", "flax", "star_tpu")


def forbidden_loaded(names):
    """the top-level names among `names` (module names) that are JAX's or
    the JAX package's, compared whole"""
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """a cell as BENCHMARK.json and its files define it"""

    def __init__(self, name, pb=PB):
        self.pb = pb
        bench = load_json(os.path.join(os.path.dirname(pb), "BENCHMARK.json"))
        self.bench = bench
        ent = [w for w in bench["workloads"] if w["name"] == name]
        if not ent:
            raise SystemExit(f"no workload {name} in BENCHMARK.json")
        self.entry = ent[0]
        self.name = name
        self.wl = load_json(os.path.join(pb, "workloads", name + ".json"))
        cfg_ent = [c for c in bench["configs"]
                   if c["name"] == self.entry["config"]][0]
        self.cfg = load_json(os.path.join(os.path.dirname(pb), cfg_ent["file"]))

    def metrics(self, trace):
        """the cell's metric entries of BENCHMARK.json for this kind of run"""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[key]
                if self.name in m.get("workloads", [self.name])]


def write_reads(recs, paths):
    for mate, p in enumerate(paths):
        with open(p, "w") as f:
            f.write("".join(recs[mate]))


class Feeder:
    """the feeder process of the window (harness/feeder.py); it streams
    `reads` reads, of which it makes `prefill` while set-up goes on, until
    ready() waits for them"""

    def __init__(self, cell, model_dir, seed, n_mates, reads, prefill=0,
                 cpus=None):
        self.tmp = tempfile.mkdtemp(prefix="portbench-")
        self.fifos = [os.path.join(self.tmp, f"mate{i + 1}.fq")
                      for i in range(n_mates)]
        for f in self.fifos:
            os.mkfifo(f)
        spec = {"root": ROOT, "model_dir": model_dir, "seed": seed,
                "traffic_file": os.path.join(cell.pb, "traffic",
                                             cell.wl["traffic"] + ".py"),
                "params": cell.wl["params"], "fifos": self.fifos,
                "reads": reads, "prefill": prefill, "cpus": cpus}
        spec_path = os.path.join(self.tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(PB, "harness", "feeder.py"), spec_path],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def ready(self):
        if self.proc.stdout.readline().strip() != "ready":
            raise RuntimeError("the feeder did not start")

    def start(self):
        self.proc.stdin.write("go\n")
        self.proc.stdin.flush()

    def finish(self, ok=True):
        """records written to every mate; the process is waited for, and
        ended first where the job failed (ok false: nobody reads the pipes)"""
        if not ok:
            self.proc.kill()
        try:
            out, _ = self.proc.communicate(timeout=120)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            shutil.rmtree(self.tmp, ignore_errors=True)
        return int(out.split()[-1]) if ok else -1


def job_reads(window_reads, seconds, run_seconds, unit):
    """the reads of a run's job: `window_reads` at `run_seconds`, in
    proportion at other `seconds`, in whole batches of `unit`, at least one"""
    return max(1, round(window_reads * seconds / (run_seconds * unit))) * unit


def card_info():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not available"


def run_cell(name, seed, seconds, trace, device=None, extra_flags=(),
             pb=PB, plant=None, feeder_cpus=None):
    """one run of a cell; returns (result dict, checks [(name, value,
    limit)]).  device=None runs on the card; "cpu" is for the tests, with
    the kernels' plain versions.  extra_flags are appended to the
    deployment's flags (the control); plant(modules) plants a fault before
    the window (the tests); feeder_cpus are the feeder's cores."""
    import torch
    from portbench.harness import cache, trace as tr
    from portbench.harness.feeder import make_traffic
    from star_tpu_torch.genome.index import GenomeIndex
    from star_tpu_torch.ops import batch_engine, device_stitch, fetch, pipeline
    from star_tpu_torch.params import Parameters
    from star_tpu_torch import run as st_run

    cell = Cell(name, pb)
    cfg, wl = cell.cfg, cell.wl
    on_card = device is None
    gdir = cache.genome_dir(cfg["genome"], pb)
    idx = cache.index_dir(gdir, cfg["index_flags"], pb)
    gi = GenomeIndex.load(idx)
    out = os.path.join(pb, "out", name)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    def expand(fl):
        return [f.replace("{gdir}", gdir).replace("{out}", out) for f in fl]
    # the reference judges by the deployment's flags; a control's extra
    # flags change only what the program is told
    stated = expand(list(cfg["flags"]) + list(wl.get("flags", [])))
    flags = stated + expand(extra_flags)
    traffic = make_traffic({"root": ROOT, "model_dir": gdir, "seed": seed,
                            "traffic_file": os.path.join(
                                pb, "traffic", wl["traffic"] + ".py"),
                            "params": wl["params"]})
    traffic.prepare(out)
    n_mates = traffic.mates

    def params(reads, prefix):
        return Parameters(["--genomeDir", idx, "--readFilesIn", *reads,
                           *flags, "--outFileNamePrefix", prefix])

    # warm-up: the same job on reads of another stream of the seed, while
    # the feeder makes the window's reads
    warm = [os.path.join(out, f"warm_mate{i + 1}.fq") for i in range(n_mates)]
    recs = traffic.warmup(int(wl["warmup_reads"]))
    write_reads(recs, warm)
    warm_P = params(warm, os.path.join(out, "warm") + "/")
    n_job = job_reads(int(wl["window_reads"]), seconds,
                      float(cell.bench["run_seconds"]), warm_P.tpuBatchSize)
    feeder = Feeder(cell, gdir, seed, n_mates, n_job, n_job, feeder_cpus)
    try:
        st_run.align_reads(warm_P, gi=gi, device=device)
        feeder.ready()
    except BaseException:
        feeder.finish(ok=False)
        raise
    for f in warm:
        os.unlink(f)
    # the window starts from a heap without the warm-up job's garbage
    gc.collect()
    pipeline.TIMERS.clear()
    batch_engine.LEVEL_STATS.clear()
    device_stitch.GROW_STATS.clear()
    launches0 = fetch.LAUNCHES
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if plant is not None:
        plant()
    P = params(feeder.fifos, os.path.join(out, "window") + "/")
    prof = spans = rec = None
    if trace:
        pipeline.TIMING = True
        spans = tr.Spans([pipeline, st_run]).__enter__()
        if on_card:
            from torch.profiler import ProfilerActivity, profile
            rec = tr.FetchRecorder(fetch).__enter__()
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
    setup_s = time.time() - _T0
    w0 = time.time()
    w0_ns = time.time_ns()
    feeder.start()
    ok = False
    try:
        stats = st_run.align_reads(P, gi=gi, device=device)
        if on_card:
            torch.cuda.synchronize()
        ok = True
    finally:
        w1 = time.time()
        w1_ns = time.time_ns()
        n_fed = feeder.finish(ok)
        if trace:
            pipeline.TIMING = False
            spans.__exit__()
            if rec is not None:
                rec.__exit__()
            if prof is not None:
                prof.__exit__(None, None, None)
    wall = w1 - w0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    launches = fetch.LAUNCHES - launches0
    timers = dict(pipeline.TIMERS)
    lv = dict(batch_engine.LEVEL_STATS)
    recs_by_w = {w: v for (w, k), v in lv.items() if k == "records"}
    w512_share = (recs_by_w.get(512, 0) / sum(recs_by_w.values())
                  if recs_by_w else 0.0)
    log(f"card: {card_info() if on_card else 'cpu (test)'}")
    log(f"window: {stats.read_n} reads ({n_fed} fed) in {wall:.3f} s, "
        f"{-(-stats.read_n // P.tpuBatchSize)} batches of {P.tpuBatchSize}; "
        f"seed records by level {recs_by_w}, W512 share {w512_share:.4f}; "
        f"fetch_window launches {launches}; setup {setup_s:.3f} s")
    device_rec = {"platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                  "count": 1, "memory_peak_bytes": int(peak)}
    metrics = {}
    breakdown = None
    if not trace:
        e2e = {"reads_per_s": (stats.read_n / wall, "reads/s"),
               "peak_mem_gib": (peak / 2**30, "GiB"),
               "setup_s": (setup_s, "s")}
        for m in cell.metrics(False):
            v = e2e[m["name"]]
            metrics[m["name"]] = {"value": v[0], "unit": v[1]}
    else:
        record = {"cell": name, "reads": stats.read_n, "timers": timers,
                  "window_s": wall, "level_stats": lv}
        if on_card:
            busy, ops, gaps, kcount = tr.device_activity(prof, w0_ns, w1_ns)
            del prof
            seen = sum(v for k, v in kcount.items() if "window_kernel" in k)
            log(f"trace: profiler saw {seen} window kernels of {launches} "
                f"fetch_window launches" + (
                    "; the idle share is an upper bound" if seen < launches
                    else ""))
            gaps.sort(key=lambda g: g[0] - g[1])
            top = [[tr.label_gap(spans.spans, a, b), (b - a) / 1e9]
                   for a, b in gaps[:10]]
            breakdown = {"device_ops": ops, "idle_gaps": top}
            record["busy_s"] = busy
            device_rec["busy_s"] = busy
            device_rec["window_s"] = wall
            calls = rec.calls
            del rec
            record["fetch"] = tr.roofline(torch, fetch, calls)
            del calls
            log(f"trace: fetch_window relaunch {record['fetch']}")
        for m in cell.metrics(True):
            mod = load_module(os.path.join(pb, "metrics", m["name"] + ".py"),
                              "metric_" + m["name"].replace(".", "_"))
            v = mod.read(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        log("trace: timers " + " ".join(f"{k}={v:.3f}" for k, v in
                                        sorted(timers.items())))
    # the program's state goes before the reference runs
    del gi, P, stats
    if on_card:
        torch.cuda.empty_cache()
    loaded = forbidden_loaded(list(sys.modules))
    if loaded:
        raise SystemExit(f"the process loaded {loaded}: the benchmark runs "
                         "the port without JAX or the JAX package")
    checks = judge(cell, gdir, traffic, n_fed, out, stated)
    failed = next((c[1] for c in checks if c[0] == "reads_missing"), 0)
    result = {"correct": all(v <= lim for _, v, lim in checks),
              "attempted": n_fed, "failed": int(failed),
              "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks


def judge(cell, gdir, traffic, n_fed, out, flags):
    """the reference's verdict on the window's job: [(name, value, limit)]"""
    from portbench.reference.genome import RefGenome
    t = time.time()
    ref = load_module(os.path.join(cell.pb, "reference",
                                   cell.cfg["reference"] + ".py"),
                      "portbench.reference." + cell.cfg["reference"])
    reads, truth = traffic.window_reads(n_fed)
    ctx = {"genome": RefGenome(os.path.join(gdir, "genome.fa"),
                               os.path.join(gdir, "annot.gtf")),
           "flags": flags, "out_dir": os.path.join(out, "window"),
           "reads": reads, "truth": truth, "limits": cell.wl["limits"],
           "gdir": gdir}
    checks = ref.check(ctx)
    for n in ctx.get("notes", []):
        log(f"check note: {n}")
    log(f"check: {ctx.get('counts')} in {time.time() - t:.1f} s")
    return checks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    a = ap.parse_args(argv)
    # one host thread for the numerical libraries, as STAR's --runThreadN 1
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    # the feeder on a core of its own, the job on the others
    cpus = sorted(os.sched_getaffinity(0))
    feeder_cpus = None
    if len(cpus) > 1:
        os.sched_setaffinity(0, cpus[:-1])
        feeder_cpus = cpus[-1:]
    import torch
    torch.set_num_threads(1)
    cell = Cell(a.workload)
    want = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        log(f"portbench: the cell needs {want} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " available. The benchmark does not run on the CPU.")
        return 3
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(PB, "cache", sub)
    result, checks = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                              feeder_cpus=feeder_cpus)
    for n, v, lim in checks:
        log(f"check {n} {v} limit {lim}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
