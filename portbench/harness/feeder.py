"""The window's read feeder: a process of its own that streams a traffic
generator's reads into named pipes, as a sequencer's compressed FASTQ is
streamed into STAR with --readFilesCommand.

Run as `python3 feeder.py <spec.json>`.  The spec names the traffic module,
its parameters, the genome model directory, the seed, one pipe per mate,
the job's reads ("reads", a whole number of the aligner's batches), the
reads to make ahead ("prefill") and the cores it runs on ("cpus", none:
any).  The feeder makes batches until it holds the prefill, prints
"ready", waits for a line on its standard input (the window's start), opens
the pipes in mate order and writes batch after batch, CHUNK records of
every mate at a time, until every mate's stream holds the job's reads.
Then it closes the pipes, prints the number of records written and exits.
The job's reads come from memory as far as the prefill reaches, so the
feeder only writes while the job runs; past it, it makes each batch as the
job takes it.  Batch k of a run is made from (seed, k): a seed gives the
same reads, and every seed the same number of them, whatever the speed of
the reader.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys

CHUNK = 32       # records of each mate in one write


def load_traffic(path: str):
    spec = importlib.util.spec_from_file_location(
        "traffic_" + os.path.basename(path)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_traffic(spec: dict):
    sys.path.insert(0, spec["root"])
    from portbench.harness.genome import Model
    mod = load_traffic(spec["traffic_file"])
    return mod.Traffic(Model(spec["model_dir"]), spec["params"], spec["seed"])


def main():
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    if spec.get("cpus"):
        os.sched_setaffinity(0, spec["cpus"])
    traffic = make_traffic(spec)
    ahead = [traffic.batch(0)[0]]
    while sum(len(r[0]) for r in ahead) < int(spec.get("prefill", 0)):
        ahead.append(traffic.batch(len(ahead))[0])
    print("ready", flush=True)
    sys.stdin.readline()
    outs = [open(p, "w") for p in spec["fifos"]]
    n = 0
    total = int(spec["reads"])
    k = 0
    try:
        while n < total:
            recs = ahead[k] if k < len(ahead) else traffic.batch(k)[0]
            m = min(len(recs[0]), total - n)
            for i in range(0, m, CHUNK):
                j = min(i + CHUNK, m)
                for mate, out in enumerate(outs):
                    out.write("".join(recs[mate][i:j]))
                    out.flush()
                n += j - i
            k += 1
    except BrokenPipeError:
        n = -1
    finally:
        for out in outs:
            try:
                out.close()
            except BrokenPipeError:
                n = -1
    print(n, flush=True)


if __name__ == "__main__":
    main()
