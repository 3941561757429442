"""The window's feeder ends every mate's stream at the same record, once it
holds the job's reads, and reports that count; past the reads it made
ahead it goes on making them."""
from __future__ import annotations

import os
import threading
import time
import types

from portbench_tiny import tiny  # noqa: F401

FAKE = '''
class Traffic:
    mates = 2

    def __init__(self, model, params, seed):
        self.n = params["batch_reads"]

    def batch(self, k, stream=0):
        names = [f"k{k}r{i}" for i in range(self.n)]
        return ([[f"@{n}\\nACGTACGTAC\\n+\\nFFFFFFFFFF\\n" for n in names],
                 [f"@{n}\\nGGGG\\n+\\nFFFF\\n" for n in names]], names)
'''


def test_feeder_stops_every_mate_at_one_record(tiny, tmp_path):
    import run
    from portbench.harness import cache
    pb = str(tmp_path / "pb")
    os.makedirs(os.path.join(pb, "traffic"))
    with open(os.path.join(pb, "traffic", "fake.py"), "w") as f:
        f.write(FAKE)
    cell = types.SimpleNamespace(pb=pb, wl={"traffic": "fake",
                                            "params": {"batch_reads": 100}})
    # reads made ahead, then made as the reader takes them
    feeder = run.Feeder(cell, cache.genome_dir("tiny", tiny), 1, 2, 448,
                        prefill=250)
    feeder.ready()
    got = {0: [], 1: []}

    def read():
        streams = [open(p) for p in feeder.fifos]
        while True:
            recs = [[s.readline() for _ in range(4)] for s in streams]
            if not recs[0][0] and not recs[1][0]:
                break
            for m in (0, 1):
                got[m].append(recs[m][0].strip())
            time.sleep(0.0005)
        for s in streams:
            s.close()

    th = threading.Thread(target=read)
    th.start()
    feeder.start()
    n = feeder.finish()
    th.join(timeout=30)
    assert not th.is_alive()
    assert n == 448
    assert len(got[0]) == len(got[1]) == n
    assert got[0] == got[1]                  # same record ends both mates
    assert got[0][:3] == ["@k0r0", "@k0r1", "@k0r2"]
    assert got[0][300] == "@k3r0" and got[0][-1] == "@k4r47"
    assert feeder.proc.returncode == 0
    assert not os.path.exists(feeder.tmp)
