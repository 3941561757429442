"""Every cell of BENCHMARK.json against its plain reference on the CPU, on a
tiny copy of the benchmark with the port on CPU tensors: a sound run comes
out correct with every exact check of its workload at 0, and each control of
its configuration comes out not correct.  The parked cells' checks hold on
the port's host path, and a changed SJ.out.tab there is caught; the
reference's Cell Ranger 4 clip is the port's.  The exact checks and the
controls come from the cells' own files (tests/portbench_cases.py)."""
import numpy as np
import pytest

from tests.portbench_cases import (  # noqa: F401
    CELLS, HOST, PARKED, assert_sound, controls, exact_checks,
    modules_of_the_session, run, sj_altered, tiny)

# the check each control must break, where it is the control's point
BREAKS = {"mates_gap_1000": "missed_pct", "trsam_softclip": "trsam_diff"}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    result, checks = run(tiny, cell)
    assert_sound(result, checks, cell)
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell,control", [(c, k) for c in CELLS
                                          for k in controls(c)])
def test_control_is_not_correct(tiny, cell, control):
    result, checks = run(tiny, cell, extra=controls(cell)[control])
    assert not result["correct"], checks
    if control in BREAKS:
        name = BREAKS[control]
        got = {n: (v, lim) for n, v, lim in checks}[name]
        assert got[0] > got[1], checks


@pytest.mark.parametrize("cell", PARKED)
def test_parked_cell_on_the_host_path(tiny, cell):
    """a parked cell's check comes out correct on the port's per-read host
    path, every exact number at 0"""
    result, checks = run(tiny, cell, extra=HOST)
    assert_sound(result, checks, cell)
    assert exact_checks(cell) >= {"reads_missing", "bad_records"}


@pytest.mark.parametrize("cell", PARKED)
def test_parked_fault_is_not_correct(tiny, monkeypatch, cell):
    result, checks = run(tiny, cell, plant=sj_altered(monkeypatch),
                         extra=HOST)
    assert not result["correct"], checks


def test_reference_clip_is_the_ports():
    """reference/cr4_clip.py clips what the port's CellRanger4 ClipMates
    clip, on reads led by parts of the TSO and ending in A tails, with
    substitutions in both"""
    from portbench.reference.cr4_clip import TSO, clips
    from star_tpu_torch.align.clip import ClipMate
    from star_tpu_torch.constants import encode_seq
    rng = np.random.default_rng(2**31 + 3)
    seqs = []
    for _ in range(3000):
        s = list(rng.choice(list("ACGT"), 91))
        if rng.random() < 0.5:
            n = int(rng.integers(5, 31))
            s[:n] = TSO[-n:]
        if rng.random() < 0.4:
            n = int(rng.integers(5, 50))
            s[91 - n:] = "A" * n
        for k in np.nonzero(rng.random(91) < 0.03)[0]:
            s[k] = "ACGTN"[int(rng.integers(0, 5))]
        seqs.append("".join(s))
    c5, c3 = ClipMate(10, 0, TSO, 0, 0.1), ClipMate(11, 0, "A", 0, 0.1)
    c5.clip_batch(seqs)
    want = []
    for s in seqs:
        m = encode_seq(s)
        lread, off = c5.clip(m, len(m))
        c3.clip(m[off:], lread)
        want.append((c5.clipped_n, c3.clipped_n))
    got = clips(seqs)
    assert got == want
    assert sum(a > 0 for a, _ in got) > 500 and sum(b > 0 for _, b in got) > 300
