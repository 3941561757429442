"""Every cell of BENCHMARK.json with its timed path broken underneath comes
out not correct on the CPU, on a tiny copy of the benchmark with the port on
CPU tensors: half of each batch left out of the outputs, the seed loop's
tables handed back untouched, a score altered after the finish (every
cell); one gene's UMIs altered and the CR4 clip skipped (the 10x cell); the
coordinate-sorted BAM left in read order (the paired-end cell).  One chip a
cell: no exchange between chips to leave out.  The stitch levels keep the
numpy grow here: the faults lie outside it, and the sound runs of
tests/test_portbench_cells.py hold the device engine on CPU tensors."""
import pytest

from tests.portbench_cases import (CELL_FAULTS, FAULTS,  # noqa: F401
                                   modules_of_the_session, run, tiny)


@pytest.fixture(autouse=True)
def numpy_grow(monkeypatch):
    from star_tpu_torch.ops import batch_engine as be
    monkeypatch.setattr(be, "DEVICE_GROW_MIN_RECORDS",
                        {k: 1 << 40 for k in be.DEVICE_GROW_MIN_RECORDS})


@pytest.mark.parametrize("cell,fault", CELL_FAULTS)
def test_fault_is_not_correct(tiny, monkeypatch, cell, fault):
    result, checks = run(tiny, cell, plant=FAULTS[fault](monkeypatch))
    assert not result["correct"], checks
