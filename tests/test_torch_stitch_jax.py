"""The port's device grow against star_tpu's: every grow that the se
alignment runs through the port (device grow forced on every level; the pe
case is in test_torch_stitch_jax_pe.py) is held, field by field, against
star_tpu.ops.device_stitch.grow_chains_device (lread=None, its CPU gather
layer; the port runs the fetch layer) on copies of the same inputs.

Two faults of the JAX engine are not repeated by the port, which follows the
numpy engine there (ROADMAP queue 3):
  * its lanes_from_blocks sign-extends the low mask word, so a chain holding
    seed 31 of a window (the W512 level only) gets a wrong mask and DFS
    rank; chains of windows without such a chain are compared exactly;
  * its annotated-junction path drops the new exon's matches from nMatch
    (sjdb goldens only, not run here)."""
import copy
import types

import numpy as np

import star_tpu.ops.device_stitch as jds
from star_tpu_torch.ops import batch_engine as be
from star_tpu_torch.ops import device_stitch as ds
from tests.conftest import GOLD
from tests.test_torch_stitch import (  # noqa: F401  (fixtures)
    _align_golden, _body, assert_lanes_equal, force_device_grow,
    one_torch_thread)


def _bit31_windows(lanes):
    """(read, window) keys of the windows holding a chain with seed 31"""
    hit = ((lanes.mask >> 31) & 1) == 1
    return set(zip(lanes.b[hit].tolist(), lanes.w[hit].tolist()))


def _keep_windows(lanes, bad):
    keep = np.array([(b, w) not in bad for b, w in
                     zip(lanes.b.tolist(), lanes.w.tolist())], bool)
    return be._lanes_take(lanes, np.nonzero(keep)[0])


def check_against_jax(tmp_path, monkeypatch, case):
    real = ds.grow_chains_device
    seen = []

    def spy(gi, P, st, ws, RS, nmm, Lpad, s_max, chain_cap, device):
        st_j = copy.deepcopy(st)
        want, acc, over = jds.grow_chains_device(gi, P, st_j, ws, RS, nmm,
                                                 Lpad, s_max, chain_cap)
        assert acc is None and over is None
        got = real(gi, P, st, ws, RS, nmm, Lpad, s_max, chain_cap, device)
        assert np.array_equal(st.fallback, st_j.fallback)
        bad = _bit31_windows(got)
        if s_max <= 31:
            assert not bad
        assert_lanes_equal(_keep_windows(got, bad), _keep_windows(want, bad))
        seen.append((s_max, len(got.b), len(bad)))
        return got

    monkeypatch.setattr(ds, "grow_chains_device", spy)
    prefix = _align_golden(tmp_path, "genome_idx", case)
    assert [s for s, _, _ in seen] == [be.S_MAX, 50]
    assert all(n > 0 for _, n, _ in seen)
    assert _body(prefix + "Aligned.out.sam") == \
        _body(f"{GOLD}/{case}/Aligned.out.sam")


def test_device_grow_matches_jax_engine_se(tmp_path, monkeypatch,
                                           force_device_grow):
    check_against_jax(tmp_path, monkeypatch, "se")


def test_jax_lanes_from_blocks_sign_extends_bit_31():
    """one chain of seeds {0, 31, 32}: the port's mask is the numpy one, the
    JAX engine's loses its high word"""
    sc = np.zeros((1, ds.NSCAL), np.int32)
    sc[0, ds.C_MASK_LO] = np.int32(-(1 << 31)) | 1
    sc[0, ds.C_MASK_HI] = 1
    ex = np.zeros((1, ds.NEXB), np.int32)
    sj = np.zeros((1, ds.NSJB), np.int32)
    st = types.SimpleNamespace(pb=np.zeros(1, np.int32),
                               pw=np.zeros(1, np.int32),
                               wa_n=np.array([40], np.int32),
                               fallback=np.zeros(1, bool))
    want = 1 | (1 << 31) | (1 << 32)
    port = ds.lanes_from_blocks(sc, ex, sj, np.zeros(1, np.int64), st, 50)
    assert int(port.mask[0]) == want
    jax_mask = jds.lanes_from_blocks(sc, ex, sj, np.zeros(1, np.int64), st,
                                     50).mask
    assert int(jax_mask[0]) != want and int(jax_mask[0]) < 0
