"""The port's device stitch engine against star_tpu's: every grow, finalize
and (single-end) select that the se alignment runs through the port (device
engine forced on every level; the pe case is in test_torch_stitch_jax_pe.py)
is held against star_tpu.ops.device_stitch.grow_chains_device with
lread/read_len2 (its CPU gather layer and its finalize engine; on se its
select engine too, forced with STAR_TPU_DEV_CLASSIFY_MIN=0) on copies of the
same inputs: the over flags exactly, the lanes and their accept flags
field by field.

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
    """the indices of the lanes outside the windows `bad`"""
    return np.array([i for i, bw in enumerate(zip(lanes.b.tolist(),
                                                  lanes.w.tolist()))
                     if bw not in bad], np.int64)


def check_against_jax(tmp_path, monkeypatch, case):
    real = ds.grow_chains_device
    seen = []
    over1 = []
    monkeypatch.setenv("STAR_TPU_DEV_CLASSIFY_MIN", "0")

    def compare(gi, P, st, ws, RS, nmm, Lpad, s_max, chain_cap, device,
                lread, read_len2, classify):
        st_j = copy.deepcopy(st)
        want, acc_j, over_j = jds.grow_chains_device(
            gi, P, st_j, ws, RS, nmm, Lpad, s_max, chain_cap, lread=lread,
            read_len2=read_len2, classify=classify)
        got, acc, over = real(gi, P, st, ws, RS, nmm, Lpad, s_max, chain_cap,
                              device, lread=lread, read_len2=read_len2,
                              classify=classify)
        assert acc is not None and acc_j is not None
        assert (over is None) == (case == "pe")
        assert np.array_equal(st.fallback, st_j.fallback)
        B = ws.n_reads
        z = np.zeros(B, bool)
        assert np.array_equal(z if over is None else over,
                              z if over_j is None else over_j)
        bad = _bit31_windows(got)
        if s_max <= 31:
            assert not bad
        k, k_j = _keep_windows(got, bad), _keep_windows(want, bad)
        assert_lanes_equal(be._lanes_take(got, k), be._lanes_take(want, k_j))
        assert np.array_equal(acc[k], acc_j[k_j])
        return got, acc, over, len(bad)

    def spy(gi, P, st, ws, RS, nmm, Lpad, s_max, chain_cap, device,
            lread=None, read_len2=None, classify=False):
        if case == "se":
            # the golden's reads map to at most 10 loci: with a limit of 1
            # the select classifies some of them over (results not used)
            P1 = copy.copy(P)
            P1.outFilterMultimapNmax = 1
            n_over = compare(gi, P1, copy.deepcopy(st), ws, RS, nmm, Lpad,
                             s_max, chain_cap, device, lread, read_len2,
                             classify)[2].sum()
            over1.append(int(n_over))
        got, acc, over, n_bad = compare(gi, P, st, ws, RS, nmm, Lpad, s_max,
                                        chain_cap, device, lread, read_len2,
                                        classify)
        seen.append((s_max, len(got.b), n_bad))
        return got, acc, over

    monkeypatch.setattr(ds, "grow_chains_device", spy)
    prefix = _align_golden(tmp_path, "genome_idx", case)
    assert [s for s, _, _ in seen] == [be.S_MAX, 50]
    assert all(n > 0 for _, n, _ in seen)
    assert case == "pe" or over1[0] > 0
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
