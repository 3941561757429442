"""star_tpu_torch.ops.fetch against star_tpu.ops.fetch: the padded table, the
fetched rows (the plain version, as on the CPU) and the
int32 / window extraction must be byte-identical.  Integer data throughout,
so the tolerance is exact equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from star_tpu.ops import fetch as jf
from star_tpu_torch.ops import fetch as tf

N_RAW = 300_001


def _raw(seed=0, n=N_RAW):
    return np.random.default_rng(seed).integers(-128, 128, size=n,
                                                dtype=np.int8)


def _offsets(n_raw, seed=1, B=4096):
    """random offsets with negative values, 0, the last raw byte and tile
    edges"""
    rng = np.random.default_rng(seed)
    off = rng.integers(-n_raw // 8, n_raw, size=B).astype(np.int64)
    special = [-1, -(1 << 40), 0, 1, n_raw - 1, 1023, 1024, 2047, 4 * 1024 - 1,
               (n_raw // 1024) * 1024 - 1, (n_raw // 1024) * 1024]
    off[:len(special)] = special
    return off


def _rows(seed=2, B=1024):
    """rows whose bytes cover the whole int8 range, incl. >= 0x80 top bytes"""
    return np.random.default_rng(seed).integers(-128, 128, size=(B, tf.FET),
                                                dtype=np.int8)


def test_pad_table_matches_jax():
    raw = _raw()
    assert np.array_equal(tf.pad_table(raw), jf.pad_table(raw))
    sa = np.random.default_rng(3).integers(0, 1 << 31, size=777).astype(np.int32)
    assert np.array_equal(tf.pad_table(sa), jf.pad_table(sa))


def test_fetch_rows_matches_jax():
    tab = tf.pad_table(_raw())
    off = _offsets(N_RAW)
    want = np.asarray(jf._fetch_rows_xla(jnp.asarray(tab),
                                         jnp.asarray(off.astype(np.int32))))
    got = tf.fetch_rows(torch.from_numpy(tab), torch.from_numpy(off)).numpy()
    assert got.shape == (len(off), tf.FET) and got.dtype == np.int8
    live = off >= 0
    assert live.sum() > 3000 and (~live).sum() > 100
    assert np.array_equal(got[live], want[live])


def test_extract_i32_matches_jax():
    rows = _rows()
    rng = np.random.default_rng(4)
    rbyte = rng.integers(0, tf.TILE + 5, size=len(rows))
    rows[0, 7] = -128                      # 0x80 top byte at rbyte 4
    rbyte[0] = 4
    want = np.asarray(jf.extract_i32(jnp.asarray(rows),
                                     jnp.asarray(rbyte.astype(np.int32))))
    got = tf.extract_i32(torch.from_numpy(rows), torch.from_numpy(rbyte))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (want < 0).sum() > 100          # the sign case is covered


@pytest.mark.parametrize("width", [128, 512, 1024])
def test_realign_matches_jax(width):
    rows = _rows(seed=5)
    r = np.random.default_rng(6).integers(0, tf.TILE, size=len(rows))
    r[:2] = [0, tf.TILE - 1]
    want = np.asarray(jf.realign(jnp.asarray(rows),
                                 jnp.asarray(r.astype(np.int32)), width))
    got = tf.realign(torch.from_numpy(rows), torch.from_numpy(r), width)
    assert np.array_equal(got.numpy(), want)
