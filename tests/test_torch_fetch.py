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


def test_window_i32_matches_jax_extract_i32():
    """the MMP's SA/SAi read: a 4-byte window viewed as int32 equals the JAX
    extract_i32 of the fetched row, sign bit included (the packed SAi keeps
    "prefix absent" there)"""
    tab = tf.pad_table(_raw(seed=4))
    rng = np.random.default_rng(4)
    s = rng.integers(0, N_RAW - 4, size=4096).astype(np.int64)
    s[:4] = [0, 1020, 1021, N_RAW - 4]     # cuts across the 1 KiB tile edge
    jt = jnp.asarray(tab)
    want = np.asarray(jf.extract_i32(
        jf._fetch_rows_xla(jt, jnp.asarray(s.astype(np.int32))),
        jnp.asarray((s % tf.TILE).astype(np.int32))))
    got = tf.fetch_window(torch.from_numpy(tab), torch.from_numpy(s), 4)
    got = got.contiguous().view(torch.int32)[:, 0]
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


# the widths the main path asks of fetch_window (100 bp SE: SA entry, SAi
# pair, lane rows of 96 and 400 bytes, Lwin = Lpad + 2, QL, 2 * Lwin, RSPAN,
# GSPAN), the 2x150 PE genome span that needs two rows, and the widest window
WIDTHS = [4, 8, 96, 104, 128, 208, 318, 400, 724, 1172, 3072]


def _starts(n, width, seed, B=2048):
    """random starts over the whole table and past both ends, every 16-byte
    residue, and the edges: 0, the last unclamped start and beyond it"""
    rng = np.random.default_rng(seed)
    s = rng.integers(-n // 8, n + 64, size=B).astype(np.int64)
    special = [-1, -(1 << 40), 0, 1, 15, 16, 17, n - width - 1, n - width,
               n - width + 1, n - 1, n, 1 << 40] + list(range(4096, 4112))
    s[:len(special)] = special
    return s


@pytest.mark.parametrize("width", WIDTHS)
def test_fetch_window_matches_jax(width):
    """fetch_window (its plain version, as on the CPU) equals the JAX
    composition the TPU path runs: _fetch_rows_xla rows at the aligned start
    (two of them, FET apart, for a window over 1,025 bytes), realigned by the
    barrel shifter, at the start clamped into the table as the kernel
    clamps it; rows with a negative start are skipped"""
    tab = tf.pad_table(_raw(seed=width))
    n = len(tab)
    s = _starts(n, width, seed=width + 1)
    got = tf.fetch_window(torch.from_numpy(tab), torch.from_numpy(s),
                          width).numpy()
    assert got.shape == (len(s), width) and got.dtype == np.int8
    sc = np.clip(s, 0, n - width)
    base = (sc // tf.TILE) * tf.TILE
    jt = jnp.asarray(tab)
    rows = jnp.concatenate(
        [jf._fetch_rows_xla(jt, jnp.asarray((base + k * tf.FET)
                                            .astype(np.int32)))
         for k in range(tf._rows_for(width))], axis=1)
    want = np.asarray(jf.realign(rows, jnp.asarray((sc - base)
                                                   .astype(np.int32)), width))
    live = s >= 0
    assert live.sum() > 1500 and (~live).sum() > 100
    assert np.array_equal(got[live], want[live])


@pytest.mark.parametrize("width", WIDTHS)
def test_fetch_window_plain_matches_rows_and_cut(width):
    """_fetch_window_torch against the composition it replaces on the stitch
    engine's path: the rows of _fetch_rows_torch FET apart from the start's
    aligned row, then one gather at start % TILE, wherever those rows fit"""
    tab = torch.from_numpy(tf.pad_table(_raw(seed=3 * width, n=40_001)))
    n = tab.numel()
    m = tf._rows_for(width)
    s = torch.from_numpy(_starts(n, width, seed=width))
    fits = (s >= 0) & ((s // tf.TILE) * tf.TILE + m * tf.FET <= n)
    assert fits.sum() > 1000
    s = s[fits]
    offs = s[:, None] + tf.FET * torch.arange(m)
    rows = tf._fetch_rows_torch(tab, offs.reshape(-1)).reshape(len(s), -1)
    idx = (s % tf.TILE)[:, None] + torch.arange(width)
    want = torch.gather(rows, 1, idx)
    assert torch.equal(tf._fetch_window_torch(tab, s, width), want)


def test_fetch_window_refuses_bad_inputs():
    tab = torch.from_numpy(tf.pad_table(np.zeros(5000, np.int8)))
    s = torch.zeros(4, dtype=torch.int64)
    for bad in (lambda: tf.fetch_window(tab, s.int(), 8),      # int32 starts
                lambda: tf.fetch_window(tab.view(torch.uint8), s, 8),
                lambda: tf.fetch_window(tab[16:], s, 8),        # not padded
                lambda: tf.fetch_window(tab, s, 0),
                lambda: tf.fetch_window(tab, s, tf.WINDOW_MAX + 1),
                lambda: tf.fetch_window(tab[:3 * tf.TILE], s, 1100)):
        with pytest.raises(ValueError):
            bad()
    assert tf.fetch_window(tab, s[:0], 400).shape == (0, 400)
