"""star_tpu_torch.ops.tile_fetch (the port of star_tpu/ops/pallas_fetch.py)
on the CPU, where make_tile_fetch takes its plain version.

pallas_fetch.make_tile_fetch runs only on a TPU (no interpret mode), so the
reference is star_tpu.ops.fetch._fetch_rows_xla, which computes the same
aligned 2 KiB row for every position >= 0.  Exact equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from star_tpu.ops import fetch as jfetch
from star_tpu.ops import pallas_fetch
from star_tpu_torch.ops import tile_fetch


def test_pad_table_matches_pallas_fetch():
    raw = np.random.default_rng(0).integers(-128, 128, 5000, dtype=np.int8)
    assert np.array_equal(tile_fetch.pad_table(raw),
                          pallas_fetch.pad_table(raw))


@pytest.mark.parametrize("n_raw,batch", [(70_001, 4096), (1 << 20, 32 * 300)])
def test_tile_fetch_matches_jax_rows(n_raw, batch):
    rng = np.random.default_rng(n_raw)
    raw = rng.integers(-128, 128, size=n_raw, dtype=np.int8)
    tab = pallas_fetch.pad_table(raw)
    pos = rng.integers(0, n_raw, size=batch).astype(np.int32)
    last_tile = (n_raw - 1) // 1024 * 1024
    pos[:6] = [0, 1023, 1024, n_raw - 1, last_tile - 1, last_tile]
    want = np.asarray(jfetch._fetch_rows_xla(jnp.asarray(tab),
                                             jnp.asarray(pos)))
    fn = tile_fetch.make_tile_fetch(torch.from_numpy(tab), batch)
    got = fn(torch.from_numpy(pos))
    assert got.shape == (batch, tile_fetch.FET) and got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)
    # the window at pos starts at column pos % 1024 of its row
    r = pos % 1024
    assert np.array_equal(got.numpy()[np.arange(batch), r], raw[pos])


def test_tile_fetch_refuses_what_the_tpu_kernel_refuses():
    tab = torch.from_numpy(tile_fetch.pad_table(np.zeros(5000, np.int8)))
    with pytest.raises(ValueError, match="multiple of blk"):
        tile_fetch.make_tile_fetch(tab, 100)                 # 100 % 32 != 0
    with pytest.raises(ValueError, match="multiple of blk"):
        tile_fetch.make_tile_fetch(tab, 64, blk=48)
    fn = tile_fetch.make_tile_fetch(tab, 64)
    with pytest.raises(ValueError):
        fn(torch.zeros(64, dtype=torch.int64))               # int64 positions
    with pytest.raises(ValueError):
        fn(torch.zeros(32, dtype=torch.int32))               # wrong batch
    with pytest.raises(ValueError):
        tile_fetch.make_tile_fetch(tab[:3000], 32)           # not padded


def test_out_of_range_positions_clamp_into_the_table():
    """where the TPU's DMA would fault, the row start clamps into
    [0, len - 2048] (the kernel does the same)"""
    raw = np.arange(6000, dtype=np.int64).astype(np.int8)
    tab = torch.from_numpy(tile_fetch.pad_table(raw))
    n = tab.numel()
    pos = torch.tensor([-5, -3000, n - 1, 2**31 - 1] + [0] * 28,
                       dtype=torch.int32)
    got = tile_fetch.make_tile_fetch(tab, 32)(pos)
    assert torch.equal(got[0], tab[:2048]) and torch.equal(got[1], tab[:2048])
    assert torch.equal(got[2], tab[n - 2048:])
    assert torch.equal(got[3], tab[n - 2048:])
