"""Tile fetch: the parallel window gather of star_tpu/ops/pallas_fetch.py.

``make_tile_fetch(table, batch, blk)`` returns ``fetch(pos)``, which maps
``batch`` int32 positions to ``[batch, FET]`` int8 rows: row i holds table
bytes ``[align1024(pos_i), align1024(pos_i) + FET)``, so the window at pos_i
starts at column ``pos_i % TILE``.  The contract is the TPU kernel's: int32
positions, ``batch`` a multiple of ``blk``, and no position is skipped
(unlike ``fetch.fetch_rows``, a negative position is not a "skip" marker).

Valid positions satisfy ``0 <= pos`` and ``align1024(pos) + FET <=
len(table)`` (``pad_table`` leaves room for every position below the raw
length).  On the TPU a position outside that range faults the DMA; here the
row start is clamped into ``[0, len(table) - FET]``, as the kernel does, so
any position reads inside the table.

On a CUDA tensor ``fetch`` launches ``tile_fetch_launch`` of
``csrc/fetch_rows.cu``: the byte-window copy of ``fetch.fetch_window`` at
width FET from the aligned start, with int32 positions and no skip (16-byte
vector loads kept in L2, streaming stores); on a CPU tensor it takes the
plain PyTorch version ``_tile_fetch_torch``.  A build or launch failure
raises.  The module has no caller on the alignment path, as its TPU
counterpart has none.
"""
from __future__ import annotations

import torch

from . import fetch as _fetch
from .fetch import FET, TILE, _fetch_rows_torch, pad_table  # noqa: F401

LAUNCHES = 0     # kernel launches of tile_fetch (CUDA tensors only)


def _tile_fetch_torch(table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """plain version: the row fetch_rows' plain version gives, which reads
    row 0 for a negative position and clamps row starts as the kernel does"""
    return _fetch_rows_torch(table, pos.long())


def _tile_fetch_cuda(table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    out = torch.empty((pos.numel(), FET), dtype=torch.int8,
                      device=table.device)
    if pos.numel():
        _fetch._raise_on(_fetch._lib().tile_fetch_launch(
            table.data_ptr(), table.numel(), pos.data_ptr(), pos.numel(),
            out.data_ptr(), _fetch._stream(table)), "tile_fetch")
        LAUNCHES += 1
    return out


def make_tile_fetch(t2_padded: torch.Tensor, batch: int, blk: int = 32):
    """returns fetch(pos [batch] int32) -> [batch, FET] int8 rows; each row
    holds the 1024-aligned 2 KiB neighbourhood of pos[i]; the window starts
    at pos[i] % 1024 within its row"""
    if blk <= 0 or batch % blk:
        raise ValueError(f"tile_fetch: batch {batch} is not a multiple of "
                         f"blk {blk}")
    n = t2_padded.numel()
    if t2_padded.dtype != torch.int8 or t2_padded.dim() != 1 \
            or not t2_padded.is_contiguous():
        raise ValueError("tile_fetch: table must be a contiguous 1-D int8 "
                         "tensor")
    if n % TILE or n < FET or (t2_padded.is_cuda and t2_padded.data_ptr() % 16):
        raise ValueError("tile_fetch: table must be 16-byte aligned and a "
                         "multiple of 1024 bytes, at least 2048 (pad_table)")

    def fetch(pos: torch.Tensor) -> torch.Tensor:
        if pos.dtype != torch.int32 or pos.shape != (batch,) \
                or not pos.is_contiguous():
            raise ValueError(f"tile_fetch: positions must be a contiguous "
                             f"int32 tensor of shape ({batch},)")
        if pos.device != t2_padded.device:
            raise ValueError("tile_fetch: table and positions on different "
                             "devices")
        if t2_padded.is_cuda:
            return _tile_fetch_cuda(t2_padded, pos)
        return _tile_fetch_torch(t2_padded, pos)

    return fetch
