"""Aligned-row table fetch — the random-access primitive of the device path.

Semantics: ``fetch_rows(table, byte_off) -> [B, FET] int8`` where row i holds
table bytes ``[align1024(off_i), align1024(off_i) + FET)``.  A negative
offset skips the row (its contents are unspecified; callers mask those
lanes).  Values at byte offset ``off_i`` therefore live at row position
``off_i % TILE`` and, with FET = 2*TILE, at least TILE further bytes are
present — enough for a 1-KB window at any alignment.

On a CUDA tensor ``fetch_rows`` launches the hand-written Hopper kernel
``csrc/fetch_rows.cu``; on a CPU tensor it takes the plain PyTorch version
``_fetch_rows_torch``.  There is no fallback between the two: a CUDA build or
launch failure raises.

``extract_i32`` and ``realign`` cut values out of the fetched rows with plain
tensor indexing (the one-hot sums and barrel shifters of the JAX package
worked around slow XLA gathers on the TPU and are not needed here).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

TILE = 1024      # row alignment quantum
FET = 2048       # bytes fetched per row (2 tiles)

LAUNCHES = 0     # kernel launches of fetch_rows (CUDA tensors only)


def resolve_device(device=None) -> torch.device:
    """the torch device an entry point runs on: ``cuda`` unless the caller
    names another; raises when CUDA is wanted but absent"""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: star_tpu_torch runs on the GPU "
                "unless device='cpu' is passed")
        return torch.device("cuda")
    return torch.device(device)


def pad_table(raw: np.ndarray) -> np.ndarray:
    """pad an int8 byte table so any in-range fetch stays in bounds.
    Padding byte is 5 (the genome spacer char: compares greater than any
    nucleotide, the same convention the host comparator uses past the end)."""
    b = np.ascontiguousarray(raw).view(np.int8).ravel()
    n = ((len(b) + FET + TILE - 1) // TILE) * TILE
    out = np.full(n, 5, dtype=np.int8)
    out[:len(b)] = b
    return out


def _fetch_rows_torch(table: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """plain version: one view-index of the table's overlapping FET-byte
    windows at TILE stride.  Negative offsets read row 0; starts clamp to the
    last full window, as the kernel does."""
    win = table.unfold(0, FET, TILE)
    base = torch.where(off >= 0, off // TILE, 0).clamp_(max=win.shape[0] - 1)
    return win[base]


def _fetch_rows_cuda(table: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if table.dtype != torch.int8 or table.dim() != 1 \
            or not table.is_contiguous():
        raise ValueError("fetch_rows: table must be a contiguous 1-D int8 tensor")
    if off.dtype != torch.int64 or off.dim() != 1 or not off.is_contiguous():
        raise ValueError("fetch_rows: offsets must be a contiguous 1-D int64 tensor")
    if off.device != table.device:
        raise ValueError("fetch_rows: table and offsets on different devices")
    n = table.numel()
    if n % TILE or n < FET or table.data_ptr() % 16:
        raise ValueError("fetch_rows: table must be 16-byte aligned and a "
                         "multiple of 1024 bytes, at least 2048 (pad_table)")
    lib = _lib()
    out = torch.empty((off.numel(), FET), dtype=torch.int8, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    rc = lib.fetch_rows_launch(table.data_ptr(), n, off.data_ptr(),
                               off.numel(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("fetch_rows kernel launch failed: "
                           + lib.fetch_rows_error_string(rc).decode())
    LAUNCHES += 1
    return out


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from . import _build
        lib = _build.load("fetch_rows")
        lib.fetch_rows_launch.restype = ctypes.c_int
        lib.fetch_rows_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.fetch_rows_error_string.restype = ctypes.c_char_p
        lib.fetch_rows_error_string.argtypes = [ctypes.c_int]
        _LIB = lib
    return _LIB


def fetch_rows(table: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """[B] int64 byte offsets -> [B, FET] int8 aligned rows (see module doc)"""
    if table.is_cuda:
        return _fetch_rows_cuda(table, off)
    return _fetch_rows_torch(table, off)


# ----------------------------------------------------------------- extraction
def extract_i32(rows: torch.Tensor, rbyte: torch.Tensor) -> torch.Tensor:
    """the little-endian int32 at row byte offset rbyte[i] (< TILE+4) of
    rows[i].  The four bytes are reinterpreted, not summed, so a top byte
    >= 0x80 gives a negative value: the packed SAi keeps "prefix absent" in
    the sign bit."""
    idx = rbyte[:, None] + torch.arange(4, device=rows.device)
    return torch.gather(rows, 1, idx).view(torch.int32)[:, 0]


def realign(rows: torch.Tensor, r: torch.Tensor, width: int) -> torch.Tensor:
    """rows[i, r_i : r_i + width] for per-row r_i in [0, TILE)"""
    idx = r[:, None] + torch.arange(width, device=rows.device)
    return torch.gather(rows, 1, idx)
