"""Byte-window table fetch — the random-access primitive of the device path.

``fetch_window(table, start, width) -> [B, width] int8``: row i holds table
bytes ``[s_i, s_i + width)``, where ``s_i`` is ``start_i`` clamped into
``[0, len(table) - width]``.  A negative start skips the row (its contents
are unspecified; callers mask those lanes).  Every read of the port's main
path is one such window: the MMP's SA entry (4 bytes), SAi pair (8 bytes) and
suffix text (QL bytes), and the stitch engine's per-lane regions and
lane-row moves.

``fetch_rows(table, off) -> [B, FET] int8`` keeps the TPU kernel's contract:
row i holds table bytes ``[align1024(off_i), align1024(off_i) + FET)``, and a
negative offset skips the row.  Values at byte offset ``off_i`` therefore
live at row position ``off_i % TILE`` and, with FET = 2*TILE, at least TILE
further bytes are present.  ``realign`` cuts a window out of such rows with
one gather (the plain version's cut; the one-hot sums and barrel shifters of
the JAX package worked around slow XLA gathers on the TPU).

On a CUDA tensor both launch the hand-written Hopper kernel
``csrc/fetch_rows.cu`` (one window copy; ``fetch_rows`` is its width-2048
call from the aligned start); on a CPU tensor they take the plain PyTorch
versions ``_fetch_window_torch`` and ``_fetch_rows_torch``.  There is no
fallback between the two: a CUDA build or launch failure raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

TILE = 1024      # row alignment quantum of fetch_rows
FET = 2048       # bytes fetched per fetch_rows row (2 tiles)
WINDOW_MAX = 3 * FET   # widest fetch_window (the plain version's three rows)

LAUNCHES = 0       # kernel launches of fetch_window (CUDA tensors only)
ROWS_LAUNCHES = 0  # kernel launches of fetch_rows (CUDA tensors only)


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


def _rows_for(width: int) -> int:
    """FET-byte rows that hold a window of `width` bytes from any TILE
    alignment"""
    return (TILE - 1 + width + FET - 1) // FET


def _check(name, table, idx, idx_dtype, width=FET):
    if table.dtype != torch.int8 or table.dim() != 1 \
            or not table.is_contiguous():
        raise ValueError(f"{name}: table must be a contiguous 1-D int8 tensor")
    if idx.dtype != idx_dtype or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"{name}: starts must be a contiguous 1-D "
                         f"{idx_dtype} tensor")
    if idx.device != table.device:
        raise ValueError(f"{name}: table and starts on different devices")
    n = table.numel()
    if n % TILE or n < FET or (table.is_cuda and table.data_ptr() % 16):
        raise ValueError(f"{name}: table must be 16-byte aligned and a "
                         "multiple of 1024 bytes, at least 2048 (pad_table)")
    if not 1 <= width <= WINDOW_MAX or n < _rows_for(width) * FET:
        raise ValueError(f"{name}: a window of {width} bytes does not fit "
                         f"the table's padding ({n} bytes, at most "
                         f"{WINDOW_MAX} per window)")


def _stream(table):
    return torch.cuda.current_stream(table.device).cuda_stream


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + _lib().fetch_rows_error_string(rc).decode())


# --------------------------------------------------------------- fetch_rows
def _fetch_rows_torch(table: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """plain version: one view-index of the table's overlapping FET-byte
    windows at TILE stride.  Negative offsets read row 0; starts clamp to the
    last full window, as the kernel does."""
    win = table.unfold(0, FET, TILE)
    base = torch.where(off >= 0, off // TILE, 0).clamp_(max=win.shape[0] - 1)
    return win[base]


def _fetch_rows_cuda(table: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    global ROWS_LAUNCHES
    out = torch.empty((off.numel(), FET), dtype=torch.int8, device=table.device)
    if off.numel():
        _raise_on(_lib().fetch_rows_launch(
            table.data_ptr(), table.numel(), off.data_ptr(), off.numel(),
            out.data_ptr(), _stream(table)), "fetch_rows")
        ROWS_LAUNCHES += 1
    return out


def fetch_rows(table: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """[B] int64 byte offsets -> [B, FET] int8 aligned rows (see module doc)"""
    _check("fetch_rows", table, off, torch.int64)
    if table.is_cuda:
        return _fetch_rows_cuda(table, off)
    return _fetch_rows_torch(table, off)


# ------------------------------------------------------------- fetch_window
def _fetch_window_torch(table: torch.Tensor, start: torch.Tensor,
                        width: int) -> torch.Tensor:
    """plain version: the FET-byte rows of ``_fetch_rows_torch`` that hold
    the window (as many as ``width`` needs, FET apart), then one gather at
    the start's column.  The first row begins at align1024(s), or lower where
    that would run past the table, so the clamped start of the kernel is
    reproduced exactly at both table edges."""
    n = table.numel()
    m = _rows_for(width)
    s = start.clamp(0, n - width)
    base = (s // TILE * TILE).clamp_(max=n - m * FET)
    offs = base[:, None] + FET * torch.arange(m, device=start.device)
    rows = _fetch_rows_torch(table, offs.reshape(-1)).reshape(-1, m * FET)
    return realign(rows, s - base, width)


def _fetch_window_cuda(table: torch.Tensor, start: torch.Tensor,
                       width: int) -> torch.Tensor:
    global LAUNCHES
    stride = (width + 15) // 16 * 16
    out = torch.empty((start.numel(), stride), dtype=torch.int8,
                      device=table.device)
    if start.numel():
        _raise_on(_lib().window_launch(
            table.data_ptr(), table.numel(), start.data_ptr(), start.numel(),
            width, out.data_ptr(), _stream(table)), "fetch_window")
        LAUNCHES += 1
    return out[:, :width]


def fetch_window(table: torch.Tensor, start: torch.Tensor,
                 width: int) -> torch.Tensor:
    """[B] int64 byte starts -> [B, width] int8 windows (see module doc).
    On a CUDA tensor the rows of the result are round_up(width, 16) bytes
    apart."""
    width = int(width)
    _check("fetch_window", table, start, torch.int64, width)
    if table.is_cuda:
        return _fetch_window_cuda(table, start, width)
    return _fetch_window_torch(table, start, width)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from . import _build
        lib = _build.load("fetch_rows")
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        for fn, args in (("window_launch", [p, i64, p, i64, i64, p, p]),
                         ("fetch_rows_launch", [p, i64, p, i64, p, p]),
                         ("tile_fetch_launch", [p, i64, p, i64, p, p])):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = args
        lib.fetch_rows_error_string.restype = ctypes.c_char_p
        lib.fetch_rows_error_string.argtypes = [ctypes.c_int]
        _LIB = lib
    return _LIB


# ----------------------------------------------------------------- extraction
def realign(rows: torch.Tensor, r: torch.Tensor, width: int) -> torch.Tensor:
    """rows[i, r_i : r_i + width] for per-row r_i (the columns must lie in
    the rows)"""
    idx = r[:, None] + torch.arange(width, device=rows.device)
    return torch.gather(rows, 1, idx)
