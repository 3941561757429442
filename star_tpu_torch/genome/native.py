"""ctypes bindings for the native (C++) index-build helpers.

The suffix sorter is the host-side hot spot of genomeGenerate at mammal scale;
native/sa_sort.cpp implements the same total order as the numpy prefix-
doubling sorter (tests enforce equality).  The library is built at first use
into the package's git-ignored _build/ directory.  Falls back to numpy when
the shared library is absent or STAR_TPU_NATIVE=0.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("STAR_TPU_NATIVE", "1") == "0":
        return None
    so, src = _paths()
    if (not os.path.exists(so)
            or (os.path.exists(src)
                and os.path.getmtime(src) > os.path.getmtime(so))):
        # build on first use (fresh checkouts / bench environments)
        if not _try_build(so, src):
            # a silent numpy fallback turns a mammal-scale index build into
            # a multi-hour stall; fail loudly unless explicitly opted out
            # (reference fails hard on misconfiguration too,
            # ErrorWarning.cpp exitWithError)
            raise SystemExit(
                "EXITING because of FATAL ERROR: could not build the native "
                f"suffix sorter ({so}).\n"
                "SOLUTION: ensure g++ is installed, or set STAR_TPU_NATIVE=0 "
                "to accept the (much slower) numpy sorter")
    try:
        _lib = _bind(so)
    except (OSError, AttributeError):
        # corrupt, incompatible or stale object (built before a symbol it
        # must export was added): remove it and rebuild once from the source
        # instead of raising or silently falling back to the Python sorter
        try:
            os.unlink(so)
        except OSError:
            pass
        _lib = None
        if _try_build(so, src):
            try:
                _lib = _bind(so)
            except (OSError, AttributeError):
                _lib = None
    return _lib


def _paths():
    """(the library in the package's _build/, its source native/sa_sort.cpp)"""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return (os.path.join(pkg, "_build", "libsasort.so"),
            os.path.join(os.path.dirname(pkg), "native", "sa_sort.cpp"))


def _bind(so: str):
    """load the library and declare the signatures of its exports; raises
    OSError for an object that does not load and AttributeError for one
    that lacks an export (and unloads it, so that a rebuilt object at the
    same path is loaded anew)"""
    lib = ctypes.CDLL(so)
    try:
        _declare(lib)
    except AttributeError:
        import _ctypes
        _ctypes.dlclose(lib._handle)
        raise
    return lib


def _declare(lib):
    lib.sa_sort_suffixes.restype = ctypes.c_int64
    lib.sa_sort_suffixes.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    lib.sa_sort_chunked.restype = ctypes.c_int64
    lib.sa_sort_chunked.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
    lib.sa_insert_ranks.restype = ctypes.c_int64
    lib.sa_insert_ranks.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    lib.sa_insert_ranks_shift.restype = ctypes.c_int64
    lib.sa_insert_ranks_shift.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int]


def _try_build(so: str, src: str) -> bool:
    if not os.path.exists(src):
        return os.path.exists(so)
    import subprocess
    os.makedirs(os.path.dirname(so), exist_ok=True)
    # compile to a process-unique temp path: concurrent builders racing on a
    # shared ".tmp" could os.replace() a half-written object into place
    tmp = f"{so}.tmp.{os.getpid()}"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-fopenmp",
             src, "-o", tmp],
            check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
        return True
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return os.path.exists(so)


def native_available() -> bool:
    return _load() is not None


def sort_suffixes_native(t2: np.ndarray, n_threads: int = 0):
    """returns SA (int64 positions) or None if unavailable"""
    lib = _load()
    if lib is None:
        return None
    n = len(t2)
    t2p = np.concatenate([t2.astype(np.int8), np.full(16, 5, dtype=np.int8)])
    out = np.empty(n, dtype=np.int64)
    m = lib.sa_sort_suffixes(
        t2p.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ctypes.c_int64(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int(n_threads))
    return out[:m].copy()


def sort_suffixes_chunked(t2: np.ndarray, out_path: str,
                          ram_cap_bytes: int, n_threads: int = 0):
    """RAM-bounded suffix sort with disk spill (mammal-scale builds): the SA
    is written to out_path chunk by chunk in final sorted order and returned
    as a read-only int64 memmap; peak resident SA memory is ~ram_cap_bytes
    (the text itself stays in RAM).  Returns None if the native library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(t2)
    t2p = np.concatenate([t2.astype(np.int8), np.full(16, 5, dtype=np.int8)])
    m = lib.sa_sort_chunked(
        t2p.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ctypes.c_int64(n), out_path.encode(),
        ctypes.c_int64(ram_cap_bytes), ctypes.c_int(n_threads))
    if m < 0:
        raise OSError(f"sa_sort_chunked failed writing {out_path}")
    return np.memmap(out_path, dtype=np.int64, mode="r", shape=(m,))


def sa_insert_positions(t2_new: np.ndarray, old_sa, new_positions: np.ndarray,
                        thresh: int, shift: int, n_threads: int = 0,
                        out=None, chunk: int = 1 << 24):
    """merge new suffix positions into an already-sorted SA: sorts the new
    positions and binary-searches each insertion rank over the old rows
    (reference sjdbBuildIndex.cpp:52-88), then rank-merges in streamed
    chunks.  Old rows >= `thresh` are shifted by `shift` into new-text
    coordinates inside the native comparator and during the merge, so the
    (possibly disk-backed) old SA is never copied whole.  `out` may be a
    preallocated array/memmap of len(old)+len(new).  Returns the merged SA
    or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    t2p = np.concatenate([t2_new.astype(np.int8),
                          np.full(16, 5, dtype=np.int8)])
    if not (isinstance(old_sa, np.memmap)) :
        old_sa = np.ascontiguousarray(old_sa, dtype=np.int64)
    new = np.ascontiguousarray(new_positions, dtype=np.int64).copy()
    ranks = np.empty(len(new), dtype=np.int64)
    lib.sa_insert_ranks_shift(
        t2p.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ctypes.c_int64(len(t2_new)),
        np.asarray(old_sa).ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(old_sa)),
        ctypes.c_int64(thresh), ctypes.c_int64(shift),
        new.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(new)),
        ranks.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int(n_threads))
    n_old = len(old_sa)
    n_new = len(new)
    if out is None:
        out = np.empty(n_old + n_new, dtype=np.int64)
    # streamed rank merge: old rows [i0, i1) land at out positions
    # i + count(ranks <= i); the new rows with ranks in [i0, i1) interleave
    for i0 in range(0, max(n_old, 1), chunk):
        i1 = min(i0 + chunk, n_old)
        r0 = np.searchsorted(ranks, i0, "left")
        r1 = np.searchsorted(ranks, i1, "left")
        oc = np.asarray(old_sa[i0:i1], dtype=np.int64)
        oc = np.where(oc >= thresh, oc + shift, oc)
        # positions of old rows within the out segment [i0+r0, i1+r1)
        cnt = np.searchsorted(ranks[r0:r1], np.arange(i0, i1), "right")
        seg = np.empty((i1 - i0) + (r1 - r0), dtype=np.int64)
        seg[np.arange(i1 - i0) + cnt] = oc
        if r1 > r0:
            # new row j's final position is ranks[j] + j; local to the
            # segment base i0 + r0 that is (ranks[j] - i0) + (j - r0)
            seg[(ranks[r0:r1] - i0) + np.arange(r1 - r0)] = new[r0:r1]
        out[i0 + r0:i1 + r1] = seg
    # new rows ranked past the end of the old SA
    r_end = np.searchsorted(ranks, n_old, "left")
    if r_end < n_new:
        out[n_old + r_end:] = new[r_end:]
    return out
