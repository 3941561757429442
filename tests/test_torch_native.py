"""The port's loader of the native suffix-sorting library: a cached
libsasort.so that predates an export the loader declares (here a stub
without sa_insert_ranks_shift) is unloaded and removed, then rebuilt from
native/sa_sort.cpp where the source is present, or left for the numpy
sorter (the loader returns None) where it is not; it never raises."""
import os
import subprocess

import numpy as np
import pytest

from star_tpu_torch.genome import generate, native
from tests.conftest import ROOT

STUB = """
#include <stdint.h>
int64_t sa_sort_suffixes(const int8_t *t, int64_t n, int64_t *o, int k)
{ return 0; }
int64_t sa_sort_chunked(const int8_t *t, int64_t n, const char *d,
                        int64_t c, int k) { return 0; }
int64_t sa_insert_ranks(const int8_t *t, int64_t n, const int64_t *a,
                        int64_t na, const int64_t *b, int64_t nb, int64_t *o,
                        int k) { return 0; }
"""


@pytest.mark.parametrize("source", ["present", "absent"])
def test_stale_library_is_rebuilt_or_dropped(tmp_path, monkeypatch, source):
    so = str(tmp_path / "_build" / "libsasort.so")
    os.makedirs(os.path.dirname(so))
    (tmp_path / "stub.c").write_text(STUB)
    subprocess.run(["gcc", "-shared", "-fPIC", str(tmp_path / "stub.c"),
                    "-o", so], check=True)
    src = (os.path.join(ROOT, "native", "sa_sort.cpp") if source == "present"
           else str(tmp_path / "missing.cpp"))
    # a cached build: newer than its source, so the loader takes it as is
    t = os.path.getmtime(os.path.join(ROOT, "native", "sa_sort.cpp")) + 3600
    os.utime(so, (t, t))
    monkeypatch.delenv("STAR_TPU_NATIVE", raising=False)
    monkeypatch.setattr(native, "_paths", lambda: (so, src))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    lib = native._load()
    if source == "absent":
        assert lib is None and not os.path.exists(so)
        return
    assert lib is not None and os.path.exists(so)
    assert hasattr(lib, "sa_insert_ranks_shift")
    # the rebuilt library sorts as the numpy sorter does
    rng = np.random.default_rng(3)
    t2 = rng.integers(0, 4, size=3000).astype(np.int8)
    t2[[700, 1900]] = 5
    got = native.sort_suffixes_native(t2)
    monkeypatch.setattr(native, "_lib", None)       # the numpy sorter now
    want = generate.sort_suffixes(t2)
    assert len(got) == len(want) > 0 and np.array_equal(got, want)
