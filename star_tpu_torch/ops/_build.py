"""Builds and loads the hand-written CUDA kernels of ops/csrc/.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (sm_90a) into a
shared library with a plain C interface, loaded with ctypes.  The build goes
into the package's git-ignored ``_build/`` directory at first use and is
keyed by the source's content hash, so an edited source rebuilds and an
unchanged one is loaded as is.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

BUILD_LOG: dict = {}     # name -> nvcc/ptxas output of the last build


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of star_tpu_torch "
                       "are built with the CUDA toolkit's nvcc (set NVCC)")


def _so_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}.{digest}.so")


def _start(name: str):
    """start nvcc for csrc/<name>.cu unless its library is built already;
    returns (so path, Popen or None, temp path)"""
    so = _so_path(name)
    if os.path.exists(so):
        return so, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, proc, tmp


def _finish(name: str, so: str, proc, tmp) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    BUILD_LOG[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, so)


def build_all(names) -> None:
    """compile the given kernels in parallel, one nvcc per source"""
    started = [(n, *_start(n)) for n in names]
    for n, so, proc, tmp in started:
        _finish(n, so, proc, tmp)


def load(name: str) -> ctypes.CDLL:
    """the library of csrc/<name>.cu, built first if it is not yet"""
    so, proc, tmp = _start(name)
    _finish(name, so, proc, tmp)
    return ctypes.CDLL(so)
