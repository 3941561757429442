"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port: the top-level name of every import
(the part before the first dot) is compared whole, since the port's name
begins with the JAX package's."""
from __future__ import annotations

import ast
import os

import pytest

import portbench_tiny  # noqa: F401  (puts the benchmark on sys.path)

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NAMES = {"jax", "jaxlib", "flax", "star_tpu"}


def _sources(sub=""):
    base = os.path.join(PB, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, PB))
def test_no_jax_import(path):
    assert not set(_top_names(path)) & JAX_NAMES


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, PB))
def test_reference_imports_nothing_of_the_port(path):
    assert not set(_top_names(path)) & (JAX_NAMES | {"star_tpu_torch"})


def test_top_name_comparison_is_whole():
    # the port's own name must not count as the JAX package's
    assert "star_tpu_torch".split(".")[0] not in JAX_NAMES


def test_run_names_what_the_process_loaded():
    """the run's check of sys.modules after the window"""
    import run
    assert run.forbidden_loaded(["star_tpu_torch", "star_tpu_torch.run",
                                 "numpy"]) == []
    assert run.forbidden_loaded(["jax.numpy", "star_tpu.ops", "flax",
                                 "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                "star_tpu"]
