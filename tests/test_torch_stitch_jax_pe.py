"""The port's device grow against star_tpu's on the pe golden (see
test_torch_stitch_jax.py; a file of its own so that the two JAX engine
compiles of each case run on different test workers)."""
from tests.test_torch_stitch import (  # noqa: F401  (fixtures)
    force_device_grow, one_torch_thread)
from tests.test_torch_stitch_jax import check_against_jax


def test_device_grow_matches_jax_engine_pe(tmp_path, monkeypatch,
                                           force_device_grow):
    check_against_jax(tmp_path, monkeypatch, "pe")
