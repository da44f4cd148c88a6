"""Test-session device setup.

tests/test_pipeline_parallel.py needs an 8-device (2x4) mesh; jax locks the
host device count at first init, so it must be set before ANY test imports
jax.  8 devices (not the dry-run's 512 — that flag stays inside
launch/dryrun.py) keeps smoke tests fast while letting the pipeline
equivalence tests build their mesh.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without one")
