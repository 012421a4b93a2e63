"""Test harness configuration.

Tests run on CPU with 8 virtual devices (testing multi-device code without
a cluster, SURVEY.md section 4): the Pallas kernel is validated in the
Pallas interpreter and shardings on a virtual mesh. Tests marked ``gpu``
need the card; they skip here and run on a GPU machine with
``python -m pytest tests -m gpu``, which leaves the platform to JAX.
"""

import os

import jax
import numpy as np
import pytest


def pytest_configure(config):
    """Pin the CPU backend with 8 virtual devices before any backend starts,
    unless the run selects the ``gpu`` tests (``-m gpu``)."""
    if (config.getoption("markexpr") or "").strip() == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _skip_gpu_tests_without_gpu(request):
    if (
        request.node.get_closest_marker("gpu") is not None
        and jax.default_backend() != "gpu"
    ):
        pytest.skip("needs a GPU: the Pallas kernel compiles through Triton "
                    "only there")


@pytest.fixture(autouse=True, scope="module")
def _bound_jit_footprint():
    """Free compiled executables at module boundaries.

    A single pytest process accumulates hundreds of XLA:CPU executables;
    after ~140 compile-heavy tests the next big compile has been seen to
    segfault inside XLA's compiler (every test passes in isolation).
    Dropping the jit caches per module keeps the resident footprint bounded
    at the cost of a few cross-module recompiles.
    """
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def cornell_scene():
    from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
        Scene,
    )

    return Scene.cornell_box()


@pytest.fixture(scope="session")
def cornell_tri_data(cornell_scene):
    from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
        precompute_triangle_data,
    )

    return precompute_triangle_data(cornell_scene)


@pytest.fixture(scope="session")
def small_cfg():
    from real_time_path_tracing_with_spatiotemporal_filtering.config import (
        RenderConfig,
    )

    # Small-but-not-tiny so every pass has interesting content; 8 bounces
    # keeps the CPU path-trace loop fast while exercising multi-bounce code.
    return RenderConfig(width=64, height=48, max_bounces=8)


@pytest.fixture(scope="session")
def rng_np():
    return np.random.default_rng(1234)
