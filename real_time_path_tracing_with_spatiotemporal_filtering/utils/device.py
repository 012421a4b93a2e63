"""Device/platform introspection and process set-up.

The reference's nvvk::Context prints device capabilities at init
(context.hpp:166-174, context.cpp:1234); this is the JAX-side analogue,
plus the persistent compilation cache the entry points share.
"""

from __future__ import annotations

import os
from typing import Any

import jax

# <checkout>/.jax_cache: a fixed path, because the cache is keyed on it.
_DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed here. Otherwise the cache lives at the fixed
    ``<checkout>/.jax_cache`` (listed in .gitignore), never at a temporary,
    per-process or per-run path, so a later process finds what an earlier
    one compiled. Call before the first compilation.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", _DEFAULT_CACHE_DIR)
    return _DEFAULT_CACHE_DIR


def device_info() -> dict[str, Any]:
    """Capabilities summary of the default backend."""
    devices = jax.devices()
    d = devices[0]
    info: dict[str, Any] = {
        "backend": jax.default_backend(),
        "num_devices": len(devices),
        "platform": d.platform,
        "device_kind": getattr(d, "device_kind", "unknown"),
        "jax_version": jax.__version__,
    }
    stats = d.memory_stats()
    if stats:
        info["bytes_limit"] = stats.get("bytes_limit")
        info["bytes_in_use"] = stats.get("bytes_in_use")
    return info


def log_device_info() -> str:
    info = device_info()
    line = (
        f"[pathtracer] {info['num_devices']}x {info['device_kind']} "
        f"({info['platform']}, jax {info['jax_version']})"
    )
    print(line)
    return line


def enable_validation(enabled: bool = True) -> None:
    """The Vulkan validation-layer analogue (context.cpp:807-808 enables
    VK_LAYER_KHRONOS_validation in debug builds): turn on JAX's NaN/Inf
    checking so any non-finite value raises at the producing op instead of
    propagating into the image. Costs a sync per op -- debug only."""
    jax.config.update("jax_debug_nans", enabled)
    jax.config.update("jax_debug_infs", enabled)
