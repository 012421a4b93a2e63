"""CI coverage for the driver entry points in ``__graft_entry__.py``.

A config added to ``dryrun_multichip`` once failed
``RenderConfig.__post_init__`` validation and no test imported the file, so
the regression stayed invisible until the entry point ran. These tests make
the entry points part of the hermetic suite:

- every ``RenderConfig`` the file constructs must validate,
- ``entry()`` must return a jittable fn and trace it,
- ``dryrun_multichip(2)`` must execute end-to-end on a small virtual mesh
  (the driver runs the same function with 8 devices).
"""

from __future__ import annotations

import ast
import importlib
import pathlib
import sys

import jax
import pytest

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


def _import_graft_entry():
    sys.path.insert(0, str(REPO_ROOT))
    try:
        return importlib.import_module("__graft_entry__")
    finally:
        sys.path.pop(0)


def _config_call_kwargs():
    """Extract the kwargs of every RenderConfig(...) / dataclasses.replace(...)
    literal in __graft_entry__.py, so new configs are covered automatically."""
    src = (REPO_ROOT / "__graft_entry__.py").read_text()
    tree = ast.parse(src)
    calls = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = getattr(fn, "attr", getattr(fn, "id", ""))
        if name not in ("RenderConfig", "replace"):
            continue
        if name == "replace":
            # only config replaces (dataclasses.replace is also used on
            # Camera in the dryrun); configs are named cfg / cfg_x
            if not (
                node.args
                and isinstance(node.args[0], ast.Name)
                and node.args[0].id.startswith("cfg")
            ):
                continue
        kwargs = {}
        ok = True
        for kw in node.keywords:
            try:
                kwargs[kw.arg] = ast.literal_eval(kw.value)
            except ValueError:
                ok = False  # computed value (e.g. 16 * n_devices): sub below
                kwargs[kw.arg] = 32
        calls.append((name, kwargs, ok))
    return calls


def test_every_entry_config_validates():
    """Every config literal in __graft_entry__.py must pass RenderConfig
    validation when layered on the base config, exactly as the file layers
    them (replace() calls apply on top of the base RenderConfig kwargs)."""
    from real_time_path_tracing_with_spatiotemporal_filtering import (
        RenderConfig,
    )

    calls = _config_call_kwargs()
    assert calls, "no RenderConfig construction found in __graft_entry__.py"
    base_kwargs = {}
    for name, kwargs, _ in calls:
        if name == "RenderConfig":
            # base configs must validate on their own
            RenderConfig(**kwargs)
            base_kwargs = kwargs
        else:  # dataclasses.replace(cfg, ...) layered on the last base
            RenderConfig(**{**base_kwargs, **kwargs})


def test_entry_traces():
    graft = _import_graft_entry()
    fn, example_args = graft.entry()
    jax.make_jaxpr(fn)(*example_args)  # full trace, no execution


def test_dryrun_multichip_executes():
    """The actual driver path, on a 2-device virtual mesh (cheap twin of the
    driver's 8-device run; every config branch in the function executes)."""
    graft = _import_graft_entry()
    graft.dryrun_multichip(2)


def test_cli_rejects_path_gradient_alone():
    """cli.py must fail at argparse (pre-JAX, rc=2) with the config's own
    message instead of crashing in RenderConfig mid-startup."""
    import subprocess

    proc = subprocess.run(
        [sys.executable, str(REPO_ROOT / "cli.py"), "--path-gradient",
         "--frames", "1"],
        capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode == 2
    assert "adaptive-alpha" in proc.stderr or "accumulation-ramp" in proc.stderr


def test_viewer_path_gradient_implies_ramp():
    """viewer --path-gradient alone must build a VALID config (the implied
    ramp supplies the gradient consumer)."""
    import argparse

    from real_time_path_tracing_with_spatiotemporal_filtering.viewer import (
        build_config,
    )

    args = argparse.Namespace(
        width=32, height=24, nee=False, rr_start_bounce=0,
        ramp=False, path_gradient=True,
    )
    cfg = build_config(args)  # round 3: raised ValueError here
    assert cfg.path_gradient and cfg.accumulation_ramp and cfg.adaptive_alpha
