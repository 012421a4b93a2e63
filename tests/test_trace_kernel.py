"""The per-pixel trace kernel (ops/pallas/pathtrace.py) against the XLA trace.

On the CPU the kernel runs in the Pallas interpreter; its Triton lowering is
checked by lowering it for CUDA without compiling. The ``gpu`` test compiles
it for the card and runs only there.

The kernel evaluates the XLA reference's arithmetic per lane, but products
are contracted differently (elementwise FMAs against matmuls), so a ray that
grazes a triangle edge may hit in one and miss in the other and that one path
diverges. Parity is therefore stated as: at most 1% of the pixels of a tiny
frame differ by more than 1e-4, and the rest agree to float rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from real_time_path_tracing_with_spatiotemporal_filtering.config import (
    RenderConfig,
)
from real_time_path_tracing_with_spatiotemporal_filtering.ops import pathtrace
from real_time_path_tracing_with_spatiotemporal_filtering.ops.pallas import (
    pathtrace as kernel,
)
from real_time_path_tracing_with_spatiotemporal_filtering.scene.scene import (
    Camera,
    Light,
    Scene,
    precompute_triangle_data,
)

CFG = RenderConfig(width=64, height=48, max_bounces=4)
FLIP_TOL = 1e-4
FLIP_SHARE = 0.01


def _scene(name):
    if name == "empty_scene":
        return Scene.from_arrays(
            np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
        )
    if name == "one_triangle":
        verts = np.array(
            [[-1.0, 0.0, -1.0], [1.0, 0.0, -1.0], [0.0, 2.0, -1.0]],
            np.float32,
        )
        return Scene.from_arrays(verts, np.array([[0, 1, 2]], np.int32))
    return Scene.cornell_box()


CASES = {
    "default": {},
    "nee": {"nee": True},
    "rr": {"rr_start_bounce": 2},
    "nee_rr": {"nee": True, "rr_start_bounce": 1},
    "spp": {"spp": 3},
    "batches": {"spp": 2, "sample_batches": 2},
    "aa_sigma0": {"aa_sigma": 0.0},
    "light_occluded": {"light_through_walls": False},
    "truncate": {"truncate_radiance": True},
    "one_bounce": {"max_bounces": 1},
    "light_dim": {"first_hit_light_dim": 2.0, "light_intensity": 10.0},
    "odd_size": {"width": 37, "height": 23},
    "rotation": {},
    "albedo": {},
    "empty_scene": {},
    "one_triangle": {},
    "late_frame": {},
    "light_moved": {},
}


def _case_inputs(case):
    cfg = dataclasses.replace(CFG, **CASES[case])
    scene = _scene(case)
    albedo = None
    if case == "albedo":
        rng = np.random.default_rng(0)
        albedo = rng.uniform(0.1, 0.9, (scene.num_triangles, 3))
    td = precompute_triangle_data(scene, albedo=albedo)
    cam = Camera.default()
    if case == "rotation":
        cam = Camera.orbit([0.0, 1.0, 0.0], 6.0, 0.4, 1.3)
    light = Light.default()
    if case == "light_moved":
        light = dataclasses.replace(
            light, position=jnp.array([0.2, 1.5, -0.6], jnp.float32)
        )
    frame = 12345 if case == "late_frame" else 3
    return td, cam, light, jnp.int32(frame), cfg


def _routes(td, cam, light, frame, cfg, **kw):
    ref = jax.jit(
        lambda td, p, r, l, f: pathtrace.path_trace_pass(
            td, p, l, f, cfg, rotation=r, **kw
        )
    )(td, cam.position, cam.rotation, light, frame)
    got = jax.jit(
        lambda td, p, r, l, f: kernel.path_trace_pass_pallas(
            td, p, l, f, cfg, rotation=r, interpret=True, **kw
        )
    )(td, cam.position, cam.rotation, light, frame)
    return np.asarray(ref), np.asarray(got)


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_xla_trace(case):
    td, cam, light, frame, cfg = _case_inputs(case)
    ref, got = _routes(td, cam, light, frame, cfg)
    assert got.shape == (cfg.height, cfg.width, 3)
    assert np.isfinite(got).all()
    flips = (np.abs(got - ref).max(-1) > FLIP_TOL).mean()
    assert flips <= FLIP_SHARE, flips
    agree = np.abs(got - ref).max(-1) <= FLIP_TOL
    np.testing.assert_allclose(got[agree], ref[agree], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("row_offset", [0, 16, 32])
def test_kernel_row_slab_equals_full_frame_rows(row_offset):
    """Seeds and rays are functions of global pixel coordinates, so a slab
    of rows (the sharded frame's unit) equals the same rows of the frame."""
    td, cam, light, frame, cfg = _case_inputs("default")
    full = kernel.path_trace_pass_pallas(
        td, cam.position, light, frame, cfg, interpret=True
    )
    slab = kernel.path_trace_pass_pallas(
        td, cam.position, light, frame, cfg, row_offset=row_offset,
        rows=16, interpret=True,
    )
    np.testing.assert_array_equal(
        np.asarray(slab), np.asarray(full)[row_offset:row_offset + 16]
    )


def test_pack_triangle_table_layout(cornell_tri_data):
    td = cornell_tri_data
    table = np.asarray(kernel.pack_triangle_table(td))
    t = td.planes.n.shape[0]
    rows = table.reshape(t, kernel.TRI_STRIDE)
    p = td.planes
    np.testing.assert_array_equal(rows[:, kernel._N:kernel._N + 3], p.n)
    np.testing.assert_array_equal(rows[:, kernel._D0], p.d0)
    np.testing.assert_array_equal(rows[:, kernel._N1:kernel._N1 + 3], p.n1)
    np.testing.assert_array_equal(rows[:, kernel._D2], p.d2)
    np.testing.assert_array_equal(rows[:, kernel._E2:kernel._E2 + 3], p.e2)
    np.testing.assert_array_equal(
        rows[:, kernel._NORMAL:kernel._NORMAL + 3], td.normals
    )
    np.testing.assert_array_equal(
        rows[:, kernel._ALBEDO:kernel._ALBEDO + 3], td.albedo
    )
    assert not rows[:, kernel._ALBEDO + 3:].any()


@pytest.mark.parametrize(
    "flag", [{"gbuffer_primary": True}, {"indirect_split": 1}]
)
def test_kernel_rejects_untraced_modes(flag, cornell_tri_data):
    cfg = dataclasses.replace(CFG, **flag)
    with pytest.raises(ValueError, match="XLA trace"):
        kernel.path_trace_pass_pallas(
            cornell_tri_data, Camera.default().position, Light.default(),
            jnp.int32(0), cfg, interpret=True,
        )


@pytest.mark.parametrize("case", ["default", "nee", "nee_rr"])
def test_kernel_lowers_for_cuda(case, cornell_tri_data):
    """The kernel's Triton lowering (what the GPU compiles) accepts every
    primitive it uses, at the headline width."""
    cfg = dataclasses.replace(
        RenderConfig(width=1920, height=1080), **CASES[case]
    )
    cam, light = Camera.default(), Light.default()
    fn = jax.jit(
        lambda td, f: kernel.path_trace_pass_pallas(
            td, cam.position, light, f, cfg, rotation=cam.rotation
        )
    )
    lowered = fn.trace(cornell_tri_data, jnp.int32(0)).lower(
        lowering_platforms=("cuda",)
    )
    assert "triton" in lowered.as_text()


@pytest.mark.gpu
def test_kernel_compiled_matches_xla_trace():
    """The compiled kernel on the card against the XLA trace on the card."""
    td, cam, light, frame, cfg = _case_inputs("nee_rr")
    ref = pathtrace.path_trace_pass(
        td, cam.position, light, frame, cfg, rotation=cam.rotation
    )
    got = kernel.path_trace_pass_pallas(
        td, cam.position, light, frame, cfg, rotation=cam.rotation
    )
    flips = (np.abs(np.asarray(got) - np.asarray(ref)).max(-1) > FLIP_TOL)
    assert flips.mean() <= FLIP_SHARE
