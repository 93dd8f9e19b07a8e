"""3D solver vs the independent NumPy oracle at the 64-grid gate.

BASELINE.json: "density fields matching the reference solver at 64^3 to
float32 tolerance".  The reference is 2D-only, so the 3D contract is the
documented generalization (oracle3d.py docstring); every op and the full
step are validated here at 64³ against a from-scratch NumPy
transliteration — catching consistent-but-wrong bugs that comparing two
JAX formulations with each other cannot.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import oracle3d
from fluidsim_tpu.config import ObstacleShape, SimConfig
from fluidsim_tpu.models.stable3d import make_step_3d
from fluidsim_tpu.ops.advect import advect_3d, advect_multi_3d
from fluidsim_tpu.ops.boundary import set_bnd_3d
from fluidsim_tpu.ops.linsolve import diffuse_3d, jacobi_3d
from fluidsim_tpu.ops.project import project_3d
from fluidsim_tpu.scene.sources import apply_custom_source
from fluidsim_tpu.state import zeros_state

pytestmark = pytest.mark.slow  # 3D oracle rollouts

N = 64


def rand(key, scale=1.0, shape=(N, N, N)):
    return np.asarray(
        jax.random.normal(jax.random.PRNGKey(key), shape, jnp.float32) * scale
    )


def sphere_obst(r=6.0, center=(32, 32, 32)):
    g = np.mgrid[0:N, 0:N, 0:N]
    d2 = sum((g[i] - center[i]) ** 2 for i in range(3))
    return d2 <= r * r


@pytest.mark.parametrize("b", [0, 1, 2, 3])
@pytest.mark.parametrize("with_obst", [False, True])
def test_set_bnd_3d_matches_oracle(b, with_obst):
    x = rand(b)
    obst = sphere_obst() if with_obst else None
    got = set_bnd_3d(b, jnp.asarray(x), jnp.asarray(obst) if with_obst else None)
    exp = oracle3d.set_bnd_3d(b, x, obst)
    np.testing.assert_allclose(np.asarray(got), exp, rtol=0, atol=1e-7)


@pytest.mark.parametrize("b,with_obst", [(0, False), (1, False), (0, True),
                                         (2, True)])
def test_jacobi_3d_matches_oracle_64(b, with_obst):
    x = np.asarray(oracle3d.set_bnd_3d(b, rand(10 + b), None))
    x0 = np.asarray(oracle3d.set_bnd_3d(b, rand(20 + b), None))
    obst = sphere_obst() if with_obst else None
    got = jacobi_3d(b, jnp.asarray(x), jnp.asarray(x0), 1.0, 6.0,
                    jnp.asarray(obst) if with_obst else None, 20)
    exp = oracle3d.lin_solve_3d(b, x, x0, 1.0, 6.0, obst, 20)
    np.testing.assert_allclose(np.asarray(got), exp, rtol=1e-6, atol=1e-6)


def test_diffuse_3d_matches_oracle_64():
    x0 = np.abs(rand(3, scale=2.0))
    cfg = SimConfig(size=N, ndim=3, jacobi_iters=20,
                    source_position=(0.5, 0.5, 0.5),
                    obstacle_position=(0.5, 0.5, 0.5)).validate()
    got = diffuse_3d(0, jnp.asarray(x0), 1e-4, 0.05, None, cfg)
    exp = oracle3d.diffuse_3d(0, x0, 1e-4, 0.05, None, 20)
    np.testing.assert_allclose(np.asarray(got), exp, rtol=1e-6,
                               atol=1e-6 * float(np.abs(exp).max()))


@pytest.mark.parametrize("with_obst", [False, True])
def test_advect_3d_gather_matches_oracle_64(with_obst):
    d0 = np.abs(rand(30, scale=3.0))
    vel = np.stack([
        np.asarray(oracle3d.set_bnd_3d(b, rand(40 + b, scale=0.3), None))
        for b in (1, 2, 3)
    ])
    obst = sphere_obst() if with_obst else None
    got = advect_3d(0, jnp.asarray(d0), jnp.asarray(vel), 0.05,
                    jnp.asarray(obst) if with_obst else None, window=0)
    exp = oracle3d.advect_3d(0, d0, vel, 0.05, obst, window=0)
    np.testing.assert_allclose(np.asarray(got), exp, rtol=1e-6, atol=1e-6)


def test_advect_3d_windowed_matches_oracle_64():
    """The gather-free windowed formulation vs the oracle's gather with the
    same CFL clamp — mathematically identical, different op order."""
    fields = jnp.stack([
        jnp.asarray(oracle3d.set_bnd_3d(b, rand(50 + b, scale=1.5), None))
        for b in (1, 2, 3)
    ])
    vel = fields * 0.2
    got = advect_multi_3d((1, 2, 3), fields, vel, 0.05, None, window=2)
    exp = np.stack([
        oracle3d.advect_3d(c + 1, np.asarray(fields[c]), np.asarray(vel),
                           0.05, None, window=2)
        for c in range(3)
    ])
    np.testing.assert_allclose(np.asarray(got), exp, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("with_obst", [False, True])
def test_project_3d_matches_oracle_64(with_obst):
    vel = np.stack([
        np.asarray(oracle3d.set_bnd_3d(b, rand(60 + b, scale=0.5), None))
        for b in (1, 2, 3)
    ])
    obst = sphere_obst() if with_obst else None
    got_v, got_p = project_3d(
        jnp.asarray(vel), jnp.asarray(obst) if with_obst else None, iters=20
    )
    exp_v, exp_p = oracle3d.project_3d(vel, obst, iters=20)
    scale = float(np.abs(exp_v).max())
    np.testing.assert_allclose(np.asarray(got_v), exp_v, rtol=1e-5,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(np.asarray(got_p), exp_p, rtol=1e-5,
                               atol=1e-6 * max(1.0, float(np.abs(exp_p).max())))


def plume_cfg():
    return SimConfig(
        size=N,
        ndim=3,
        time_step=0.02,
        diffusion=1e-4,
        viscosity=1e-4,
        jacobi_iters=20,
        buoyancy=1.0,
        ambient_density=0.0,
        vorticity_confinement=0.0,
        advect_window=2,
        enable_custom_source=True,
        source_strength=60.0,
        source_radius=3.0,
        source_position=(0.5, 0.15, 0.5),
        obstacle_position=(0.5, 0.5, 0.5),
        enable_obstacle=False,
        double_project=False,
    ).validate()


def test_step_parity_resync_64():
    """Per-step re-sync gate: every step starts both
    implementations from the SAME state, so agreement must be at float32
    op-reordering level (~1e-5 of scale), with no chaotic accumulation."""
    cfg = plume_cfg()
    step = make_step_3d(cfg)
    dt, diff, visc = cfg.effective_params()

    d = np.abs(rand(70, scale=1.0))
    v = np.stack([
        np.asarray(oracle3d.set_bnd_3d(b, rand(80 + b, scale=0.2), None))
        for b in (1, 2, 3)
    ])

    t = np.float32(0.0)
    for k in range(3):
        t = t + np.float32(dt)
        state = zeros_state(cfg).replace(
            density=jnp.asarray(d), velocity=jnp.asarray(v),
            time=jnp.float32(t - np.float32(dt)),
        )
        sd, sv = apply_custom_source(state.density, state.velocity, cfg,
                                     jnp.float32(t))
        state = step(state.replace(density=sd, velocity=sv))

        od, ov = np.asarray(sd), np.asarray(sv)
        od, ov, op = oracle3d.simulate_step_3d(
            od, ov, dt, diff, visc, cfg.jacobi_iters,
            buoy=cfg.buoyancy, ambient=cfg.ambient_density,
            advect_window=cfg.advect_window,
        )

        for name, got, exp in (
            ("density", state.density, od),
            ("velocity", state.velocity, ov),
            ("pressure", state.pressure, op),
        ):
            scale = max(1.0, float(np.abs(exp).max()))
            np.testing.assert_allclose(
                np.asarray(got), exp, rtol=1e-4, atol=2e-5 * scale,
                err_msg=f"step {k}: {name} diverged from 3D oracle",
            )

        # re-sync: next step starts from the oracle's state
        d, v = od, ov
