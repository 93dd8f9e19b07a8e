"""Golden-field integration parity: K full Simulate() steps of the JAX 2D
engine vs the NumPy oracle (SURVEY.md §4: "Golden-field integration tests"),
with emitters and obstacles active."""

import numpy as np
import jax.numpy as jnp

import oracle2d
from fluidsim_tpu.config import ObstacleShape, SimConfig
from fluidsim_tpu.models.stable2d import make_step_2d, simulate_step_2d
from fluidsim_tpu.scene.obstacles import build_obstacle_mask
from fluidsim_tpu.scene.sources import apply_custom_source
from fluidsim_tpu.state import zeros_state


def small_cfg(**kw):
    base = dict(
        size=32,
        resolution_multiplier=1.0,
        time_step=0.05,
        diffusion=1e-4,
        viscosity=1e-4,
        enable_custom_source=True,
        source_strength=80.0,
        source_emits_velocity=True,
        source_direction=0.0,
        source_velocity=12.0,
        source_radius=2.5,
        source_position=(0.2, 0.5),
        enable_obstacle=True,
        obstacle_shape=ObstacleShape.CIRCLE,
        obstacle_position=(0.6, 0.5),
        obstacle_radius=0.12,
    )
    base.update(kw)
    return SimConfig(**base).validate()


def run_parity(cfg, steps=5):
    obst = build_obstacle_mask(cfg)
    n = cfg.current_size

    # Oracle state
    od = np.zeros((n, n), np.float32)
    ovx = np.zeros((n, n), np.float32)
    ovy = np.zeros((n, n), np.float32)

    # Engine state
    state = zeros_state(cfg, obstacles=obst)
    step_fn = make_step_2d(cfg)

    t = np.float32(0.0)
    frame_dt = np.float32(cfg.effective_params()[0])
    for _ in range(steps):
        t = t + frame_dt
        # Emitter before Simulate (reference Update() order, FluidSim.cs:405-442)
        oracle2d.custom_source(od, ovx, ovy, cfg, t)
        d, vel = apply_custom_source(
            state.density, state.velocity, cfg, jnp.float32(t)
        )
        state = state.replace(density=d, velocity=vel)

        od, ovx, ovy, op = oracle2d.simulate_step(od, ovx, ovy, obst, cfg)
        state = step_fn(state)

    # Tolerances are scale-aware: per-op agreement is ~1 ulp (see
    # test_parity_ops), but semi-Lagrangian gathers flip interpolation
    # cells on ulp-level velocity differences, so chaotic trajectories
    # drift at ~1e-4 of field scale over a few steps.  That drift rate is
    # the practical meaning of "float32 tolerance" for this solver.
    def check(got, exp, name):
        scale = max(1.0, float(np.abs(exp).max()))
        np.testing.assert_allclose(
            np.asarray(got), exp, rtol=1e-3, atol=5e-4 * scale,
            err_msg=f"{name} diverged from oracle",
        )

    check(state.density, od, "density")
    check(state.velocity[0], ovx, "vel_x")
    check(state.velocity[1], ovy, "vel_y")
    check(state.pressure, op, "pressure")


def test_step_parity_obstacle_emitter():
    run_parity(small_cfg(), steps=5)


def test_step_parity_no_obstacle():
    run_parity(small_cfg(enable_obstacle=False), steps=5)


def test_step_parity_pulsing_airfoil():
    run_parity(
        small_cfg(
            obstacle_shape=ObstacleShape.AIRFOIL,
            obstacle_width=0.2,
            obstacle_height=0.05,
            source_pulsing=True,
            source_pulse_rate=5.0,
            auto_adjust_parameters=True,
        ),
        steps=4,
    )


def test_step_parity_resolution_multiplier():
    """Auto-adjust path: dt·dtScale, diff/resMult (FluidSim.cs:554-556)."""
    run_parity(
        small_cfg(size=32, resolution_multiplier=1.5,
                  auto_adjust_parameters=True),
        steps=3,
    )


def test_step_parity_resync_64():
    """The 64-grid gate with per-step re-sync: each
    step starts engine and oracle from the SAME state, so the comparison
    isolates genuine formula mismatches from chaotic semi-Lagrangian
    drift — agreement must be at float32 op-reordering level."""
    cfg = small_cfg(size=64, source_position=(0.2, 0.5),
                    obstacle_position=(0.6, 0.5))
    obst = build_obstacle_mask(cfg)
    n = cfg.current_size
    step_fn = make_step_2d(cfg)

    od = np.zeros((n, n), np.float32)
    ovx = np.zeros((n, n), np.float32)
    ovy = np.zeros((n, n), np.float32)

    t = np.float32(0.0)
    frame_dt = np.float32(cfg.effective_params()[0])
    for k in range(4):
        t = t + frame_dt
        oracle2d.custom_source(od, ovx, ovy, cfg, t)
        state = zeros_state(cfg, obstacles=obst).replace(
            density=jnp.asarray(od), velocity=jnp.stack(
                [jnp.asarray(ovx), jnp.asarray(ovy)]
            ),
        )
        od, ovx, ovy, op = oracle2d.simulate_step(od, ovx, ovy, obst, cfg)
        state = step_fn(state)

        for name, got, exp in (
            ("density", state.density, od),
            ("vel_x", state.velocity[0], ovx),
            ("vel_y", state.velocity[1], ovy),
            ("pressure", state.pressure, op),
        ):
            scale = max(1.0, float(np.abs(exp).max()))
            np.testing.assert_allclose(
                np.asarray(got), exp, rtol=1e-5, atol=2e-6 * scale,
                err_msg=f"step {k}: {name} diverged (resync gate)",
            )


def test_density_decay_nonnegative():
    """Property: with no sources, density stays non-negative under decay."""
    cfg = small_cfg(enable_custom_source=False, enable_obstacle=False)
    state = zeros_state(cfg)
    d = np.zeros(cfg.grid_shape, np.float32)
    d[10:20, 10:20] = 50.0
    state = state.replace(density=jnp.asarray(d))
    step = make_step_2d(cfg)
    for _ in range(10):
        state = step(state)
    assert float(jnp.min(state.density)) >= -1e-4
    assert float(jnp.max(state.density)) <= 50.0 + 1e-3


def test_obstacle_cells_zero_velocity():
    """Property: obstacle interior cells end each step with zero velocity...
    except set_bnd's mirror writes; the enforce pass zeroes them last."""
    cfg = small_cfg()
    obst = build_obstacle_mask(cfg)
    state = zeros_state(cfg, obstacles=obst)
    d, vel = apply_custom_source(state.density, state.velocity, cfg,
                                 jnp.float32(0.05))
    state = state.replace(density=d, velocity=vel)
    state = make_step_2d(cfg)(state)
    interior = np.zeros(cfg.grid_shape, bool)
    interior[1:-1, 1:-1] = True
    inside = np.asarray(obst) & interior
    assert np.abs(np.asarray(state.velocity)[:, inside]).max() == 0.0
