"""3D solver tests: windowed-vs-gather advection equivalence, projection
strength (c=6 is correct in 3D), physics sanity for the BASELINE configs."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fluidsim_tpu.config import SimConfig
from fluidsim_tpu.engine import Engine
from fluidsim_tpu.ops.advect import advect_3d, advect_multi_3d
from fluidsim_tpu.ops.forces import vorticity_confinement_3d
from fluidsim_tpu.ops.project import project_3d

pytestmark = pytest.mark.slow  # 3D solver rollouts


N = 24


def rand(key, shape, scale=1.0):
    return jax.random.normal(jax.random.PRNGKey(key), shape, jnp.float32) * scale


def test_windowed_advection_equals_gather_within_cfl():
    """The hat-window formulation is exactly the trilinear gather when
    displacement < window (ops/advect.py)."""
    d0 = rand(0, (N, N, N), 2.0)
    # |v|·dt·(N−2) < 2 cells → window 3 is exact
    vel = rand(1, (3, N, N, N), 0.5)
    dt = 2.0 / (0.5 * 4 * (N - 2))  # max disp ≈ 2 cells w/ 4σ margin
    g = advect_3d(0, d0, vel, dt, None, window=0)
    w = advect_3d(0, d0, vel, dt, None, window=3)
    np.testing.assert_allclose(np.asarray(w), np.asarray(g),
                               rtol=1e-5, atol=1e-5)


def test_windowed_advection_with_obstacles():
    d0 = rand(0, (N, N, N), 2.0)
    vel = rand(1, (3, N, N, N), 0.3)
    obst = np.zeros((N, N, N), bool)
    obst[8:12, 8:12, 8:12] = True
    obst = jnp.asarray(obst)
    dt = 0.02
    g = advect_3d(0, d0, vel, dt, obst, window=0)
    w = advect_3d(0, d0, vel, dt, obst, window=3)
    np.testing.assert_allclose(np.asarray(w), np.asarray(g),
                               rtol=1e-5, atol=1e-5)


def test_multi_advect_matches_single():
    fields = rand(0, (3, N, N, N), 1.5)
    vel = rand(1, (3, N, N, N), 0.3)
    dt = 0.02
    multi = advect_multi_3d((1, 2, 3), fields, vel, dt, None, window=2)
    for c in range(3):
        single = advect_3d(c + 1, fields[c], vel, dt, None, window=2)
        np.testing.assert_allclose(np.asarray(multi[c]), np.asarray(single),
                                   rtol=1e-6, atol=1e-6)


def test_project_3d_reduces_divergence_strongly():
    """In 3D, c = 6 is the correct Poisson diagonal — unlike the 2D
    reference quirk, projection should kill most of the divergence.

    Uses a *smooth* velocity field: the collocated central-difference
    div/grad pair has checkerboard modes in its null space (a property of
    this discretization family, the reference's included), so white noise
    cannot be projected; and Jacobi damps low frequencies slowly, so the
    bound reflects 60 iterations, not the converged solve.
    """
    k = 2 * np.pi / N
    z, y, x = np.meshgrid(np.arange(N), np.arange(N), np.arange(N),
                          indexing="ij")
    vel = jnp.asarray(
        np.stack([
            np.sin(k * x) * np.cos(k * y) * np.cos(k * z),
            np.cos(k * x) * np.sin(k * y) * np.cos(k * z),
            np.cos(k * x) * np.cos(k * y) * np.sin(k * z),
        ]),
        jnp.float32,
    )

    def div_norm(vel):
        vx, vy, vz = vel[0], vel[1], vel[2]
        d = (
            (vx[1:-1, 1:-1, 2:] - vx[1:-1, 1:-1, :-2])
            + (vy[1:-1, 2:, 1:-1] - vy[1:-1, :-2, 1:-1])
            + (vz[2:, 1:-1, 1:-1] - vz[:-2, 1:-1, 1:-1])
        )
        return float(np.abs(np.asarray(d)).mean())

    before = div_norm(vel)
    out, _ = project_3d(vel, None, iters=60)
    after = div_norm(out)
    assert after < before * 0.35
    # a second application keeps converging (0.26 → ~0.07 measured)
    out2, _ = project_3d(out, None, iters=60)
    assert div_norm(out2) < after * 0.5


def test_obstacle_cells_zero_velocity_3d():
    cfg = SimConfig(
        ndim=3, size=32, time_step=0.03, auto_adjust_parameters=False,
        diffusion=0.0, viscosity=0.0, double_diffuse=False,
        enable_custom_source=True, source_strength=100.0, source_radius=3.0,
        source_emits_velocity=True, source_velocity=10.0,
        source_position=(0.5, 0.2, 0.5),
        enable_obstacle=True, obstacle_position=(0.5, 0.5, 0.5),
        obstacle_radius=0.15, advect_window=2,
    )
    eng = Engine(cfg)
    eng.step(3)
    obst = np.asarray(eng.state.obstacles)
    interior = np.zeros_like(obst)
    interior[1:-1, 1:-1, 1:-1] = True
    inside = obst & interior
    assert inside.sum() > 0
    assert np.abs(np.asarray(eng.state.velocity)[:, inside]).max() == 0.0


@pytest.mark.parametrize("preset", ["smoke32", "plume64"])
def test_baseline_presets_stable(preset):
    """BASELINE configs run without NaN and produce rising plumes."""
    import fluidsim_tpu as fs

    cfg = fs.get_preset(preset)
    if cfg.size > 48:  # keep CPU CI fast: shrink but keep physics flags
        cfg = cfg.replace(size=32, source_radius=2.0)
    eng = Engine(cfg, nan_guard=True)
    eng.step(8)
    dens = np.asarray(eng.state.density)
    assert dens.sum() > 0
    n = cfg.current_size
    com_y = float(
        (dens.sum(axis=(0, 2)) * np.arange(n)).sum() / max(dens.sum(), 1e-9)
    )
    emitter_y = cfg.source_position[1] * n
    assert com_y >= emitter_y - 1.0  # plume at or above the emitter


def test_vorticity_confinement_preserves_shape_and_scale():
    vel = rand(7, (3, N, N, N), 1.0)
    out = vorticity_confinement_3d(vel, dt=0.01, eps=2.0)
    assert out.shape == vel.shape
    # small dt·ε perturbation: bounded relative change
    delta = float(jnp.abs(out - vel).max())
    assert 0.0 < delta < 1.0


def test_fft_projection_exact():
    """pressure_solver='fft' removes central-difference divergence to
    machine precision (ops/fft_poisson.py)."""
    from fluidsim_tpu.ops.fft_poisson import project_3d_fft

    vel = rand(11, (3, N, N, N), 1.0)
    for _ in range(4):
        vel = sum(
            jnp.roll(vel, s, ax) for ax in (1, 2, 3) for s in (-1, 1)
        ) / 6.0

    def div_norm(v):
        d = 0.5 * (
            (jnp.roll(v[0], -1, 2) - jnp.roll(v[0], 1, 2))
            + (jnp.roll(v[1], -1, 1) - jnp.roll(v[1], 1, 1))
            + (jnp.roll(v[2], -1, 0) - jnp.roll(v[2], 1, 0))
        )
        return float(jnp.abs(d[2:-2, 2:-2, 2:-2]).mean())

    before = div_norm(vel)
    out, p = project_3d_fft(vel)
    assert div_norm(out) < before * 1e-4
    assert p.shape == (N, N, N)


def test_fft_pressure_solver_in_step():
    import fluidsim_tpu as fs
    from fluidsim_tpu.engine import Engine

    cfg = fs.get_preset("smoke32").replace(
        pressure_solver="fft", advect_window=2
    )
    eng = Engine(cfg, nan_guard=True)
    eng.step(5)
    assert float(eng.state.density.sum()) > 0


def test_turbulence_3d():
    from fluidsim_tpu.ops.forces import apply_turbulent_noise_3d

    vel = rand(12, (3, N, N, N), 1.0)
    out = apply_turbulent_noise_3d(vel)
    assert out.shape == vel.shape
    delta = np.asarray(jnp.abs(out - vel))
    interior = delta[:, 1:-1, 1:-1, 1:-1]
    assert interior.max() > 0  # perturbed
    # scaled by |v|: zero velocity → zero perturbation
    out0 = apply_turbulent_noise_3d(jnp.zeros_like(vel))
    assert float(jnp.abs(out0).max()) == 0.0


def test_maccormack_advection():
    """MacCormack reduces numerical diffusion vs plain semi-Lagrangian
    when transporting a sharp blob through a uniform flow."""
    from fluidsim_tpu.ops.advect import advect_maccormack_3d, advect_multi_3d

    n = 32
    d = np.zeros((n, n, n), np.float32)
    d[12:20, 12:20, 12:20] = 1.0
    d = jnp.asarray(d)[None]
    vel = jnp.ones((3, n, n, n), jnp.float32) * 0.11  # ~0.33 cell/step
    dt = 0.1

    sl = d
    mc = d
    for _ in range(6):
        sl = advect_multi_3d((0,), sl, vel, dt, None, window=2)
        mc = advect_maccormack_3d((0,), mc, vel, dt, None, window=2)
    # sharper = more cells remain close to the original extremes
    sl_sharp = float(jnp.sum((sl > 0.9)))
    mc_sharp = float(jnp.sum((mc > 0.9)))
    assert mc_sharp > sl_sharp
    # limiter keeps values within the original range
    assert float(mc.max()) <= 1.0 + 1e-5
    assert float(mc.min()) >= -1e-5


def test_maccormack_in_step():
    import fluidsim_tpu as fs
    from fluidsim_tpu.engine import Engine

    cfg = fs.get_preset("smoke32").replace(
        advection_scheme="maccormack", advect_window=2
    )
    eng = Engine(cfg, nan_guard=True)
    eng.step(5)
    assert float(eng.state.density.sum()) > 0


def test_crash_snapshot(tmp_path):
    import fluidsim_tpu as fs
    from fluidsim_tpu.engine import Engine

    snap = str(tmp_path / "crash.npz")
    cfg = fs.get_preset("smoke32").replace(advect_window=2)
    eng = Engine(cfg, nan_guard=True, crash_snapshot_path=snap)
    eng.step(2)
    good_step = int(eng.state.step)
    eng.state = eng.state.replace(
        density=eng.state.density.at[3, 3, 3].set(jnp.nan)
    )
    with pytest.raises(FloatingPointError):
        eng.step(1)
    eng2 = Engine.from_checkpoint(snap)
    assert int(eng2.state.step) == good_step
    assert not bool(jnp.isnan(eng2.state.density).any())


def test_substep_advection_matches_single_for_uniform_flow():
    """For a uniform velocity field the substepped composition equals a
    single full-dt advection (straight characteristics)."""
    from fluidsim_tpu.ops.advect import advect_multi_3d, advect_substep_3d

    n = 32
    d = np.zeros((n, n, n), np.float32)
    d[10:20, 10:20, 10:20] = 1.0
    d = jnp.asarray(d)[None]
    vel = jnp.ones((3, n, n, n), jnp.float32) * 0.15
    dt = 0.1
    one = advect_multi_3d((0,), d, vel, dt, None, window=2)
    sub = advect_substep_3d((0,), d, vel, dt, None, window=1, n_sub=2)
    # uniform flow: both sample the same displaced box (substepping adds
    # one interpolation smoothing → small tolerance)
    np.testing.assert_allclose(np.asarray(sub), np.asarray(one),
                               rtol=0.2, atol=0.08)
    # mass approximately conserved by both
    assert abs(float(sub.sum()) - float(one.sum())) / float(one.sum()) < 0.05


def test_substep_scheme_in_step():
    import fluidsim_tpu as fs
    from fluidsim_tpu.engine import Engine

    cfg = fs.get_preset("smoke32").replace(
        advection_scheme="substep", advect_window=1
    )
    eng = Engine(cfg, nan_guard=True)
    eng.step(5)
    assert float(eng.state.density.sum()) > 0


def test_density_dissipation_exact_decay():
    """Stam's implicit sink: with zero velocity (advection = identity in
    the interior) interior density scales by exactly 1/(1+dt·κ) per step."""
    from fluidsim_tpu.models.stable3d import simulate_step_3d
    from fluidsim_tpu.state import FluidState, zeros_state

    M = 32
    base = dict(ndim=3, size=M, auto_adjust_parameters=False,
                time_step=0.05, diffusion=0.0, viscosity=0.0,
                double_diffuse=False, enable_custom_source=False,
                enable_obstacle=False, buoyancy=0.0,
                source_position=(0.5, 0.5, 0.5),
                obstacle_position=(0.5, 0.5, 0.5),
                advect_window=1, jacobi_iters=4)
    cfg = SimConfig(**base, density_dissipation=4.0).validate()
    state = zeros_state(cfg)
    d0 = jnp.abs(rand(3, (M, M, M), 1.0)) + 1.0
    state = state.replace(density=d0)
    state = simulate_step_3d(state, cfg)
    f = np.float32(1.0) / (np.float32(1.0) + np.float32(0.05) * np.float32(4.0))
    inner = (slice(2, -2),) * 3
    np.testing.assert_allclose(
        np.asarray(state.density[inner]), np.asarray(d0[inner]) * f,
        rtol=1e-6)


def test_velocity_damping_scales_velocity_exactly():
    """velocity_damping multiplies the post-projection field by exactly
    1/(1+dt·κ) (and therefore preserves its divergence-free-ness)."""
    from fluidsim_tpu.models.stable3d import simulate_step_3d
    from fluidsim_tpu.state import zeros_state

    M = 32
    base = dict(ndim=3, size=M, auto_adjust_parameters=False,
                time_step=0.05, diffusion=0.0, viscosity=0.0,
                double_diffuse=False, enable_custom_source=False,
                enable_obstacle=False, buoyancy=0.0,
                source_position=(0.5, 0.5, 0.5),
                obstacle_position=(0.5, 0.5, 0.5),
                advect_window=1, jacobi_iters=8)
    cfg_u = SimConfig(**base).validate()
    cfg_d = SimConfig(**base, velocity_damping=2.0).validate()
    vel = rand(4, (3, M, M, M), 0.05)
    d0 = jnp.abs(rand(5, (M, M, M), 1.0))
    s0 = zeros_state(cfg_u).replace(density=d0, velocity=vel)
    su = simulate_step_3d(s0, cfg_u)
    sd = simulate_step_3d(s0, cfg_d)
    f = np.float32(1.0) / (np.float32(1.0) + np.float32(0.05) * np.float32(2.0))
    np.testing.assert_array_equal(
        np.asarray(sd.velocity), np.asarray(su.velocity) * f)
