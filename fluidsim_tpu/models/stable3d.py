"""3D stable-fluids solver — the product engine.

The reference implements Jos Stam's stable fluids on a 2D grid with
3D-lineage constants (SURVEY.md top note; FluidSim.cs:744, 1581-1582).  This
module is the genuine 3D voxel engine the BASELINE configs ask for:
``[z, y, x]`` fields, 6-neighbor stencils (where ``c = 1+6a`` / ``c = 6``
are actually correct), trilinear advection, buoyancy and vorticity
confinement.

Step order (one fused XLA program)::

    buoyancy → vorticity confinement → [viscous diffusion] →
    [reference-style pre-projection] → self-advect velocity →
    pressure projection (cfg.jacobi_iters) →
    [density diffusion] → advect density → obstacle enforcement

With ``cfg.double_project=False`` (default) the step spends exactly
``cfg.jacobi_iters`` Jacobi sweeps in the single projection — the
BASELINE.json "60-iter Jacobi" workload is ``preset_bench_128``
(jacobi_iters=60).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SimConfig
from ..ops.advect import advect_multi_3d
from ..ops.forces import (
    buoyancy_force,
    enforce_obstacle_boundaries_3d,
    vorticity_confinement_3d,
)
from ..ops.linsolve import diffuse_3d
from ..ops.project import project_3d
from ..state import FluidState


def simulate_step_3d(state: FluidState, cfg: SimConfig,
                     jacobi_fn=None) -> FluidState:
    """One product step.  ``jacobi_fn(p, div, iters, obst)`` optionally
    overrides the pressure solve — the hook the explicit halo-exchange
    solver (parallel/halo.jacobi_3d_sharded) plugs into via
    ``sharded_step_fn``."""
    dt, diff, visc = cfg.effective_params()
    # Static no-obstacle specialization: passing None removes every
    # obstacle branch from the compiled program.
    obst = state.obstacles if cfg.enable_obstacle else None
    win = cfg.advect_window
    vel = state.velocity
    density = state.density

    # -- body forces ----------------------------------------------------
    if cfg.buoyancy != 0.0 or cfg.gravity != 0.0:
        vel = buoyancy_force(
            vel, density, dt, cfg.buoyancy, cfg.ambient_density, cfg.gravity
        )
    if cfg.vorticity_confinement != 0.0:
        vel = vorticity_confinement_3d(vel, dt, cfg.vorticity_confinement)

    # -- viscous diffusion (skipped entirely when visc == 0) ------------
    if visc > 0.0:
        vel = jnp.stack(
            [diffuse_3d(c + 1, vel[c], visc, dt, obst, cfg) for c in range(3)]
        )

    if cfg.double_project:
        vel, _ = project_3d(vel, obst, cfg.jacobi_iters)

    # -- self-advection (one shared backtrace for all three components) --
    def advect_fields(bs, fields, velocity):
        base = lambda b_, f_, v_, d_: advect_multi_3d(
            b_, f_, v_, d_, obst, window=win
        )
        if cfg.advection_scheme == "maccormack":
            from ..ops.advect import advect_maccormack_3d

            return advect_maccormack_3d(bs, fields, velocity, dt, obst,
                                        win, advect_fn=base)
        if cfg.advection_scheme == "substep":
            from ..ops.advect import advect_substep_3d

            return advect_substep_3d(bs, fields, velocity, dt, obst,
                                     win, advect_fn=base,
                                     n_sub=cfg.advect_substeps)
        return base(bs, fields, velocity, dt)

    vel = advect_fields((1, 2, 3), vel, vel)

    # -- pressure projection --------------------------------------------
    if jacobi_fn is not None:
        vel, pressure = project_3d(vel, obst, cfg.jacobi_iters,
                                   jacobi_fn=jacobi_fn)
    elif cfg.pressure_solver == "fft":
        if cfg.enable_obstacle:
            raise ValueError("pressure_solver='fft' requires no obstacles")
        from ..ops.fft_poisson import project_3d_fft

        vel, pressure = project_3d_fft(vel)
    else:
        vel, pressure = project_3d(vel, obst, cfg.jacobi_iters)

    # -- velocity damping (implicit Stam-style sink; a scalar multiple
    #    preserves the just-projected divergence-free field) -------------
    if cfg.velocity_damping != 0.0:
        vel = vel * jnp.asarray(
            1.0 / (1.0 + np.float32(dt) * np.float32(cfg.velocity_damping)),
            vel.dtype,
        )

    # -- density transport ----------------------------------------------
    if diff > 0.0:
        density = diffuse_3d(0, density, diff, dt, obst, cfg)
    density = advect_fields((0,), density[None], vel)[0]
    if cfg.density_dissipation != 0.0:
        # Stam's implicit dissipation: s/(1 + dt·κ) ("Stable Fluids",
        # density equation sink term).
        density = density * jnp.asarray(
            1.0 / (1.0 + np.float32(dt) * np.float32(cfg.density_dissipation)),
            density.dtype,
        )

    # -- turbulence forcing (FluidSim.cs:561-564 analog) ----------------
    if cfg.apply_turbulent_noise:
        from ..ops.forces import apply_turbulent_noise_3d

        vel = apply_turbulent_noise_3d(vel)

    # -- obstacles ------------------------------------------------------
    if cfg.enable_obstacle:
        vel = enforce_obstacle_boundaries_3d(
            vel, state.obstacles, cfg.cell_size, cfg.viscosity
        )

    return state.replace(
        density=density,
        velocity=vel,
        pressure=pressure,
        step=state.step + 1,
        time=state.time + jnp.float32(dt),
    )


def make_step_3d(cfg: SimConfig, n_substeps: int = 1):
    """Compile a jitted ``n_substeps``-step advance (``lax.scan`` rollout)."""

    def one(state, _):
        return simulate_step_3d(state, cfg), None

    @jax.jit
    def step(state: FluidState) -> FluidState:
        if n_substeps == 1:
            return simulate_step_3d(state, cfg)
        state, _ = jax.lax.scan(one, state, None, length=n_substeps)
        return state

    return step


def make_step(cfg: SimConfig, n_substeps: int = 1):
    """Dimension-dispatching step factory."""
    if cfg.ndim == 3:
        return make_step_3d(cfg, n_substeps)
    from .stable2d import make_step_2d

    return make_step_2d(cfg, n_substeps)
