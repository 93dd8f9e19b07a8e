"""Reference-parity 2D stable-fluids solver.

Reproduces the reference's ``Simulate`` orchestration (FluidSim.cs:551-721)
to float32 tolerance:

``VelocityStep`` (FluidSim.cs:703-714)::

    vx0 = Diffuse(1, vx);  vy0 = Diffuse(2, vy)          # 40 sweeps each
    (vx0, vy0) = Project(vx0, vy0)                        # 20-iter Jacobi
    vx = Advect(1, vx0 by (vx0, vy0))
    vy = Advect(2, vy0 by (vx0, vy0))
    (vx, vy, pressure) = Project(vx, vy)                  # writes `pressure`

``DensityStep`` (FluidSim.cs:716-721)::

    tmp = Diffuse(0, density);  density = Advect(0, tmp by (vx, vy))

then optional turbulence (FluidSim.cs:561-564) and obstacle enforcement +
Reynolds drag (FluidSim.cs:566-570).  The reference's ``velocityX0/Y0``
scratch arrays carry no information across frames (they are fully
overwritten by the next frame's diffusion), so they are not part of state.

The whole step is one pure function — a single XLA program per call, with
no per-kernel buffer copies (the reference re-allocates and copies
``NativeArray``s around every job dispatch, e.g. FluidSim.cs:1299-1301,
1425-1429, 1529-1533).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SimConfig
from ..ops.advect import advect_2d, advect_2d_pair
from ..ops.forces import apply_turbulent_noise_2d, enforce_obstacle_boundaries_2d
from ..ops.linsolve import diffuse_2d
from ..ops.project import project_2d
from ..state import FluidState


def velocity_step_2d(vel_x, vel_y, obst, dt: float, visc: float, cfg: SimConfig):
    """FluidSim.cs:703-714. Returns (vel_x, vel_y, pressure)."""
    iters = cfg.jacobi_iters
    vx0 = diffuse_2d(1, vel_x, visc, dt, obst, cfg)
    vy0 = diffuse_2d(2, vel_y, visc, dt, obst, cfg)
    vx0, vy0, _ = project_2d(vx0, vy0, obst, iters)
    # One shared backtrace + batched gathers for both components —
    # bitwise equal to the two separate advect_2d calls (FluidSim.cs:710-711).
    vel_x, vel_y = advect_2d_pair(vx0, vy0, vx0, vy0, dt, obst)
    vel_x, vel_y, pressure = project_2d(vel_x, vel_y, obst, iters)
    return vel_x, vel_y, pressure


def density_step_2d(density, vel_x, vel_y, obst, dt: float, diff: float,
                    cfg: SimConfig):
    """FluidSim.cs:716-721."""
    tmp = diffuse_2d(0, density, diff, dt, obst, cfg)
    return advect_2d(0, tmp, vel_x, vel_y, dt, obst)


def simulate_step_2d(state: FluidState, cfg: SimConfig) -> FluidState:
    """One full reference ``Simulate()`` (FluidSim.cs:551-576)."""
    dt, diff, visc = cfg.effective_params()
    obst = state.obstacles

    vel_x, vel_y, pressure = velocity_step_2d(
        state.velocity[0], state.velocity[1], obst, dt, visc, cfg
    )
    density = density_step_2d(state.density, vel_x, vel_y, obst, dt, diff, cfg)

    if cfg.apply_turbulent_noise:
        vel_x, vel_y = apply_turbulent_noise_2d(vel_x, vel_y)

    if cfg.enable_obstacle:
        vel_x, vel_y = enforce_obstacle_boundaries_2d(
            vel_x, vel_y, obst, cfg.cell_size, cfg.viscosity
        )

    return state.replace(
        density=density,
        velocity=jnp.stack([vel_x, vel_y]),
        pressure=pressure,
        step=state.step + 1,
        time=state.time + jnp.float32(dt),
    )


def make_step_2d(cfg: SimConfig, n_substeps: int = 1):
    """Compile a jitted function advancing ``n_substeps`` sim steps.

    Multi-step rollout uses ``lax.scan`` so the device loops without host
    round trips (the reference blocks on ``.Complete()`` after every job,
    FluidSim.cs:1339,1396).
    """

    def one(state, _):
        return simulate_step_2d(state, cfg), None

    @jax.jit
    def step(state: FluidState) -> FluidState:
        if n_substeps == 1:
            return simulate_step_2d(state, cfg)
        state, _ = jax.lax.scan(one, state, None, length=n_substeps)
        return state

    return step
