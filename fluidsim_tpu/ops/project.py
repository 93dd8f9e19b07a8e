"""Pressure projection (Helmholtz-Hodge).

Reference: ``ProjectWithJobs`` (FluidSim.cs:1417-1521) —

1. divergence ``div = −0.5·(Δu + Δv)/N`` on interior cells, ``p = 0``
   (FluidSim.cs:1089-1094; note division by ``N``, not ``N−2``),
2. ``set_bnd(0)`` on both,
3. 20-iter Jacobi with ``a=1, c=6`` (``PressureSolveWithJobs``,
   FluidSim.cs:1578-1637 — the 3D 6-neighbor constant on a 2D grid),
4. gradient subtraction ``u −= 0.5·N·∂p`` on interior non-obstacle cells
   (FluidSim.cs:1120-1121), then ``set_bnd(1)``/``set_bnd(2)``.

Returns the solved pressure as well — the reference copies it into the
``pressure`` field for visualization (FluidSim.cs:1509).
"""

from __future__ import annotations

import jax.numpy as jnp

from .boundary import set_bnd_2d, set_bnd_3d
from .linsolve import lin_solve_2d, jacobi_3d


def project_2d(vel_x, vel_y, obst, iters: int = 20):
    """Returns (vel_x, vel_y, p). Arrays are ``[y, x]``."""
    n = vel_x.shape[0]
    nf = jnp.asarray(n, vel_x.dtype)
    core = (slice(1, -1), slice(1, -1))

    div_int = (
        -0.5
        * (
            (vel_x[1:-1, 2:] - vel_x[1:-1, :-2])
            + vel_y[2:, 1:-1]
            - vel_y[:-2, 1:-1]
        )
        / nf
    )
    div = jnp.zeros_like(vel_x).at[core].set(div_int)
    div = set_bnd_2d(0, div, obst)
    p = set_bnd_2d(0, jnp.zeros_like(vel_x), obst)
    p = lin_solve_2d(0, p, div, a=1.0, c=6.0, obst=obst, iters=iters)

    gx = 0.5 * (p[1:-1, 2:] - p[1:-1, :-2]) * nf
    gy = 0.5 * (p[2:, 1:-1] - p[:-2, 1:-1]) * nf
    obst_int = obst[core]
    vel_x = vel_x.at[core].set(
        jnp.where(obst_int, vel_x[core], vel_x[core] - gx)
    )
    vel_y = vel_y.at[core].set(
        jnp.where(obst_int, vel_y[core], vel_y[core] - gy)
    )
    vel_x = set_bnd_2d(1, vel_x, obst)
    vel_y = set_bnd_2d(2, vel_y, obst)
    return vel_x, vel_y, p


def project_3d(vel, obst=None, iters: int = 20, jacobi_fn=None):
    """3D projection on a ``[z, y, x]`` grid; ``vel`` is ``(3, N, N, N)``.

    Same structure as 2D with the 6-neighbor divergence and ``c = 6`` —
    the coefficient the reference uses is exactly right here.
    ``obst=None`` statically removes the obstacle branches.
    ``jacobi_fn(p, div, iters, obst)`` overrides the pressure solve
    entirely — the hook the explicit halo-exchange solver
    (parallel/halo.jacobi_3d_sharded) plugs into; it receives the
    (possibly None) obstacle mask and must implement the copy-through
    rule ``jacobi_3d`` applies.  Returns (vel, p).
    """
    n = vel.shape[-1]
    in_dtype = vel.dtype
    if in_dtype != jnp.float32:
        # bf16 storage: divergence/solve/gradient accumulate in f32.
        vel = vel.astype(jnp.float32)
    nf = jnp.asarray(n, vel.dtype)
    core = (slice(1, -1),) * 3
    vx, vy, vz = vel[0], vel[1], vel[2]

    div_int = (
        -0.5
        * (
            (vx[1:-1, 1:-1, 2:] - vx[1:-1, 1:-1, :-2])
            + (vy[1:-1, 2:, 1:-1] - vy[1:-1, :-2, 1:-1])
            + (vz[2:, 1:-1, 1:-1] - vz[:-2, 1:-1, 1:-1])
        )
        / nf
    )
    div = jnp.zeros_like(vx).at[core].set(div_int)
    div = set_bnd_3d(0, div, obst)
    p = set_bnd_3d(0, jnp.zeros_like(vx), obst)

    if jacobi_fn is not None:
        p = jacobi_fn(p, div, iters, obst)
    else:
        p = jacobi_3d(0, p, div, a=1.0, c=6.0, obst=obst, iters=iters)

    gx = 0.5 * (p[1:-1, 1:-1, 2:] - p[1:-1, 1:-1, :-2]) * nf
    gy = 0.5 * (p[1:-1, 2:, 1:-1] - p[1:-1, :-2, 1:-1]) * nf
    gz = 0.5 * (p[2:, 1:-1, 1:-1] - p[:-2, 1:-1, 1:-1]) * nf
    if obst is not None:
        obst_int = obst[core]
        gx = jnp.where(obst_int, 0.0, gx)
        gy = jnp.where(obst_int, 0.0, gy)
        gz = jnp.where(obst_int, 0.0, gz)

    vx = vx.at[core].set(vx[core] - gx)
    vy = vy.at[core].set(vy[core] - gy)
    vz = vz.at[core].set(vz[core] - gz)
    vx = set_bnd_3d(1, vx, obst)
    vy = set_bnd_3d(2, vy, obst)
    vz = set_bnd_3d(3, vz, obst)
    return jnp.stack([vx, vy, vz]).astype(in_dtype), p.astype(in_dtype)
