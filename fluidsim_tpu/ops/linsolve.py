"""Jacobi linear solvers.

The reference's linear algebra (all on flat 2D grids):

* ``DiffuseJob`` (FluidSim.cs:1034-1069): a *self-smoothing* sweep — the rhs
  is the current iterate itself: ``x_{k+1} = (x_k + a·Σ₄ x_k) / c``.  Cells
  outside the interior and obstacle cells are skipped, leaving them at their
  previous buffer value (which, by the reference's double-buffer
  initialization at FluidSim.cs:1299-1300, is always the original ``x0``);
  boundaries are then reapplied.  20 iterations (FluidSim.cs:1310).
* ``LinearSolveIterationJob`` (FluidSim.cs:1188-1233): the classic fixed-rhs
  Jacobi sweep ``x_{k+1} = (x0 + a·Σ₄ x_k) / c``; skipped cells copy the
  previous iterate.  20 iterations (FluidSim.cs:1378, 1594).
* ``Diffuse`` (FluidSim.cs:740-745) runs BOTH, back to back — 40 sweeps with
  the 3D-lineage coefficient ``c = 1 + 6a`` on a 2D grid.

Each sweep is a fused radius-1 stencil + masked boundary update under one
``lax.fori_loop``; there are no buffer copies or host round trips.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .boundary import set_bnd_2d, set_bnd_3d


def _nbr_sum_2d(x):
    """4-neighbor sum over the interior, reference add order
    (right + left) + up + down (FluidSim.cs:1062-1067)."""
    return ((x[1:-1, 2:] + x[1:-1, :-2]) + x[2:, 1:-1]) + x[:-2, 1:-1]


def _nbr_sum_3d(x):
    """6-neighbor sum over the interior of a [z, y, x] array."""
    return (
        ((x[1:-1, 1:-1, 2:] + x[1:-1, 1:-1, :-2])
         + (x[1:-1, 2:, 1:-1] + x[1:-1, :-2, 1:-1]))
        + (x[2:, 1:-1, 1:-1] + x[:-2, 1:-1, 1:-1])
    )


def diffuse_smooth_2d(b: int, x0, a: float, c: float, obst, iters: int = 20):
    """The reference ``DiffuseWithJobs`` phase (FluidSim.cs:1292-1357).

    Starts from ``x0``; each sweep updates interior non-obstacle cells from
    the current iterate, resets untouched interior obstacle cells to ``x0``
    (the stale-buffer quirk), then applies ``set_bnd``.
    """
    obst_int = obst[1:-1, 1:-1]
    x0_int = x0[1:-1, 1:-1]

    def body(_, x):
        upd = (x[1:-1, 1:-1] + a * _nbr_sum_2d(x)) / c
        out = x0.at[1:-1, 1:-1].set(jnp.where(obst_int, x0_int, upd))
        return set_bnd_2d(b, out, obst)

    # unroll=4 keeps the sweep fused without exploding program size when
    # hundreds of steps stack in one lax.scan rollout.
    return jax.lax.fori_loop(0, iters, body, x0, unroll=4)


def lin_solve_2d(b: int, x, x0, a: float, c: float, obst, iters: int = 20):
    """The reference ``LinearSolveWithJobs`` (FluidSim.cs:1359-1415).

    Fixed-rhs Jacobi from initial guess ``x``; skipped cells (walls and
    obstacles) copy the previous iterate; ``set_bnd`` after every sweep.
    """
    obst_int = obst[1:-1, 1:-1]
    x0_int = x0[1:-1, 1:-1]

    def body(_, x):
        upd = (x0_int + a * _nbr_sum_2d(x)) / c
        out = x.at[1:-1, 1:-1].set(jnp.where(obst_int, x[1:-1, 1:-1], upd))
        return set_bnd_2d(b, out, obst)

    return jax.lax.fori_loop(0, iters, body, x, unroll=4)


def diffuse_2d(b: int, x0, diff: float, dt: float, obst, cfg):
    """The reference ``Diffuse`` (FluidSim.cs:740-745).

    ``a = dt·diff·(N-2)²``, ``c = 1 + 6a`` (float32, reference order), then
    the 20-sweep smoothing solve followed (if ``cfg.double_diffuse``) by the
    20-sweep fixed-rhs solve — the reference's 40-sweep quirk.
    """
    n = x0.shape[0]
    a = float(
        np.float32(dt) * np.float32(diff) * np.float32(n - 2) * np.float32(n - 2)
    )
    c = float(np.float32(1.0) + np.float32(6.0) * np.float32(a))
    iters = cfg.jacobi_iters
    x = diffuse_smooth_2d(b, x0, a, c, obst, iters)
    if cfg.double_diffuse:
        x = lin_solve_2d(b, x, x0, a, c, obst, iters)
    return x


# ----------------------------------------------------------------------
# 3D
# ----------------------------------------------------------------------

def jacobi_3d(b: int, x, x0, a: float, c: float, obst, iters: int,
              unroll: int = 4):
    """Fixed-rhs Jacobi sweep in 3D with fused boundary handling.

    ``x_{k+1} = (x0 + a·Σ₆ x_k) / c`` on interior non-obstacle cells;
    obstacle cells copy the previous iterate; ``set_bnd_3d`` after each
    sweep.  ``obst=None`` statically removes the obstacle branches.

    Each sweep is one fused XLA pass: the interior update is zero-padded
    back to full shape and ``set_bnd_3d`` rewrites the entire border from
    interior values (every border cell is covered by a face plane, so the
    pad zeros never survive — proven by the face-pass data-flow).
    """
    in_dtype = x.dtype
    if in_dtype != jnp.float32:
        # bf16 field storage: the fixed-point iteration accumulates in f32
        # (8 mantissa bits would dominate the 60-iteration residual).
        x = x.astype(jnp.float32)
        x0 = x0.astype(jnp.float32)

    core = (slice(1, -1),) * 3
    x0_int = x0[core]
    obst_int = obst[core] if obst is not None else None

    def body(_, x):
        upd = (x0_int + a * _nbr_sum_3d(x)) / c
        if obst_int is not None:
            upd = jnp.where(obst_int, x[core], upd)
        full = jax.lax.pad(upd, jnp.asarray(0.0, x.dtype), [(1, 1, 0)] * 3)
        return set_bnd_3d(b, full, obst)

    out = jax.lax.fori_loop(0, iters, body, x, unroll=unroll)
    return out.astype(in_dtype)


def diffuse_3d(b: int, x0, diff: float, dt: float, obst, cfg):
    """3D diffusion: ``a = dt·diff·(N-2)²``, ``c = 1 + 6a`` (six neighbors —
    the constant the reference inherited is actually correct in 3D)."""
    n = x0.shape[-1]
    a = float(
        np.float32(dt) * np.float32(diff) * np.float32(n - 2) * np.float32(n - 2)
    )
    c = float(np.float32(1.0) + np.float32(6.0) * np.float32(a))
    return jacobi_3d(b, x0, x0, a, c, obst, cfg.jacobi_iters)
