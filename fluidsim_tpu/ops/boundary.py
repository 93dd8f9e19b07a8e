"""Boundary conditions (the reference's ``set_bnd``).

The reference runs a *single-threaded* ``BoundaryJob`` between every Jacobi
sweep (FluidSim.cs:1235-1289) — its sequential bottleneck.  Here the same
semantics become a handful of masked slice updates that XLA fuses into the
surrounding stencil; there is no serialization.

Exact 2D semantics reproduced (FluidSim.cs:1243-1288):

* Wall edges (excluding corners): copy the adjacent interior value, negated
  for the velocity component normal to the wall (``b==1`` for x-walls,
  ``b==2`` for y-walls).  Edge writes read only interior cells, so order is
  irrelevant.
* Corners: average of the two adjacent *edge* cells, computed after the edge
  update (FluidSim.cs:1255-1258).
* Interior obstacle cells (``b==1``/``b==2`` only): the negated average of
  the non-obstacle neighbors along the component axis; 0 if both neighbors
  are obstacles (FluidSim.cs:1261-1287).  Scalar fields (``b==0``) leave
  obstacle cells untouched.

The 3D variant generalizes these rules (the reference is 2D-only; there is
no 3D ground truth to match): faces mirror/negate from the adjacent interior
plane, applied sequentially per axis so shared edges take the last axis's
value; the obstacle mirror extends to the z pair for ``b==3``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def interior_mask(shape, dtype=bool):
    """Mask of cells with all coordinates in [1, N-2] (the solver interior)."""
    m = np.zeros(shape, dtype=bool)
    m[(slice(1, -1),) * len(shape)] = True
    return jnp.asarray(m, dtype=dtype)


def _mirror_obstacles_axis(x, obst, axis):
    """Obstacle mirror along one axis (FluidSim.cs:1269-1284), vectorized.

    Writes only obstacle cells in the interior (all coords 1..N-2); reads
    only non-obstacle neighbor cells, so there is no sequential dependency.
    """
    core = (slice(1, -1),) * x.ndim

    def shifted(arr, delta):
        idx = list(core)
        idx[axis] = slice(1 + delta, arr.shape[axis] - 1 + delta)
        return arr[tuple(idx)]

    prev_fluid = ~shifted(obst, -1)
    next_fluid = ~shifted(obst, +1)
    total = jnp.where(prev_fluid, -shifted(x, -1), 0.0) + jnp.where(
        next_fluid, -shifted(x, +1), 0.0
    )
    count = prev_fluid.astype(x.dtype) + next_fluid.astype(x.dtype)
    mirrored = jnp.where(count > 0, total / jnp.maximum(count, 1.0), 0.0)
    inner = x[core]
    return x.at[core].set(jnp.where(obst[core], mirrored, inner))


def set_bnd_2d(b: int, x, obst):
    """Exact reference ``BoundaryJob`` (FluidSim.cs:1235-1289). ``b`` static.

    Arrays are ``[y, x]``; ``b==1`` negates across x-walls (columns 0/N-1),
    ``b==2`` across y-walls (rows 0/N-1).
    """
    sx = -1.0 if b == 1 else 1.0
    sy = -1.0 if b == 2 else 1.0

    # Wall edges, excluding corners (rows/cols 1..N-2).
    x = x.at[1:-1, 0].set(sx * x[1:-1, 1])
    x = x.at[1:-1, -1].set(sx * x[1:-1, -2])
    x = x.at[0, 1:-1].set(sy * x[1, 1:-1])
    x = x.at[-1, 1:-1].set(sy * x[-2, 1:-1])

    # Corners, from the just-updated edges (FluidSim.cs:1255-1258).
    x = x.at[0, 0].set(0.5 * (x[0, 1] + x[1, 0]))
    x = x.at[-1, 0].set(0.5 * (x[-1, 1] + x[-2, 0]))
    x = x.at[0, -1].set(0.5 * (x[0, -2] + x[1, -1]))
    x = x.at[-1, -1].set(0.5 * (x[-1, -2] + x[-2, -1]))

    # Interior obstacle mirroring — velocity components only.
    if b == 1:
        x = _mirror_obstacles_axis(x, obst, axis=1)
    elif b == 2:
        x = _mirror_obstacles_axis(x, obst, axis=0)
    return x


def _axis_index(shape, axis):
    import jax

    return jax.lax.broadcasted_iota(jnp.int32, shape, axis)


def _shift_to_face(x, axis):
    """(low, high): low[t] = x[t+1 along axis], high[t] = x[t−1 along axis]
    (zero-filled past the border; only read at the faces)."""
    nd = x.ndim
    pad_lo = [(0, 0)] * nd
    pad_lo[axis] = (0, 1)
    sl_lo = [slice(None)] * nd
    sl_lo[axis] = slice(1, None)
    low = jnp.pad(x, pad_lo)[tuple(sl_lo)]
    pad_hi = [(0, 0)] * nd
    pad_hi[axis] = (1, 0)
    sl_hi = [slice(None)] * nd
    sl_hi[axis] = slice(None, -1)
    high = jnp.pad(x, pad_hi)[tuple(sl_hi)]
    return low, high


def apply_faces_3d(b: int, x):
    """Wall faces of a [z, y, x] array, applied z→y→x (later write wins at
    shared edges/corners).  Fused masked formulation — equivalent to the
    sequential face updates but a single XLA fusion, no scatter chain."""
    for axis, neg_b in ((0, 3), (1, 2), (2, 1)):
        s = -1.0 if b == neg_b else 1.0
        idx = _axis_index(x.shape, axis)
        n = x.shape[axis]
        low, high = _shift_to_face(x, axis)
        x = jnp.where(idx == 0, s * low, jnp.where(idx == n - 1, s * high, x))
    return x


def set_bnd_3d(b: int, x, obst=None):
    """3D boundary conditions. Arrays are ``[z, y, x]``.

    ``b``: 0 scalar, 1 = vx (x-walls negate), 2 = vy, 3 = vz.
    Faces are mirrored from the adjacent interior plane, applied z→y→x so
    shared edges/corners take the later write (a standard 3D generalization
    of the reference's 2D rule; the reference has no 3D mode).

    ``obst=None`` statically disables the obstacle mirror (the
    no-obstacle specialization — cfg.enable_obstacle is a static config).
    """
    x = apply_faces_3d(b, x)
    if obst is not None:
        if b == 1:
            x = _mirror_obstacles_axis(x, obst, axis=2)
        elif b == 2:
            x = _mirror_obstacles_axis(x, obst, axis=1)
        elif b == 3:
            x = _mirror_obstacles_axis(x, obst, axis=0)
    return x
