"""Independent NumPy oracle for the 3D solver.

A from-scratch float32 NumPy transliteration of the *documented* 3D
generalization of the reference's 2D rules (SURVEY.md §2.2-2.6 promoted to
six neighbors; the reference itself is 2D-only — FluidSim.cs:1034-1289):

* faces mirror/negate from the adjacent interior plane, applied z→y→x so
  shared edges take the later axis's value;
* obstacle cells mirror the negated average of fluid neighbors along the
  component axis;
* fixed-rhs Jacobi ``x ← (x0 + a·Σ₆ x)/c`` with boundaries re-applied
  after every sweep, skipped cells copying the previous iterate;
* semi-Lagrangian advection with ``dt0 = dt·(N−2)``, clamp ``[0.5, N−1.5]``
  (FluidSim.cs:1526, 1162-1168), trilinear interpolation, fresh-zero output
  buffer (FluidSim.cs:1529);
* projection: ``div = −0.5·(∂x+∂y+∂z)/N``, 20-iter Jacobi ``a=1, c=6``,
  gradient subtraction ``v −= 0.5·N·∂p`` (FluidSim.cs:1071-1123).

Written against the *spec*, not the JAX code: boundary faces use explicit
slice assignment (not masked selects), advection uses fancy-indexed
gathers (not shifted-window sums), sweeps use np.pad-free interior views.
This catches consistent-but-wrong bugs that comparing two JAX
formulations with each other cannot (they share a formulation family).
"""

from __future__ import annotations

import numpy as np

F = np.float32


def _signs(b: int):
    """(sz, sy, sx) wall mirror signs: b=1 negates x faces, 2 y, 3 z."""
    return (
        F(-1.0) if b == 3 else F(1.0),
        F(-1.0) if b == 2 else F(1.0),
        F(-1.0) if b == 1 else F(1.0),
    )


def set_bnd_3d(b: int, x, obst=None):
    """Faces z→y→x (later write wins), then the obstacle mirror for
    velocity components."""
    x = x.astype(F).copy()
    sz, sy, sx = _signs(b)
    x[0, :, :] = sz * x[1, :, :]
    x[-1, :, :] = sz * x[-2, :, :]
    x[:, 0, :] = sy * x[:, 1, :]
    x[:, -1, :] = sy * x[:, -2, :]
    x[:, :, 0] = sx * x[:, :, 1]
    x[:, :, -1] = sx * x[:, :, -2]

    if obst is not None and b in (1, 2, 3):
        axis = {1: 2, 2: 1, 3: 0}[b]
        x = _mirror_obstacles(x, np.asarray(obst, bool), axis)
    return x


def _mirror_obstacles(x, obst, axis):
    """Interior obstacle cells take the negated average of their fluid
    neighbors along ``axis`` (0 if both neighbors are obstacles)."""
    out = x.copy()
    n = x.shape[0]
    it = np.argwhere(obst)
    for k, j, i in it:
        if not (1 <= k <= n - 2 and 1 <= j <= n - 2 and 1 <= i <= n - 2):
            continue
        idx = [k, j, i]
        lo = idx.copy()
        hi = idx.copy()
        lo[axis] -= 1
        hi[axis] += 1
        total = F(0.0)
        count = F(0.0)
        if not obst[tuple(lo)]:
            total = total + (-x[tuple(lo)])
            count += F(1.0)
        if not obst[tuple(hi)]:
            total = total + (-x[tuple(hi)])
            count += F(1.0)
        out[k, j, i] = total / count if count > 0 else F(0.0)
    return out


def lin_solve_3d(b: int, x, x0, a, c, obst, iters):
    """Fixed-rhs Jacobi; obstacle cells copy the previous iterate;
    set_bnd after every sweep."""
    a = F(a)
    c = F(c)
    x = x.astype(F).copy()
    x0 = np.asarray(x0, F)
    n = x.shape[0]
    core = (slice(1, -1),) * 3
    for _ in range(iters):
        nbr = (
            (x[1:-1, 1:-1, 2:] + x[1:-1, 1:-1, :-2])
            + (x[1:-1, 2:, 1:-1] + x[1:-1, :-2, 1:-1])
        ) + (x[2:, 1:-1, 1:-1] + x[:-2, 1:-1, 1:-1])
        upd = (x0[core] + a * nbr) / c
        new = x.copy()
        if obst is not None:
            o = np.asarray(obst, bool)[core]
            new[core] = np.where(o, x[core], upd)
        else:
            new[core] = upd
        x = set_bnd_3d(b, new, obst)
    return x


def diffuse_3d(b: int, x0, diff, dt, obst, iters):
    """``a = dt·diff·(N−2)²``, ``c = 1+6a`` (FluidSim.cs:744 constants,
    actually correct for six neighbors)."""
    n = x0.shape[0]
    a = F(dt) * F(diff) * F(n - 2) * F(n - 2)
    c = F(1.0) + F(6.0) * a
    return lin_solve_3d(b, np.asarray(x0, F), x0, a, c, obst, iters)


def advect_3d(b: int, d0, vel, dt, obst=None, window: int = 0):
    """Backtrace + trilinear gather; fresh-zero buffer; set_bnd.

    ``window=K`` additionally clamps the backtrace target into
    ``[coord−K, coord+K]`` per axis (the product's CFL limiter) so the
    oracle covers the windowed formulation too.
    """
    d0 = np.asarray(d0, F)
    n = d0.shape[0]
    dt0 = F(dt) * F(n - 2)

    kk, jj, ii = np.meshgrid(
        np.arange(n, dtype=F), np.arange(n, dtype=F), np.arange(n, dtype=F),
        indexing="ij",
    )

    def backtrace(coord, v):
        t = coord - dt0 * np.asarray(v, F)
        t = np.where(t < F(0.5), F(0.5), t)
        t = np.where(t > F(n - 1.5), F(n - 1.5), t)
        if window > 0:
            t = np.clip(t, coord - F(window), coord + F(window))
        return t

    xs = backtrace(ii, vel[0])
    ys = backtrace(jj, vel[1])
    zs = backtrace(kk, vel[2])

    i0 = np.floor(xs).astype(np.int64)
    j0 = np.floor(ys).astype(np.int64)
    k0 = np.floor(zs).astype(np.int64)
    s1 = (xs - i0.astype(F)).astype(F)
    t1 = (ys - j0.astype(F)).astype(F)
    u1 = (zs - k0.astype(F)).astype(F)
    s0, t0, u0 = F(1.0) - s1, F(1.0) - t1, F(1.0) - u1
    i1, j1, k1 = i0 + 1, j0 + 1, k0 + 1

    def g(k, j, i):
        return d0[k, j, i]

    val = u0 * (
        s0 * (t0 * g(k0, j0, i0) + t1 * g(k0, j1, i0))
        + s1 * (t0 * g(k0, j0, i1) + t1 * g(k0, j1, i1))
    ) + u1 * (
        s0 * (t0 * g(k1, j0, i0) + t1 * g(k1, j1, i0))
        + s1 * (t0 * g(k1, j0, i1) + t1 * g(k1, j1, i1))
    )

    out = np.zeros_like(d0)
    core = (slice(1, -1),) * 3
    inner = val[core]
    if obst is not None:
        inner = np.where(np.asarray(obst, bool)[core], F(0.0), inner)
    out[core] = inner
    return set_bnd_3d(b, out, obst)


def project_3d(vel, obst=None, iters: int = 20):
    """Divergence → Jacobi(a=1, c=6) → gradient subtraction.  Returns
    (vel, p)."""
    vel = np.asarray(vel, F).copy()
    n = vel.shape[-1]
    nf = F(n)
    core = (slice(1, -1),) * 3
    vx, vy, vz = vel[0], vel[1], vel[2]

    div = np.zeros((n, n, n), F)
    div[core] = (
        F(-0.5)
        * (
            (vx[1:-1, 1:-1, 2:] - vx[1:-1, 1:-1, :-2])
            + (vy[1:-1, 2:, 1:-1] - vy[1:-1, :-2, 1:-1])
            + (vz[2:, 1:-1, 1:-1] - vz[:-2, 1:-1, 1:-1])
        )
        / nf
    )
    div = set_bnd_3d(0, div, obst)
    p = set_bnd_3d(0, np.zeros((n, n, n), F), obst)
    p = lin_solve_3d(0, p, div, 1.0, 6.0, obst, iters)

    gx = F(0.5) * (p[1:-1, 1:-1, 2:] - p[1:-1, 1:-1, :-2]) * nf
    gy = F(0.5) * (p[1:-1, 2:, 1:-1] - p[1:-1, :-2, 1:-1]) * nf
    gz = F(0.5) * (p[2:, 1:-1, 1:-1] - p[:-2, 1:-1, 1:-1]) * nf
    if obst is not None:
        o = np.asarray(obst, bool)[core]
        gx = np.where(o, F(0.0), gx)
        gy = np.where(o, F(0.0), gy)
        gz = np.where(o, F(0.0), gz)
    vx[core] = vx[core] - gx
    vy[core] = vy[core] - gy
    vz[core] = vz[core] - gz
    vx = set_bnd_3d(1, vx, obst)
    vy = set_bnd_3d(2, vy, obst)
    vz = set_bnd_3d(3, vz, obst)
    return np.stack([vx, vy, vz]), p


def buoyancy(vel, density, dt, buoy, ambient=0.0, gravity=0.0):
    """Upward y-force ∝ (ρ − ambient), downward ∝ gravity·ρ."""
    vel = np.asarray(vel, F).copy()
    accel = F(buoy) * (np.asarray(density, F) - F(ambient)) - F(gravity) * np.asarray(density, F)
    vel[1] = vel[1] + F(dt) * accel
    return vel


def simulate_step_3d(density, vel, dt, diff, visc, jacobi_iters,
                     buoy=0.0, ambient=0.0, obst=None,
                     double_project=False, advect_window=0):
    """The product step order (models/stable3d.py) for configs without
    vorticity/turbulence/drag: buoyancy → [diffuse] → [pre-project] →
    self-advect → project → [density diffuse] → density advect."""
    if buoy != 0.0:
        vel = buoyancy(vel, density, dt, buoy, ambient)
    if visc > 0.0:
        vel = np.stack(
            [diffuse_3d(c + 1, vel[c], visc, dt, obst, jacobi_iters)
             for c in range(3)]
        )
    if double_project:
        vel, _ = project_3d(vel, obst, jacobi_iters)
    vel0 = vel
    vel = np.stack(
        [advect_3d(c + 1, vel0[c], vel0, dt, obst, advect_window)
         for c in range(3)]
    )
    vel, p = project_3d(vel, obst, jacobi_iters)
    if diff > 0.0:
        density = diffuse_3d(0, density, diff, dt, obst, jacobi_iters)
    density = advect_3d(0, density, vel, dt, obst, advect_window)
    return density, vel, p
