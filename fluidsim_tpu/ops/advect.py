"""Semi-Lagrangian advection.

Reference: ``AdvectJob`` (FluidSim.cs:1125-1186) + ``AdvectWithJobs``
(FluidSim.cs:1523-1576).  Backtrace ``x = i − dt0·u`` with
``dt0 = dt·(N−2)``, clamp to ``[0.5, N−1.5]``, bilinear interpolation.
The output buffer is freshly zero-allocated per call (FluidSim.cs:1529), so
wall cells and obstacle cells come out 0 before ``set_bnd`` runs — including
density at obstacles (the "leave unchanged" comment at FluidSim.cs:1154 is
dead code against a zero buffer).

The bilinear/trilinear sample is a vectorized gather; the whole op fuses
into the step program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .boundary import set_bnd_2d, set_bnd_3d


def _backtrace_1d(coord, vel, dt0, n):
    """Clamped backtrace along one axis: returns (i0, frac) with
    i0 = floor(clamp(coord - dt0*vel, 0.5, n-1.5))."""
    x = coord - dt0 * vel
    x = jnp.where(x < 0.5, 0.5, x)
    x = jnp.where(x > n - 1.5, jnp.asarray(n - 1.5, x.dtype), x)
    i0 = jnp.floor(x).astype(jnp.int32)
    return i0, x - i0.astype(x.dtype)


def advect_2d(b: int, d0, vel_x, vel_y, dt: float, obst):
    """Exact reference advection. Arrays are ``[y, x]``; ``b`` static."""
    n = d0.shape[0]
    dt0 = np.float32(dt) * np.float32(n - 2)

    cdt = jnp.float32  # compute dtype: coords/fracs need f32 even for
    # bf16 storage (integers > 256 are not exact in bf16)
    jj, ii = jnp.meshgrid(
        jnp.arange(n, dtype=cdt), jnp.arange(n, dtype=cdt),
        indexing="ij",
    )
    i0, s1 = _backtrace_1d(ii, vel_x.astype(cdt), dt0, n)
    j0, t1 = _backtrace_1d(jj, vel_y.astype(cdt), dt0, n)
    s0 = 1.0 - s1
    t0 = 1.0 - t1
    i1 = i0 + 1
    j1 = j0 + 1

    # Bilinear sample, reference term order (FluidSim.cs:1183-1184).
    val = s0 * (t0 * d0[j0, i0] + t1 * d0[j1, i0]) + s1 * (
        t0 * d0[j0, i1] + t1 * d0[j1, i1]
    )

    # Fresh zero buffer semantics: only interior non-obstacle cells written.
    out = jnp.zeros_like(d0)
    core = (slice(1, -1), slice(1, -1))
    inner = val[core].astype(d0.dtype)  # val may be an f32 accumulator
    out = out.at[core].set(jnp.where(obst[core], jnp.asarray(0.0, d0.dtype),
                                     inner))
    return set_bnd_2d(b, out, obst)


def advect_2d_pair(d0x, d0y, vel_x, vel_y, dt: float, obst):
    """Advect the two velocity components with ONE shared backtrace.

    The reference advects vx and vy by the same velocity field in two
    separate jobs (FluidSim.cs:710-711) — both backtrace from the same
    ``(vel_x, vel_y)`` with the same dt, so ``(i0, j0, s, t)`` are
    identical.  Computing them once and gathering a stacked ``[2, n, n]``
    array turns eight latency-bound gathers into four batched ones (each
    tap fetches both components per index).  Per-element arithmetic is
    unchanged — same ops, same order — so the result is bitwise equal to
    two ``advect_2d`` calls (the parity tests cover the composition).

    Returns ``(vel_x', vel_y')`` with ``set_bnd(1, ·)`` / ``set_bnd(2, ·)``
    applied.
    """
    n = d0x.shape[0]
    dt0 = np.float32(dt) * np.float32(n - 2)

    cdt = jnp.float32
    jj, ii = jnp.meshgrid(
        jnp.arange(n, dtype=cdt), jnp.arange(n, dtype=cdt),
        indexing="ij",
    )
    i0, s1 = _backtrace_1d(ii, vel_x.astype(cdt), dt0, n)
    j0, t1 = _backtrace_1d(jj, vel_y.astype(cdt), dt0, n)
    s0 = 1.0 - s1
    t0 = 1.0 - t1
    i1 = i0 + 1
    j1 = j0 + 1

    D = jnp.stack([d0x, d0y])  # [2, n, n]; taps broadcast over the pair
    val = s0 * (t0 * D[:, j0, i0] + t1 * D[:, j1, i0]) + s1 * (
        t0 * D[:, j0, i1] + t1 * D[:, j1, i1]
    )

    outs = []
    core = (slice(1, -1), slice(1, -1))
    for b, comp in ((1, val[0]), (2, val[1])):
        out = jnp.zeros_like(d0x)
        inner = comp[core].astype(d0x.dtype)
        out = out.at[core].set(
            jnp.where(obst[core], jnp.asarray(0.0, d0x.dtype), inner))
        outs.append(set_bnd_2d(b, out, obst))
    return outs[0], outs[1]


def advect_3d(b: int, d0, vel, dt: float, obst=None, window: int = 0):
    """Trilinear semi-Lagrangian advection on a ``[z, y, x]`` grid.

    ``vel`` is ``(3, N, N, N)`` with components (vx, vy, vz).  Same clamped
    backtrace and zero-buffer semantics as 2D, promoted to three axes.
    ``obst=None`` statically removes the obstacle branches.

    ``window=0`` uses an explicit 8-tap gather — exact.  ``window=K>0``
    uses a gather-free formulation: the trilinear sample as a sum of
    statically-shifted arrays weighted by per-cell hat functions,
    ``out = Σ_{|d|≤K} wz(dz)·wy(dy)·wx(dx)·shift(d0, d)``, which is
    *mathematically identical* to the gather whenever the backtrace
    displacement is < K cells; displacement is clamped to the window (a
    CFL limiter) so the result is always well-defined.  All ops are
    shifts/FMAs that XLA fuses — no gather.
    """
    if window > 0:
        return _advect_3d_window(b, d0, vel, dt, obst, window)

    n = d0.shape[-1]
    dt0 = np.float32(dt) * np.float32(n - 2)

    cdt = jnp.float32
    kk, jj, ii = jnp.meshgrid(
        jnp.arange(n, dtype=cdt),
        jnp.arange(n, dtype=cdt),
        jnp.arange(n, dtype=cdt),
        indexing="ij",
    )
    i0, s1 = _backtrace_1d(ii, vel[0].astype(cdt), dt0, n)
    j0, t1 = _backtrace_1d(jj, vel[1].astype(cdt), dt0, n)
    k0, u1 = _backtrace_1d(kk, vel[2].astype(cdt), dt0, n)
    s0, t0, u0 = 1.0 - s1, 1.0 - t1, 1.0 - u1
    i1, j1, k1 = i0 + 1, j0 + 1, k0 + 1

    def sample(k, j, i):
        return d0[k, j, i]

    val = u0 * (
        s0 * (t0 * sample(k0, j0, i0) + t1 * sample(k0, j1, i0))
        + s1 * (t0 * sample(k0, j0, i1) + t1 * sample(k0, j1, i1))
    ) + u1 * (
        s0 * (t0 * sample(k1, j0, i0) + t1 * sample(k1, j1, i0))
        + s1 * (t0 * sample(k1, j0, i1) + t1 * sample(k1, j1, i1))
    )
    return _mask_and_bnd_3d(b, val, d0, obst)


def _mask_and_bnd_3d(b, val, d0, obst):
    """Fresh-zero-buffer semantics: interior non-obstacle cells take ``val``,
    everything else 0, then ``set_bnd_3d``."""
    core = (slice(1, -1),) * 3
    inner = val[core].astype(d0.dtype)  # val may be an f32 accumulator
    if obst is not None:
        inner = jnp.where(obst[core], jnp.asarray(0.0, d0.dtype), inner)
    out = jnp.zeros_like(d0).at[core].set(inner)
    return set_bnd_3d(b, out, obst)


def _advect_3d_window(b: int, d0, vel, dt: float, obst, window: int):
    """Windowed-trilinear advection (see advect_3d docstring)."""
    n = d0.shape[-1]
    dt0 = np.float32(dt) * np.float32(n - 2)
    k_win = jnp.asarray(window, jnp.float32)

    def frac_disp(axis_idx, v, coord):
        x = coord - dt0 * v
        x = jnp.where(x < 0.5, 0.5, x)
        x = jnp.where(x > n - 1.5, jnp.asarray(n - 1.5, x.dtype), x)
        # CFL limiter: clamp the target into the window around the cell.
        x = jnp.clip(x, coord - k_win, coord + k_win)
        return x - coord

    cdt = jnp.float32
    kk, jj, ii = jnp.meshgrid(
        jnp.arange(n, dtype=cdt),
        jnp.arange(n, dtype=cdt),
        jnp.arange(n, dtype=cdt),
        indexing="ij",
    )
    fx = frac_disp(2, vel[0].astype(cdt), ii)
    fy = frac_disp(1, vel[1].astype(cdt), jj)
    fz = frac_disp(0, vel[2].astype(cdt), kk)

    def shift(arr, dz, dy, dx):
        # result[c] = arr[c + (dz,dy,dx)]; wrapped cells get zero hat weight
        # (the displacement clamp keeps targets in [0.5, n-1.5]).
        return jnp.roll(arr, (-dz, -dy, -dx), (0, 1, 2))

    out = jnp.zeros(d0.shape, jnp.float32)
    for dz in range(-window, window + 1):
        wz = jnp.maximum(0.0, 1.0 - jnp.abs(fz - dz))
        for dy in range(-window, window + 1):
            wzy = wz * jnp.maximum(0.0, 1.0 - jnp.abs(fy - dy))
            for dx in range(-window, window + 1):
                wx = jnp.maximum(0.0, 1.0 - jnp.abs(fx - dx))
                out = out + wzy * wx * shift(d0, dz, dy, dx)
    return _mask_and_bnd_3d(b, out.astype(d0.dtype), d0, obst)


def advect_multi_3d(bs, fields, vel, dt: float, obst=None, window: int = 0):
    """Advect several fields through the same velocity in one pass.

    ``fields`` is ``(C, N, N, N)``; ``bs`` the per-field boundary codes.
    The backtrace (and, in windowed mode, the per-cell hat weights) is
    computed once and shared across fields — the weight evaluation
    dominates the windowed formulation's cost, so advecting the three
    velocity components together is ~2.5× cheaper than three single-field
    calls.  Returns the stacked advected fields.
    """
    n = fields.shape[-1]
    dt0 = np.float32(dt) * np.float32(n - 2)

    cdt = jnp.float32  # f32 coords/weights even for bf16 field storage
    kk, jj, ii = jnp.meshgrid(
        jnp.arange(n, dtype=cdt),
        jnp.arange(n, dtype=cdt),
        jnp.arange(n, dtype=cdt),
        indexing="ij",
    )

    if window > 0:
        k_win = jnp.asarray(window, cdt)

        def frac_disp(v, coord):
            x = coord - dt0 * v
            x = jnp.where(x < 0.5, 0.5, x)
            x = jnp.where(x > n - 1.5, jnp.asarray(n - 1.5, x.dtype), x)
            x = jnp.clip(x, coord - k_win, coord + k_win)
            return x - coord

        fx = frac_disp(vel[0].astype(cdt), ii)
        fy = frac_disp(vel[1].astype(cdt), jj)
        fz = frac_disp(vel[2].astype(cdt), kk)

        if n >= 192:
            # Large grids: loop over the window with traced shifts
            # instead of a statically unrolled (2K+1)³ sum — O(1)
            # program size and compile time, same math.
            w_sz = 2 * window + 1

            def term(idx, acc):
                dz = idx // (w_sz * w_sz) - window
                dy = (idx // w_sz) % w_sz - window
                dx = idx % w_sz - window
                w = (
                    jnp.maximum(0.0, 1.0 - jnp.abs(fz - dz))
                    * jnp.maximum(0.0, 1.0 - jnp.abs(fy - dy))
                    * jnp.maximum(0.0, 1.0 - jnp.abs(fx - dx))
                )
                shifted = jnp.roll(fields, (-dz, -dy, -dx), (1, 2, 3))
                return acc + w[None] * shifted

            vals = jax.lax.fori_loop(
                0, w_sz ** 3, term, jnp.zeros(fields.shape, jnp.float32)
            ).astype(fields.dtype)
        else:
            out = jnp.zeros(fields.shape, jnp.float32)
            for dz in range(-window, window + 1):
                wz = jnp.maximum(0.0, 1.0 - jnp.abs(fz - dz))
                for dy in range(-window, window + 1):
                    wzy = wz * jnp.maximum(0.0, 1.0 - jnp.abs(fy - dy))
                    for dx in range(-window, window + 1):
                        w = wzy * jnp.maximum(0.0, 1.0 - jnp.abs(fx - dx))
                        shifted = jnp.roll(fields, (-dz, -dy, -dx), (1, 2, 3))
                        out = out + w[None] * shifted
            vals = out.astype(fields.dtype)
    else:
        i0, s1 = _backtrace_1d(ii, vel[0].astype(cdt), dt0, n)
        j0, t1 = _backtrace_1d(jj, vel[1].astype(cdt), dt0, n)
        k0, u1 = _backtrace_1d(kk, vel[2].astype(cdt), dt0, n)
        s0, t0, u0 = 1.0 - s1, 1.0 - t1, 1.0 - u1
        i1, j1, k1 = i0 + 1, j0 + 1, k0 + 1

        def sample(f, k, j, i):
            return f[k, j, i]

        def tri(f):
            return u0 * (
                s0 * (t0 * sample(f, k0, j0, i0) + t1 * sample(f, k0, j1, i0))
                + s1 * (t0 * sample(f, k0, j0, i1) + t1 * sample(f, k0, j1, i1))
            ) + u1 * (
                s0 * (t0 * sample(f, k1, j0, i0) + t1 * sample(f, k1, j1, i0))
                + s1 * (t0 * sample(f, k1, j0, i1) + t1 * sample(f, k1, j1, i1))
            )

        vals = jnp.stack([tri(fields[c]) for c in range(fields.shape[0])])

    return jnp.stack(
        [
            _mask_and_bnd_3d(b, vals[c], fields[c], obst)
            for c, b in enumerate(bs)
        ]
    )


def advect_maccormack_3d(bs, fields, vel, dt: float, obst=None,
                         window: int = 2, advect_fn=None):
    """MacCormack (BFECC-style) advection — second-order upgrade over the
    reference's first-order semi-Lagrangian scheme (no reference
    counterpart; ``cfg.advection_scheme='maccormack'``).

    forward  = A(φ)          (backtrace with +v)
    backward = A⁻¹(forward)  (backtrace with −v)
    φ' = clamp(forward + (φ − backward)/2, local min/max of forward's
    source cells — approximated by the (2·1+1)³ neighborhood) — the
    limiter restores monotonicity where the correction overshoots.
    """
    if advect_fn is None:
        advect_fn = lambda b_, f_, v_, d_: advect_multi_3d(
            b_, f_, v_, d_, obst, window
        )
    forward = advect_fn(bs, fields, vel, dt)
    backward = advect_fn(bs, forward, -vel, dt)
    corrected = forward + 0.5 * (fields - backward)

    # Monotonicity limiter: clamp to the face-neighborhood extremes of the
    # forward solution (cheap static shifts).
    lo = forward
    hi = forward
    for axis in (1, 2, 3):
        for s in (-1, 1):
            shifted = jnp.roll(forward, s, axis)
            lo = jnp.minimum(lo, shifted)
            hi = jnp.maximum(hi, shifted)
    limited = jnp.clip(corrected, lo, hi)

    # Re-impose the advection output contract (zero walls + set_bnd).
    out = []
    for c, b in enumerate(bs):
        out.append(_mask_and_bnd_3d(b, limited[c], fields[c], obst))
    return jnp.stack(out)


def advect_substep_3d(bs, fields, vel, dt: float, obst=None,
                      window: int = 1, n_sub: int = 2, advect_fn=None):
    """Substepped semi-Lagrangian advection (``advection_scheme='substep'``).

    ``n_sub`` sub-advections of ``dt/n_sub`` each, re-interpolating through
    the *same* velocity field — the composition follows curved
    characteristics (midpoint-rule flavor) instead of one straight-line
    backtrace, and each substep's displacement shrinks by ``n_sub``, so a
    small window (K=1) stays exact for flows whose full-step displacement
    would need K=n_sub: 2·27 hat terms instead of 5³ = 125 for K=2.
    Slightly more dissipative per step (one extra interpolation); no
    reference counterpart.
    """
    if advect_fn is None:
        advect_fn = lambda b_, f_, v_, d_: advect_multi_3d(
            b_, f_, v_, d_, obst, window
        )
    sub_dt = float(np.float32(dt) / np.float32(n_sub))
    out = fields
    for _ in range(n_sub):
        out = advect_fn(bs, out, vel, sub_dt)
    return out
