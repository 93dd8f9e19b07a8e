"""Spectral Poisson projection — an exact alternative to the
reference's 20-iter Jacobi pressure solve.

The reference's projection (FluidSim.cs:1417-1521) under-converges: Jacobi
damps low-frequency pressure modes slowly (and in 2D its ``c = 6`` is the
wrong diagonal).  FFTs are fast XLA primitives, so a closed-box
smoke solver can afford an *exact* solve.  This is the
``pressure_solver="fft"`` option for obstacle-free 3D scenes — not a
parity path (the reference cannot express it).

Discretization notes:

* The solver family's divergence and gradient are central differences
  with effective spacing 2 (FluidSim.cs:1089-1092, 1120-1121), so the
  composed operator ``div∘grad`` is the **wide** Laplacian
  ``Σ_axis p(x±2) − 2p(x)`` divided by 4.  Solving with the matching wide
  eigenvalues makes the projected field's central-difference divergence
  vanish *identically* — up to the operator's checkerboard null space,
  which no solver of this discretization can remove.
* Closed-box (no-flux) walls are imposed by mirror extension to length
  2N per axis: the wall-normal velocity component is odd-extended
  (zero at the wall), tangential components and pressure even-extended —
  the spectral analog of the ``set_bnd`` rules.  The periodic solve on
  the extension then restricts to the Neumann solution.
* Zero-eigenvalue modes (mean + checkerboard null space) are projected
  out.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _mirror(f, parities):
    """Extend to 2N per axis: ``[f, ±reverse(f)]`` with the given parity
    (+1 even, −1 odd) per axis."""
    for ax, s in enumerate(parities):
        f = jnp.concatenate([f, s * jnp.flip(f, axis=ax)], axis=ax)
    return f


def _crop(f, n):
    return f[tuple(slice(0, n) for _ in range(f.ndim))]


def _cdiff(f, axis):
    """Central difference (f(x+1) − f(x−1))/2, periodic (valid on the
    mirror extension)."""
    return 0.5 * (jnp.roll(f, -1, axis) - jnp.roll(f, 1, axis))


def _wide_inv_eigenvalues(shape_ext, rfft_axis_len):
    """1/eigenvalue of the wide Laplacian ``Σ p(x±2) − 2p`` on the
    periodic extension; 0 where the eigenvalue (numerically) vanishes."""
    dims = len(shape_ext)
    total = None
    for ax in range(dims):
        m = shape_ext[ax]
        if ax == dims - 1:
            freqs = np.arange(rfft_axis_len, dtype=np.float64) / m
        else:
            freqs = np.fft.fftfreq(m)
        lam = 2.0 * np.cos(4.0 * np.pi * freqs) - 2.0
        bshape = [1] * dims
        bshape[ax] = len(freqs)
        lam = lam.reshape(bshape)
        total = lam if total is None else total + lam
    inv = np.where(np.abs(total) > 1e-8, 1.0 / np.where(total == 0, 1, total),
                   0.0)
    return jnp.asarray(inv, jnp.float32)


def project_3d_fft(vel):
    """Exact wide-operator projection of a ``(3, N, N, N)`` velocity field
    (obstacle-free closed box).  Returns (vel, p) with p cropped to N³."""
    n = vel.shape[-1]
    dtype = vel.dtype

    # Axis order of fields is [z, y, x]; component c points along grid
    # axis 2−c.  Normal component is odd across its own walls.
    parities = {
        0: (1, 1, -1),   # vx: odd along x (axis 2)
        1: (1, -1, 1),   # vy: odd along y (axis 1)
        2: (-1, 1, 1),   # vz: odd along z (axis 0)
    }
    ext = [
        _mirror(vel[c].astype(jnp.float32), parities[c]) for c in range(3)
    ]

    div = _cdiff(ext[0], 2) + _cdiff(ext[1], 1) + _cdiff(ext[2], 0)

    # div∘grad = wide_lap/4  ⇒  wide_lap(p) = 4·div
    rhs_hat = jnp.fft.rfftn(4.0 * div)
    inv = _wide_inv_eigenvalues(div.shape, rhs_hat.shape[-1])
    p_ext = jnp.fft.irfftn(rhs_hat * inv, s=div.shape)

    out = jnp.stack([
        ext[0] - _cdiff(p_ext, 2),
        ext[1] - _cdiff(p_ext, 1),
        ext[2] - _cdiff(p_ext, 0),
    ])
    return (
        jnp.stack([_crop(out[c], n) for c in range(3)]).astype(dtype),
        _crop(p_ext, n).astype(dtype),
    )
