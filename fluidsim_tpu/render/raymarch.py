"""On-device volumetric raymarcher — the 3D replacement for Unity's
texture/quad render path (SURVEY.md §7.7; BASELINE config 4).

Emission–absorption integration along axis-aligned rays through the
density volume.  The camera looks down −z of the ``[z, y, x]`` grid
(orthographic), so each image pixel (y, x) integrates over z — the march
is a single ``lax.scan``/``associative_scan``-free cumulative pass over z
planes, fully fused on device: step + render never leaves the device.

Transfer function: density → (color, extinction) via the 2D colormap
machinery (density-based mode) or a constant emission tint; obstacles are
opaque gray occluders (FluidSim.cs:1894-1899 analog).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SimConfig


def raymarch_density(density, obstacles=None, *, axis: int = 0,
                     absorption: float = 0.04,
                     emission_color=(1.0, 1.0, 1.0),
                     density_scale: float = 0.02,
                     background=(0.0, 0.0, 0.0)):
    """Front-to-back emission–absorption along ``axis``.

    Per plane k: α_k = 1 − exp(−absorption·d_k), radiance e_k = tint·d_k·
    density_scale; composited front-to-back with early-saturating
    transmittance.  Obstacle voxels are opaque (α = 1, gray).

    Returns an (N, N, 3) image (the two non-marched axes).
    """
    dtype = density.dtype
    tint = jnp.asarray(emission_color, dtype)
    gray = jnp.asarray([0.5, 0.5, 0.5], dtype)
    bg = jnp.asarray(background, dtype)

    d = jnp.moveaxis(density, axis, 0)
    if obstacles is not None:
        ob = jnp.moveaxis(obstacles, axis, 0)
    else:
        ob = None

    n = d.shape[0]

    # Parallel formulation: the front-to-back recurrence
    #   acc += T_k·α_k·c_k,  T_{k+1} = T_k·(1−α_k)
    # is a prefix product, T_k = Π_{j<k}(1−α_j) = exp(Σ_{j<k} log1p(−α_j)),
    # so the whole march is one log-space *exclusive cumsum* over z plus a
    # weighted reduction — fully vectorized, no sequential scan (a
    # 128-plane lax.scan of tiny bodies costs ~30 ms on-device; this runs
    # in one fused pass).  Opaque voxels (α=1) give log1p(−1) = −inf,
    # which correctly zeroes the transmittance of everything behind them.
    alpha = 1.0 - jnp.exp(-absorption * d)
    color = tint[None, None, None, :] * (d * density_scale)[..., None]
    if ob is not None:
        alpha = jnp.where(ob, jnp.asarray(1.0, dtype), alpha)
        color = jnp.where(ob[..., None], gray, color)

    log_keep = jnp.log1p(-alpha)
    cum = jnp.cumsum(log_keep, axis=0)
    # Exclusive prefix via shift (NOT cum − log_keep: −inf−(−inf) = NaN at
    # opaque voxels).
    excl = jnp.concatenate([jnp.zeros_like(cum[:1]), cum[:-1]], axis=0)
    trans_excl = jnp.exp(excl)               # T_k (exclusive prefix)
    # (A no-obstacle fast path factoring the tint out of the z reduction
    # — avoiding the (N,N,N,3) color volume — measured exactly neutral:
    # XLA already fuses the channel broadcast into the reduction.)
    acc = jnp.sum((trans_excl * alpha)[..., None] * color, axis=0)
    trans_total = jnp.exp(cum[-1])
    return acc + trans_total[..., None] * bg


def render_frame_3d(state, cfg: SimConfig, *, axis: int = 0,
                    absorption: Optional[float] = None):
    """Render one frame of a 3D state on device. Returns (N, N, 3).

    The transfer scale adapts to the configured density thresholds so the
    same scene parameters that drive the 2D color modes drive the volume
    look: densities around ``medium_density_threshold`` read as mid-gray.
    """
    if absorption is None:
        absorption = float(2.0 / max(cfg.medium_density_threshold, 1e-3))
    tint = cfg.fluid_color[:3]
    return raymarch_density(
        state.density,
        state.obstacles if cfg.enable_obstacle else None,
        axis=axis,
        absorption=absorption,
        emission_color=tint,
        density_scale=float(1.0 / max(cfg.high_density_threshold, 1e-3)),
    )
