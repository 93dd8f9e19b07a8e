"""Interaction forces — the mouse-drag math as a scriptable API.

Reference: ``Update()``'s drag handling (FluidSim.cs:414-436) and
``AddForceToArea`` (FluidSim.cs:452-483).  The engine has no mouse; the
same math is exposed as pure functions the host driver can call with any
pointer trajectory (interactive viewer, replay file, or test script).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..config import SimConfig


def add_force_to_area(vel, density, center, force, radius,
                      source_strength: float):
    """``AddForceToArea`` (FluidSim.cs:452-483), vectorized.

    Applies ``force·(1 − dist/radius)`` to velocity within ``radius`` of
    ``center`` (grid coords, (x, y[, z])) and adds
    ``source_strength·falloff`` density within the inner 30 % of the radius.
    """
    shape = density.shape
    dtype = density.dtype
    ranges = [jnp.arange(s, dtype=dtype) for s in shape]
    grids = jnp.meshgrid(*ranges, indexing="ij")
    coords = tuple(reversed(grids))  # (x, y[, z])

    dist = jnp.sqrt(sum((c - jnp.asarray(p, dtype)) ** 2
                        for c, p in zip(coords, center)))
    radius = jnp.asarray(radius, dtype)
    in_radius = dist <= radius
    falloff = jnp.where(in_radius, 1.0 - dist / radius, 0.0)

    for c, f in enumerate(force):
        vel = vel.at[c].add(jnp.asarray(f, dtype) * falloff)

    inner = dist < radius * 0.3
    density = density + jnp.where(inner, source_strength * falloff, 0.0)
    return vel, density


def mouse_drag_force(prev_pos: Tuple[float, ...], cur_pos: Tuple[float, ...],
                     cfg: SimConfig):
    """The reference's drag→force mapping (FluidSim.cs:419-432).

    Returns (center, force_vector, radius) for ``add_force_to_area``:
    ``|Δ|^1.5 · 0.8`` along the drag direction, radius
    ``clamp(|Δ|·0.5, 2, 10)``.
    """
    delta = np.asarray(cur_pos, np.float32) - np.asarray(prev_pos, np.float32)
    mag = float(np.linalg.norm(delta) * np.float32(cfg.resolution_multiplier))
    if mag == 0.0:
        return cur_pos, tuple(0.0 for _ in cur_pos), 2.0
    direction = delta / np.linalg.norm(delta)
    scaled = np.float32(mag) ** np.float32(1.5) * np.float32(0.8)
    radius = float(np.clip(mag * 0.5, 2.0, 10.0))
    return cur_pos, tuple(float(d * scaled) for d in direction), radius


def screen_to_grid(screen_pos, viewport_min, viewport_max, grid_size: int):
    """Screen/world position → grid coordinates.

    The reference maps the mouse through the camera ray and the render
    quad's world-space corner bounds (``GetMousePositionInGrid``,
    FluidSim.cs:535-549): ``normalized = (world − min)/(max − min)``,
    ``grid = normalized · N``.  Here the caller supplies the viewport
    bounds (there is no camera); any windowing layer can drive the
    interaction API with this mapping.
    """
    p = np.asarray(screen_pos, np.float32)
    lo = np.asarray(viewport_min, np.float32)
    hi = np.asarray(viewport_max, np.float32)
    normalized = (p - lo) / (hi - lo)
    return tuple(float(v) for v in normalized * np.float32(grid_size))
