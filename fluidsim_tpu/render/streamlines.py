"""Streamline visualization.

Reference pipeline (FluidSim.cs:886-976, 1657-1849):

1. ``StreamlineCalculationJob`` — on a subsampled seed grid
   (``skip = max(1, N // (density·10))``, seeds at ``(x·skip+skip,
   y·skip+skip)``), compute flow angle and length
   ``min(skip−1, |v|·scale)``; obstacle seeds and ``|v| < 0.01`` are
   invalid (FluidSim.cs:1680-1727).
2. ``StreamlineDrawJob`` — convert to line segments (FluidSim.cs:1739-1762).
3. CPU Bresenham rasterization with thickness (FluidSim.cs:1765-1849) —
   scatter-heavy, tiny, and left on the host by design (the reference
   does the same to avoid write races).

Steps 1–2 run on device as fused vector ops.  Step 3 uses the native C++
rasterizer (native/rasterizer.cpp via ctypes) with a NumPy fallback of
identical semantics.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..config import SimConfig

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native",
                 "librasterizer.so"),
    os.path.join(os.path.dirname(__file__), "librasterizer.so"),
]


def _load_native():
    for p in _LIB_PATHS:
        p = os.path.abspath(p)
        if os.path.exists(p):
            try:
                lib = ctypes.CDLL(p)
                lib.draw_segments.argtypes = [
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_int, ctypes.c_float,
                ]
                lib.composite_over.argtypes = [
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ]
                return lib
            except OSError:
                continue
    return None


_NATIVE = _load_native()


def streamline_skip(cfg: SimConfig) -> int:
    """skip = max(1, N // (streamlineDensity·10)) (FluidSim.cs:892)."""
    return max(1, cfg.current_size // (cfg.streamline_density * 10))


def compute_streamline_segments(vel_x, vel_y, obstacles, cfg: SimConfig):
    """Steps 1–2 on device. Returns an (M, 4) array of segments
    (x0, y0, x1, y1); invalid entries have x0 = −1 (FluidSim.cs:1744-1748).
    """
    n = cfg.current_size
    skip = streamline_skip(cfg)
    n_seeds = n // skip

    idx = jnp.arange(n_seeds * n_seeds, dtype=jnp.int32)
    sx = (idx % n_seeds) * skip + skip   # grid x (FluidSim.cs:1687)
    sy = (idx // n_seeds) * skip + skip  # grid y
    in_range = (sx > 0) & (sx < n - 1) & (sy > 0) & (sy < n - 1)
    sx_c = jnp.clip(sx, 0, n - 1)
    sy_c = jnp.clip(sy, 0, n - 1)

    vx = vel_x[sy_c, sx_c]
    vy = vel_y[sy_c, sx_c]
    obst = obstacles[sy_c, sx_c]

    mag = jnp.sqrt(vx * vx + vy * vy)
    valid = in_range & (~obst) & (mag >= 0.01)

    length = jnp.minimum(float(skip - 1), mag * cfg.streamline_scale)
    angle = jnp.arctan2(vy, vx)
    ex = sx.astype(jnp.float32) + jnp.cos(angle) * length
    ey = sy.astype(jnp.float32) + jnp.sin(angle) * length

    segs = jnp.stack(
        [
            jnp.where(valid, sx.astype(jnp.float32), -1.0),
            jnp.where(valid, sy.astype(jnp.float32), -1.0),
            jnp.where(valid, ex, -1.0),
            jnp.where(valid, ey, -1.0),
        ],
        axis=-1,
    )
    return segs


def _rasterize_numpy(segments, rgba, color, size, thickness):
    """NumPy fallback with semantics identical to native/rasterizer.cpp
    (and FluidSim.cs:1783-1849)."""
    half = int(np.floor(thickness / 2.0))
    for seg in segments:
        if seg[0] < 0:
            continue
        x0, y0 = int(seg[0]), int(seg[1])
        x1, y1 = int(round(float(seg[2]))), int(round(float(seg[3])))
        steep = abs(y1 - y0) > abs(x1 - x0)
        if steep:
            x0, y0 = y0, x0
            x1, y1 = y1, x1
        if x0 > x1:
            x0, x1 = x1, x0
            y0, y1 = y1, y0
        dx = x1 - x0
        dy = abs(y1 - y0)
        error = dx // 2
        y = y0
        ystep = 1 if y0 < y1 else -1
        for x in range(x0, x1 + 1):
            for tx in range(-half, half + 1):
                for ty in range(-half, half + 1):
                    draw_x = (y if steep else x) + tx
                    draw_y = (x if steep else y) + ty
                    if 0 <= draw_x < size and 0 <= draw_y < size:
                        rgba[draw_y, draw_x] = color
            error -= dy
            if error < 0:
                y += ystep
                error += dx


def rasterize_streamlines(segments, cfg: SimConfig,
                          base_frame: Optional[np.ndarray] = None):
    """Step 3 (host): rasterize segments to an RGBA overlay and, if a base
    frame is given, composite it on top (CombineTextures,
    FluidSim.cs:868-884).  Returns a host (N, N, 4) array.
    """
    n = cfg.current_size
    segs = np.ascontiguousarray(np.asarray(segments), np.float32)
    overlay = np.zeros((n, n, 4), np.float32)
    color = np.asarray(cfg.streamline_color, np.float32)

    if _NATIVE is not None:
        _NATIVE.draw_segments(
            segs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(segs),
            overlay.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            color.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n,
            float(cfg.streamline_thickness),
        )
    else:
        _rasterize_numpy(segs, overlay, color, n, cfg.streamline_thickness)

    if base_frame is None:
        return overlay
    # A fresh copy: ``np.asarray`` of a device array is a read-only view.
    base = np.array(base_frame, np.float32, order="C")
    if _NATIVE is not None:
        _NATIVE.composite_over(
            base.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            overlay.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n * n,
        )
        return base
    mask = overlay[..., 3] > 0
    base[mask] = overlay[mask]
    return base


def native_rasterizer_available() -> bool:
    return _NATIVE is not None
