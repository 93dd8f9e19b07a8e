"""Explicit halo exchange between devices (``shard_map`` + ``ppermute``).

The slab-decomposed Jacobi sweep needs each shard's top/bottom neighbor
plane every iteration.  This module implements the exchange explicitly,
two ways:

* ``block_iters=1`` — one single-plane ``ppermute`` up and down per sweep
  (the minimal-traffic schedule; latency-bound at one exchange per
  sweep).
* ``block_iters=T>1`` — **communication-avoiding deep halo**: exchange a
  T-plane halo once per T sweeps.  A T-deep halo covers the dependency
  cone of T Jacobi sweeps exactly (each sweep's stencil erodes one plane
  of halo validity), so the result is *identical* to the per-sweep
  schedule — T× fewer round-trips for 2·T·N² exchanged bytes per
  round (same total bytes, amortized latency) at the cost of
  O(T²·N²/lz) redundant halo compute.  This is the classic
  communication-avoiding stencil trade.

All solver functions here run **inside** ``shard_map`` over a 1-D mesh
axis; the global z extent is ``n_dev · local_z``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def halo_exchange_z(x_local, axis_name: str = "z", depth: int = 1,
                    axis: int = 0):
    """Return (below, above): the neighbor edge slabs of this shard.

    ``below[j,y,x]`` holds the last ``depth`` z-planes of the shard below
    (zeros at the global bottom); ``above`` the first ``depth`` planes of
    the shard above (zeros at the global top).  One ``ppermute`` in each
    direction — 2·depth·N²·4 bytes per call.

    ``axis``: position of the sharded z axis (0 for a plain (lz, N, N)
    field, 1 for channel-stacked (C, lz, N, N) fields — one ``ppermute``
    pair then exchanges all channels' edge slabs at once).

    ``depth`` must not exceed the local slab depth: a shard only owns
    ``lz`` planes, so a deeper halo would silently come back truncated
    (the edge slice caps at ``lz`` planes) and any consumer that
    concatenates ``[below, x, above]`` expecting ``lz + 2·depth`` planes
    would slice against the wrong geometry.
    """
    lz = x_local.shape[axis]
    if depth > lz:
        raise ValueError(
            f"halo depth={depth} exceeds the local slab depth {lz}"
        )
    n_dev = jax.lax.axis_size(axis_name)
    top_slab = jax.lax.slice_in_dim(x_local, lz - depth, lz, axis=axis)
    bot_slab = jax.lax.slice_in_dim(x_local, 0, depth, axis=axis)
    up = [(i, i + 1) for i in range(n_dev - 1)]
    down = [(i + 1, i) for i in range(n_dev - 1)]
    below = jax.lax.ppermute(top_slab, axis_name, up)      # from rank-1
    above = jax.lax.ppermute(bot_slab, axis_name, down)    # from rank+1
    return below, above


def _ext_sweep(b, xp, x0_ext, a, c, rank, n_dev, halo: int, lz: int,
               obst_ext=None):
    """One Jacobi update on a halo-extended z-slab ``xp`` of shape
    ``(lz + 2·halo, N, N)``.  Updates every interior plane of the extended
    array (halo planes erode one per sweep — callers run at most ``halo``
    sweeps between exchanges), then rewrites wall faces via
    ``_ext_faces``.

    ``obst_ext``: optional halo-extended obstacle mask — obstacle cells
    copy the previous iterate (``ops.linsolve.jacobi_3d``'s rule; for the
    pressure solve, whose iterate starts at 0 in solids, this is
    copy-through of zero — the coefficient-volume formulation of
    FluidSim.cs:1209-1211's skip).
    """
    nbr = (
        ((xp[1:-1, 1:-1, 2:] + xp[1:-1, 1:-1, :-2])
         + (xp[1:-1, 2:, 1:-1] + xp[1:-1, :-2, 1:-1]))
        + (xp[2:, 1:-1, 1:-1] + xp[:-2, 1:-1, 1:-1])
    )
    upd = (x0_ext[1:-1, 1:-1, 1:-1] + a * nbr) / c
    if obst_ext is not None:
        upd = jnp.where(obst_ext[1:-1, 1:-1, 1:-1], xp[1:-1, 1:-1, 1:-1],
                        upd)
    out = jax.lax.pad(upd, jnp.asarray(0.0, xp.dtype),
                      [(1, 1, 0), (1, 1, 0), (1, 1, 0)])
    return _ext_faces(b, out, rank, n_dev, halo, lz)


def _ext_faces(b, out, rank, n_dev, halo: int, lz: int):
    """Rewrite wall faces on a halo-extended slab exactly like the
    single-device ``set_bnd_3d`` face pass: global z faces (ext indices
    ``halo`` / ``halo+lz−1``) only on the first/last shard, y/x faces on
    every plane, z → y → x order (later passes read earlier results,
    healing shared edges), with the mirror-negate sign for the velocity
    component normal to each wall (``b``: 0 scalar, 1 = vx, 2 = vy,
    3 = vz)."""
    sz = -1.0 if b == 3 else 1.0
    sy = -1.0 if b == 2 else 1.0
    sx = -1.0 if b == 1 else 1.0

    # Global z faces exist only on the first/last shard, at extended
    # indices halo / halo+lz−1.
    is_bottom = rank == 0
    is_top = rank == n_dev - 1
    zidx = jax.lax.broadcasted_iota(jnp.int32, out.shape, 0)
    zlow = sz * jnp.concatenate([out[1:2], out[2:], out[-1:]], axis=0)
    zhigh = sz * jnp.concatenate([out[:1], out[:-2], out[-2:-1]], axis=0)
    out = jnp.where(jnp.logical_and(is_bottom, zidx == halo), zlow, out)
    out = jnp.where(jnp.logical_and(is_top, zidx == halo + lz - 1),
                    zhigh, out)

    n = out.shape[1]
    yidx = jax.lax.broadcasted_iota(jnp.int32, out.shape, 1)
    ylow = sy * jnp.concatenate([out[:, 1:2], out[:, 2:], out[:, -1:]],
                                axis=1)
    yhigh = sy * jnp.concatenate([out[:, :1], out[:, :-2], out[:, -2:-1]],
                                 axis=1)
    out = jnp.where(yidx == 0, ylow,
                    jnp.where(yidx == n - 1, yhigh, out))
    xidx = jax.lax.broadcasted_iota(jnp.int32, out.shape, 2)
    xlow = sx * jnp.concatenate([out[:, :, 1:2], out[:, :, 2:],
                                 out[:, :, -1:]], axis=2)
    xhigh = sx * jnp.concatenate([out[:, :, :1], out[:, :, :-2],
                                  out[:, :, -2:-1]], axis=2)
    out = jnp.where(xidx == 0, xlow,
                    jnp.where(xidx == n - 1, xhigh, out))
    return out


def jacobi_3d_sharded(x, x0, a: float, c: float, iters: int,
                      mesh: Mesh, axis_name: str = "z", b: int = 0,
                      block_iters: int = 1, obst=None):
    """Slab-sharded fixed-rhs Jacobi with explicit halo exchange.
    ``x``/``x0`` are global ``[z, y, x]`` arrays (sharded or not); the
    result matches the single-device ``jacobi_3d`` for any
    ``block_iters`` (a T-deep halo covers the dependency cone of T
    sweeps exactly — see module docstring).

    ``b`` selects the wall rule exactly as in ``set_bnd_3d`` (0 scalar,
    1/2/3 = velocity component normal to the x/y/z walls).
    ``obst``: optional global boolean obstacle mask (``b == 0`` only —
    the scalar contract has no obstacle mirror): obstacle cells copy the
    previous iterate, exactly ``ops.linsolve.jacobi_3d``'s rule.  The
    mask's own T-deep halo is exchanged once (it is round-invariant).
    ``block_iters`` (T) sets the exchange cadence: T-plane halos every T
    sweeps instead of 1-plane halos every sweep.  Requires
    ``iters % T == 0`` and T ≤ the local slab depth.  Each shard runs its
    T sweeps on the extended slab (``_ext_sweep``).
    """
    T = int(block_iters)
    if iters % T:
        raise ValueError(f"iters={iters} not divisible by block_iters={T}")
    if obst is not None and b != 0:
        raise ValueError(
            "jacobi_3d_sharded: obst requires b == 0 (the scalar set_bnd "
            "contract — velocity components need the obstacle mirror, "
            "which this solver does not implement)"
        )
    n_shards = mesh.shape[axis_name]
    lz_global = x.shape[0] // n_shards
    if T > lz_global:
        raise ValueError(
            f"block_iters={T} exceeds the local slab depth {lz_global}"
        )
    spec = P(axis_name, None, None)
    in_specs = (spec, spec) + ((spec,) if obst is not None else ())

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=in_specs, out_specs=spec,
    )
    def run(x_local, x0_local, *rest):
        obst_local = rest[0] if rest else None
        rank = jax.lax.axis_index(axis_name)
        n_dev = jax.lax.axis_size(axis_name)
        lz = x_local.shape[0]

        # The mask is round-invariant: exchange its T-deep halo ONCE, as
        # int8 (the halo planes past the global edges come back 0 =
        # fluid, which only touches erosion-garbage planes).
        obst_ext = None
        if obst_local is not None:
            obst_i8 = obst_local.astype(jnp.int8)
            ob, oa = halo_exchange_z(obst_i8, axis_name, T)
            obst_ext = jnp.concatenate([ob, obst_i8, oa], axis=0) != 0

        # The rhs never changes: exchange its halo once for all rounds.
        x0b, x0a = halo_exchange_z(x0_local, axis_name, T)
        x0_ext = jnp.concatenate([x0b, x0_local, x0a], axis=0)

        def round_body(_, xl):
            below, above = halo_exchange_z(xl, axis_name, T)
            xp = jnp.concatenate([below, xl, above], axis=0)

            def sweep(_, xp):
                return _ext_sweep(b, xp, x0_ext, a, c, rank, n_dev,
                                  T, lz, obst_ext)

            xp = jax.lax.fori_loop(0, T, sweep, xp)
            return jax.lax.slice_in_dim(xp, T, T + lz, axis=0)

        return jax.lax.fori_loop(0, iters // T, round_body, x_local)

    args = (x, x0) + ((obst,) if obst is not None else ())
    return run(*args)
