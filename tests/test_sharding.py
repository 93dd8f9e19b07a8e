"""Multi-device tests on the forced 8-device CPU mesh (conftest.py):
sharded execution must match single-device results (SURVEY.md §4)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import fluidsim_tpu as fs
from fluidsim_tpu.ops.linsolve import jacobi_3d
from fluidsim_tpu.parallel.halo import jacobi_3d_sharded
from fluidsim_tpu.parallel.sharding import (
    make_mesh,
    shard_state,
    sharded_step_fn,
    state_sharding,
)
from fluidsim_tpu.scene.obstacles import build_obstacle_mask


pytestmark = [
    pytest.mark.slow,  # 8-device-mesh suite (minutes)
    pytest.mark.skipif(
        len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
    ),
]


def cfg3d(**kw):
    base = fs.get_preset("vortex128").replace(
        size=32, advect_window=2, source_radius=2.0
    )
    return base.replace(**kw) if kw else base


@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_sharded_jacobi_matches_single_device(b):
    n = 32
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (n, n, n), jnp.float32)
    x0 = jax.random.normal(jax.random.PRNGKey(1), (n, n, n), jnp.float32)
    mesh = make_mesh(jax.devices()[:8])

    single = jacobi_3d(b, x, x0, 1.0, 6.0, None, iters=20)
    sharded = jacobi_3d_sharded(x, x0, 1.0, 6.0, 20, mesh, b=b)
    np.testing.assert_allclose(
        np.asarray(sharded), np.asarray(single), rtol=1e-5, atol=1e-6
    )


@pytest.mark.parametrize("b", [0, 3])
@pytest.mark.parametrize("block_iters", [2, 4])
def test_deep_halo_jacobi_matches_per_sweep(b, block_iters):
    """Communication-avoiding schedule (T-deep halos every T sweeps) is
    EXACT: a T-deep halo covers the dependency cone of T sweeps, so the
    result is bitwise-equal to the per-sweep-exchange schedule (which in
    turn matches the single-device solver)."""
    n = 32
    x = jax.random.normal(jax.random.PRNGKey(2), (n, n, n), jnp.float32)
    x0 = jax.random.normal(jax.random.PRNGKey(3), (n, n, n), jnp.float32)
    mesh = make_mesh(jax.devices()[:8])

    per_sweep = jacobi_3d_sharded(x, x0, 1.0, 6.0, 20, mesh, b=b,
                                  block_iters=1)
    deep = jacobi_3d_sharded(x, x0, 1.0, 6.0, 20, mesh, b=b,
                             block_iters=block_iters)
    np.testing.assert_array_equal(np.asarray(deep), np.asarray(per_sweep))

    single = jacobi_3d(b, x, x0, 1.0, 6.0, None, iters=20)
    np.testing.assert_allclose(
        np.asarray(deep), np.asarray(single), rtol=1e-5, atol=1e-6
    )


def test_deep_halo_validation():
    mesh = make_mesh(jax.devices()[:8])
    x = jnp.zeros((32, 32, 32), jnp.float32)
    with pytest.raises(ValueError, match="not divisible"):
        jacobi_3d_sharded(x, x, 1.0, 6.0, 20, mesh, block_iters=3)
    with pytest.raises(ValueError, match="local slab depth"):
        # 32/8 = 4 local planes; a 5-deep halo would need next-nearest
        # neighbors.
        jacobi_3d_sharded(x, x, 1.0, 6.0, 20, mesh, block_iters=5)


def _ball_mask(n):
    """A centered solid ball (analog of the vortex128 obstacle)."""
    idx = np.indices((n, n, n))
    r2 = sum((i - n / 2.0) ** 2 for i in idx)
    return jnp.asarray(r2 < (n / 5.0) ** 2)


def test_sharded_jacobi_obstacle_matches_single_device():
    """Obstacle copy-through on the sharded solve (the solve's
    coefficient-volume contract) equals the
    single-device jacobi_3d with the same mask — per-sweep and deep-halo
    cadences."""
    n = 32
    obst = _ball_mask(n)
    x = jax.random.normal(jax.random.PRNGKey(8), (n, n, n), jnp.float32)
    x0 = jax.random.normal(jax.random.PRNGKey(9), (n, n, n), jnp.float32)
    mesh = make_mesh(jax.devices()[:8])

    single = jacobi_3d(0, x, x0, 1.0, 6.0, obst, iters=20)
    for T in (1, 4):
        sharded = jacobi_3d_sharded(x, x0, 1.0, 6.0, 20, mesh, b=0,
                                    block_iters=T, obst=obst)
        np.testing.assert_allclose(
            np.asarray(sharded), np.asarray(single), rtol=1e-5, atol=1e-6
        )


def test_sharded_jacobi_obstacle_requires_b0():
    mesh = make_mesh(jax.devices()[:8])
    x = jnp.zeros((32, 32, 32), jnp.float32)
    with pytest.raises(ValueError, match="b == 0"):
        jacobi_3d_sharded(x, x, 1.0, 6.0, 20, mesh, b=1,
                          obst=_ball_mask(32))


def test_sharded_step_explicit_obstacle_matches_auto():
    """The FULL product step on an obstacle scene (vortex-class config)
    through halo='explicit' — pressure solve with the mask as a
    copy-through coefficient, advection on the auto-partitioned XLA
    path — equals the auto path."""
    cfg = cfg3d()
    assert cfg.enable_obstacle
    obst = jnp.asarray(build_obstacle_mask(cfg))
    state = fs.zeros_state(cfg, obstacles=obst)

    mesh = make_mesh(jax.devices()[:8])
    s_auto = shard_state(state, mesh)
    s_exp = shard_state(state, mesh)
    step_auto = sharded_step_fn(cfg, mesh, halo="auto")
    step_exp = sharded_step_fn(cfg, mesh, halo="explicit",
                               halo_block_iters=2)
    for _ in range(3):
        s_auto = step_auto(s_auto)
        s_exp = step_exp(s_exp)

    np.testing.assert_allclose(
        np.asarray(s_exp.density), np.asarray(s_auto.density),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(s_exp.velocity), np.asarray(s_auto.velocity),
        rtol=1e-5, atol=1e-4,
    )


def test_halo_exchange_rejects_deep_halo():
    """The primitive itself refuses depth > local slab — a deeper
    request would silently come back truncated (x_local[-depth:] caps
    at lz planes) and corrupt any [below, x, above] concatenation."""
    import functools

    from jax.sharding import PartitionSpec as P

    from fluidsim_tpu.parallel.halo import halo_exchange_z

    mesh = make_mesh(jax.devices()[:8])
    x = jnp.zeros((32, 32, 32), jnp.float32)  # 4 local planes

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=P("z", None, None), out_specs=P("z", None, None),
    )
    def bad(xl):
        below, _ = halo_exchange_z(xl, depth=5)
        return xl

    with pytest.raises(ValueError, match="local slab depth"):
        bad(x)


def test_sharded_step_rejects_block_iters_on_auto():
    """halo_block_iters silently did nothing on the auto path — it must
    raise so a benchmark of the communication-avoiding cadence can't
    accidentally measure the auto path."""
    cfg = cfg3d(enable_obstacle=False)
    mesh = make_mesh(jax.devices()[:8])
    with pytest.raises(ValueError, match="halo_block_iters"):
        sharded_step_fn(cfg, mesh, halo="auto", halo_block_iters=4)


def test_sharded_step_explicit_deep_halo_matches_auto():
    """The product step with the communication-avoiding exchange cadence
    (halo_block_iters=4) equals the auto-partitioned path."""
    cfg = cfg3d(enable_obstacle=False)
    state = fs.zeros_state(cfg)

    mesh = make_mesh(jax.devices()[:8])
    s_auto = shard_state(state, mesh)
    s_deep = shard_state(state, mesh)
    step_auto = sharded_step_fn(cfg, mesh, halo="auto")
    step_deep = sharded_step_fn(cfg, mesh, halo="explicit",
                                halo_block_iters=4)
    for _ in range(3):
        s_auto = step_auto(s_auto)
        s_deep = step_deep(s_deep)

    np.testing.assert_allclose(
        np.asarray(s_deep.density), np.asarray(s_auto.density),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(s_deep.velocity), np.asarray(s_auto.velocity),
        rtol=1e-5, atol=1e-4,
    )


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_step_matches_single_device(n_dev):
    cfg = cfg3d()
    obst = build_obstacle_mask(cfg)
    state = fs.zeros_state(cfg, obstacles=jnp.asarray(obst))

    # single-device run
    from fluidsim_tpu.models.stable3d import simulate_step_3d
    from fluidsim_tpu.scene.sources import apply_custom_source

    dt = np.float32(cfg.effective_params()[0])

    @jax.jit
    def single_step(state):
        t = state.time + dt
        d, v = apply_custom_source(state.density, state.velocity, cfg, t)
        return simulate_step_3d(state.replace(density=d, velocity=v), cfg)

    s1 = state
    for _ in range(3):
        s1 = single_step(s1)

    # sharded run
    mesh = make_mesh(jax.devices()[:n_dev])
    s2 = shard_state(state, mesh)
    step = sharded_step_fn(cfg, mesh)
    for _ in range(3):
        s2 = step(s2)

    np.testing.assert_allclose(
        np.asarray(s2.density), np.asarray(s1.density), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(s2.velocity), np.asarray(s1.velocity), rtol=1e-5, atol=1e-4
    )


def test_sharded_step_explicit_halo_matches_auto():
    """The product step with halo='explicit' (shard_map + per-sweep
    ppermute pressure solve) equals the XLA
    auto-partitioned path and the single-device step."""
    cfg = cfg3d(enable_obstacle=False)
    state = fs.zeros_state(cfg)

    mesh = make_mesh(jax.devices()[:8])
    s_auto = shard_state(state, mesh)
    s_exp = shard_state(state, mesh)
    step_auto = sharded_step_fn(cfg, mesh, halo="auto")
    step_exp = sharded_step_fn(cfg, mesh, halo="explicit")
    for _ in range(3):
        s_auto = step_auto(s_auto)
        s_exp = step_exp(s_exp)

    np.testing.assert_allclose(
        np.asarray(s_exp.density), np.asarray(s_auto.density),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(s_exp.velocity), np.asarray(s_auto.velocity),
        rtol=1e-5, atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(s_exp.pressure), np.asarray(s_auto.pressure),
        rtol=1e-5, atol=1e-5,
    )


def test_sharded_state_placement():
    cfg = cfg3d()
    mesh = make_mesh(jax.devices()[:8])
    state = shard_state(fs.zeros_state(cfg), mesh)
    sh = state.density.sharding
    assert sh.is_equivalent_to(
        state_sharding(mesh).density, ndim=state.density.ndim
    )
    # each device holds a 4-plane slab of the 32³ grid
    shard_shapes = {s.data.shape for s in state.density.addressable_shards}
    assert shard_shapes == {(4, 32, 32)}


def test_graft_dryrun_multichip():
    import sys, pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)
