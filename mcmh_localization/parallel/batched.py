"""Batched multi-robot / multi-hypothesis localization via a leading vmap axis.

The reference runs one filter per process (one robot, one map).  Here a
fleet of B robots on the same map is a single vmapped step — every kernel
(motion, likelihood gather, MH, resampling) batches to (B, N, ...) arrays
with zero python-level looping, and the batch axis composes with the
particle-axis mesh sharding (SURVEY.md §7 step 9).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mcmh_localization.config import FilterConfig
from mcmh_localization.filter.step import make_model


class BatchedModel(NamedTuple):
    config: FilterConfig
    grid_map: object
    batch: int
    step: object   # (states, ranges (B,M), angles (M,), deltas (B,3)) -> ...
    run: object    # (states, ranges (T,B,M), angles, deltas (T,B,3)) -> ...
    init: object   # key -> batched FilterState


def stack_maps(maps):
    """Stack same-shaped GridMaps into one batched pytree.

    ``free_xy`` tables differ in length per map, so each is padded to the
    longest by tiling its own entries — every free cell then appears k or
    k+1 times, keeping uniform free-space sampling within ~1/F of exact.
    """
    f_max = max(m.free_xy.shape[0] for m in maps)

    def pad_free(m):
        f = m.free_xy.shape[0]
        reps = -(-f_max // f)
        return m.replace(free_xy=jnp.tile(m.free_xy, (reps, 1))[:f_max])

    maps = [pad_free(m) for m in maps]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *maps)


def make_multimap_model(config: FilterConfig, grid_maps, batch: int) -> BatchedModel:
    """Batched localization with a DIFFERENT map per robot.

    ``grid_maps``: a GridMap pytree whose leaves carry a leading batch axis
    (stack same-shaped maps with ``jax.tree_util.tree_map(jnp.stack, ...)``).
    Uses the exact (jnp) likelihood path — the corr scorer needs a concrete
    per-map resolution at trace time.
    """
    from mcmh_localization.filter.step import _correct, _predict
    from mcmh_localization.models.sensor import log_likelihood_field

    config = config.replace(likelihood_impl="jnp")
    one_map = jax.tree_util.tree_map(lambda x: x[0], grid_maps)
    base = make_model(config, one_map)  # init template / shapes

    def _step_one(state, ranges, angles, delta, grid_map):
        log_field = log_likelihood_field(grid_map, config)
        st = _predict(state, delta, grid_map, config)
        return _correct(st, ranges, angles, grid_map, log_field, config)

    step = jax.jit(jax.vmap(_step_one, in_axes=(0, 0, None, 0, 0)))

    def init(key, initial_poses=None):
        keys = jax.random.split(key, batch)
        states = []
        for b, k in enumerate(keys):
            gm_b = jax.tree_util.tree_map(lambda x: x[b], grid_maps)
            m_b = make_model(config, gm_b)
            pose = None if initial_poses is None else jnp.asarray(initial_poses[b])
            states.append(m_b.init(k, initial_pose=pose))
        return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)

    @jax.jit
    def run(states, ranges_seq, angles, deltas_seq):
        def body(s, inputs):
            r, d = inputs
            s, info = jax.vmap(_step_one, in_axes=(0, 0, None, 0, 0))(
                s, r, angles, d, grid_maps
            )
            return s, info

        return jax.lax.scan(body, states, (ranges_seq, deltas_seq))

    return BatchedModel(
        config=config, grid_map=grid_maps, batch=batch,
        step=lambda s, r, a, d: step(s, r, a, d, grid_maps),
        run=run, init=init,
    )


def make_batched_model(config: FilterConfig, grid_map, batch: int) -> BatchedModel:
    base = make_model(config, grid_map)

    def _step_one(state, ranges, angles, delta):
        # re-derive from the unjitted pieces via the base model's step
        return base.step(state, ranges, angles, delta)

    step = jax.jit(jax.vmap(_step_one, in_axes=(0, 0, None, 0)))

    def init(key, initial_poses=None):
        keys = jax.random.split(key, batch)
        if initial_poses is None:
            states = [base.init(k) for k in keys]
        else:
            states = [
                base.init(k, initial_pose=jnp.asarray(p))
                for k, p in zip(keys, initial_poses)
            ]
        return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)

    @jax.jit
    def run(states, ranges_seq, angles, deltas_seq):
        def body(s, inputs):
            r, d = inputs
            s, info = jax.vmap(_step_one, in_axes=(0, 0, None, 0))(s, r, angles, d)
            return s, info

        return jax.lax.scan(body, states, (ranges_seq, deltas_seq))

    return BatchedModel(
        config=config, grid_map=grid_map, batch=batch,
        step=step, run=run, init=init,
    )
