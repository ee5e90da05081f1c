"""Multi-chip scaling: particle-axis sharding over a jax.sharding.Mesh.

The reference's only parallelism is Numba ``prange`` over particles on one
host's cores (SURVEY.md §2.4).  The accelerator equivalent is SPMD over a
device mesh: the particle axis of every (N, ...) array is sharded across the
``"data"`` mesh axis; scalars, the map, the log-likelihood field, and scan
arrays are replicated.

We use the GSPMD recipe (How to Scale Your Model): annotate shardings on the
jitted step's inputs/outputs and let XLA insert the collectives —
  * weight normalization / max-log-score / ESS -> all-reduce (psum/pmax)
  * systematic & KLD resampling index into the global particle array ->
    all-gather + local gather
  * per-particle work (motion sampling, likelihood gather, MH) stays fully
    local with zero communication.
All collectives ride ICI; nothing in the step touches the host.

``dryrun`` capability: everything here works identically on a CPU mesh with
``--xla_force_host_platform_device_count=N`` (see tests/test_sharding.py).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mcmh_localization.config import FilterConfig
from mcmh_localization.filter.state import FilterState
from mcmh_localization.filter.step import (
    StepInfo,
    _correct,
    _predict,
    make_model,
    state_size,
)
from mcmh_localization.models.sensor import log_likelihood_field


def make_mesh(devices: Sequence[jax.Device] | None = None, axis: str = "data") -> Mesh:
    """1-D device mesh over the particle axis."""
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.asarray(devices), (axis,))


def _state_sharding(mesh: Mesh, axis: str = "data"):
    """FilterState sharding: particle-axis arrays sharded, scalars replicated."""
    sharded = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    return FilterState(
        particles=NamedSharding(mesh, P(axis, None)),
        prev_particles=NamedSharding(mesh, P(axis, None)),
        weights=sharded,
        count=rep,
        w_slow=rep,
        w_fast=rep,
        delta=rep,
        anchor=rep,
        anchor_streak=rep,
        key=rep,
    )


def shard_state(state: FilterState, mesh: Mesh, axis: str = "data") -> FilterState:
    """Place an existing state onto the mesh with the canonical shardings."""
    shardings = _state_sharding(mesh, axis)
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, s), state, shardings
    )


class ShardedModel(NamedTuple):
    config: FilterConfig
    grid_map: object
    mesh: Mesh
    step: object       # (state, ranges, angles, delta) -> (state, info)
    run: object        # (state, ranges_seq, angles, deltas) -> (state, infos)
    init: object       # key -> sharded FilterState


def make_sharded_model(
    config: FilterConfig, grid_map, mesh: Mesh, axis: str = "data"
) -> ShardedModel:
    """Build jitted step/run with particle-axis sharding over ``mesh``.

    The particle count is padded up to a multiple of the mesh size so every
    device owns an equal shard (config.max/num_particles are adjusted).
    """
    n_dev = mesh.devices.size
    n_max = state_size(config)
    if n_max % n_dev:
        pad = n_dev - n_max % n_dev
        if config.use_adaptive:
            config = config.replace(max_particles=n_max + pad)
        else:
            config = config.replace(
                num_particles=n_max + pad, max_particles=n_max + pad
            )

    base = make_model(config, grid_map)
    log_field = base.log_field
    state_shardings = _state_sharding(mesh, axis)
    rep = NamedSharding(mesh, P())

    def _step(state, ranges, angles, delta):
        state = _predict(state, delta, grid_map, config)
        return _correct(state, ranges, angles, grid_map, log_field, config)

    step = jax.jit(
        _step,
        in_shardings=(state_shardings, rep, rep, rep),
        out_shardings=(state_shardings, None),
    )

    def init(key, **kw) -> FilterState:
        return shard_state(base.init(key, **kw), mesh, axis)

    @jax.jit
    def run(state, ranges_seq, angles, deltas):
        def body(s, inputs):
            r, d = inputs
            s, info = step(s, r, angles, d)
            return s, info

        return jax.lax.scan(body, state, (ranges_seq, deltas))

    return ShardedModel(
        config=config, grid_map=grid_map, mesh=mesh,
        step=step, run=run, init=init,
    )
