"""Particle initialization.

Replaces ``generate_valid_particles`` (parallel_utils.py:450-465) and
``initialize_gaussian_parallel``/``validate_samples``
(parallel_utils.py:594-615), dispatched from ``initialize_particles``
(amcmh_localizer.py:179-197).

Design: uniform free-space init samples a free CELL uniformly from
the precomputed free-cell table and jitters uniformly within the cell —
exactly the uniform-over-free-space distribution the reference gets from its
50x oversample-and-reject, but with a static shape and no chance of
returning fewer particles than asked (the reference can,
parallel_utils.py:462-465).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# Free-cell draws above this count come from a tiled iid pool instead of
# one random row gather per particle (the augmented-MCL injection branch's
# main cost at 1M).  At such counts the draw must revisit cells anyway (maps have far fewer free
# cells than 64k), so tiling an iid pool with per-slot jitter/theta is
# distribution-equivalent up to cell multiplicities; only slot<->cell
# pairing is pool-periodic, and slot order carries no meaning downstream.
_POOL = 65536


def init_uniform(key: jax.Array, n: int, grid_map) -> jnp.ndarray:
    """(n, 3) poses uniform over free space, theta ~ U(-pi, pi).

    Above the pool size, CELLS are tiled but the within-cell jitter and
    theta stay PER SLOT, so every particle is a distinct pose (a fully
    tiled pose pool was tried and produced bitwise duplicates — 65k
    distinct hypotheses pretending to be 1M)."""
    k_cell, k_off, k_theta = jax.random.split(key, 3)
    f = grid_map.free_xy.shape[0]
    pool = min(n, _POOL)
    cells = jax.random.randint(k_cell, (pool,), 0, f)
    xy_pool = grid_map.free_xy[cells]  # (pool, 2)
    if pool < n:
        reps = -(-n // pool)
        xy = jnp.tile(xy_pool, (reps, 1))[:n]
    else:
        xy = xy_pool
    jitter = jax.random.uniform(
        k_off, (n, 2), minval=-0.5, maxval=0.5
    ) * grid_map.resolution
    theta = jax.random.uniform(k_theta, (n,), minval=-jnp.pi, maxval=jnp.pi)
    return jnp.concatenate(
        [xy + jitter, theta[:, None]], axis=1
    ).astype(jnp.float32)


def init_gaussian(
    key: jax.Array,
    mean: jnp.ndarray,
    cov: jnp.ndarray,
    n: int,
    grid_map,
    ref_compat: bool = False,
) -> jnp.ndarray:
    """(n, 3) poses ~ N(mean, cov), validated against the map.

    Replaces initialize_gaussian_parallel + validate_samples
    (parallel_utils.py:594-615).

    ``ref_compat=True`` reproduces the reference exactly: a sample is kept
    iff in-bounds AND the distance field there is < 1.0 m — i.e. poses in
    open space (>1 m from any obstacle) are REJECTED and zeroed to
    (0, 0, 0), which mis-initializes the filter whenever the start pose is
    in the open (a reference quirk, :610-613).

    Default (corrected): a sample is kept iff its cell is free; invalid
    samples collapse to the mean pose, keeping the init mass where it was
    requested.
    """
    k_n, _ = jax.random.split(key)
    mean = jnp.asarray(mean, dtype=jnp.float32)
    chol = jnp.linalg.cholesky(jnp.asarray(cov, dtype=jnp.float32))
    eps = jax.random.normal(k_n, (n, 3), dtype=jnp.float32)
    # HIGHEST: a TF32 product would round the noise to 10 mantissa bits
    samples = mean[None, :] + jnp.matmul(
        eps, chol.T, precision=jax.lax.Precision.HIGHEST
    )

    mx, my = grid_map.world_to_grid(samples[:, 0], samples[:, 1])
    if ref_compat:
        ok = grid_map.in_bounds(mx, my) & (
            grid_map.distance_at(mx, my, fill=jnp.inf) < 1.0
        )
        fallback = jnp.zeros_like(samples)
    else:
        ok = grid_map.occupancy_at(mx, my) == 0
        fallback = jnp.broadcast_to(mean, samples.shape)
    return jnp.where(ok[:, None], samples, fallback)
