"""Odometry motion model (Thrun et al., Probabilistic Robotics §5.4).

Replaces the reference's Numba kernels:
  * sampling / proposal: ``apply_motion_model_parallel`` (parallel_utils.py:332-363)
  * density evaluation:  ``motion_model_odometry_parallel`` (parallel_utils.py:282-330)
  * odometry decomposition: ``compute_motion`` (amcmh_localizer.py:410-421)

Design notes:
  * The reference rejection-samples each particle's proposal up to 1000 times
    until it lands on a free cell, falling back to the old pose
    (parallel_utils.py:339-361) — a data-dependent loop that cannot live under
    jit.  We draw a fixed, static number of candidate proposals per particle
    (``retries``), pick the first valid one with a masked argmax, and fall
    back to the old pose when none is valid.  Same fallback semantics and,
    for any realistic map, statistically indistinguishable acceptance
    (P[valid] per draw is high; 8 draws ≈ 1000 draws to ~1e-8).
  * Everything is batched (N, ...) arrays; no per-particle loops.  The whole
    model fuses into a handful of elementwise kernels under jit.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from mcmh_localization.utils.angles import normalize_angle

# Guard against zero noise scales producing NaNs in the density; the
# reference divides by sigma unguarded (parallel_utils.py:33) and returns
# inf/nan when the robot is stationary — we clamp instead (documented
# deviation; normalized output is identical whenever any motion occurred).
_SIGMA_MIN = 1e-9


def compute_motion(odom_prev: jnp.ndarray, odom_curr: jnp.ndarray) -> jnp.ndarray:
    """Decompose two odometry poses into (rot1, trans, rot2).

    Matches amcmh_localizer.py:410-421 exactly: dtheta is wrapped, rot1 is
    NOT wrapped (same artifact as the reference), rot2 = dtheta - rot1.
    """
    dx = odom_curr[0] - odom_prev[0]
    dy = odom_curr[1] - odom_prev[1]
    dtheta = normalize_angle(odom_curr[2] - odom_prev[2])
    rot1 = jnp.arctan2(dy, dx) - odom_prev[2]
    trans = jnp.hypot(dx, dy)
    rot2 = dtheta - rot1
    return jnp.stack([rot1, trans, rot2])


def invert_delta(delta: jnp.ndarray, ref_compat: bool = False) -> jnp.ndarray:
    """The reverse motion of ``delta = (rot1, trans, rot2)``.

    Correct inverse (default): retracing the motion from the end pose back to
    the start pose gives ``(pi - rot2, trans, -rot1 - pi)`` (derived from the
    rot1/trans/rot2 composition; angles wrapped).

    ``ref_compat=True`` reproduces the reference quirk at
    amcmh_localizer.py:429-434, which applies a 2-D rigid-body inverse as if
    delta were (dx, dy, dtheta).
    """
    r1, t, r2 = delta[0], delta[1], delta[2]
    if ref_compat:
        return jnp.stack(
            [
                -r1 * jnp.cos(r2) - t * jnp.sin(r2),
                r1 * jnp.sin(r2) - t * jnp.cos(r2),
                -r2,
            ]
        )
    return jnp.stack(
        [normalize_angle(jnp.pi - r2), t, normalize_angle(-r1 - jnp.pi)]
    )


def _noise_stds(delta, alpha):
    """Per-component proposal noise scales (parallel_utils.py:314-316)."""
    rot1, trans, rot2 = delta[0], delta[1], delta[2]
    a1, a2, a3, a4 = alpha
    s_rot1 = a1 * jnp.abs(rot1) + a2 * jnp.abs(trans)
    s_trans = a3 * jnp.abs(trans) + a4 * (jnp.abs(rot1) + jnp.abs(rot2))
    s_rot2 = a1 * jnp.abs(rot2) + a2 * jnp.abs(trans)
    return s_rot1, s_trans, s_rot2


def fast_normal(key: jax.Array, shape, dtype=jnp.float32) -> jnp.ndarray:
    """Standard normals via the XLA RngBitGenerator ("rbg") instead of
    threefry.

    Threefry bit generation can dominate the predict phase at scale; rbg
    generates bits in hardware-friendly fashion at a fraction of that.  The rbg key
    is derived DETERMINISTICALLY from the caller's threefry key data, so
    filter determinism (same seed -> same run, checkpoint/replay
    bit-exactness) is fully preserved — only the realized noise sequence
    differs from the threefry one, which nothing golden-pins (proposal
    noise is statistical by nature).  jax upstream documents rbg as
    usable wherever exact threefry sequence identity is not required."""
    kd = jnp.asarray(key)
    if kd.dtype != jnp.uint32:                 # typed key -> raw data
        kd = jax.random.key_data(key)
    rbg = jax.random.wrap_key_data(
        jnp.tile(kd.reshape(-1)[:2], 2), impl="rbg"
    )
    return jax.random.normal(rbg, shape, dtype=dtype)


def _noise(key, shape, dtype, impl: str):
    if impl == "rbg":
        return fast_normal(key, shape, dtype)
    return jax.random.normal(key, shape, dtype=dtype)


def sample_motion(
    key: jax.Array,
    particles: jnp.ndarray,
    delta: jnp.ndarray,
    alpha: Tuple[float, float, float, float],
    grid_map,
    retries: int = 8,
    rng_impl: str = "rbg",
) -> jnp.ndarray:
    """Propagate all particles through the noisy odometry motion model.

    particles: (N, 3); delta: (3,) observed (rot1, trans, rot2).
    Returns (N, 3) proposed particles; a particle keeps its old pose when all
    ``retries`` candidate draws land on non-free cells
    (the reference's fallback at parallel_utils.py:360-361).

    ``retries=0``: no validity check at all — the raw first draw is returned
    (used with ``motion_validity="score"``, where non-free poses are
    penalized by the sensor score instead; saves retries x N map lookups).
    """
    n = particles.shape[0]
    s_rot1, s_trans, s_rot2 = _noise_stds(delta, alpha)

    if retries == 0:
        eps = _noise(key, (n, 3), particles.dtype, rng_impl)
        r1_hat = delta[0] + eps[:, 0] * s_rot1
        t_hat = delta[1] + eps[:, 1] * s_trans
        r2_hat = delta[2] + eps[:, 2] * s_rot2
        heading = particles[:, 2] + r1_hat
        return jnp.stack(
            [
                particles[:, 0] + t_hat * jnp.cos(heading),
                particles[:, 1] + t_hat * jnp.sin(heading),
                normalize_angle(heading + r2_hat),
            ],
            axis=-1,
        )

    eps = _noise(key, (retries, n, 3), particles.dtype, rng_impl)
    r1_hat = delta[0] + eps[..., 0] * s_rot1  # (R, N)
    t_hat = delta[1] + eps[..., 1] * s_trans
    r2_hat = delta[2] + eps[..., 2] * s_rot2

    x, y, theta = particles[:, 0], particles[:, 1], particles[:, 2]
    heading = theta[None, :] + r1_hat
    cand_x = x[None, :] + t_hat * jnp.cos(heading)
    cand_y = y[None, :] + t_hat * jnp.sin(heading)
    cand_t = normalize_angle(theta[None, :] + r1_hat + r2_hat)

    valid = grid_map.is_free_world(cand_x, cand_y)  # (R, N)
    any_valid = jnp.any(valid, axis=0)  # (N,)
    first = jnp.argmax(valid, axis=0)  # (N,) first valid draw (0 if none)

    # one-hot select over the R retry rows: dense elementwise work
    onehot = (
        jax.lax.broadcasted_iota(jnp.int32, valid.shape, 0) == first[None, :]
    ).astype(particles.dtype)
    pick = lambda c: jnp.sum(c * onehot, axis=0)
    new_x = jnp.where(any_valid, pick(cand_x), x)
    new_y = jnp.where(any_valid, pick(cand_y), y)
    new_t = jnp.where(any_valid, pick(cand_t), theta)
    return jnp.stack([new_x, new_y, new_t], axis=-1)


def _gaussian_prob(diff, sigma):
    """N(diff; 0, sigma) density (parallel_utils.py:31-33), sigma clamped."""
    s = jnp.maximum(sigma, _SIGMA_MIN)
    return jnp.exp(-0.5 * (diff / s) ** 2) / jnp.sqrt(2.0 * jnp.pi * s * s)


def motion_density(
    particles_prev: jnp.ndarray,
    particles_curr: jnp.ndarray,
    delta: jnp.ndarray,
    alpha: Tuple[float, float, float, float],
    normalize: bool = True,
) -> jnp.ndarray:
    """p(x_t | x_{t-1}, u_t) for all particle pairs, normalized to sum 1.

    Matches motion_model_odometry_parallel (parallel_utils.py:282-330): the
    per-particle implied (rot1_hat, trans_hat, rot2_hat) is scored against
    the observed delta under the alpha-scaled Gaussians, then the vector is
    normalized across particles.  ``normalize=False`` returns the raw
    densities (the distributed step normalizes globally with a psum).
    """
    dx = particles_curr[:, 0] - particles_prev[:, 0]
    dy = particles_curr[:, 1] - particles_prev[:, 1]
    theta_prev = particles_prev[:, 2]
    theta_curr = particles_curr[:, 2]

    trans_hat = jnp.sqrt(dx * dx + dy * dy)
    rot1_hat = normalize_angle(jnp.arctan2(dy, dx) - theta_prev)
    rot2_hat = normalize_angle(theta_curr - theta_prev - rot1_hat)

    s_rot1, s_trans, s_rot2 = _noise_stds(delta, alpha)
    p = (
        _gaussian_prob(normalize_angle(delta[0] - rot1_hat), s_rot1)
        * _gaussian_prob(delta[1] - trans_hat, s_trans)
        * _gaussian_prob(normalize_angle(delta[2] - rot2_hat), s_rot2)
    )
    if not normalize:
        return p
    total = jnp.sum(p)
    return jnp.where(total > 0, p / total, p)
