"""Pose estimation from the weighted particle set.

Replaces ``publish_estimate`` math (amcmh_localizer.py:584-623): weighted
mean x/y, circular (vector-sum) mean theta, and the weighted 3x3 covariance
of (x, y, wrapped-theta) residuals, plus the ROS 6x6 flat covariance packing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mcmh_localization.utils import pytree as struct
from mcmh_localization.utils.angles import normalize_angle_about


@struct.dataclass
class PoseEstimate:
    mean: jnp.ndarray  # (3,) [x, y, theta]
    cov: jnp.ndarray   # (3, 3) over (x, y, theta)


def estimate_pose(
    particles: jnp.ndarray,
    weights: jnp.ndarray,
    mask: jnp.ndarray | None = None,
) -> PoseEstimate:
    """Weighted mean + covariance of a (possibly padded) particle set.

    With ``mask``, padded slots are excluded (their weights should already be
    zero; the mask guards the residual computation as well).

    Matches amcmh_localizer.py:584-597: xy mean is the weighted average,
    theta is atan2 of weighted sin/cos sums, and the covariance follows
    numpy's ``cov(..., aweights=w)`` normalization
    1 / (V1 - V2/V1) with V1 = sum(w), V2 = sum(w^2).
    """
    w = jnp.where(mask, weights, 0.0) if mask is not None else weights
    v1 = jnp.sum(w)
    wn = w / jnp.maximum(v1, 1e-30)

    mean_xy = jnp.sum(particles[:, :2] * wn[:, None], axis=0)
    cos_m = jnp.sum(jnp.cos(particles[:, 2]) * wn)
    sin_m = jnp.sum(jnp.sin(particles[:, 2]) * wn)
    mean_theta = jnp.arctan2(sin_m, cos_m)
    mean = jnp.concatenate([mean_xy, mean_theta[None]])

    # residuals kept (3, N) so the weighted covariance is one (3, N) @
    # (N, 3) contraction; HIGHEST keeps it in float32 (a TF32 pass would
    # round the residuals to 10 mantissa bits before they are squared)
    res3 = jnp.stack(
        [
            particles[:, 0] - mean_xy[0],
            particles[:, 1] - mean_xy[1],
            normalize_angle_about(particles[:, 2], mean_theta),
        ],
        axis=0,
    )
    if mask is not None:
        res3 = jnp.where(mask[None, :], res3, 0.0)
    v2 = jnp.sum(wn * wn)
    denom = jnp.maximum(1.0 - v2, 1e-12)  # (V1 - V2/V1)/V1 with wn normalized
    cov = jnp.matmul(
        res3 * wn[None, :], res3.T, precision=jax.lax.Precision.HIGHEST
    ) / denom
    return PoseEstimate(mean=mean, cov=cov)


def estimate_pose_cluster(
    particles: jnp.ndarray,
    weights: jnp.ndarray,
    mask: jnp.ndarray | None = None,
    radius_xy: float = 0.5,
    radius_theta: float = 1.0,
    anchor: jnp.ndarray | None = None,
) -> PoseEstimate:
    """Mode-finding estimate: weighted mean over the top-weight cluster.

    The reference publishes the GLOBAL weighted mean (amcmh_localizer.py
    :584-597), which is meaningless while the cloud is multimodal (global
    localization / kidnapped recovery — it averages across modes).  Here the
    highest-weight particle anchors a (radius_xy, radius_theta) neighborhood
    and the estimate is the weighted mean over that neighborhood only.  For a
    unimodal converged cloud this equals the global mean; non-reference
    extension, enabled with ``FilterConfig.estimate_mode="cluster"``.

    ``anchor``: explicit cluster center — ``estimate_mode="anchor"``
    passes the hysteretic window anchor so the estimate stays on the
    COMMITTED mode instead of flipping with the per-scan argmax when two
    near-symmetric modes hold comparable mass.
    """
    w = jnp.where(mask, weights, 0.0) if mask is not None else weights
    if anchor is None:
        anchor = particles[jnp.argmax(w)]  # (3,) — one row gather
    dx = particles[:, 0] - anchor[0]
    dy = particles[:, 1] - anchor[1]
    dth = jnp.abs(normalize_angle_about(particles[:, 2], anchor[2]))
    near = (dx * dx + dy * dy <= radius_xy * radius_xy) & (dth <= radius_theta)
    cmask = near if mask is None else (near & mask)
    return estimate_pose(particles, weights, cmask)


def cluster_mass(
    particles: jnp.ndarray,
    weights: jnp.ndarray,
    pose: jnp.ndarray,
    radius_xy: float,
    radius_theta: float,
    mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Total weight within (radius_xy, radius_theta) of ``pose`` — the
    mode-mass signal used to gate window-anchor migration (filter/step.py):
    a single lucky coarse-scored particle has mass ~ its own weight, while
    a genuine competing mode accumulates resampled followers."""
    w = jnp.where(mask, weights, 0.0) if mask is not None else weights
    dx = particles[:, 0] - pose[0]
    dy = particles[:, 1] - pose[1]
    dth = jnp.abs(normalize_angle_about(particles[:, 2], pose[2]))
    near = (dx * dx + dy * dy <= radius_xy * radius_xy) & (dth <= radius_theta)
    return jnp.sum(jnp.where(near, w, 0.0))


def covariance_6x6(cov3: jnp.ndarray) -> jnp.ndarray:
    """Pack a 3x3 (x, y, theta) covariance into the ROS flat 6x6 layout
    (x, y, z, rot_x, rot_y, rot_z) used at amcmh_localizer.py:606-620."""
    flat = jnp.zeros(36, dtype=cov3.dtype)
    idx = jnp.array([0, 1, 5, 6, 7, 11, 30, 31, 35])
    vals = jnp.stack(
        [
            cov3[0, 0], cov3[0, 1], cov3[0, 2],
            cov3[1, 0], cov3[1, 1], cov3[1, 2],
            cov3[2, 0], cov3[2, 1], cov3[2, 2],
        ]
    )
    return flat.at[idx].set(vals)
