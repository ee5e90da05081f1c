"""3-D lidar likelihood-field sensor model (BASELINE stretch config #5).

Planar pose (x, y, theta) + 3-D scan: each beam j carries a range r_j,
a body-frame azimuth a_j, and an elevation e_j (a multi-ring/solid-state
lidar).  The endpoint in world coords is

    p_j = (x, y, z0) + r_j * [cos e_j cos(theta + a_j),
                              cos e_j sin(theta + a_j),
                              sin e_j]

scored with the same likelihood-field mixture as the 2-D workhorse
(``parallel_utils.py:85-149`` semantics: valid = finite & r < max_range;
out-of-volume endpoints count in the denominator with 0 contribution;
per-beam log(z_hit * N(d; sigma) + z_rand/max_range); blind scans score
-50) — against the 3-D EDT volume of a VoxelMap.

The whole scan is two outer products for the endpoints plus ONE gather
per (particle, beam) from the (D, H, W) distance volume.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mcmh_localization.config import FilterConfig
from mcmh_localization.maps.voxel_map import VoxelMap
from mcmh_localization.models.sensor import BLIND_SCORE, LOG_FLOOR


def lidar3d_scores(
    particles: jnp.ndarray,     # (N, 3) planar poses
    ranges: jnp.ndarray,        # (M,)
    directions: jnp.ndarray,    # (M, 2): [azimuth, elevation] body-frame
    voxel_map: VoxelMap,
    config: FilterConfig,
    sensor_z: float = 0.0,      # sensor height above the pose plane
) -> jnp.ndarray:
    """Per-particle log-likelihood scores, (N,) float32."""
    azimuth = directions[:, 0]
    elevation = directions[:, 1]
    if config.step > 1:
        ranges = ranges[:: config.step]
        azimuth = azimuth[:: config.step]
        elevation = elevation[:: config.step]

    valid = jnp.isfinite(ranges) & (ranges < config.max_range)
    safe_r = jnp.where(valid, ranges, 0.0)

    # horizontal/vertical components per beam (M,)
    ce = jnp.cos(elevation)
    u = safe_r * ce * jnp.cos(azimuth)
    v = safe_r * ce * jnp.sin(azimuth)
    w = safe_r * jnp.sin(elevation)

    cos_t = jnp.cos(particles[:, 2])[:, None]
    sin_t = jnp.sin(particles[:, 2])[:, None]
    ex = particles[:, 0][:, None] + cos_t * u[None, :] - sin_t * v[None, :]
    ey = particles[:, 1][:, None] + sin_t * u[None, :] + cos_t * v[None, :]
    ez = sensor_z + jnp.broadcast_to(w[None, :], ex.shape)

    vx, vy, vz = voxel_map.world_to_voxel(ex, ey, ez)
    in_vol = voxel_map.in_bounds(vx, vy, vz)
    d_, h, wd = voxel_map.distance.shape
    vxc = jnp.clip(vx, 0, wd - 1)
    vyc = jnp.clip(vy, 0, h - 1)
    vzc = jnp.clip(vz, 0, d_ - 1)

    # log-mixture table over distance is monotone in d only through the
    # Gaussian — precompute nothing, evaluate from the gathered distance
    # (the 2-D path's per-cell log table would be (D*H*W) — fine too, but
    # the gather is the cost either way and this keeps memory at 1 volume)
    dist = voxel_map.distance[vzc, vyc, vxc]

    sigma = config.sigma_hit
    inv_norm = 1.0 / (jnp.sqrt(2.0 * jnp.pi) * sigma)
    p_hit = inv_norm * jnp.exp(-0.5 * (dist / sigma) ** 2)
    prob = config.z_hit * p_hit + config.z_rand / config.max_range
    logp = jnp.log(jnp.maximum(prob, LOG_FLOOR))
    contrib = jnp.where(valid[None, :] & in_vol, logp, 0.0)

    count = jnp.sum(valid)
    total = jnp.sum(contrib, axis=1)
    if config.score_aggregation == "sum":
        score = total
    else:
        score = total / jnp.maximum(count, 1)
    return jnp.where(count > 0, score, BLIND_SCORE).astype(jnp.float32)


def simulate_scan3d(
    key: jax.Array,
    pose: jnp.ndarray,          # (3,) planar pose
    directions: jnp.ndarray,    # (M, 2) body-frame [azimuth, elevation]
    voxel_map: VoxelMap,
    max_range: float,
    sensor_z: float = 0.0,
    noise: float = 0.0,
) -> jnp.ndarray:
    """Ground-truth 3-D scan from a pose (simulator/golden path)."""
    from mcmh_localization.maps.voxel_map import raycast3d

    origin = jnp.asarray([pose[0], pose[1], sensor_z])
    r = raycast3d(
        origin, pose[2] + directions[:, 0], directions[:, 1],
        voxel_map, max_range,
    )
    if noise > 0:
        r = r + noise * jax.random.normal(key, r.shape)
    return jnp.clip(r, 0.05, max_range)
