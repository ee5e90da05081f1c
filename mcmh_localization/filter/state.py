"""FilterState: the complete filter state as one immutable pytree.

The reference keeps mutable arrays on a ROS node object, mutated
concurrently by the /odom and /scan callback threads with no locking
(amcmh_localizer.py:397-405 vs :305-338 — SURVEY.md §3 "concurrency
hazard").  Here ALL state is an immutable pytree threaded through pure step
functions: races are impossible by construction, the whole trajectory is a
``lax.scan``, and checkpoint/resume is trivial (the state is directly
serializable — see utils/checkpoint.py).

Arrays are padded to a static ``n_max`` with an ``count`` scalar giving the
active particle number (adaptive/KLD modes vary it; the reference reallocates
arrays instead, amcmh_localizer.py:520-522).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mcmh_localization.utils import pytree as struct


@struct.dataclass
class FilterState:
    particles: jnp.ndarray       # (n_max, 3) current particle set
    prev_particles: jnp.ndarray  # (n_max, 3) pre-proposal set (for MH)
    weights: jnp.ndarray         # (n_max,) normalized; 0 on inactive slots
    count: jnp.ndarray           # () int32 active particle count
    w_slow: jnp.ndarray          # () f32 augmented-MCL slow average
    w_fast: jnp.ndarray          # () f32 augmented-MCL fast average
    delta: jnp.ndarray           # (3,) last odometry delta (rot1, trans, rot2)
    anchor: jnp.ndarray          # (3,) top-weight pose of the last scored
                                 # scan, advanced by each odometry delta —
                                 # the window center under
                                 # config.window_center="anchor"
    anchor_streak: jnp.ndarray   # () int32 consecutive scans a different-
                                 # mode candidate has won the migration
                                 # tests (debounced commitment,
                                 # config.anchor_commit_scans); 0 between
                                 # challenges
    key: jax.Array               # PRNG key

    @property
    def n_max(self) -> int:
        return self.particles.shape[0]

    @property
    def active_mask(self) -> jnp.ndarray:
        return jnp.arange(self.n_max) < self.count


def make_state(
    particles: jnp.ndarray,
    count,
    key: jax.Array,
    n_max: int,
    w_init: float | None = None,
) -> FilterState:
    """Build an initial state from (count, 3) particles padded to n_max.

    Initial weights are uniform 1/count (amcmh_localizer.py:98).  w_slow and
    w_fast start at ``w_init``; the reference hardcodes 1e-3 (:86-87), which
    for N > 1000 sits above the steady-state w_avg = 1/N and triggers a long
    random-injection transient — the default here is 1/count
    (config.ref_compat_w_init restores the reference value).
    """
    n = particles.shape[0]
    pad = n_max - n
    if pad < 0:
        raise ValueError(f"{n} particles > n_max={n_max}")
    particles = jnp.pad(particles.astype(jnp.float32), ((0, pad), (0, 0)))
    # initial window anchor: the cloud mean (circular in theta) — no scan
    # has been scored yet, so there is no top-weight pose; on the first
    # correct the anchor refreshes to argmax-weight (filter/step.py)
    denom = jnp.float32(max(int(n), 1))
    mean_xy = jnp.sum(particles[:n, :2], axis=0) / denom
    mean_th = jnp.arctan2(
        jnp.sum(jnp.sin(particles[:n, 2])), jnp.sum(jnp.cos(particles[:n, 2]))
    )
    anchor = jnp.concatenate([mean_xy, mean_th[None]]).astype(jnp.float32)
    count = jnp.asarray(count, dtype=jnp.int32)
    mask = jnp.arange(n_max) < count
    weights = jnp.where(mask, 1.0 / jnp.maximum(count, 1), 0.0).astype(jnp.float32)
    if w_init is None:
        w_init = 1.0 / max(int(n), 1)
    return FilterState(
        particles=particles,
        prev_particles=particles,
        weights=weights,
        count=count,
        w_slow=jnp.float32(w_init),
        w_fast=jnp.float32(w_init),
        delta=jnp.zeros(3, dtype=jnp.float32),
        anchor=anchor,
        anchor_streak=jnp.zeros((), dtype=jnp.int32),
        key=key,
    )
