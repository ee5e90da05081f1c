"""OnlineLocalizer: callback-style facade mirroring the reference node.

The reference's ``AMCMHLocalizer`` is a ROS node driven by /odom (~30 Hz)
and /scan (~5 Hz) callbacks (amcmh_localizer.py:104-105,294,379).  This
facade gives reference users the same mental model on top of the pure
filter: feed odometry poses and scans as they arrive; each odometry message
runs the (jitted) predict step, each scan runs the correct step and returns
the estimate.  Internally it is just FilterState threading — no threads, no
shared mutable arrays, no races (SURVEY.md §3 hazard note).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mcmh_localization.config import FilterConfig
from mcmh_localization.filter.step import make_model
from mcmh_localization.models.motion import compute_motion
from mcmh_localization.utils.angles import yaw_from_quaternion


class OnlineLocalizer:
    """Stateful wrapper: on_odom()/on_scan() like the reference's callbacks."""

    def __init__(
        self,
        config: FilterConfig,
        grid_map,
        seed: int = 0,
        initial_pose=None,
        voxel_map=None,
        staged: bool = False,
        tracking_capacity: int | None = None,
        tracking_ess_threshold: float | None = None,
        tracking_theta_bins: int | None = None,
        tracking_window_cells: int | None = None,
        frame_recorder=None,
    ):
        """``voxel_map``: VoxelMap for sensor_model="lidar3d" (grid_map is
        then the 2-D navigation slice; on_scan's ``angles`` becomes the
        (M, 2) [azimuth, elevation] direction array).

        ``staged=True`` runs the two-program execution (filter/staged.py)
        online: global/recovery phases use the full-capacity full-field
        program, converged tracking the small windowed one, switching
        per scan on the same count/injection/mode-dominance policy as
        run_staged.  Requires an adaptive mode.

        ``frame_recorder``: a ``viz.FrameRecorder`` — every on_scan
        renders the live cloud + estimate into it (the reference node's
        per-scan MarkerArray stream into RViz, amcmh_localizer.py:538-581,
        as a direct hook; settable later via ``.frame_recorder``)."""
        self.config = config
        self.grid_map = grid_map
        self.staged = None
        if staged:
            from mcmh_localization.filter.staged import make_staged_model
            from mcmh_localization.filter.step import state_size

            self.staged = make_staged_model(
                config, grid_map, tracking_capacity=tracking_capacity,
                voxel_map=voxel_map,
                tracking_ess_threshold=tracking_ess_threshold,
                tracking_theta_bins=tracking_theta_bins,
                tracking_window_cells=tracking_window_cells,
            )
            self._cap = state_size(self.staged.small_config)
            self._n_big = state_size(self.staged.config)
            self._in_small = False
            self.model = self.staged.big
        else:
            self.model = make_model(config, grid_map, voxel_map=voxel_map)
        self.state = self.model.init(
            jax.random.PRNGKey(seed), initial_pose=initial_pose
        )
        self._last_odom: Optional[np.ndarray] = None
        # per_scan batching: odom pose at the time of the last predict —
        # on_scan dispatches ONE predict covering everything since
        self._predicted_from: Optional[np.ndarray] = None
        self.last_info = None
        self._est_for = self._est_cache = None
        # live map->odom re-anchoring (pose_broadcaster node equivalent);
        # fed by on_odom, emits on every on_scan via .reanchor.latest()
        from mcmh_localization.viz import TFReanchorer

        self.reanchor = TFReanchorer()
        self.frame_recorder = frame_recorder

    # -- inputs --------------------------------------------------------------

    def set_initial_pose(self, x: float, y: float, yaw: float, seed: int = 1):
        """Re-initialize around a pose (the /initial_pose callback,
        amcmh_localizer.py:199-208)."""
        if self.staged is not None:
            # re-initialization is a global event: back to the big program
            self.model = self.staged.big
            self._in_small = False
        self.state = self.model.init(
            jax.random.PRNGKey(seed), initial_pose=jnp.asarray([x, y, yaw])
        )
        self._last_odom = None
        self._predicted_from = None

    def warmup(self, ranges, angles=None, angle_min=-np.pi, angle_max=np.pi):
        """Populate the jit caches for EVERY program this localizer can
        dispatch — outside any timed or real-time region.

        A cold compile takes seconds to minutes; under staged execution
        the SMALL program and the shrink/grow hand-off only compile at the
        FIRST stage switch, which otherwise lands inside the caller's
        deadline window.  Runs one throwaway
        predict+correct per program on a representative scan; the
        localizer's state, odometry bookkeeping, and estimate cache are
        untouched.  The online twin of ``filter.staged.warmup_staged``."""
        ranges = jnp.asarray(ranges, dtype=jnp.float32)
        if angles is None:
            angles = jnp.linspace(angle_min, angle_max, ranges.shape[0],
                                  dtype=jnp.float32)
        else:
            angles = jnp.asarray(angles, dtype=jnp.float32)
        delta = jnp.zeros(3, jnp.float32)
        if self.staged is None:
            programs = [(self.model, self.state)]
        else:
            from mcmh_localization.filter.staged import _handoff_fns

            shrink, grow = _handoff_fns(self.staged)
            big_state = grow(self.state) if self._in_small else self.state
            small_state = shrink(big_state)
            # the grow direction too: escalation back to the big program
            jax.block_until_ready(grow(small_state).particles)
            programs = [
                (self.staged.big, big_state),
                (self.staged.small, small_state),
            ]
        for model, st in programs:
            st = model.predict(st, delta)
            st, _ = model.correct(st, ranges, angles)
            jax.block_until_ready(st.particles)

    def on_odom(self, x: float, y: float, yaw: float, stamp: float | None = None):
        """Odometry pose update -> motion proposal (odom_callback,
        amcmh_localizer.py:379-408).  First message only seeds last_odom.

        With config.predict_batching="per_scan" this is host-side
        bookkeeping only (no device dispatch); on_scan runs one predict
        covering all odometry since the previous scan."""
        curr = np.asarray([x, y, yaw], dtype=np.float32)
        if self._last_odom is None:
            self._predicted_from = curr
        elif self.config.predict_batching == "per_message":
            delta = compute_motion(
                jnp.asarray(self._last_odom), jnp.asarray(curr)
            )
            self.state = self.model.predict(self.state, delta)
            self._predicted_from = curr
        self._last_odom = curr
        self.reanchor.on_odom(x, y, yaw, stamp)

    def on_odom_quaternion(self, x, y, qx, qy, qz, qw):
        """Odometry with quaternion orientation, as a ROS Odometry carries."""
        yaw = float(yaw_from_quaternion(qx, qy, qz, qw))
        self.on_odom(x, y, yaw)

    def on_scan(self, ranges, angles=None, angle_min=-np.pi, angle_max=np.pi):
        """Scan update -> full correction; returns the estimate dict
        (lidar_callback, amcmh_localizer.py:294-338).  ``angles`` defaults to
        the reference's linspace(angle_min, angle_max, M) layout
        (get_lidar_angles, :346-348)."""
        ranges = jnp.asarray(ranges, dtype=jnp.float32)
        if angles is None:
            angles = jnp.linspace(angle_min, angle_max, ranges.shape[0],
                                  dtype=jnp.float32)
        else:
            angles = jnp.asarray(angles, dtype=jnp.float32)
        if (
            self.config.predict_batching == "per_scan"
            and self._last_odom is not None
            and self._predicted_from is not None
            and not np.array_equal(self._predicted_from, self._last_odom)
        ):
            delta = compute_motion(
                jnp.asarray(self._predicted_from), jnp.asarray(self._last_odom)
            )
            self.state = self.model.predict(self.state, delta)
            self._predicted_from = self._last_odom
        self.state, info = self.model.correct(self.state, ranges, angles)
        self.last_info = info
        if self.staged is not None:
            from mcmh_localization.filter.staged import (
                _handoff_fns,
                next_stage,
            )

            shrink, grow = _handoff_fns(self.staged)
            # ONE batched fetch for the three policy scalars (each
            # np.asarray inside next_stage would be its own blocking
            # device-to-host round trip)
            cnt, p_rand, mass = jax.device_get(
                (info.count, info.p_random, info.anchor_mass)
            )
            nxt = next_stage(self._in_small, cnt, p_rand, mass, self._cap)
            if nxt and not self._in_small:
                self.state = shrink(self.state)
                self.model = self.staged.small
            elif self._in_small and not nxt:
                self.state = grow(self.state)
                self.model = self.staged.big
            self._in_small = nxt
        est = self.estimate()
        if est:
            # the pose_broadcaster loop: one map->odom re-anchor per
            # estimate (pose_broadcaster.py:31-35)
            self.reanchor.on_estimate(est["pose3"])
        if self.frame_recorder is not None:
            self.frame_recorder.update(
                self.state.particles, self.state.weights,
                estimate=(est["pose3"] if est else None),
                count=int(self.state.count),
            )
        return est

    # -- outputs -------------------------------------------------------------

    def estimate(self) -> dict:
        """Latest pose estimate in PoseWithCovarianceStamped-like form
        (publish_estimate, amcmh_localizer.py:584-623).

        Cached per step: each ``np.asarray`` of a device array is a
        blocking host<->device fetch, and on_scan already builds this dict
        internally — a second call per scan must not pay the fetches
        again."""
        if self.last_info is None:
            return {}
        if self._est_for is self.last_info:
            return self._est_cache
        # one batched device_get instead of two sequential fetches, and
        # the 6x6 ROS packing done host-side on the fetched values
        # (covariance_6x6 is jnp — calling it here would enqueue a fresh
        # device op + a third fetch per estimate)
        mean, cov = jax.device_get(
            (self.last_info.estimate.mean, self.last_info.estimate.cov)
        )
        yaw = float(mean[2])
        flat = np.zeros(36, dtype=np.float32)
        flat[[0, 1, 5, 6, 7, 11, 30, 31, 35]] = np.asarray(
            cov, dtype=np.float32
        ).reshape(-1)  # covariance_6x6's ROS layout (amcmh_localizer.py:606-620)
        est = {
            "position": (float(mean[0]), float(mean[1]), 0.0),
            "orientation": (0.0, 0.0, float(np.sin(yaw / 2)), float(np.cos(yaw / 2))),
            "covariance": flat,
            "pose3": (float(mean[0]), float(mean[1]), yaw),
        }
        self._est_for, self._est_cache = self.last_info, est
        return est

    def particles(self) -> tuple[np.ndarray, np.ndarray]:
        """(active particles, weights) for visualization."""
        n = int(self.state.count)
        return (
            np.asarray(self.state.particles[:n]),
            np.asarray(self.state.weights[:n]),
        )

    # -- checkpoint/resume -----------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """Persist the filter state (utils/checkpoint.py npz, bit-exact
        incl. PRNG key).  Under staged execution the array capacity
        identifies the active program, so no extra metadata is needed."""
        from mcmh_localization.utils.checkpoint import save_state

        save_state(path, self.state)

    def load_checkpoint(self, path: str) -> None:
        """Resume from ``save_checkpoint``.  Under staged execution the
        checkpoint's capacity selects the matching compiled program (BIG
        or SMALL); a capacity matching neither configuration is an error.
        Odometry bookkeeping resets — the next on_odom re-seeds it, as at
        construction."""
        from mcmh_localization.utils.checkpoint import load_state

        st = load_state(path)
        if self.staged is not None:
            cap = st.particles.shape[0]
            if cap == self._cap:
                self._in_small = True
                self.model = self.staged.small
            elif cap == self._n_big:
                self._in_small = False
                self.model = self.staged.big
            else:
                raise ValueError(
                    f"checkpoint capacity {cap} matches neither the big "
                    f"({self._n_big}) nor the tracking ({self._cap}) program"
                )
        elif st.particles.shape[0] != self.state.particles.shape[0]:
            raise ValueError(
                f"checkpoint capacity {st.particles.shape[0]} != model "
                f"capacity {self.state.particles.shape[0]}"
            )
        self.state = st
        self._last_odom = None
        self._predicted_from = None
        self.last_info = None
        self._est_for = self._est_cache = None
