"""Visualization + TF-frame parity utilities.

Replaces the reference's RViz-facing layer with library equivalents:
  * ``particle_markers``     — weight-colored particle arrow data, the
    MarkerArray analogue (publish_particles, amcmh_localizer.py:538-581)
  * ``plot_particles``       — matplotlib rendering standing in for RViz
  * ``map_to_odom_transform``— the map->odom re-anchoring transform math
    (pose_broadcaster.py:43-86)
  * ``latched_initial_pose`` — the /initial_pose message content
    (initial_pose_pub.py:25-49)
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from mcmh_localization.utils.angles import normalize_angle


class ParticleMarkers(NamedTuple):
    """Render-ready particle glyphs (the MarkerArray analogue)."""

    positions: np.ndarray   # (K, 2)
    yaws: np.ndarray        # (K,)
    colors: np.ndarray      # (K, 3) rgb; r=weight, b=1-weight like :567-569
    quaternions: np.ndarray  # (K, 4) xyzw planar


def particle_markers(particles, weights, grid_map=None, count=None) -> ParticleMarkers:
    """Weight-colored particle glyphs, invalid-pose filtered.

    Mirrors publish_particles (amcmh_localizer.py:538-581): weights min-max
    normalized (:546), color red=high/blue=low, particles on non-free cells
    skipped (:552).
    """
    particles = np.asarray(particles)
    weights = np.asarray(weights)
    if count is not None:
        particles = particles[: int(count)]
        weights = weights[: int(count)]
    w = (weights - weights.min()) / (weights.max() - weights.min() + 1e-6)
    if grid_map is not None:
        import jax.numpy as jnp

        valid = np.asarray(grid_map.valid_mask(jnp.asarray(particles)))
    else:
        valid = np.ones(len(particles), dtype=bool)
    p = particles[valid]
    w = w[valid]
    yaw = p[:, 2]
    quat = np.stack(
        [np.zeros_like(yaw), np.zeros_like(yaw), np.sin(yaw / 2), np.cos(yaw / 2)],
        axis=1,
    )
    colors = np.stack([w, np.zeros_like(w), 1.0 - w], axis=1)
    return ParticleMarkers(p[:, :2], yaw, colors, quat)


def plot_particles(grid_map, particles, weights, estimate=None, count=None,
                   path=None, ax=None):
    """Matplotlib stand-in for the RViz particle view."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    markers = particle_markers(particles, weights, grid_map, count)
    occ = np.asarray(grid_map.occupancy)
    origin = np.asarray(grid_map.origin)
    res = float(grid_map.resolution)
    extent = [origin[0], origin[0] + occ.shape[1] * res,
              origin[1], origin[1] + occ.shape[0] * res]

    own_fig = ax is None
    if own_fig:
        fig, ax = plt.subplots(figsize=(7, 7))
    img = np.where(occ == 0, 1.0, np.where(occ > 0, 0.0, 0.5))
    ax.imshow(img, cmap="gray", origin="lower", extent=extent)
    ax.quiver(
        markers.positions[:, 0], markers.positions[:, 1],
        np.cos(markers.yaws), np.sin(markers.yaws),
        color=markers.colors, scale=40, width=2.5e-3, alpha=0.8,
    )
    if estimate is not None:
        est = np.asarray(estimate)
        ax.plot(est[0], est[1], "g*", markersize=15, label="estimate")
        ax.legend()
    ax.set_aspect("equal")
    if path and own_fig:
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return path
    return ax


def _pose_to_matrix(x, y, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0, x], [s, c, 0, y], [0, 0, 1, 0], [0, 0, 0, 1]])


def map_to_odom_transform(
    estimated_pose: Tuple[float, float, float],
    odom_to_base: Tuple[float, float, float],
):
    """T_map_odom = T_map_base . inv(T_odom_base), quaternion w forced >= 0.

    The planar equivalent of compute_map_to_odom_tf
    (pose_broadcaster.py:43-86): re-anchors the odometry frame so that
    composing map->odom->base reproduces the estimated pose.
    Returns (translation (3,), quaternion xyzw (4,)).
    """
    t_map_base = _pose_to_matrix(*estimated_pose)
    t_odom_base = _pose_to_matrix(*odom_to_base)
    t_map_odom = t_map_base @ np.linalg.inv(t_odom_base)
    yaw = np.arctan2(t_map_odom[1, 0], t_map_odom[0, 0])
    quat = np.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])
    quat /= np.linalg.norm(quat)
    if quat[3] < 0:
        quat = -quat
    trans = np.array([t_map_odom[0, 3], t_map_odom[1, 3], 0.0])
    return trans, quat


class FrameRecorder:
    """Live (during-run) particle visualization — the library stand-in for
    the reference's per-scan weight-colored MarkerArray stream into RViz
    (publish_particles, amcmh_localizer.py:538-581 + app/rviz/
    mcmh_view.rviz).  Every ``every``-th ``update`` renders the current
    cloud + estimate trail to a PNG frame in ``out_dir``; ``to_gif``
    assembles the frames into an animation.  Works headless (Agg)."""

    def __init__(self, grid_map, out_dir: str, every: int = 1,
                 gt=None, max_particles: int = 20000):
        import os

        self.grid_map = grid_map
        self.out_dir = out_dir
        self.every = max(int(every), 1)
        self.gt = None if gt is None else np.asarray(gt)
        self.max_particles = max_particles
        self.frames: list = []
        self.trail: list = []
        self._step = 0
        os.makedirs(out_dir, exist_ok=True)

    def update(self, particles, weights, estimate=None, count=None):
        import os

        step = self._step
        self._step += 1
        if estimate is not None:
            self.trail.append(np.asarray(estimate)[:2])
        if step % self.every:
            return None
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        particles = np.asarray(particles)
        weights = np.asarray(weights)
        if count is not None:
            particles = particles[: int(count)]
            weights = weights[: int(count)]
        if len(particles) > self.max_particles:
            # deterministic thinning keeps frames light at 1M particles
            stride = len(particles) // self.max_particles
            particles = particles[::stride]
            weights = weights[::stride]
        fig, ax = plt.subplots(figsize=(6, 6))
        plot_particles(self.grid_map, particles, weights,
                       estimate=estimate, ax=ax)
        if self.gt is not None and step < len(self.gt):
            ax.plot(self.gt[: step + 1, 0], self.gt[: step + 1, 1],
                    "c-", lw=0.8, label="ground truth")
            ax.plot(self.gt[step, 0], self.gt[step, 1], "co", ms=5)
        if len(self.trail) > 1:
            tr = np.asarray(self.trail)
            ax.plot(tr[:, 0], tr[:, 1], "g-", lw=0.8)
        ax.set_title(f"scan {step}")
        path = os.path.join(self.out_dir, f"frame_{step:05d}.png")
        fig.savefig(path, dpi=90, bbox_inches="tight")
        plt.close(fig)
        self.frames.append(path)
        return path

    def to_gif(self, path: str | None = None, fps: float = 5.0):
        """Assemble recorded frames into an animated GIF (PIL)."""
        import os

        if not self.frames:
            return None
        if path is None:
            path = os.path.join(self.out_dir, "run.gif")
        from PIL import Image

        ims = [Image.open(f) for f in self.frames]
        ims[0].save(
            path, save_all=True, append_images=ims[1:],
            duration=int(1000 / fps), loop=0,
        )
        return path


class TFReanchorer:
    """Live map->odom re-anchoring loop — the PoseBroadcaster node as a
    stream helper (pose_broadcaster.py:22,31-41,88-105; closes SURVEY.md
    L2).

    The reference node, per estimate message: look up the LATEST
    odom->base transform from the TF buffer (``Time(0)`` semantics,
    :37-41), compose ``T_map_odom = T_map_base . inv(T_odom_base)``
    (:43-86), and broadcast map->odom (:88-105).  Here ``on_odom`` plays
    the TF buffer (latest odom->base) and ``on_estimate`` plays
    pose_callback, returning the TransformStamped-equivalent dict (and
    recording it on ``.transforms``).

    Deviations (documented): when no odom->base is available yet the
    reference's lookup returns None and pose_callback would crash on it
    (pose_broadcaster.py:33-34 passes None into the math) — here the
    estimate is skipped and None returned.  ``stale_after`` optionally
    rejects odom older than the estimate by more than that many seconds
    (the ExtrapolationException analogue); default None = the reference's
    Time(0) latest-available behavior.
    """

    def __init__(self, stale_after: float | None = None):
        self.stale_after = stale_after
        self._odom = None          # (x, y, yaw)
        self._odom_stamp = None
        self.transforms: list = []  # broadcast history

    def on_odom(self, x: float, y: float, yaw: float, stamp: float | None = None):
        """Latest odom->base_footprint pose (the TF-listener feed)."""
        self._odom = (float(x), float(y), float(yaw))
        self._odom_stamp = stamp

    def on_estimate(self, pose3, stamp: float | None = None):
        """One estimate message -> one map->odom broadcast (or None when
        the odom lookup fails / is stale)."""
        if self._odom is None:
            return None
        if (
            self.stale_after is not None
            and stamp is not None
            and self._odom_stamp is not None
            and stamp - self._odom_stamp > self.stale_after
        ):
            return None
        trans, quat = map_to_odom_transform(tuple(pose3), self._odom)
        t = {
            "frame_id": "map",
            "child_frame_id": "odom",
            "stamp": stamp,
            "translation": tuple(float(v) for v in trans),
            "rotation": tuple(float(v) for v in quat),
        }
        self.transforms.append(t)
        return t

    def latest(self):
        return self.transforms[-1] if self.transforms else None


def sample_check(map_yaml: str | None, n: int = 500, seed: int = 0,
                 out: str = "particle_bound.png"):
    """Map-sampling sanity check: draw n uniform free-space poses and render
    them — the particle_generator.py / particle_bound.launch equivalent
    (SURVEY.md §2.2 'ParticleMarkerPublisher').  ``map_yaml=None`` uses the
    seeded in-repo house map."""
    import jax

    from mcmh_localization.filter.init import init_uniform
    from mcmh_localization.maps.grid_map import load_map
    from mcmh_localization.maps.house import make_house_map

    grid_map = load_map(map_yaml) if map_yaml else make_house_map()
    particles = init_uniform(jax.random.PRNGKey(seed), n, grid_map)
    weights = np.full(n, 1.0 / n)
    path = plot_particles(grid_map, np.asarray(particles), weights, path=out)
    # every sampled pose must be on a free cell — assert like a smoke test
    import jax.numpy as jnp

    valid = np.asarray(grid_map.valid_mask(jnp.asarray(particles)))
    print(f"sampled {n} poses, {valid.sum()} valid -> {path}")
    return path


def latched_initial_pose(
    x: float = -2.0, y: float = -0.5, yaw: float = 0.0, cov_diag=(0.25, 0.25, 0.0685)
):
    """The /initial_pose message content the reference latches once
    (initial_pose_pub.py:25-49): pose + 6x6 covariance with (x, y, yaw)
    diagonal entries."""
    cov = np.zeros(36)
    cov[0] = cov_diag[0]
    cov[7] = cov_diag[1]
    cov[35] = cov_diag[2]
    return {
        "position": (x, y, 0.0),
        "orientation": (0.0, 0.0, float(np.sin(yaw / 2)), float(np.cos(yaw / 2))),
        "covariance": cov,
        "pose3": (x, y, float(normalize_angle(np.float32(yaw)))),
    }


def _main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="mcmh-viz")
    sub = p.add_subparsers(dest="cmd", required=True)
    sc = sub.add_parser("sample-check", help="particle_bound.launch equivalent")
    sc.add_argument("--map", default=None,
                    help="ROS map YAML; default: the seeded house map")
    sc.add_argument("--n", type=int, default=500)
    sc.add_argument("--seed", type=int, default=0)
    sc.add_argument("--out", default="particle_bound.png")
    args = p.parse_args(argv)
    sample_check(args.map, args.n, args.seed, args.out)


if __name__ == "__main__":
    _main()
