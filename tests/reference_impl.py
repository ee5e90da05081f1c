"""Plain-numpy golden implementations mirroring the reference semantics
(re-derived from the documented behavior in SURVEY.md §2.1; used only to
validate the vectorized JAX kernels against a straightforward loop form)."""

import os

import numpy as np


def reference_file(relpath):
    """Path of ``relpath`` inside the reference project's checkout, named by
    the MCMH_REFERENCE_REPO environment variable; None when that checkout
    (or the file) is not available."""
    root = os.environ.get("MCMH_REFERENCE_REPO")
    if not root:
        return None
    path = os.path.join(root, relpath)
    return path if os.path.exists(path) else None


def ref_likelihood_field_scores(
    particles, ranges, angles, distance_map, resolution, origin,
    width, height, sigma_hit, z_hit, z_rand, max_range, step,
):
    """Loop mirror of the likelihood-field scorer (parallel_utils.py:85-149)."""
    n = particles.shape[0]
    out = np.zeros(n, dtype=np.float64)
    for i in range(n):
        x, y, th = particles[i]
        acc = 0.0
        nvalid = 0
        for j in range(0, len(ranges), step):
            r = ranges[j]
            if not (np.isfinite(r) and r < max_range):
                continue
            nvalid += 1
            ex = x + r * np.cos(th + angles[j])
            ey = y + r * np.sin(th + angles[j])
            cx = int((ex - origin[0]) / resolution)
            cy = int((ey - origin[1]) / resolution)
            if cx < 0 or cx >= width or cy < 0 or cy >= height:
                continue
            d = distance_map[cy, cx]
            if d <= max_range:
                ph = np.exp(-0.5 * d * d / sigma_hit**2) / np.sqrt(
                    2 * np.pi * sigma_hit**2
                )
            else:
                ph = 0.0
            pr = 1.0 / max_range if 0 <= r <= max_range else 0.0
            acc += np.log(max(z_hit * ph + z_rand * pr, 1e-6))
        out[i] = acc / nvalid if nvalid > 0 else -50.0
    return out


def ref_likelihood_field_scores_np(
    particles, ranges, angles, distance_map, resolution, origin,
    width, height, sigma_hit, z_hit, z_rand, max_range, step, chunk=4096,
):
    """Array form of ``ref_likelihood_field_scores`` in float64: the same
    per-beam arithmetic (endpoint from ``th + angle``, toward-zero cell
    truncation, p_hit cutoff), evaluated over particle chunks so 1e5+
    particles stay practical.  Agrees with the loop form to float64
    rounding (tests/test_sensor.py)."""
    particles = np.asarray(particles, dtype=np.float64)
    r = np.asarray(ranges, dtype=np.float64)[::step]
    a = np.asarray(angles, dtype=np.float64)[::step]
    valid = np.isfinite(r) & (r < max_range)
    r, a = r[valid], a[valid]
    nvalid = int(valid.sum())
    out = np.full(particles.shape[0], -50.0)
    if nvalid == 0:
        return out
    dm = np.asarray(distance_map, dtype=np.float64)
    pr = 1.0 / max_range  # valid beams satisfy 0 <= r <= max_range
    for s in range(0, particles.shape[0], chunk):
        p = particles[s:s + chunk]
        ang = p[:, 2:3] + a[None, :]
        ex = p[:, 0:1] + r[None, :] * np.cos(ang)
        ey = p[:, 1:2] + r[None, :] * np.sin(ang)
        cx = np.trunc((ex - origin[0]) / resolution).astype(np.int64)
        cy = np.trunc((ey - origin[1]) / resolution).astype(np.int64)
        inside = (cx >= 0) & (cx < width) & (cy >= 0) & (cy < height)
        d = dm[np.clip(cy, 0, height - 1), np.clip(cx, 0, width - 1)]
        ph = np.where(
            d <= max_range,
            np.exp(-0.5 * d * d / sigma_hit**2)
            / np.sqrt(2 * np.pi * sigma_hit**2),
            0.0,
        )
        lp = np.log(np.maximum(z_hit * ph + z_rand * pr, 1e-6))
        out[s:s + chunk] = np.where(inside, lp, 0.0).sum(axis=1) / nvalid
    return out


def ref_systematic_indices(weights, num_out, r):
    """Systematic resampling in float64: slot m takes the first particle
    whose normalized cumulative weight exceeds u_m = (m + r) / num_out
    (the low-variance walk of parallel_utils.py:416-446)."""
    c = np.cumsum(np.asarray(weights, dtype=np.float64))
    c /= c[-1]
    u = (np.arange(num_out) + r) / num_out
    idx = np.searchsorted(c, u, side="right")
    return np.clip(idx, 0, len(c) - 1)


def ref_kld_stop_count(samples, bin_xy, bin_t, eps, z, max_samples,
                       min_particles, rule="every_sample"):
    """Python-set mirror of the KLD stopping walk on given jittered samples
    (kld_sampling_amcl, parallel_utils.py:529-591).  ``rule="new_bin"``
    reproduces the reference's quirk of checking the bound only on new-bin
    samples (parallel_utils.py:556-591); the default checks every sample
    (the shipped semantics)."""
    bins = set()
    count = 0
    while count < max_samples:
        p = samples[count]
        b = (int(p[0] / bin_xy), int(p[1] / bin_xy), int(p[2] / bin_t))
        new = b not in bins
        if new:
            bins.add(b)
        k = len(bins)
        if (new or rule == "every_sample") and k > 1 and count >= min_particles:
            chi2 = (k - 1) * (
                1 - 2 / (9 * (k - 1)) + np.sqrt(2 / (9 * (k - 1))) * z
            ) ** 3
            if count > chi2 / (2 * eps):
                break
        count += 1
    return count


def ref_motion_density(prev, curr, delta, alpha):
    """Loop mirror of the odometry motion density (parallel_utils.py:282-330)."""
    def wrap(a):
        return (a + np.pi) % (2 * np.pi) - np.pi

    def gauss(d, s):
        s = max(s, 1e-9)
        return np.exp(-0.5 * (d / s) ** 2) / np.sqrt(2 * np.pi * s * s)

    r1, t, r2 = delta
    a1, a2, a3, a4 = alpha
    n = prev.shape[0]
    p = np.zeros(n)
    for i in range(n):
        dx = curr[i, 0] - prev[i, 0]
        dy = curr[i, 1] - prev[i, 1]
        th = np.hypot(dx, dy)
        r1h = wrap(np.arctan2(dy, dx) - prev[i, 2])
        r2h = wrap(curr[i, 2] - prev[i, 2] - r1h)
        s1 = a1 * abs(r1) + a2 * abs(t)
        st = a3 * abs(t) + a4 * (abs(r1) + abs(r2))
        s2 = a1 * abs(r2) + a2 * abs(t)
        p[i] = gauss(wrap(r1 - r1h), s1) * gauss(t - th, st) * gauss(wrap(r2 - r2h), s2)
    s = p.sum()
    return p / s if s > 0 else p


def ref_raycast(pose_xy, angle, occupancy, resolution, origin, max_range, step=0.1):
    """Loop mirror of the fixed-step raycaster (parallel_utils.py:4-29)."""
    h, w = occupancy.shape
    cx, cy = np.cos(angle), np.sin(angle)
    n_steps = int(max_range / step)
    for i in range(1, n_steps + 1):
        px = pose_xy[0] + i * step * cx
        py = pose_xy[1] + i * step * cy
        gx = int((px - origin[0]) / resolution)
        gy = int((py - origin[1]) / resolution)
        if not (0 <= gx < w and 0 <= gy < h):
            return max_range
        if occupancy[gy, gx] > 0.5:
            return i * step
    return max_range


def ref_mcl_run(seed, bag, grid_map, n_particles, alpha, sigma_hit, z_hit,
                z_rand, max_range, beam_step=1, initial_pose=None,
                initial_cov=(0.05, 0.05, 0.1)):
    """Sequential full-filter MCL oracle: an INDEPENDENT plain-numpy
    implementation of the reference's plain-MCL pipeline (predict via the
    sampling odometry model, likelihood-field correct, low-variance
    resample every step; amcmh_localizer.py:404-533 control flow with the
    parallel_utils.py kernels), built only from this file's loop mirrors.

    The reference repo could launch stock ROS `amcl` as an external control
    (app/launch/amcl.launch:15-19); this is the equivalent here — a
    framework-independent baseline that a whole-framework systematic bias
    cannot hide from.  Returns (T, 3) pose estimates (weighted mean,
    circular in theta).
    """
    rng = np.random.default_rng(seed)
    dm = np.asarray(grid_map.distance)
    res = float(grid_map.resolution)
    origin = (float(grid_map.origin[0]), float(grid_map.origin[1]))
    h, w = dm.shape

    p0 = np.asarray(initial_pose if initial_pose is not None else bag.gt[0])
    particles = p0[None, :] + rng.normal(size=(n_particles, 3)) * np.asarray(
        initial_cov
    )
    odom = np.asarray(bag.odom, dtype=np.float64)
    ranges = np.asarray(bag.ranges, dtype=np.float64)
    angles = np.asarray(bag.angles, dtype=np.float64)

    def wrap(a):
        return (a + np.pi) % (2 * np.pi) - np.pi

    ests = np.zeros((len(odom), 3))
    for t in range(len(odom)):
        if t > 0:
            dx, dy = odom[t, 0] - odom[t - 1, 0], odom[t, 1] - odom[t - 1, 1]
            trans = np.hypot(dx, dy)
            rot1 = np.arctan2(dy, dx) - odom[t - 1, 2]
            rot2 = wrap(odom[t, 2] - odom[t - 1, 2]) - rot1
            a1, a2, a3, a4 = alpha
            s1 = a1 * abs(rot1) + a2 * abs(trans)
            st = a3 * abs(trans) + a4 * (abs(rot1) + abs(rot2))
            s2 = a1 * abs(rot2) + a2 * abs(trans)
            for i in range(n_particles):
                r1h = rot1 + rng.normal() * s1
                th_ = trans + rng.normal() * st
                r2h = rot2 + rng.normal() * s2
                particles[i, 0] += th_ * np.cos(particles[i, 2] + r1h)
                particles[i, 1] += th_ * np.sin(particles[i, 2] + r1h)
                particles[i, 2] = wrap(particles[i, 2] + r1h + r2h)
        scores = ref_likelihood_field_scores(
            particles, ranges[t], angles, dm, res, origin, w, h,
            sigma_hit, z_hit, z_rand, max_range, beam_step,
        )
        weights = np.exp(scores - scores.max())
        weights /= weights.sum()
        ests[t, 0] = weights @ particles[:, 0]
        ests[t, 1] = weights @ particles[:, 1]
        ests[t, 2] = np.arctan2(
            weights @ np.sin(particles[:, 2]), weights @ np.cos(particles[:, 2])
        )
        # low-variance (systematic) resample, numba kernel semantics
        # (parallel_utils.py:416-446)
        start = rng.random() / n_particles
        cum = np.cumsum(weights)
        out = np.empty_like(particles)
        j = 0
        for i in range(n_particles):
            u = start + i / n_particles
            while cum[j] < u and j < n_particles - 1:
                j += 1
            out[i] = particles[j]
        particles = out
    return ests
