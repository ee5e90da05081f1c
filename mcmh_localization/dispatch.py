"""Size-dependent implementation choices, made in one place.

Each ``"auto"`` option of the filter resolves here, from what the code can
observe at trace time: the sensor model, the particle count, and whether a
scoring window is configured.  The choices and their crossovers were timed
on an NVIDIA H100 (PERF.md, "Decisions"; scripts/time_impls.py); none
depends on the platform name.
"""

from __future__ import annotations

from mcmh_localization.config import FilterConfig

# Windowed correlation field vs exact scorer, whole AMHAMCL steps x 360
# beams (H100): the exact scorer wins at 1,500 and 100k particles, the
# 128-cell window at 1M; the linear fits of the three points cross near
# 5e5.  The full-map field never wins.
CORR_MIN_PARTICLES = 500_000


def state_size(config: FilterConfig) -> int:
    """Static particle-array size for a config."""
    return config.max_particles if config.use_adaptive else config.num_particles


def likelihood_impl(config: FilterConfig) -> str:
    """``"jnp"`` (exact per-beam scorer) or ``"corr"`` (correlation field).

    ``auto``: the windowed correlation field at CORR_MIN_PARTICLES and
    above when a window is configured, else the exact scorer (its (N, M)
    endpoint gather fuses into one reduction over a table that fits in
    cache)."""
    if config.likelihood_impl != "auto":
        return config.likelihood_impl
    if config.corr_window_cells and state_size(config) >= CORR_MIN_PARTICLES:
        return "corr"
    return "jnp"


def beam_impl(config: FilterConfig) -> str:
    """Beam-model scorer: ``"dense"`` (per-particle ray march), ``"table"``
    (range-table lookup per beam) or ``"field"`` (windowed score field).

    ``auto`` is the range table: at 100k particles x 360 beams it beat the
    score field and was two orders of magnitude ahead of the dense march,
    which stays the explicit reference form."""
    impl = config.beam_impl
    if impl == "auto":
        impl = "table"
    if impl == "field" and not config.corr_window_cells:
        raise ValueError(
            "beam_impl='field' requires corr_window_cells > 0 (the beam "
            "score field is built over the particle-cloud window)"
        )
    return impl


def corr_field_builder(config: FilterConfig) -> str:
    """Builder of the correlation fields (the window's and the coarse
    fallback's) for ``field_impl="auto"``.

    ``"dft"`` (the correlation as float32 matmuls) beat the shifted-slice
    ``"xla"`` builder at the flagship window, on the full map and for the
    coarse field.  Its error is ~1e-5 of the
    field's magnitude: divided by the beam count under ``"mean"``
    aggregation, but unscaled in the log-weights under ``"sum"``, where the
    exact ``"xla"`` sums are kept."""
    return "dft" if config.score_aggregation == "mean" else "xla"
