import pytest

from mcmh_localization.config import FilterConfig, parse_mode


@pytest.mark.parametrize(
    "mode,expected",
    [
        ("MCL", (False, False, False)),
        ("AMCL", (False, True, False)),
        ("MHMCL", (True, False, False)),
        ("MHAMCL", (True, True, False)),
        ("AMHMCL", (True, False, True)),
        ("AMHAMCL", (True, True, True)),
    ],
)
def test_parse_mode(mode, expected):
    # reference substring convention, amcmh_localizer.py:19-21
    assert parse_mode(mode) == expected


def test_config_flags():
    c = FilterConfig(mode="AMHAMCL")
    assert c.use_mh and c.use_adaptive and c.asymmetric
    c2 = c.with_mode("MCL")
    assert not (c2.use_mh or c2.use_adaptive or c2.asymmetric)


def test_config_hashable_static():
    a = FilterConfig()
    b = FilterConfig()
    assert hash(a) == hash(b) and a == b
    assert a.replace(num_particles=7).num_particles == 7


def test_max_particles_clamped():
    c = FilterConfig(num_particles=6000, max_particles=5000)
    assert c.max_particles == 6000


def test_from_yaml(tmp_path):
    p = tmp_path / "params.yaml"
    p.write_text(
        "localization_mode: \"MHAMCL\"\ninit_particles: 1234\n"
        "alpha1: 0.01 # comment\nmax_range: 6.0\nstep: 2\ninitialized: False\n"
    )
    c = FilterConfig.from_yaml(str(p))
    assert c.mode == "MHAMCL"
    assert c.num_particles == 1234
    assert c.alpha1 == 0.01
    assert c.max_range == 6.0
    assert c.step == 2
    assert c.initialized is False


def test_from_yaml_extension_keys(tmp_path):
    """Non-reference keys matching native field names pass through, with
    int fields coerced; unknown keys are ignored."""
    p = tmp_path / "flagship.yaml"
    p.write_text(
        "localization_mode: 'AMHAMCL'\ninit_particles: 2000\n"
        "likelihood_impl: corr\ncorr_window_cells: 96\n"
        "corr_theta_window_bins: 24\nestimate_mode: cluster\n"
        "motion_validity: score\nmin_injection_prob: 0.02\n"
        "not_a_field_at_all: 7\n"
    )
    c = FilterConfig.from_yaml(str(p))
    assert c.likelihood_impl == "corr"
    assert c.corr_window_cells == 96 and isinstance(c.corr_window_cells, int)
    assert c.corr_theta_window_bins == 24
    assert c.estimate_mode == "cluster"
    assert c.motion_validity == "score"
    assert c.min_injection_prob == 0.02
    # reference alias still wins over a direct field name collision
    q = tmp_path / "alias.yaml"
    q.write_text("init_particles: 111\nnum_particles: 999\n")
    assert FilterConfig.from_yaml(str(q)).num_particles == 111


def test_from_yaml_tuple_fields(tmp_path):
    """Tuple-typed fields (initial_pose / initial_cov) parse [a, b, c]
    list syntax; a scalar value for a tuple field raises immediately
    instead of corrupting the config and blowing up in model.init."""
    p = tmp_path / "pose.yaml"
    p.write_text(
        "initialized: true\ninitial_pose: [1.0, 2.0, 0.5]\n"
        "initial_cov: [0.1, 0.1, 0.2]\n"
    )
    c = FilterConfig.from_yaml(str(p))
    assert c.initial_pose == (1.0, 2.0, 0.5)
    assert c.initial_cov == (0.1, 0.1, 0.2)
    q = tmp_path / "bad.yaml"
    q.write_text("initial_pose: 1.0\n")
    with pytest.raises(ValueError, match="initial_pose"):
        FilterConfig.from_yaml(str(q))


def test_from_reference_yaml_if_present():
    from tests.reference_impl import reference_file

    path = reference_file("app/params/amhmcl.yaml")
    if path is None:
        pytest.skip("reference params not present (set MCMH_REFERENCE_REPO)")
    c = FilterConfig.from_yaml(path)
    assert c.mode == "AMHAMCL"
    assert c.num_particles == 1500
    assert c.alpha == (0.002, 0.03, 0.08, 0.002)
    assert c.sigma_hit == 0.3
    assert c.z_hit == 0.75
    assert c.max_range == 5.0
    assert c.kld_bin_size_xy == 0.20
    assert c.min_particles == 100 and c.max_particles == 5000


def test_config_enum_validation():
    import pytest as _pytest

    for kw in (
        dict(sensor_model="sonar"),
        dict(adaptive_resampler="bogus"),
        dict(likelihood_impl="fft"),
        dict(score_aggregation="max"),
        dict(corr_window_cells=100),
        dict(step=0),
    ):
        with _pytest.raises(ValueError):
            FilterConfig(**kw)
