"""Native C++ EDT tests (skipped when the library isn't built)."""

import numpy as np
import pytest
from scipy.ndimage import distance_transform_edt

from mcmh_localization import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="libmcmh_native.so not built"
)


def test_native_edt_matches_scipy_random():
    rng = np.random.default_rng(0)
    for shape in ((33, 47), (128, 128), (200, 64)):
        occ = rng.random(shape) < 0.08
        occ[0, 0] = True
        ref = distance_transform_edt(~occ)
        got = native.edt(occ)
        np.testing.assert_allclose(got, ref, atol=1e-4)


def test_native_edt_house(house_occupancy):
    occ = house_occupancy != 0
    ref = distance_transform_edt(~occ)
    got = native.edt(occ)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_native_edt_no_obstacles():
    occ = np.zeros((16, 16), dtype=bool)
    got = native.edt(occ)
    assert (got > 1e10).all()  # effectively infinite


def test_native_edt_all_obstacles():
    occ = np.ones((8, 8), dtype=bool)
    got = native.edt(occ)
    assert (got == 0).all()


def test_build_grid_map_native_path(house_occupancy):
    from mcmh_localization.maps.grid_map import build_grid_map

    m_native = build_grid_map(house_occupancy, 0.05, (-4.8, -4.8), edt_impl="native")
    m_scipy = build_grid_map(house_occupancy, 0.05, (-4.8, -4.8), edt_impl="scipy")
    np.testing.assert_allclose(
        np.asarray(m_native.distance), np.asarray(m_scipy.distance), atol=1e-4
    )
