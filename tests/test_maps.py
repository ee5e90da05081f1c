"""Tests for map loading, transforms, and the distance transform."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.ndimage import distance_transform_edt

from mcmh_localization.io.pgm import read_pgm, write_pgm, load_map_yaml
from mcmh_localization.maps.edt import distance_transform_edt_device
from mcmh_localization.maps.grid_map import build_grid_map, load_map


def test_pgm_roundtrip(tmp_path):
    img = (np.arange(64 * 48) % 251).astype(np.uint8).reshape(48, 64)
    path = str(tmp_path / "t.pgm")
    write_pgm(path, img)
    back = read_pgm(path)
    np.testing.assert_array_equal(img, back)


def test_pgm_comment_header(tmp_path):
    img = np.full((4, 6), 200, dtype=np.uint8)
    path = str(tmp_path / "c.pgm")
    with open(path, "wb") as f:
        f.write(b"P5\n# CREATOR: map_saver.cpp 0.050 m/pix\n6 4\n255\n")
        f.write(img.tobytes())
    back = read_pgm(path)
    np.testing.assert_array_equal(img, back)


def test_map_yaml_trinary(tmp_path):
    # 254 -> free, 0 -> occupied, 205 -> unknown (map_saver conventions)
    img = np.array(
        [[254, 0, 205], [254, 254, 0]], dtype=np.uint8
    )
    write_pgm(str(tmp_path / "m.pgm"), img)
    with open(tmp_path / "m.yaml", "w") as f:
        f.write(
            "image: ./m.pgm\nresolution: 0.05\norigin: [-1.0, -2.0, 0.0]\n"
            "negate: 0\noccupied_thresh: 0.65\nfree_thresh: 0.196\n"
        )
    occ, meta = load_map_yaml(str(tmp_path / "m.yaml"))
    assert meta["resolution"] == 0.05
    assert meta["origin"][:2] == (-1.0, -2.0)
    # vertical flip: image row 0 becomes occupancy row -1
    np.testing.assert_array_equal(occ[1], [0, 100, -1])
    np.testing.assert_array_equal(occ[0], [0, 0, 100])


def test_map_yaml_trinary_16bit(tmp_path):
    # 16-bit PGM must be normalized by 65535, not 255 (ADVICE.md io/pgm.py
    # finding): 65022/256 ~= the 8-bit 254 "free", 52480/256 ~= 205 "unknown"
    img16 = np.array([[65022, 0, 52480]], dtype=">u2")
    path = str(tmp_path / "m16.pgm")
    with open(path, "wb") as f:
        f.write(b"P5\n3 1\n65535\n")
        f.write(img16.tobytes())
    with open(tmp_path / "m16.yaml", "w") as f:
        f.write("image: ./m16.pgm\nresolution: 0.05\n")
    occ, _ = load_map_yaml(str(tmp_path / "m16.yaml"))
    np.testing.assert_array_equal(occ[0], [0, 100, -1])


def test_device_edt_matches_scipy(house_occupancy):
    occupied = house_occupancy != 0
    ref = distance_transform_edt(~occupied)
    dev = np.asarray(distance_transform_edt_device(jnp.asarray(occupied), 1.0))
    np.testing.assert_allclose(dev, ref, atol=1e-3)


def test_device_edt_random():
    rng = np.random.default_rng(0)
    occupied = rng.random((37, 53)) < 0.1
    occupied[0, 0] = True  # ensure nonempty
    ref = distance_transform_edt(~occupied)
    dev = np.asarray(distance_transform_edt_device(jnp.asarray(occupied), 1.0))
    np.testing.assert_allclose(dev, ref, atol=1e-3)


def test_world_grid_roundtrip(house_map):
    m = house_map
    x, y = m.grid_to_world(jnp.array([0, 10, 191]), jnp.array([0, 20, 191]))
    mx, my = m.world_to_grid(x, y)
    np.testing.assert_array_equal(np.asarray(mx), [0, 10, 191])
    np.testing.assert_array_equal(np.asarray(my), [0, 20, 191])


def test_world_to_grid_truncation(house_map):
    # reference semantics: int() truncation toward zero (parallel_utils.py:377)
    m = house_map
    mx, my = m.world_to_grid(jnp.float32(-4.8 + 0.149), jnp.float32(-4.8 + 0.051))
    assert int(mx) == 2 and int(my) == 1


def test_valid_mask(house_map):
    m = house_map
    particles = jnp.array(
        [
            [1.0, 1.0, 0.0],     # interior free (away from inner walls)
            [-4.8 + 8.5 * 0.05, 0.0, 0.0],  # on west wall
            [99.0, 99.0, 0.0],   # out of bounds
        ],
        dtype=jnp.float32,
    )
    mask = np.asarray(m.valid_mask(particles))
    assert mask.tolist() == [True, False, False]


def test_occupancy_at_fill(house_map):
    m = house_map
    v = m.occupancy_at(jnp.array([-5, 0]), jnp.array([0, -5]))
    assert (np.asarray(v) == 100).all()


def test_distance_positive_in_free_space(house_map):
    m = house_map
    interior = m.distance[90:100, 20:30]
    assert float(jnp.min(interior)) > 0.0


def test_load_reference_map_if_present():
    from tests.reference_impl import reference_file

    path = reference_file("app/maps/map_house.yaml")
    if path is None:
        pytest.skip("reference maps not present (set MCMH_REFERENCE_REPO)")
    m = load_map(path, edt_impl="scipy")
    assert m.width == 384 and m.height == 384
    assert float(m.resolution) == pytest.approx(0.05)
    np.testing.assert_allclose(np.asarray(m.origin), [-10.0, -10.0])
    # reference map has substantial free space
    frees = int(jnp.sum(m.occupancy == 0))
    assert frees > 10000


def test_house_map_shape_and_layout():
    from mcmh_localization.maps.house import house_occupancy

    occ = house_occupancy(0)
    assert occ.shape == (384, 384) and occ.dtype == np.int8
    assert set(np.unique(occ)) == {-1, 0, 100}
    # unknown border around the footprint, walls on its edge
    assert (occ[:30] == -1).all() and (occ[:, -30:] == -1).all()
    assert 0.4 < (occ == 0).mean() < 0.7


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_house_map_is_seeded(seed):
    from mcmh_localization.maps.house import house_occupancy

    np.testing.assert_array_equal(house_occupancy(seed),
                                  house_occupancy(seed))
    assert not np.array_equal(house_occupancy(seed),
                              house_occupancy(seed + 1))


@pytest.mark.parametrize("seed", [0, 3])
def test_house_map_start_pose_is_clear(seed):
    """World (0, 0) keeps >= 1.2 m of clearance on every seed."""
    from mcmh_localization.maps.house import make_house_map

    gm = make_house_map(seed, edt_impl="scipy")
    mx, my = gm.world_to_grid(0.0, 0.0)
    assert float(gm.distance[int(my), int(mx)]) >= 1.2
    assert gm.width == gm.height == 384
    assert float(gm.resolution) == pytest.approx(0.05)
    np.testing.assert_allclose(np.asarray(gm.origin), [-10.0, -10.0])
