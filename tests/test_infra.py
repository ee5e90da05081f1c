"""Infrastructure: the pytree dataclass helper, the compile-cache location,
and chip_smoke.py's refusal to run without a GPU."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmh_localization.utils import compile_cache
from mcmh_localization.utils import pytree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytree.dataclass
class _Box:
    values: jnp.ndarray
    scale: jnp.ndarray
    name: str = pytree.field(pytree_node=False, default="box")


def test_pytree_replace_is_functional():
    b = _Box(values=jnp.arange(3.0), scale=jnp.float32(2.0))
    c = b.replace(scale=jnp.float32(5.0))
    assert float(b.scale) == 2.0 and float(c.scale) == 5.0
    assert c.values is b.values and c.name == "box"
    with pytest.raises(dataclasses.FrozenInstanceError):
        b.scale = 1.0


def test_pytree_static_fields_are_not_leaves():
    b = _Box(values=jnp.arange(3.0), scale=jnp.float32(2.0), name="tag")
    leaves, treedef = jax.tree_util.tree_flatten(b)
    assert len(leaves) == 2
    assert all(isinstance(x, jax.Array) for x in leaves)
    assert jax.tree_util.tree_unflatten(treedef, leaves).name == "tag"


def test_pytree_jit_round_trip():
    traces = []

    @jax.jit
    def scaled(b):
        traces.append(b.name)
        return b.replace(values=b.values * b.scale)

    b = _Box(values=jnp.arange(3.0), scale=jnp.float32(2.0), name="a")
    out = scaled(b)
    np.testing.assert_allclose(np.asarray(out.values), [0.0, 2.0, 4.0])
    assert out.name == "a"
    scaled(b.replace(scale=jnp.float32(3.0)))   # leaf change: cached
    scaled(b.replace(name="b"))                 # static change: retrace
    assert traces == ["a", "b"]


def test_filter_state_is_a_pytree(house_map, default_config):
    """The filter's own dataclasses flatten without flax."""
    from mcmh_localization.filter.step import make_model

    model = make_model(default_config, house_map)
    state = model.init(jax.random.PRNGKey(0))
    assert len(jax.tree_util.tree_leaves(state)) == 10
    assert len(jax.tree_util.tree_leaves(house_map)) == 6


def test_cache_dir_defaults_under_the_checkout(monkeypatch):
    calls = []
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in calls


def test_cache_dir_honours_the_environment(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []   # JAX reads the variable itself


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    out = _run_smoke(ROOT, "chip_smoke.py")
    assert out.returncode != 0
    assert "no GPU found" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_smoke(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_result_line_shape():
    sys.path.insert(0, ROOT)
    import chip_smoke

    class _Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([_Dev()] * 4)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


@pytest.mark.gpu
def test_vs_reference_on_gpu(gpu_devices):
    """chip_smoke's comparisons with the NumPy references, at small sizes,
    on the GPU (skips without one)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    sizes = chip_smoke.Sizes(bag_seconds=10.0, exact_n=(1_500,),
                             resample_n=1 << 16, kld_n=20_000)
    chip_smoke.phase_vs_reference(chip_smoke.Ctx(sizes, 0))
