"""Process and file utilities: the pytree dataclass helper, the PNG writer
and the compilation-cache setup."""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from spcbpt_tpu.utils import struct
from spcbpt_tpu.utils.image import write_png


@struct.dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray = None
    tag: str = struct.field(pytree_node=False, default="x")


def test_struct_tree_roundtrip():
    p = _Pair(a=jnp.arange(3.0), b=jnp.ones((2, 2)), tag="y")
    leaves, tree = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2                     # static fields are not leaves
    q = jax.tree_util.tree_unflatten(tree, leaves)
    assert q.tag == "y"
    np.testing.assert_array_equal(q.a, p.a)
    # None fields are empty subtrees
    assert len(jax.tree_util.tree_leaves(_Pair(a=jnp.zeros(1)))) == 1


def test_struct_static_field_is_compile_time():
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.tag)
        return p.a * 2 if p.tag == "y" else p.a

    np.testing.assert_array_equal(f(_Pair(a=jnp.ones(2), tag="y")), [2, 2])
    np.testing.assert_array_equal(f(_Pair(a=jnp.ones(2), tag="z")), [1, 1])
    f(_Pair(a=jnp.zeros(2), tag="z"))
    assert traces == ["y", "z"]                 # a new tag recompiles


def test_struct_replace_and_frozen():
    p = _Pair(a=jnp.zeros(2), b=jnp.ones(2))
    q = p.replace(tag="w", b=None)
    assert (q.tag, q.b, p.tag) == ("w", None, "x")
    assert q.a is p.a
    with pytest.raises(Exception):
        p.a = jnp.ones(2)


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (64, 33)])
def test_png_roundtrip(tmp_path, read_png, shape):
    img = np.random.default_rng(0).integers(0, 256, shape + (3,), np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)


def test_png_rejects_non_rgb(tmp_path):
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "x.png"), np.zeros((4, 4), np.uint8))


_CACHE_PROBE = ("import jax; from spcbpt_tpu.runtime import setup; setup(); "
                "print(jax.config.jax_compilation_cache_dir)")


@pytest.mark.parametrize("env_dir", [True, False])
def test_runtime_setup_cache_dir(tmp_path, env_dir):
    """runtime.setup keeps JAX's compile cache where JAX_COMPILATION_CACHE_DIR
    says and sets no other; unset, the cache is the fixed <repo>/.jax_cache."""
    from spcbpt_tpu.runtime import DEFAULT_CACHE_DIR
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], env=env,
                         cwd=root, capture_output=True, text=True,
                         timeout=120, check=True).stdout.strip().splitlines()
    want = str(tmp_path / "cache") if env_dir else DEFAULT_CACHE_DIR
    assert out[-1] == want
