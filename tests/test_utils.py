"""utils: pixel-chunked execution and the persistent compile-cache helper."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from fypraytracer_tpu.utils.chunking import map_chunks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_map_chunks_pads_and_trims():
    x = jnp.arange(10, dtype=jnp.float32)
    seen = []

    def fn(a):
        seen.append(a.shape)
        return a * 2.0

    out = map_chunks(fn, (x,), chunk=4)          # 10 -> 3 chunks of 4
    assert seen == [(4,)]                         # traced once under lax.map
    np.testing.assert_array_equal(np.asarray(out), np.arange(10) * 2.0)
    # a batch within one chunk runs unchunked
    np.testing.assert_array_equal(np.asarray(map_chunks(fn, (x,), chunk=16)),
                                  np.arange(10) * 2.0)


def test_map_chunks_numpy_path():
    x = np.arange(10, dtype=np.float32)
    y = np.ones((10, 3), np.float32)
    calls = []

    def fn(a, b):
        calls.append(len(a))
        return a[:, None] + b

    out = map_chunks(fn, (x, y), chunk=4)
    assert isinstance(out, np.ndarray)
    assert calls == [4, 4, 2]                     # plain loop, no padding
    np.testing.assert_array_equal(out, x[:, None] + y)


def test_map_chunks_pytree_outputs():
    x = jnp.arange(7, dtype=jnp.int32)
    v = jnp.ones((7, 2), jnp.float32)

    out = map_chunks(lambda a, b: {"i": a + 1, "nested": (b * a[:, None],)},
                     (x, v), chunk=3)
    np.testing.assert_array_equal(np.asarray(out["i"]), np.arange(7) + 1)
    assert out["nested"][0].shape == (7, 2)
    np.testing.assert_array_equal(np.asarray(out["nested"][0]),
                                  np.arange(7)[:, None] * np.ones((7, 2)))


def _cache_dir_in_subprocess(env):
    code = ("import jax; from fypraytracer_tpu.utils.compile_cache import "
            "enable_compile_cache; d = enable_compile_cache(); "
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120,
                         check=True)
    return out.stdout.split()


def test_compile_cache_honours_environment(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "c"),
               JAX_PLATFORMS="cpu")
    returned, configured = _cache_dir_in_subprocess(env)
    assert returned == configured == str(tmp_path / "c")


def test_compile_cache_defaults_to_repo_dir():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    returned, configured = _cache_dir_in_subprocess(env)
    assert returned == configured == os.path.join(REPO, ".jax_cache")
    # the directory is ignored by git, never committed
    ignore = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignore
