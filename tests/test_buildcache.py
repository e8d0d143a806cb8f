"""Build and cache placement: content-keyed native libraries
(f5c_tpu/buildcache.py), the JAX compile cache location
(f5c_tpu/__init__.py) and the zstd codec's libzstd path (io/zstd.py)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRINT_CACHE = ("import f5c_tpu, jax; "
                "print(jax.config.jax_compilation_cache_dir); "
                "print(jax.config.jax_persistent_cache_min_compile_time_secs)")


def _cache_config(env_dir):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", _PRINT_CACHE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split()


def test_compile_cache_defaults_to_checkout():
    path, min_secs = _cache_config(None)
    assert path == os.path.join(REPO, ".jax_cache")
    assert float(min_secs) == 2.0


def test_compile_cache_env_decides_alone(tmp_path):
    path, min_secs = _cache_config(str(tmp_path))
    assert path == str(tmp_path)
    # nothing else is set in code when the variable is given: JAX's own
    # default stays
    assert float(min_secs) == 1.0


def test_keyed_path_tracks_source_command_and_host(tmp_path):
    from f5c_tpu import buildcache

    src = tmp_path / "a.c"
    src.write_text("int f(void) { return 1; }\n")
    base = buildcache.keyed_path("liba", str(src), ["cc", "-O2"], "v1")
    assert os.path.dirname(base) == buildcache.BUILD_DIR
    assert base == buildcache.keyed_path("liba", str(src), ["cc", "-O2"],
                                         "v1")
    assert base != buildcache.keyed_path("liba", str(src), ["cc", "-O3"],
                                         "v1")
    assert base != buildcache.keyed_path("liba", str(src), ["cc", "-O2"],
                                         "v2")
    src.write_text("int f(void) { return 2; }\n")
    assert base != buildcache.keyed_path("liba", str(src), ["cc", "-O2"],
                                         "v1")
    assert buildcache.host_cpu()


def test_tree_digest_tracks_header_contents(tmp_path):
    from f5c_tpu import buildcache

    inc = tmp_path / "include" / "xla" / "ffi"
    inc.mkdir(parents=True)
    (inc / "api.h").write_text("#define V 1\n")
    root = str(tmp_path / "include")
    base = buildcache.tree_digest(root)
    assert base == buildcache.tree_digest(root)
    (inc / "api.h").write_text("#define V 2\n")
    changed = buildcache.tree_digest(root)
    assert changed != base
    (inc / "ffi.h").write_text("")
    assert buildcache.tree_digest(root) != changed


def test_build_is_atomic_and_reused(tmp_path):
    from f5c_tpu import buildcache

    out = str(tmp_path / "x" / "lib.so")
    cmd = [sys.executable, "-c",
           "import sys; open(sys.argv[-1], 'w').write('ok')"]
    assert buildcache.build(out, cmd) == out
    assert open(out).read() == "ok"
    os.utime(out, (0, 0))
    buildcache.build(out, [sys.executable, "-c", "raise SystemExit(1)"])
    assert open(out).read() == "ok"          # existing build reused
    with pytest.raises(RuntimeError, match="failed"):
        buildcache.build(str(tmp_path / "y.so"),
                         [sys.executable, "-c", "raise SystemExit(3)"])
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_native_library_is_keyed():
    from f5c_tpu import native

    if not native.available():
        pytest.skip("no host compiler")
    path = native._build()
    assert os.path.basename(path).startswith("libf5chost-")
    assert path.startswith(os.path.join(REPO, ".build"))


def test_libzstd_codec_roundtrip():
    from f5c_tpu.io import zstd

    try:
        zstd._libzstd()
    except RuntimeError:
        pytest.skip("no system libzstd")
    data = os.urandom(2000) + b"acgt" * 50_000
    blob = zstd.compress(data)
    assert len(blob) < len(data) // 10
    assert zstd.decompress(blob) == data
    assert zstd.decompress(zstd.compress(data, level=1)) == data
    assert zstd.decompress(zstd.compress(b"")) == b""
    with pytest.raises(RuntimeError, match="zstd"):
        zstd.decompress(b"not a zstd frame")
