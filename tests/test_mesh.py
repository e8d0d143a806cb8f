"""Multi-device data parallelism: call-methylation and eventalign on the
vendored golden set, dealt over a 4-device virtual CPU mesh, must be
byte-identical to the one-device run (parallel/mesh_check.py).

The comparison runs in a subprocess because the device count is fixed
when JAX starts (this suite's own processes have 8 virtual devices)."""

import os
import subprocess
import sys


def test_sharded_align_matches_single():
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "PYTHONPATH": os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))),
    })
    out = subprocess.run(
        [sys.executable, "-m", "f5c_tpu.parallel.mesh_check"],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "4 devices == 1 device byte for byte" in out.stdout
    assert "[mesh_check] OK" in out.stdout
