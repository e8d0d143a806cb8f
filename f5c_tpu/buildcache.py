"""Content-keyed build outputs for the native libraries.

Each shared library is compiled from a committed source at first use
into ``<checkout>/.build/`` (listed in ``.gitignore``).  Its file name
carries a hash of everything that decides the binary: the source, the
compiler command line, the compiler's version, the external headers it
includes and, for code compiled with ``-march=native``, the host CPU.  A checkout copied to another
machine therefore never loads a library built for a different CPU,
compiler or source.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(ROOT, ".build")


def host_cpu() -> str:
    """The host CPU as ``-march=native`` sees it: model name + flags."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().splitlines()
    except OSError:
        import platform

        return platform.machine() + platform.processor()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(keep[:2])


def tree_digest(root: str) -> str:
    """Hash of every file under ``root`` (relative names and contents):
    the headers a source includes from outside the repo."""
    h = hashlib.sha256()
    for dirpath, dirnames, files in os.walk(root):
        dirnames.sort()
        for name in sorted(files):
            path = os.path.join(dirpath, name)
            h.update(os.path.relpath(path, root).encode() + b"\0")
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def keyed_path(stem: str, source: str, cmd: list[str], *extra: str) -> str:
    """``.build/<stem>-<hash>.so`` for this source + command + extras."""
    h = hashlib.sha256()
    with open(source, "rb") as f:
        h.update(f.read())
    for part in (" ".join(cmd), *extra):
        h.update(b"\0" + part.encode())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build(out_path: str, cmd: list[str]) -> str:
    """Run ``cmd + ['-o', tmp]`` unless ``out_path`` exists; atomic."""
    if os.path.exists(out_path):
        return out_path
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    tmp = f"{out_path}.tmp{os.getpid()}"
    res = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"build of {os.path.basename(out_path)} failed:"
                           f"\n{' '.join(cmd)}\n{res.stderr[-4000:]}")
    os.replace(tmp, out_path)
    return out_path
