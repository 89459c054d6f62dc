"""Host flatten/unflatten of Python string lists through a C helper.

Port of `custrings_tpu/native/build.py`.  The C source is the port's own
copy of the JAX package's `fastcolumn.c`, `csrc/fastcolumn.c`, compiled
with the system compiler into `build/custrings_tpu_torch/` at first use.
When there is no compiler (or no source), `load()` returns None and the
column module takes its pure-numpy host path.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sysconfig

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_PKG, "csrc", "fastcolumn.c")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "custrings_tpu_torch")

_mod = None
_tried = False


def load():
    """The compiled `fastcolumn` module, or None without a toolchain."""
    global _mod, _tried
    if _mod is not None or _tried:
        return _mod
    _tried = True
    if not os.path.exists(SRC):
        return None
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    so_path = os.path.join(BUILD_DIR, "fastcolumn" + suffix)
    if not os.path.exists(so_path) or os.path.getmtime(SRC) > os.path.getmtime(
        so_path
    ):
        os.makedirs(BUILD_DIR, exist_ok=True)
        include = sysconfig.get_paths()["include"]
        cc = os.environ.get("CC", "cc")
        tmp = f"{so_path}.{os.getpid()}.tmp"
        cmd = [cc, "-O2", "-shared", "-fPIC", f"-I{include}", SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
        os.replace(tmp, so_path)  # atomic: parallel test workers may race
    spec = importlib.util.spec_from_file_location("fastcolumn", so_path)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    except ImportError:
        return None
    _mod = mod
    return _mod
