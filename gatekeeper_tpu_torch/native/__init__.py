# Copied from gatekeeper_tpu/native/__init__.py for the PyTorch port.
"""Native columnar-ingest accelerator: build-on-first-import loader.

Compiles colext.c into a shared object under ``_build/`` (cached by
source hash) and exposes its functions; everything degrades silently to
the pure-Python implementations when a toolchain is unavailable or
``GATEKEEPER_NO_NATIVE=1`` is set.  The Python twins remain the
semantics contract — tests cross-check both paths.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig

available = False
elem_arrays = None
scalar_col = None
memb_fill = None
process_meta = None

MODE_CODES = {"str": 0, "val": 1, "num": 2, "len": 3, "present": 4,
              "truthy": 5}


def _build() -> object | None:
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "colext.c")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    build_dir = os.path.join(here, "_build")
    so_path = os.path.join(build_dir, f"_colext_{digest}.so")
    if not os.path.exists(so_path):
        os.makedirs(build_dir, exist_ok=True)
        include = sysconfig.get_paths()["include"]
        cc = os.environ.get("CC", "cc")
        cmd = [cc, "-O2", "-shared", "-fPIC", f"-I{include}", src,
               "-o", so_path + ".tmp"]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(so_path + ".tmp", so_path)
    loader = importlib.machinery.ExtensionFileLoader("_colext", so_path)
    spec = importlib.util.spec_from_file_location("_colext", so_path,
                                                  loader=loader)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_dtype(mode_code: int):
    import numpy as np
    if mode_code in (0, 1):          # str / val -> interner ids
        return np.int32
    if mode_code in (2, 3):          # num / len
        return np.float64
    return np.bool_                  # present / truthy


def _wrap(mod):
    """numpy views over the extension's raw cell buffers (the C side
    writes machine scalars, not PyObjects — see colext.c Buf)."""
    import numpy as np

    def scalar_col(objs, path, mode, ids, strings, encode_cb):
        buf = mod.scalar_col(objs, path, mode, ids, strings, encode_cb)
        return np.frombuffer(buf, dtype=_np_dtype(mode))

    def elem_arrays(objs, base, rels, modes, ids, strings, encode_cb):
        counts, cols = mod.elem_arrays(objs, base, rels, modes, ids,
                                       strings, encode_cb)
        return (np.frombuffer(counts, dtype=np.int32),
                [np.frombuffer(c, dtype=_np_dtype(m))
                 for c, m in zip(cols, modes)])

    return scalar_col, elem_arrays


if os.environ.get("GATEKEEPER_NO_NATIVE") != "1":
    try:
        _mod = _build()
        scalar_col, elem_arrays = _wrap(_mod)
        memb_fill = _mod.memb_fill
        process_meta = _mod.process_meta
        available = True
    except Exception:  # no toolchain / unexpected platform: Python paths
        available = False
