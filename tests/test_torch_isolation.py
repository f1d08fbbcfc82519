"""The PyTorch port stands alone: no jax, no flax, and from the JAX package
only the numpy-only checkpoint converter (plus its data loaders, imported
lazily inside the inference tool's main)."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mvster_tpu_torch")

# what importing every module and exporting weights may load of the JAX package
ALLOWED_LOADED = {"mvster_tpu", "mvster_tpu.tools", "mvster_tpu.tools.convert_torch_ckpt"}

_PROBE = r"""
import importlib, pkgutil, sys
import numpy as np
import mvster_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mvster_tpu_torch.__path__, "mvster_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from mvster_tpu_torch.tools.weights import state_dict_from_jax
state_dict_from_jax({"params": {"feature": {"out1": {"kernel": np.zeros((1, 1, 2, 2), np.float32)}}}})
print(len(names))
print(" ".join(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "mvster_tpu"))))
"""


def test_importing_every_module_loads_no_jax():
    # tests/conftest.py imports jax into this process, so probe a fresh one
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().split("\n")
    assert int(lines[0]) >= 15, proc.stdout
    loaded = set(lines[1].split()) if len(lines) > 1 else set()
    assert not {m for m in loaded if m.split(".")[0] in ("jax", "jaxlib", "flax")}, loaded
    assert loaded <= ALLOWED_LOADED, loaded - ALLOWED_LOADED


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_only_the_converter_and_data_loaders():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    seen = {}
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax"), (path, mod)
            if top == "mvster_tpu":
                seen.setdefault(mod, []).append(os.path.relpath(path, REPO))
    allowed = {"mvster_tpu.tools.convert_torch_ckpt", "mvster_tpu.data",
               "mvster_tpu.data.common", "mvster_tpu.data.pfm"}
    assert set(seen) <= allowed, seen
    # the loaders (PIL, cv2) only from the inference tool, inside functions
    for mod, paths in seen.items():
        if mod.startswith("mvster_tpu.data"):
            assert paths == ["mvster_tpu_torch/tools/test.py"], (mod, paths)
