"""The PyTorch port stands alone: it imports nothing of jax, jaxlib, flax,
optax or the JAX package (mvster_tpu), not even its numpy-only modules."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mvster_tpu_torch")
FORBIDDEN = ("mvster_tpu", "jax", "jaxlib", "flax", "optax")

# what importing every port module and exporting weights may load of the
# forbidden packages: nothing
ALLOWED_LOADED: set[str] = set()

_PROBE = r"""
import importlib, pkgutil, sys
import numpy as np
import mvster_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mvster_tpu_torch.__path__, "mvster_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from mvster_tpu_torch.tools.weights import state_dict_from_jax
state_dict_from_jax({"params": {"feature": {"out1": {"kernel": np.zeros((1, 1, 2, 2), np.float32)}}}})
print(" ".join(names))
print(" ".join(sorted(m for m in sys.modules if m.split(".")[0] in %r)))
""" % (FORBIDDEN,)


def test_importing_every_module_loads_no_jax():
    # tests/conftest.py imports jax into this process, so probe a fresh one
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().split("\n")
    names = set(lines[0].split())
    assert len(names) >= 30, proc.stdout
    # the data-parallel layer too (its process group, its reductions, the
    # image-row sharding) and the debug dumps
    assert {"mvster_tpu_torch.dist.mesh", "mvster_tpu_torch.dist.reduce",
            "mvster_tpu_torch.dist.spatial", "mvster_tpu_torch.utils.debug"} <= names, names
    loaded = set(lines[1].split()) if len(lines) > 1 else set()
    assert loaded <= ALLOWED_LOADED, loaded - ALLOWED_LOADED


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_only_the_converter_and_data_loaders():
    """The port's sources import nothing of the JAX package: its converter
    and data loaders are the port's own copies."""
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    seen = {}
    for path in files:
        for mod in _imports(path):
            if mod.split(".")[0] in FORBIDDEN:
                seen.setdefault(mod, []).append(os.path.relpath(path, REPO))
    assert not seen, seen
