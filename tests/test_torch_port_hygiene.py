"""Import hygiene of the PyTorch port: no port module and not
``chip_smoke.py`` loads JAX, Flax, Optax, Orbax or the JAX package, at
import time (checked in a fresh interpreter) or in any import statement
(checked on the sources, which also covers imports inside functions)."""

import ast
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "attention_based_tbn_tpu_torch"
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "optax", "orbax")
JAX_PACKAGE = "attention_based_tbn_tpu"
DRAWING_ROOTS = ("matplotlib", "cv2", "PIL")


def forbidden(name: str) -> bool:
    """Exact package names or their submodules: the port's own name starts
    with the JAX package's, so a plain prefix test would be wrong."""
    root = name.split(".")[0]
    return root in FORBIDDEN_ROOTS or root == JAX_PACKAGE


def port_sources():
    for dirpath, _, files in os.walk(os.path.join(REPO, PACKAGE)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_forbidden_name_rule():
    assert forbidden("jax.numpy") and forbidden("attention_based_tbn_tpu.ops")
    assert forbidden("attention_based_tbn_tpu")
    assert not forbidden(PACKAGE) and not forbidden(PACKAGE + ".ops.kernels")
    assert not forbidden("jaxtyping_like") and not forbidden("torch")


def test_no_forbidden_import_statements():
    offenders = []
    for path in port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [(os.path.relpath(path, REPO), n) for n in names if forbidden(n)]
    assert not offenders


def test_importing_the_port_loads_no_jax():
    code = f"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {REPO!r})
import {PACKAGE}
names = [m.name for m in pkgutil.walk_packages({PACKAGE}.__path__, "{PACKAGE}.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(json.dumps({{"imported": names, "loaded": sorted(sys.modules)}}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    for module in ("tools.serve", "tools.export", "tools.train", "tools.test", "main",
                   "ops.kernels", "ops.pooling", "models.losses", "parallel.optim",
                   "parallel.train_step", "utils.metrics", "utils.checkpoint",
                   "utils.logging", "data.loader", "data.dataset", "data.classes",
                   "models.builder", "models.convert", "models.bridge", "tools.vis",
                   "models.convert_back", "models.convert_cli", "utils.platform"):
        assert f"{PACKAGE}.{module}" in result["imported"]
    assert [m for m in result["loaded"] if forbidden(m)] == []
    # drawing and video libraries load only where a figure or a clip is made
    assert [m for m in result["loaded"] if m.split(".")[0] in DRAWING_ROOTS] == []


def test_drawing_libraries_are_imported_only_inside_functions():
    """matplotlib, cv2 and PIL may be missing on a host: no port module and
    not chip_smoke.py imports them at module level."""
    offenders = []
    for path in port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in tree.body:
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [(os.path.relpath(path, REPO), n) for n in names
                          if n.split(".")[0] in DRAWING_ROOTS]
    assert not offenders


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, whatever the host has
    return subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                          cwd=cwd, env=env, timeout=300)


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    with open(os.path.join(REPO, "chip_smoke.py")) as src:
        (tmp_path / "chip_smoke.py").write_text(src.read())
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
