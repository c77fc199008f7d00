"""Nothing the benchmark runs loads JAX or the JAX package, with top-level
names compared whole; the reference loads nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from portbench.harness import guard

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)


def test_top_level_names_are_compared_whole():
    assert guard.found(["attention_based_tbn_tpu_torch", "attention_based_tbn_tpu_torch.ops"]) == []
    assert guard.found(["attention_based_tbn_tpu.models.tbn"]) == ["attention_based_tbn_tpu"]
    assert guard.found(["jaxlib.xla_client", "jaxtyping", "flax", "flaxen"]) == ["flax", "jaxlib"]
    assert guard.found(["jax"]) == ["jax"]


def _imports(path: str):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_of_the_benchmark_imports_jax():
    for root, _, files in os.walk(BENCH):
        for name in files:
            if name.endswith(".py"):
                found = guard.found(_imports(os.path.join(root, name)))
                assert found == [], (name, found)


def test_the_reference_imports_nothing_of_the_program():
    banned = guard.FORBIDDEN + (guard.PROGRAM,)
    folder = os.path.join(BENCH, "reference")
    for name in os.listdir(folder):
        if name.endswith(".py"):
            assert guard.found(_imports(os.path.join(folder, name)), banned) == [], name
    code = ("import sys, portbench.reference.tbn, portbench.reference.train;"
            "from portbench.harness import guard;"
            "print(guard.found(sys.modules, guard.FORBIDDEN + (guard.PROGRAM,)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True, env={**os.environ, "PYTHONPATH": REPO}).stdout
    assert out.strip() == "[]"


def test_a_cell_run_loads_no_jax():
    """The drivers and the program they drive, imported as a run imports
    them, load none of the forbidden modules."""
    code = ("import sys; from portbench.harness.catalog import Catalog; c = Catalog();"
            "[c.driver(d) for d in ('serve_closed', 'train')];"
            "import attention_based_tbn_tpu_torch.tools.serve, "
            "attention_based_tbn_tpu_torch.parallel.train_step;"
            "from portbench.harness import guard; print(guard.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True, env={**os.environ, "PYTHONPATH": REPO}).stdout
    assert out.strip() == "[]"
