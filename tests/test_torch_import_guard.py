"""No file that runs on the card imports JAX or the JAX package.

The machine with the card has neither ``jax``, ``jaxlib`` nor ``orbax``.
Every module of the port, every port example, ``chip_smoke.py`` and the
tools it and the examples' checks run are parsed, and each ``import`` and
``from ... import`` is held to that; ``vectorwave_tpu_torch`` itself is the
port, not the JAX package."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted([*(ROOT / "vectorwave_tpu_torch").rglob("*.py"),
                *(ROOT / "examples" / "torch").glob("*.py"),
                ROOT / "chip_smoke.py",
                ROOT / "tools" / "example_figures.py",
                ROOT / "tools" / "mirror_cases.py",
                ROOT / "tools" / "sweep_gates.py",
                ROOT / "tools" / "record_jax_examples.py"])
FORBIDDEN = ("jax", "jaxlib", "orbax", "vectorwave_tpu")


def imported_modules(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_file_imports_no_jax(path):
    bad = [m for m in imported_modules(path) if forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_guard_sees_what_it_guards_against(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom vectorwave_tpu.ops import dwt\n"
                     "from orbax import checkpoint\nimport vectorwave_tpu_torch\n"
                     "from . import sibling\n")
    assert [m for m in imported_modules(probe) if forbidden(m)] == [
        "jax.numpy", "vectorwave_tpu.ops", "orbax"]
    assert len(FILES) > 100
