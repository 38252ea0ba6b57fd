"""The port stands alone: no module of crdt_enc_tpu_torch, and not
chip_smoke.py, imports jax, jaxlib, the JAX package (crdt_enc_tpu) or
msgpack.  The machine with the card has none of them."""

from __future__ import annotations

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "crdt_enc_tpu", "msgpack"}
FILES = sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "crdt_enc_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
)


def imported_top_levels(tree: ast.AST) -> set:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and not node.args[0].value.startswith(".")):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_the_port_and_the_smoke_script_exist():
    assert "chip_smoke.py" in FILES
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES)
def test_no_forbidden_imports(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = imported_top_levels(tree) & FORBIDDEN
    assert not bad, f"{path} imports {sorted(bad)}"


def test_the_scan_catches_each_forbidden_form():
    src = (
        "import jax.numpy as jnp\nfrom crdt_enc_tpu.ops import orset\n"
        "import msgpack\nimportlib.import_module('jaxlib')\n"
        "from .ops import orset\nimport crdt_enc_tpu_torch\n"
    )
    assert imported_top_levels(ast.parse(src)) & FORBIDDEN == FORBIDDEN
