"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: `inferno_tpu_torch` begins with `inferno_tpu` but is
not it."""

from __future__ import annotations

import ast
import os

import pytest

from benchmark import common

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "inferno_tpu"}
PROGRAM = "inferno_tpu_torch"


def _sources():
    for dirpath, _, files in os.walk(common.BENCH):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(_sources())


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, common.BENCH))
def test_no_jax_import(path):
    found = set(_top_level_imports(path)) & FORBIDDEN
    assert not found, f"{path} imports {sorted(found)}"


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(common.BENCH, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            found = set(_top_level_imports(os.path.join(ref, name))) & (FORBIDDEN | {PROGRAM})
            assert not found, f"reference/{name} imports {sorted(found)}"


def test_names_compare_whole():
    """The scan's rule and the run's own check both tell the port from the
    JAX package."""
    from benchmark.run import FORBIDDEN as RUN_FORBIDDEN, forbidden_modules

    assert PROGRAM.split(".")[0] not in FORBIDDEN | set(RUN_FORBIDDEN)
    assert "inferno_tpu" in RUN_FORBIDDEN
    import sys

    sys.modules.setdefault("inferno_tpu_torch", __import__("inferno_tpu_torch"))
    assert "inferno_tpu_torch" not in forbidden_modules()
