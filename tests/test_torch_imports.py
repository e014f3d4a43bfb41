"""The port stands alone: no module under sphericalsfm_tpu_torch/ imports
jax or the JAX package. An AST scan, not a subprocess import, because an
interpreter start-up hook may import jax by itself."""

import ast
import pathlib

import torch

torch.set_num_threads(1)

PKG = pathlib.Path(__file__).resolve().parents[1] / "sphericalsfm_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "sphericalsfm_tpu")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20, files
    bad = []
    for f in files:
        roots = set(_imported_roots(ast.parse(f.read_text(), filename=str(f))))
        bad += [f"{f.relative_to(PKG)}: {r}" for r in roots if r in FORBIDDEN]
    assert not bad, bad


def test_scan_catches_a_jax_import():
    tree = ast.parse("import numpy\nfrom jax import numpy as jnp\n"
                     "import sphericalsfm_tpu.geometry\n")
    assert {"jax", "sphericalsfm_tpu"} <= set(_imported_roots(tree))


def test_port_modules_import():
    import importlib

    for f in sorted(PKG.rglob("*.py")):
        rel = f.relative_to(PKG.parent).with_suffix("")
        name = ".".join(p for p in rel.parts if p != "__init__")
        importlib.import_module(name)
