"""The port stands alone: no module of ``src/repro_torch/``, no script of
``examples_torch/`` and not ``chip_smoke.py`` imports JAX, anything of the JAX package ``repro``, or
``ml_dtypes`` (the card's machine has none; the checkpoint reads and
writes bfloat16 itself). Only the tests import them. And every test file of
the port imports ``tests/_torch_cpu.py`` (one intra-op thread a test
process: see its docstring)."""

import ast
import os

import pytest

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
EXAMPLES = os.path.join(REPO, "examples_torch")
TESTS = os.path.join(REPO, "tests")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for top in (PORT, EXAMPLES):
        for root, _, files in os.walk(top):
            out += [os.path.join(root, f) for f in files
                    if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "ml_dtypes") or \
        top.startswith("jax_")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    assert os.path.isfile(path), path
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_port_package_is_scanned():
    rel = {os.path.relpath(p, PORT) for p in _port_files()}
    for must in ("kernels/paged_kv.py", "serve/engine.py",
                 "models/transformer.py", "launch/serve.py", "bridge.py",
                 "kernels/bucket_pack.py", "core/bucketing.py",
                 "core/collectives.py", "core/progress.py", "core/vci.py",
                 "core/comm.py", "train/trainer.py", "launch/train.py",
                 "optim/adamw.py", "tree.py", "kernels/flash_attention.py",
                 "dist/sharding.py", "dist/tp.py", "checkpoint/io.py",
                 "launch/dryrun.py", "launch/inputs.py", "launch/mesh.py",
                 "launch/report.py", "launch/roofline.py",
                 "launch/ranks.py", "data/pipeline.py"):
        assert must in rel
    for name in sorted(os.listdir(os.path.join(REPO, "examples"))):
        if name.endswith(".py"):
            assert os.path.join("..", "..", "examples_torch", name) in rel


def _port_tests():
    return sorted(os.path.join(TESTS, f) for f in os.listdir(TESTS)
                  if f.startswith("test_torch_") and f.endswith(".py"))


@pytest.mark.parametrize("path", _port_tests(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_tests_import_the_one_thread_setup(path):
    """A top-level ``import _torch_cpu`` before the file's first import of
    the port, the reference or another test module (which may compute)."""
    tree = ast.parse(open(path).read(), filename=path)
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name if isinstance(n, ast.Import) else n.module or ""
             for n in top for a in n.names]
    assert "_torch_cpu" in names, path
    local = [i for i, m in enumerate(names) if m.split(".")[0] in
             ("repro", "repro_torch") or m.startswith("test_torch_")]
    assert not local or names.index("_torch_cpu") < local[0], path
