"""The port stands alone: no module of ``src/repro_torch/``, no script of
``examples_torch/`` and not ``chip_smoke.py`` imports JAX, anything of the JAX package ``repro``, or
``ml_dtypes`` (the card's machine has none; the checkpoint reads and
writes bfloat16 itself). Only the tests import them."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
EXAMPLES = os.path.join(REPO, "examples_torch")


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
