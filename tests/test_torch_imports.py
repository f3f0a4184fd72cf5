"""The PyTorch port imports neither jax nor the JAX package.

mavmap_tpu_torch must run on a machine without JAX: every module is
imported in a fresh interpreter and `jax` must stay out of sys.modules.
"""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import mavmap_tpu_torch
from mavmap_tpu_torch.ops.cuda import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mavmap_tpu_torch")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([PKG], "mavmap_tpu_torch."))


def test_port_imports_without_jax():
    mods = _modules()
    assert {"mavmap_tpu_torch.sfm.mapper", "mavmap_tpu_torch.ba.core",
            "mavmap_tpu_torch.sfm.pipeline", "mavmap_tpu_torch.loop.voctree",
            "mavmap_tpu_torch.loop.detector", "mavmap_tpu_torch.cli",
            "mavmap_tpu_torch.features.detector", "mavmap_tpu_torch.features.cache",
            "mavmap_tpu_torch.sfm.outputs", "mavmap_tpu_torch.sfm.debug",
            "mavmap_tpu_torch.utils.io", "mavmap_tpu_torch.utils.imageio",
            "mavmap_tpu_torch.utils.timer", "mavmap_tpu_torch.utils.checkpoint",
            "mavmap_tpu_torch.utils.synthetic",
            "mavmap_tpu_torch.parallel", "mavmap_tpu_torch.parallel.multihost",
            "mavmap_tpu_torch.parallel.dist_ba", "mavmap_tpu_torch.parallel.dist_match",
            "mavmap_tpu_torch.parallel.dist_register"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'mavmap_tpu', 'PIL'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("mod", _modules() + ["chip_smoke"])
def test_source_has_no_jax_import(mod):
    """No module of the port, and not chip_smoke.py, names jax or
    mavmap_tpu in an import."""
    path = os.path.join(ROOT, *mod.split(".")) + ".py"
    if not os.path.exists(path):
        path = os.path.join(ROOT, *mod.split("."), "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "mavmap_tpu"), f"{mod} imports {n}"


@pytest.mark.parametrize("mod", _modules() + ["chip_smoke"])
def test_source_has_no_top_level_pillow_import(mod):
    """Pillow is not on the card's machine: no module of the port, and not
    chip_smoke.py, imports PIL when it is imported (the debug drawings
    import it inside the call that draws)."""
    path = os.path.join(ROOT, *mod.split(".")) + ".py"
    if not os.path.exists(path):
        path = os.path.join(ROOT, *mod.split("."), "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert all(n.split(".")[0] != "PIL" for n in names), f"{mod} imports {names}"


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a GPU")
def test_chip_smoke_refuses_without_gpu():
    """Without a CUDA device chip_smoke.py exits non-zero and prints no
    result line (it never falls back to the CPU)."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert '"ok"' not in out.stdout


def test_package_sets_full_precision_matmuls():
    assert mavmap_tpu_torch.__version__
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_kernel_argument_checks():
    """The CUDA wrappers validate dtype, rank and contiguity before any
    launch (checked here on CPU tensors)."""
    dev = torch.device("cpu")
    x = torch.zeros((4, 3))
    build.require(x, "x", torch.float32, 2, dev)
    with pytest.raises(TypeError):
        build.require(x.double(), "x", torch.float32, 2, dev)
    with pytest.raises(ValueError):
        build.require(x, "x", torch.float32, 1, dev)
    with pytest.raises(ValueError):
        build.require(x.T, "x", torch.float32, 2, dev)
    with pytest.raises(RuntimeError):
        build.check(700, "kernel")


def test_kernel_build_is_keyed_by_source_hash():
    d1 = build._digest()
    assert d1 == build._digest() and len(d1) == 16
    assert set(build.launches) == {"match", "match_batched", "seg_accum_full",
                                   "seg_accum_full_one_pass", "seg_accum_sorted"}
    build.launches["match"] += 1
    build.slots["match_batched"] += 3
    build.reset_launches()
    assert all(v == 0 for v in build.launches.values())
    assert all(v == 0 for v in build.slots.values())
