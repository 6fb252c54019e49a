"""The PyTorch port stands alone: importing every module of
grandine_tpu_torch pulls in neither JAX nor the JAX package, no source
file of the port (or chip_smoke.py) imports either, and its entry points
run on the card unless the caller asks for the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import grandine_tpu_torch
from grandine_tpu_torch.gpu.bls import TorchBlsBackend
from grandine_tpu_torch.gpu.registry import DevicePubkeyRegistry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "grandine_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "grandine_tpu")


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([PKG], "grandine_tpu_torch.")
    )


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert {"grandine_tpu_torch.gpu.bls", "grandine_tpu_torch.runtime.isolation",
            "grandine_tpu_torch.consensus.keys"} <= set(mods)
    assert len(mods) >= 18
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(repr(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("rel", ["grandine_tpu_torch", "chip_smoke.py"])
def test_sources_import_nothing_of_the_reference(rel):
    path = os.path.join(ROOT, rel)
    files = [path] if path.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs
        if f.endswith(".py")
    ]
    assert files
    for f in files:
        bad = set(_imported_roots(f)) & set(FORBIDDEN)
        assert not bad, f"{f} imports {bad}"


@pytest.mark.parametrize("cls", [TorchBlsBackend, DevicePubkeyRegistry])
def test_entry_points_default_to_cuda(cls):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        cls()
    assert cls(device="cpu").device.type == "cpu"


def test_torch_verifier_defaults_to_cuda():
    from grandine_tpu_torch.consensus.verifier import TorchVerifier

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchVerifier()
    assert TorchVerifier(device="cpu").backend.device.type == "cpu"


def test_package_has_no_prebuilt_binary():
    for d, _, fs in os.walk(PKG):
        assert not any(f.endswith((".so", ".cubin", ".fatbin")) for f in fs
                       if "build" not in d), d
    assert grandine_tpu_torch.__name__ == "grandine_tpu_torch"
