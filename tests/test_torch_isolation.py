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
from grandine_tpu_torch.gpu.spans import SpanPlane

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
            "grandine_tpu_torch.consensus.keys",
            "grandine_tpu_torch.runtime.sign_plane",
            "grandine_tpu_torch.runtime.health",
            "grandine_tpu_torch.validator.duties",
            "grandine_tpu_torch.gpu.kzg", "grandine_tpu_torch.kzg.fr",
            "grandine_tpu_torch.kzg.setup",
            "grandine_tpu_torch.kzg.eip4844",
            "grandine_tpu_torch.crypto.ed25519",
            "grandine_tpu_torch.gpu.ed25519",
            "grandine_tpu_torch.runtime.verify_scheduler",
            "grandine_tpu_torch.runtime.flight",
            "grandine_tpu_torch.testing.chaos",
            "grandine_tpu_torch.tracing",
            "grandine_tpu_torch.slasher", "grandine_tpu_torch.gpu.spans",
            "grandine_tpu_torch.storage.database",
            "grandine_tpu_torch.spec_tests.snappy",
            "grandine_tpu_torch.native",
            "grandine_tpu_torch.testing.slasher"} <= set(mods)
    assert len(mods) >= 48
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


@pytest.mark.parametrize("cls", [TorchBlsBackend, DevicePubkeyRegistry,
                                 SpanPlane])
def test_entry_points_default_to_cuda(cls):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        cls()
    assert cls(device="cpu").device.type == "cpu"


def test_signing_entry_points_default_to_cuda():
    from grandine_tpu_torch.gpu.bls import g2_aggregate_groups
    from grandine_tpu_torch.crypto.bls import SecretKey
    from grandine_tpu_torch.runtime.sign_plane import SigningPlane
    from grandine_tpu_torch.validator.duties import device_aggregator

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        SigningPlane()
    with pytest.raises(RuntimeError, match="CUDA"):
        device_aggregator()
    with pytest.raises(RuntimeError, match="CUDA"):
        g2_aggregate_groups([[SecretKey(1).sign(b"m")]])


def test_verify_scheduler_defaults_to_cuda():
    from grandine_tpu_torch.gpu.ed25519 import Ed25519Backend
    from grandine_tpu_torch.runtime.verify_scheduler import VerifyScheduler

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        VerifyScheduler()
    with pytest.raises(RuntimeError, match="CUDA"):
        Ed25519Backend()
    sched = VerifyScheduler(device="cpu")
    try:
        assert sched.device.type == "cpu"
    finally:
        sched.stop()


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


@pytest.mark.parametrize("mod", ["kzg/fr.py", "kzg/setup.py",
                                 "kzg/eip4844.py", "gpu/kzg.py"])
def test_kzg_sources_read_no_path_of_the_reference(mod):
    """No string the code uses (docstrings aside) names a path under
    grandine_tpu/: the port reads its own ceremony copy and writes its
    cache under grandine_tpu_torch/kzg/data/."""
    tree = ast.parse(open(os.path.join(PKG, mod), encoding="utf-8").read())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            assert node.value.rstrip("/") != "grandine_tpu", mod
            assert "grandine_tpu/" not in node.value, mod


def test_kzg_entry_points_default_to_cuda():
    from grandine_tpu_torch.gpu import schemes
    from grandine_tpu_torch.kzg import eip4844 as K
    from grandine_tpu_torch.kzg import setup as S

    assert S._OFFICIAL_TXT.startswith(os.path.join(PKG, "kzg", "data"))
    assert S._OFFICIAL_CACHE.startswith(os.path.join(PKG, "kzg", "data"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        K.KzgDeviceBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        schemes.get("blob_kzg").make_backend()
    setup = S.dev_setup(8)
    blob = bytes(32 * 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        K.blob_to_kzg_commitment(blob, setup)
    with pytest.raises(RuntimeError, match="CUDA"):
        K.compute_kzg_proof(blob, bytes(32), setup)
    with pytest.raises(RuntimeError, match="CUDA"):
        K.compute_blob_kzg_proof(blob, K.G1_POINT_AT_INFINITY, setup)
    with pytest.raises(RuntimeError, match="CUDA"):
        K.verify_blob_kzg_proof_batch([blob] * 2, [K.G1_POINT_AT_INFINITY] * 2,
                                      [K.G1_POINT_AT_INFINITY] * 2, setup)
    assert K.KzgDeviceBackend(device="cpu").device.type == "cpu"
