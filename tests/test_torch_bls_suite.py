"""The in-repo BLS spec vectors (tests/vectors/bls/{verify,
fast_aggregate_verify}, the consensus-spec-tests layout) through the
port's single-item seams `TorchBlsBackend.verify` and
`fast_aggregate_verify`, with the verdicts tests/test_bls_suite.py expects
of the JAX package: on the plain versions (device="cpu", one case per
vector directory) and, under the `cuda` marker, on the kernels (skipped
without a card). The vector files are read by a small loader for their
flat layout (no YAML package needed on the card machine)."""

import os

import pytest
import torch

from grandine_tpu_torch.crypto import bls as A
from grandine_tpu_torch.gpu.bls import TorchBlsBackend

VECTORS = os.path.join(os.path.dirname(__file__), "vectors", "bls")
HANDLERS = ("verify", "fast_aggregate_verify")


def _scalar(text: str):
    text = text.strip()
    if text in ("true", "false"):
        return text == "true"
    if text == "[]":
        return []
    return text.strip("'\"")


def load_case(path: str) -> dict:
    """data.yaml of one case: {"input": {key: hex or [hex, …]}, "output":
    bool} — the two-level mapping with block lists these handlers use."""
    data, inp, key = {}, {}, None
    with open(os.path.join(path, "data.yaml")) as f:
        for line in f:
            if not line.strip():
                continue
            if not line.startswith(" "):
                name, _, rest = line.partition(":")
                data[name] = inp if name == "input" else _scalar(rest)
            elif line.lstrip().startswith("- "):
                inp[key].append(_scalar(line.lstrip()[2:]))
            else:
                key, _, rest = line.strip().partition(":")
                inp[key] = _scalar(rest) if rest.strip() else []
    return data


def cases():
    out = []
    for handler in HANDLERS:
        root = os.path.join(VECTORS, handler)
        out += [(handler, name) for name in sorted(os.listdir(root))
                if os.path.isdir(os.path.join(root, name))]
    return out


def unhex(s: str) -> bytes:
    return bytes.fromhex(s.removeprefix("0x"))


def verdict(backend, handler: str, inp: dict) -> bool:
    """The backend's verdict on one case; undecodable inputs are False
    before the backend is asked, as tests/test_bls_suite.py scores them."""
    message = unhex(inp["message"])
    try:
        sig = A.Signature.from_bytes(unhex(inp["signature"]))
        if handler == "verify":
            pk = A.PublicKey.from_bytes(unhex(inp["pubkey"]))
        else:
            pks = [A.PublicKey.from_bytes(unhex(p)) for p in inp["pubkeys"]]
    except A.BlsError:
        return False
    if handler == "verify":
        return backend.verify(message, sig, pk)
    return backend.fast_aggregate_verify(message, sig, pks)


def test_loader_reads_every_case_as_yaml_does():
    yaml = pytest.importorskip("yaml")
    assert len(cases()) >= 9
    for handler, name in cases():
        path = os.path.join(VECTORS, handler, name)
        with open(os.path.join(path, "data.yaml")) as f:
            assert load_case(path) == yaml.safe_load(f), path


@pytest.fixture(scope="module")
def cpu_backend():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the plain field ops are many tiny tensor ops
    yield TorchBlsBackend(device="cpu")
    torch.set_num_threads(n)


@pytest.mark.parametrize("handler,name", cases())
def test_vector_on_the_plain_versions(handler, name, cpu_backend):
    data = load_case(os.path.join(VECTORS, handler, name))
    assert verdict(cpu_backend, handler, data["input"]) is data["output"]


@pytest.fixture(scope="module")
def cuda_backend():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on a card")
    return TorchBlsBackend()


@pytest.mark.cuda
@pytest.mark.parametrize("handler,name", cases())
def test_vector_on_the_kernels(handler, name, cuda_backend):
    data = load_case(os.path.join(VECTORS, handler, name))
    assert verdict(cuda_backend, handler, data["input"]) is data["output"]
