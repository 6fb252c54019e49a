"""The verify plane's device-mesh seam (counterpart of
grandine_tpu/tpu/mesh.py).

Every multi-device decision of the verify plane flows through ONE object
built here: a `VerifyMesh`, a power-of-two tuple of `torch.device`s over
the one `"batch"` axis. As in the reference,

  - device topology is INJECTED, never discovered, inside dispatch paths:
    `VerifyMesh.build` is the one place that enumerates devices;
  - the single-device node is the degenerate case: `mesh_or_none`
    collapses a 1-entry mesh to None, so every consumer behaves exactly
    as if there were no mesh;
  - the layouts are named once: `shard_range` is what `P("batch")` gives
    shard d of a length-n axis (per-signature operands, registry rows),
    `member_range` what `P(None, "batch")` gives it of the member axis of
    (M, K) grouped arrays; replicated operands are simply put on every
    shard.

A JAX mesh is one process driving a list of devices, and so is this one:
the sharded functions (gpu/bls.py `make_sharded_multi_verify*`) launch
each shard's kernels on its device from one thread, and the all-gather
becomes a stream-ordered copy of each shard's partial to the first
device. A list may name one device more than once (virtual shards, the
counterpart of XLA's virtual host devices): the CPU tests run D virtual
CPU shards, and one card runs D shards on `cuda:0`, which exercises every
launch, the split, the gather and the finish but not peer copies between
distinct cards.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

#: the one mesh axis name the verify plane shards over
BATCH_AXIS = "batch"


def normal_device(d) -> torch.device:
    """`d` as a torch.device with its CUDA index made explicit (the
    current device's for a bare "cuda"); raises without a card."""
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: a CUDA mesh needs a card "
                               "(platform='cpu' builds virtual CPU shards)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class VerifyMesh:
    """A power-of-two list of devices over one axis, and its layouts."""

    def __init__(self, devices: "Sequence", axis: str = BATCH_AXIS) -> None:
        devices = [normal_device(d) for d in devices]
        if not devices:
            raise ValueError("VerifyMesh needs at least one device")
        n = len(devices)
        if n & (n - 1):
            raise ValueError(
                f"VerifyMesh needs a power-of-two device count, got {n}")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"VerifyMesh mixes device types: {devices}")
        self.axis = axis
        self.devices = tuple(devices)

    # ----------------------------------------------------------- topology

    @property
    def device_count(self) -> int:
        return len(self.devices)

    @property
    def is_single(self) -> bool:
        """True for the degenerate 1-device mesh, which every consumer
        treats exactly like `mesh is None`."""
        return self.device_count == 1

    def describe(self) -> str:
        """Stable shape string for flight records (a field, never a
        metric label)."""
        return f"{self.axis}:{self.device_count}"

    def divides(self, n: int) -> bool:
        """True when a length-n batch axis shards evenly over the mesh."""
        return n >= self.device_count and n % self.device_count == 0

    # ----------------------------------------------------------- layouts

    def shard_range(self, n: int, d: int) -> "tuple[int, int]":
        """Rows [d·n/D, (d+1)·n/D) of a length-n axis: shard d's block
        under `P("batch")`. Raises unless the mesh divides n."""
        if not self.divides(n):
            raise ValueError(f"an axis of {n} does not shard over "
                             f"{self.device_count} devices")
        per = n // self.device_count
        return d * per, (d + 1) * per

    def member_range(self, k: int, d: int) -> "tuple[int, int]":
        """Members [d·k/D, (d+1)·k/D) of every group of a (M, K) member
        array: shard d's block under `P(None, "batch")`."""
        return self.shard_range(k, d)

    def put(self, tensors, d: int) -> tuple:
        """Place tensors (or numpy arrays) on shard d's device. A copy
        from host memory to a card goes through pinned memory without
        blocking, so it waits for no kernel queued earlier (a copy from
        pageable memory would first wait for the stream)."""
        dev = self.devices[d]
        out = []
        for t in tensors:
            if not isinstance(t, torch.Tensor):
                t = torch.from_numpy(np.array(t, order="C"))  # a copy
            if dev.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
            out.append(t.to(dev, non_blocking=True))
        return tuple(out)

    def gather(self, parts) -> torch.Tensor:
        """The all-gather's counterpart: one partial a shard (on shard d's
        device), copied to the first device and concatenated in shard
        order. Copies between cards are ordered on the streams (no host
        wait), so the result is complete before a kernel queued after it
        reads it."""
        dev = self.devices[0]
        return torch.cat([p.to(dev, non_blocking=True) for p in parts])

    # -------------------------------------------------------- construction

    @classmethod
    def build(cls, count: "Optional[int]" = None,
              platform: "Optional[str]" = None) -> "VerifyMesh":
        """Enumerate devices and build the mesh — the ONE place the verify
        plane lists devices. On CUDA (the default): the first `count`
        distinct cards, or with count=None every card rounded down to a
        power of two; a count the machine cannot satisfy raises. With
        platform="cpu": `count` virtual CPU shards (None: one)."""
        if platform == "cpu":
            count = 1 if count is None else count
            if count < 1:
                raise ValueError(f"mesh of {count} devices requested")
            return cls([torch.device("cpu")] * count)
        if platform not in (None, "cuda"):
            raise ValueError(f"unknown platform {platform!r}")
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass platform='cpu' for "
                               "virtual CPU shards")
        n = torch.cuda.device_count()
        if count is None:
            count = 1 << (n.bit_length() - 1)
        if count < 1 or count > n:
            raise ValueError(
                f"mesh of {count} devices requested, the machine has {n}")
        return cls([torch.device("cuda", i) for i in range(count)])


def mesh_or_none(mesh: "Optional[VerifyMesh]") -> "Optional[VerifyMesh]":
    """Normalize the degenerate mesh: a 1-device VerifyMesh and None are
    the SAME configuration to every consumer."""
    if mesh is None or mesh.is_single:
        return None
    return mesh


def resolve_mesh(mesh, device):
    """(mesh_or_none(mesh), the device its consumer runs on): with a mesh
    its first device, which a given `device` must name (else ValueError);
    without one `device` as given."""
    mesh = mesh_or_none(mesh)
    if mesh is None:
        return None, device
    first = mesh.devices[0]
    if device is not None and normal_device(device) != first:
        raise ValueError(f"device {device} is not the mesh's first device "
                         f"{first}")
    return mesh, first


__all__ = ["VerifyMesh", "mesh_or_none", "resolve_mesh", "normal_device",
           "BATCH_AXIS"]
