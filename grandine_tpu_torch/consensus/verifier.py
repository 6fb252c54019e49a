"""The batch-verification seam (counterpart of
grandine_tpu/consensus/verifier.py, reference helper_functions/src/
verifier.rs): transition code hands signature checks to a `Verifier` and
never sees which backend runs them.

  NullVerifier       — trust everything
  SingleVerifier     — eager per-signature verification on the host anchor
  MultiVerifier      — accumulate `Triple`s, one host RLC batch in finish()
  TorchVerifier      — accumulate `Triple`s, one flat RLC batch on the card
                       (`TorchBlsBackend.multi_verify_async`) in finish():
                       the port's block-verify entry point
  CollectingVerifier — defer everything into an external sink spanning
                       many blocks (a replay window)
"""

from __future__ import annotations

from typing import Sequence

from grandine_tpu_torch.crypto import bls as A
from grandine_tpu_torch.gpu.bls import TorchBlsBackend
from grandine_tpu_torch.consensus.keys import decompress_pubkey


class SignatureInvalid(Exception):
    """A signature (or batch of signatures) failed verification."""


class Triple:
    """One deferred signature check: 32-byte signing root, 96-byte
    compressed signature, and the (possibly aggregated) public key."""

    __slots__ = ("message", "signature", "public_key")

    def __init__(self, message: bytes, signature: bytes,
                 public_key: "A.PublicKey") -> None:
        self.message = bytes(message)
        self.signature = bytes(signature)
        self.public_key = public_key

    def __repr__(self) -> str:
        return f"Triple(msg={self.message.hex()[:16]}…)"


class Verifier:
    """Interface. `verify_singular`/`verify_aggregate` enqueue or eagerly
    check one signature; `extend` takes prebuilt triples; `finish` settles
    whatever was deferred, raising SignatureInvalid on failure."""

    def verify_singular(self, message: bytes, signature: bytes,
                        public_key: "A.PublicKey") -> None:
        raise NotImplementedError

    def verify_aggregate(self, message: bytes, signature: bytes,
                         public_keys: "Sequence[A.PublicKey]") -> None:
        """fast_aggregate_verify shape: many signers, one message. The keys
        are aggregated here (host G1 additions); an aggregate that sums to
        the identity is rejected at verification time."""
        if not public_keys:
            raise SignatureInvalid("aggregate with no public keys")
        self.verify_singular(message, signature,
                             A.PublicKey.aggregate(public_keys))

    def verify_aggregate_indexed(self, message: bytes, signature: bytes,
                                 member_indices: "Sequence[int]",
                                 pubkey_columns) -> None:
        """fast_aggregate_verify with the signers named by registry row
        indices into the state's compressed pubkey columns. Default:
        decompress (no subgroup check: registry keys passed KeyValidate
        at deposit) and delegate."""
        if not member_indices:
            raise SignatureInvalid("aggregate with no public keys")
        try:
            pks = [decompress_pubkey(pubkey_columns[int(i)], trusted=True)
                   for i in member_indices]
        except Exception as e:
            raise SignatureInvalid(f"invalid registry pubkey: {e}") from e
        self.verify_aggregate(message, signature, pks)

    def extend(self, triples: "Sequence[Triple]") -> None:
        for t in triples:
            self.verify_singular(t.message, t.signature, t.public_key)

    def finish(self) -> None:
        pass

    def finish_async(self):
        """Dispatch whatever finish() would settle; the returned zero-arg
        callable completes it (raising SignatureInvalid on failure)."""
        self.finish()
        return lambda: None

    def is_null(self) -> bool:
        return False


class NullVerifier(Verifier):
    """Trust every signature."""

    def verify_singular(self, message, signature, public_key) -> None:
        pass

    def verify_aggregate(self, message, signature, public_keys) -> None:
        pass

    def verify_aggregate_indexed(self, message, signature, member_indices,
                                 pubkey_columns) -> None:
        pass

    def extend(self, triples) -> None:
        pass

    def is_null(self) -> bool:
        return True


class SingleVerifier(Verifier):
    """Eager per-signature verification on the host anchor."""

    def verify_singular(self, message, signature, public_key) -> None:
        try:
            sig = A.Signature.from_bytes(signature)
        except A.BlsError as e:
            raise SignatureInvalid(f"malformed signature: {e}") from e
        if not sig.verify(bytes(message), public_key):
            raise SignatureInvalid(
                f"invalid signature over {bytes(message).hex()}")


class CollectingVerifier(Verifier):
    """Defer every check into an external cross-block sink; finish() is a
    no-op. `sink.add(message, signature, public_keys=...)` or
    `sink.add(message, signature, member_indices=..., pubkey_columns=...)`.
    An empty aggregate still raises here: it is a property of the block,
    not of a signature batch."""

    def __init__(self, sink) -> None:
        self.sink = sink

    def verify_singular(self, message, signature, public_key) -> None:
        self.sink.add(message, signature, public_keys=(public_key,))

    def verify_aggregate(self, message, signature, public_keys) -> None:
        if not public_keys:
            raise SignatureInvalid("aggregate with no public keys")
        self.sink.add(message, signature, public_keys=tuple(public_keys))

    def verify_aggregate_indexed(self, message, signature, member_indices,
                                 pubkey_columns) -> None:
        if not member_indices:
            raise SignatureInvalid("aggregate with no public keys")
        self.sink.add(message, signature,
                      member_indices=tuple(int(i) for i in member_indices),
                      pubkey_columns=pubkey_columns)

    def extend(self, triples) -> None:
        for t in triples:
            self.sink.add(t.message, t.signature, public_keys=(t.public_key,))


class MultiVerifier(Verifier):
    """Accumulate triples; one host RLC `multi_verify` in finish()."""

    def __init__(self) -> None:
        self.triples: "list[Triple]" = []

    def verify_singular(self, message, signature, public_key) -> None:
        self.triples.append(Triple(message, signature, public_key))

    def extend(self, triples) -> None:
        self.triples.extend(triples)

    def _decompress(self):
        """The triples as (messages, Signatures, keys); the host
        decompression keeps its subgroup check, so a signature outside G2
        raises SignatureInvalid here."""
        messages, signatures, keys = [], [], []
        for t in self.triples:
            try:
                signatures.append(A.Signature.from_bytes(t.signature))
            except A.BlsError as e:
                raise SignatureInvalid(f"malformed signature: {e}") from e
            messages.append(t.message)
            keys.append(t.public_key)
        return messages, signatures, keys

    def finish(self) -> None:
        if not self.triples:
            return
        messages, signatures, keys = self._decompress()
        if not A.multi_verify(messages, signatures, keys):
            raise SignatureInvalid(
                f"batch of {len(messages)} failed multi_verify")
        self.triples = []


class TorchVerifier(MultiVerifier):
    """MultiVerifier whose finish() runs the batch on the card through
    `TorchBlsBackend.multi_verify_async` (default backend on CUDA; raises
    without a card unless given device="cpu"). Counterpart of the JAX
    package's TpuVerifier."""

    def __init__(self, backend=None, device=None) -> None:
        super().__init__()
        self.backend = (TorchBlsBackend(device=device) if backend is None
                        else backend)

    def finish(self) -> None:
        self.finish_async()()

    def finish_async(self):
        """Launch the device batch now; the returned callable waits for
        the verdict, so host work between the two calls overlaps the
        device run."""
        if not self.triples:
            return lambda: None
        messages, signatures, keys = self._decompress()
        n = len(messages)
        self.triples = []
        pending = self.backend.multi_verify_async(messages, signatures, keys)

        def settle() -> None:
            if not pending():
                raise SignatureInvalid(
                    f"batch of {n} failed device multi_verify")

        return settle


__all__ = [
    "SignatureInvalid", "Triple", "Verifier", "NullVerifier",
    "SingleVerifier", "CollectingVerifier", "MultiVerifier", "TorchVerifier",
]
