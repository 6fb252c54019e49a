"""BLS signature API (min_pk: 48-byte public keys in G1, 96-byte signatures
in G2) — the equivalent of the reference's `bls` crate public surface:

  SecretKey.sign                    (bls/src/secret_key.rs:82-86)
  PublicKey aggregation/validate    (bls/src/public_key.rs:21-55)
  Signature.verify                  (bls/src/signature.rs:49)
  Signature.aggregate[_in_place]    (bls/src/signature.rs:64-75)
  fast_aggregate_verify             (bls/src/signature.rs:78-93)
  multi_verify (batch, RLC)         (bls/src/signature.rs:96-129)
  CachedPublicKey                   (bls/src/cached_public_key.rs)

Point serialization is the ZCash/Ethereum compressed encoding (flag bits in
the top three bits of the first byte; Fp2 x-coordinate serialized c1 ‖ c0).

This module is the pure-Python correctness anchor. The CUDA batch backend
(`grandine_tpu_torch.gpu.bls.TorchBlsBackend`) mirrors its policy semantics; the
consensus layer chooses between them at its Verifier seam (the equivalent
of the reference's `helper_functions/src/verifier.rs:16-69`).
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import secrets
import threading
from typing import Iterable, Optional, Sequence

from grandine_tpu_torch.crypto import constants
from grandine_tpu_torch.crypto.curves import (
    B1,
    B2,
    G1,
    G2,
    Point,
    g1_infinity,
    g2_infinity,
)
from grandine_tpu_torch.crypto.fields import Fq, Fq2
from grandine_tpu_torch.crypto.hash_to_curve import hash_to_g2

P = constants.P
R = constants.R

_COMPRESSED_FLAG = 0x80
_INFINITY_FLAG = 0x40
_SIGN_FLAG = 0x20


class BlsError(ValueError):
    pass


# --- point (de)serialization ----------------------------------------------


def g1_to_bytes(p: Point[Fq]) -> bytes:
    if p.is_infinity():
        return bytes([_COMPRESSED_FLAG | _INFINITY_FLAG]) + b"\x00" * 47
    aff = p.to_affine()
    assert aff is not None
    x, y = aff
    flags = _COMPRESSED_FLAG
    if y.n > P - y.n:
        flags |= _SIGN_FLAG
    raw = x.n.to_bytes(48, "big")
    return bytes([raw[0] | flags]) + raw[1:]


def g1_from_bytes(data: bytes, subgroup_check: bool = True) -> Point[Fq]:
    if len(data) != 48:
        raise BlsError("G1 compressed point must be 48 bytes")
    flags = data[0]
    if not flags & _COMPRESSED_FLAG:
        raise BlsError("uncompressed G1 encoding not supported")
    if flags & _INFINITY_FLAG:
        if (flags & ~(_COMPRESSED_FLAG | _INFINITY_FLAG)) or any(data[1:]):
            raise BlsError("malformed G1 infinity encoding")
        return g1_infinity()
    x_int = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x_int >= P:
        raise BlsError("G1 x-coordinate out of range")
    x = Fq(x_int)
    y = (x.square() * x + B1).sqrt()
    if y is None:
        raise BlsError("G1 point not on curve")
    y_is_larger = y.n > P - y.n
    if bool(flags & _SIGN_FLAG) != y_is_larger:
        y = -y
    point = Point.from_affine(x, y, B1)
    if subgroup_check and not point.in_subgroup():
        raise BlsError("G1 point not in subgroup")
    return point


def _fq2_lex_larger(y: Fq2) -> bool:
    neg = -y
    return (y.c1.n, y.c0.n) > (neg.c1.n, neg.c0.n)


def g2_to_bytes(p: Point[Fq2]) -> bytes:
    if p.is_infinity():
        return bytes([_COMPRESSED_FLAG | _INFINITY_FLAG]) + b"\x00" * 95
    aff = p.to_affine()
    assert aff is not None
    x, y = aff
    flags = _COMPRESSED_FLAG
    if _fq2_lex_larger(y):
        flags |= _SIGN_FLAG
    raw = x.c1.n.to_bytes(48, "big") + x.c0.n.to_bytes(48, "big")
    return bytes([raw[0] | flags]) + raw[1:]


def g2_from_bytes(data: bytes, subgroup_check: bool = True) -> Point[Fq2]:
    if len(data) != 96:
        raise BlsError("G2 compressed point must be 96 bytes")
    flags = data[0]
    if not flags & _COMPRESSED_FLAG:
        raise BlsError("uncompressed G2 encoding not supported")
    if flags & _INFINITY_FLAG:
        if (flags & ~(_COMPRESSED_FLAG | _INFINITY_FLAG)) or any(data[1:]):
            raise BlsError("malformed G2 infinity encoding")
        return g2_infinity()
    c1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    c0 = int.from_bytes(data[48:96], "big")
    if c0 >= P or c1 >= P:
        raise BlsError("G2 x-coordinate out of range")
    x = Fq2.from_ints(c0, c1)
    y = (x.square() * x + B2).sqrt()
    if y is None:
        raise BlsError("G2 point not on curve")
    if bool(flags & _SIGN_FLAG) != _fq2_lex_larger(y):
        y = -y
    point = Point.from_affine(x, y, B2)
    if subgroup_check and not point.in_subgroup():
        raise BlsError("G2 point not in subgroup")
    return point


# --- key and signature types ----------------------------------------------


class SecretKey:
    __slots__ = ("_sk",)

    def __init__(self, sk: int) -> None:
        if not 0 < sk < R:
            raise BlsError("secret key out of range")
        self._sk = sk

    @staticmethod
    def keygen(ikm: bytes, key_info: bytes = b"") -> "SecretKey":
        """RFC/draft-irtf-cfrg-bls-signature KeyGen (HKDF-SHA-256 mod r)."""
        if len(ikm) < 32:
            raise BlsError("IKM must be at least 32 bytes")
        salt = b"BLS-SIG-KEYGEN-SALT-"
        while True:
            salt = hashlib.sha256(salt).digest()
            prk = hmac_mod.new(salt, ikm + b"\x00", hashlib.sha256).digest()
            okm = b""
            prev = b""
            info = key_info + (48).to_bytes(2, "big")
            for i in range(1, 3):
                prev = hmac_mod.new(
                    prk, prev + info + i.to_bytes(1, "big"), hashlib.sha256
                ).digest()
                okm += prev
            sk = int.from_bytes(okm[:48], "big") % R
            if sk != 0:
                return SecretKey(sk)

    @staticmethod
    def from_bytes(data: bytes) -> "SecretKey":
        if len(data) != 32:
            raise BlsError("secret key must be 32 bytes")
        return SecretKey(int.from_bytes(data, "big"))

    def to_bytes(self) -> bytes:
        return self._sk.to_bytes(32, "big")

    @property
    def scalar(self) -> int:
        return self._sk

    def public_key(self) -> "PublicKey":
        return PublicKey(G1.mul(self._sk))

    def sign(self, message: bytes, dst: bytes = constants.DST_SIGNATURE) -> "Signature":
        return Signature(hash_to_g2(message, dst).mul(self._sk))

    def __repr__(self) -> str:  # never leak key material
        return "SecretKey(<redacted>)"


class PublicKey:
    __slots__ = ("point",)

    def __init__(self, point: Point[Fq]) -> None:
        self.point = point

    @staticmethod
    def from_bytes(data: bytes) -> "PublicKey":
        # Mandatory validation on decompress, as in the reference
        # (bls/src/public_key.rs:21-27): subgroup membership AND rejection of
        # the identity element (IETF KeyValidate).
        point = g1_from_bytes(data, subgroup_check=True)
        if point.is_infinity():
            raise BlsError("identity public key is invalid")
        return PublicKey(point)

    def to_bytes(self) -> bytes:
        return g1_to_bytes(self.point)

    @staticmethod
    def aggregate(keys: "Sequence[PublicKey]") -> "PublicKey":
        acc = g1_infinity()
        for k in keys:
            acc = acc + k.point
        return PublicKey(acc)

    def __eq__(self, o: object) -> bool:
        return isinstance(o, PublicKey) and self.point == o.point

    def __hash__(self) -> int:
        return hash(self.to_bytes())


class CachedPublicKey:
    """Bytes + lazily-decompressed point (reference: bls/src/cached_public_key.rs).

    `decompress` is reachable from the scheduler's completion thread and
    from block-replay workers at once, so the first-use fill holds a
    per-instance lock: an unlocked check-then-set would let two threads
    decompress the same key concurrently (wasted work) and, worse, let a
    reader observe the attribute mid-publication. All access to
    `_decompressed` stays inside the lock — no bare fast-path read — so
    the lock-coverage lints can prove the attribute consistently
    protected (schedule-fuzz scenario: cached_pubkey).
    """

    __slots__ = ("_bytes", "_decompressed", "_lock")

    def __init__(self, data: bytes) -> None:
        self._bytes = bytes(data)
        self._decompressed: Optional[PublicKey] = None
        self._lock = threading.Lock()

    def as_bytes(self) -> bytes:
        return self._bytes

    def decompress(self) -> PublicKey:
        with self._lock:
            if self._decompressed is None:
                self._decompressed = PublicKey.from_bytes(self._bytes)
            return self._decompressed


class Signature:
    __slots__ = ("point",)

    def __init__(self, point: Point[Fq2]) -> None:
        self.point = point

    @staticmethod
    def from_bytes(data: bytes) -> "Signature":
        return Signature(g2_from_bytes(data, subgroup_check=True))

    def to_bytes(self) -> bytes:
        return g2_to_bytes(self.point)

    @staticmethod
    def empty() -> "Signature":
        return Signature(g2_infinity())

    def is_empty(self) -> bool:
        return self.point.is_infinity()

    # -- verification ------------------------------------------------------
    def verify(
        self,
        message: bytes,
        public_key: PublicKey,
        dst: bytes = constants.DST_SIGNATURE,
    ) -> bool:
        """e(pk, H(m)) == e(g1, sig), as one product check."""
        from grandine_tpu_torch.crypto.pairing import pairing_check

        if public_key.point.is_infinity():
            return False  # Eth2 rejects the identity public key
        return pairing_check(
            [(-G1, self.point), (public_key.point, hash_to_g2(message, dst))]
        )

    @staticmethod
    def aggregate(signatures: "Sequence[Signature]") -> "Signature":
        acc = g2_infinity()
        for s in signatures:
            acc = acc + s.point
        return Signature(acc)

    def aggregate_in_place(self, other: "Signature") -> None:
        self.point = self.point + other.point

    def fast_aggregate_verify(
        self,
        message: bytes,
        public_keys: "Sequence[PublicKey]",
        dst: bytes = constants.DST_SIGNATURE,
    ) -> bool:
        """All keys signed the same message (attestation aggregate)."""
        if not public_keys:
            return False
        if any(pk.point.is_infinity() for pk in public_keys):
            return False  # identity key would fake participation
        agg = PublicKey.aggregate(public_keys)
        return self.verify(message, agg, dst)

    def aggregate_verify(
        self,
        messages: "Sequence[bytes]",
        public_keys: "Sequence[PublicKey]",
        dst: bytes = constants.DST_SIGNATURE,
    ) -> bool:
        """Distinct messages: ∏ e(pkᵢ, H(mᵢ)) == e(g1, sig)."""
        from grandine_tpu_torch.crypto.pairing import pairing_check

        if len(messages) != len(public_keys) or not messages:
            return False
        if len(set(messages)) != len(messages):
            return False  # RO-suite requires distinct messages
        if any(pk.point.is_infinity() for pk in public_keys):
            return False
        pairs = [(-G1, self.point)]
        pairs += [
            (pk.point, hash_to_g2(m, dst)) for pk, m in zip(public_keys, messages)
        ]
        return pairing_check(pairs)

    def __eq__(self, o: object) -> bool:
        return isinstance(o, Signature) and self.point == o.point

    def __hash__(self) -> int:
        return hash(self.to_bytes())


def multi_verify(
    messages: "Sequence[bytes]",
    signatures: "Sequence[Signature]",
    public_keys: "Sequence[PublicKey]",
    dst: bytes = constants.DST_SIGNATURE,
    rng=secrets,
) -> bool:
    """Batch verification by random linear combination, the algebraic twin of
    `Signature::multi_verify` (bls/src/signature.rs:96-129): nonzero 64-bit
    scalars rᵢ; accept iff

        e(g1, Σ rᵢ·sigᵢ) == ∏ e(rᵢ·pkᵢ, H(mᵢ))

    i.e. N+1 Miller loops and a single final exponentiation.
    """
    from grandine_tpu_torch.crypto.pairing import pairing_check

    if not (len(messages) == len(signatures) == len(public_keys)):
        return False
    if not messages:
        return True
    if any(pk.point.is_infinity() for pk in public_keys):
        return False
    scalars = []
    for _ in messages:
        s = 0
        while s == 0:
            s = rng.randbits(64)
        scalars.append(s)
    sig_acc = g2_infinity()
    for s, sig in zip(scalars, signatures):
        sig_acc = sig_acc + sig.point.mul(s)
    pairs = [(-G1, sig_acc)]
    pairs += [
        (pk.point.mul(s), hash_to_g2(m, dst))
        for s, pk, m in zip(scalars, public_keys, messages)
    ]
    return pairing_check(pairs)


__all__ = [
    "BlsError",
    "SecretKey",
    "PublicKey",
    "CachedPublicKey",
    "Signature",
    "multi_verify",
    "g1_to_bytes",
    "g1_from_bytes",
    "g2_to_bytes",
    "g2_from_bytes",
]
