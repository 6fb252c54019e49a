"""The verification outcome type the dispatch raises and catches
(counterpart of grandine_tpu/consensus/verifier.py SignatureInvalid)."""


class SignatureInvalid(Exception):
    """A signature (or batch of signatures) failed verification."""


__all__ = ["SignatureInvalid"]
