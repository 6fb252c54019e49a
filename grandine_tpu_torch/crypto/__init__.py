"""BLS12-381 host arithmetic for the PyTorch port: the pure-Python
correctness anchor (point codecs, keys, signatures, the host pairing and
hash-to-G2), kept as the port's own copy so the port imports nothing of
the JAX package."""

from grandine_tpu_torch.crypto import constants, fields, curves, pairing, hash_to_curve, bls

__all__ = ["constants", "fields", "curves", "pairing", "hash_to_curve", "bls"]
