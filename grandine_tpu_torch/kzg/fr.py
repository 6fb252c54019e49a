"""BLS12-381 scalar-field (Fr) helpers for KZG: roots of unity,
bit-reversal permutation, batch inversion, barycentric evaluation — the
port's own copy of grandine_tpu/kzg/fr.py (host code in both packages).

Spec parity: deneb/polynomial-commitments.md (compute_roots_of_unity,
bit_reversal_permutation, evaluate_polynomial_in_evaluation_form).
"""

from __future__ import annotations

from typing import Sequence

from grandine_tpu_torch.crypto.constants import R as BLS_MODULUS
from grandine_tpu_torch.crypto.fields import batch_inverse as _batch_inverse

#: multiplicative generator of Fr* (c-kzg PRIMITIVE_ROOT_OF_UNITY)
PRIMITIVE_ROOT = 7


def compute_roots_of_unity(order: int) -> "list[int]":
    """order-th roots of unity, natural order: w^0, w^1, …"""
    assert order & (order - 1) == 0, "order must be a power of two"
    assert (BLS_MODULUS - 1) % order == 0
    w = pow(PRIMITIVE_ROOT, (BLS_MODULUS - 1) // order, BLS_MODULUS)
    out = [1] * order
    for i in range(1, order):
        out[i] = out[i - 1] * w % BLS_MODULUS
    return out


def bit_reversal_permutation(values: Sequence) -> list:
    n = len(values)
    assert n & (n - 1) == 0
    bits = n.bit_length() - 1
    return [
        values[int(format(i, f"0{bits}b")[::-1], 2)] if bits else values[i]
        for i in range(n)
    ]


def batch_inverse(values: "Sequence[int]") -> "list[int]":
    """Montgomery batch inversion over Fr; zeros map to zero (callers
    guard the z == root case)."""
    return _batch_inverse(values, BLS_MODULUS)


def evaluate_polynomial_in_evaluation_form(
    evaluations: "Sequence[int]", z: int, roots_brp: "Sequence[int]"
) -> int:
    """Barycentric evaluation at z of the polynomial given by its
    evaluations at the bit-reversed roots of unity (spec
    evaluate_polynomial_in_evaluation_form)."""
    width = len(evaluations)
    assert len(roots_brp) == width
    z %= BLS_MODULUS
    # z coincides with a root: the evaluation is just that entry
    for i, r in enumerate(roots_brp):
        if z == r:
            return evaluations[i] % BLS_MODULUS
    inverses = batch_inverse([(z - r) % BLS_MODULUS for r in roots_brp])
    result = 0
    for f_i, r_i, inv_i in zip(evaluations, roots_brp, inverses):
        result += f_i * r_i % BLS_MODULUS * inv_i % BLS_MODULUS
    result %= BLS_MODULUS
    result = result * (pow(z, width, BLS_MODULUS) - 1) % BLS_MODULUS
    result = (
        result * pow(width % BLS_MODULUS, BLS_MODULUS - 2, BLS_MODULUS)
        % BLS_MODULUS
    )
    return result


__all__ = [
    "BLS_MODULUS",
    "PRIMITIVE_ROOT",
    "compute_roots_of_unity",
    "bit_reversal_permutation",
    "batch_inverse",
    "evaluate_polynomial_in_evaluation_form",
]
