"""`batch_pubkey` operands that reach the comb's edges, shared by the host
harness (tests/test_torch_ladders.py), the card's tests
(tests/test_torch_cuda.py) and chip_smoke.py. Host numpy arrays in the
wrapper's layout: k (N, 2, 4) int32 little-endian words of |k0|, |k1|,
neg (N, 2) bool their signs."""

from __future__ import annotations

import numpy as np

from grandine_tpu_torch.crypto.curves import LAMBDA

_ONES = (1 << 128) - 1

#: (|k0|, |k1|, k0 < 0, k1 < 0): half 0 zero (lane 0's sum is ∞); halves
#: below 2⁶⁴ (their upper windows all zero); halves (λ, 1) with equal
#: signs (the lanes' join doubles) and opposite signs (the join gives ∞:
#: row 3); halves of all-15 digits, one with a zero half 1 (lane 1's sum
#: is ∞)
COMB_EDGES = [(0, (1 << 127) + 12345, False, True),
              ((1 << 64) - 7, (1 << 63) + 1, True, False),
              (LAMBDA, 1, False, False), (LAMBDA, 1, False, True),
              (_ONES, _ONES, True, True), (_ONES, 0, False, False)]
#: the row of COMB_EDGES whose key is ∞
COMB_INF_ROW = 3


def halves_operands(rows):
    """[(|k0|, |k1|, neg0, neg1), …] → (k, neg), the wrapper's operands."""
    k = np.zeros((len(rows), 2, 4), np.uint32)
    neg = np.zeros((len(rows), 2), bool)
    for i, (a, b, na, nb) in enumerate(rows):
        k[i, 0] = np.frombuffer(a.to_bytes(16, "little"), "<u4")
        k[i, 1] = np.frombuffer(b.to_bytes(16, "little"), "<u4")
        neg[i] = na, nb
    return k.view(np.int32), neg
