"""The warp programs of `rlc_finish`'s tail, of `miller_loop_pairs` and of
`aggregate_rlc_scale`'s G2 ladder, and the generator of their tables
(csrc/finish_programs.cuh).

One warp runs a group's Miller loop of (−g1, Σ rᵢ·sigᵢ), the product with
its f terms and the final exponentiation (csrc/finish_tail.cuh); one warp
runs a pair's Miller loop of (a Jacobian P, an affine Q) in
`miller_loop_pairs` on the same doubling and addition formulas, P's line
coefficients taken from a program group instead of −g1's constants; and
two warps of an `aggregate_rlc_scale` block run the halves of its G2 GLV
ladder (G2DBL, G2MADD) and join them (G2ADD). Each
step of that chain is a *program*: a straight-line set of Fp products,
each of two linear forms (small signed multiples of Fp values), grouped
into rounds of at most 32 independent products, one a lane, followed by
an output stage in which a lane writes one output Fp value as a linear
form of the products. The tower's additions (Karatsuba pre-sums and
post-sums, ξ and v multiplications, conjugations, the Granger–Scott
combinations) all live in those forms, so a program's dependent depth is
its number of rounds.

The programs are built here by running the formulas of
gpu/pairing.py and gpu/field.py (the same as csrc/bls12_381.cuh's) on
symbolic linear forms: a product of two forms becomes a node of the
program, and a form that is zero, a constant or one is folded. Then the
nodes are scheduled into rounds (longest path first, 32 a round), their
scratch slots allocated by liveness, and the tables written as C arrays.
`python -m grandine_tpu_torch.gpu.finish_programs` rewrites the header;
`tests/test_torch_finish_tail.py` requires the committed one to equal
what `header()` gives and runs every program, as `evaluate` does here,
against the plain field ops.

Fp12 groups hold 12 Fp values in the layout of csrc's `fp12` (c0.c0.c0,
c0.c0.c1, c0.c1.c0, … c1.c2.c1); a G2 point group holds x, y, z as Fp2
(6 values), an affine one x, y (4); a G1 coefficient group yP, zP³ and
−xP·zP (3).
"""

from __future__ import annotations

from grandine_tpu_torch.crypto.constants import P, X
from grandine_tpu_torch.crypto.curves import G1
from grandine_tpu_torch.crypto.fields import Fq2

#: lanes of a warp: the products of one round
WIDTH = 32
ABS_X = abs(X)
#: slot kinds of the tables (the high 4 bits of a 16-bit slot)
KIND_GROUP0, KIND_SCRATCH, KIND_CONST = 0, 4, 5


# --- linear forms ------------------------------------------------------------


class Lin:
    """Σ cₖ·xₖ over slots: ("i", group, index) an input, ("k", value) the
    constant `value` (canonical; at most one such term, coefficient 1),
    ("p", node) a product node."""

    __slots__ = ("t",)

    def __init__(self, terms=None):
        t, k = {}, 0
        for key, c in (terms or {}).items():
            if key[0] == "k":
                k = (k + c * key[1]) % P
            elif c:
                t[key] = t.get(key, 0) + c
        t = {key: c for key, c in t.items() if c}
        if k:
            t[("k", k)] = 1
        self.t = t

    def __add__(self, o):
        s = dict(self.t)
        for key, c in o.t.items():
            s[key] = s.get(key, 0) + c
        return Lin(s)

    def __sub__(self, o):
        return self + o.scale(-1)

    def __neg__(self):
        return self.scale(-1)

    def scale(self, n):
        return Lin({key: c * n for key, c in self.t.items()})

    def key(self):
        return tuple(sorted(self.t.items()))

    def is_zero(self):
        return not self.t

    def const(self):
        """The value of a constant form, else None."""
        if len(self.t) == 1:
            (key, c), = self.t.items()
            if key[0] == "k":
                return key[1] * c % P
        return None if self.t else 0

    def __eq__(self, o):
        return self.t == o.t

    __hash__ = None


ZERO = Lin()


def const(v):
    return Lin({("k", v % P): 1})


# --- programs ----------------------------------------------------------------


class Program:
    """A straight-line program over up to four groups of Fp values."""

    def __init__(self, name, groups):
        self.name = name
        self.groups = list(groups)  # (name, size)
        self.nodes = []  # (a, b) forms
        self.cse = {}
        self.outputs = []  # (group, index, form)

    def group(self, name):
        g = [n for n, _ in self.groups].index(name)
        return [Lin({("i", g, i): 1}) for i in range(self.groups[g][1])]

    def mul(self, a, b):
        if a.is_zero() or b.is_zero():
            return ZERO
        ca, cb = a.const(), b.const()
        if ca is not None and cb is not None:
            return const(ca * cb)
        if ca == 1:
            return b
        if cb == 1:
            return a
        ka, kb = a.key(), b.key()
        if kb < ka:
            a, b, ka, kb = b, a, kb, ka
        node = self.cse.get((ka, kb))
        if node is None:
            node = len(self.nodes)
            self.nodes.append((a, b))
            self.cse[(ka, kb)] = node
        return Lin({("p", node): 1})

    def output(self, name, values):
        """Values 0 .. len(values) of group `name`."""
        g = [n for n, _ in self.groups].index(name)
        if len(values) > self.groups[g][1]:
            raise ValueError(f"{self.name}: {len(values)} outputs to {name}")
        self.outputs += [(g, i, v) for i, v in enumerate(values)]


# --- the tower on forms (the formulas of gpu/field.py) -------------------------


def f2_add(a, b):
    return (a[0] + b[0], a[1] + b[1])


def f2_sub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def f2_neg(a):
    return (-a[0], -a[1])


def f2_scale(a, n):
    return (a[0].scale(n), a[1].scale(n))


def f2_conj(a):
    return (a[0], -a[1])


def f2_xi(a):
    return (a[0] - a[1], a[0] + a[1])


def f2_zero():
    return (ZERO, ZERO)


def f2_mul(pr, a, b):
    """Karatsuba (3 products); complex squaring (2) for a square;
    schoolbook over the non-zero components when one is zero."""
    a0, a1 = a
    b0, b1 = b
    if a0 == b0 and a1 == b1 and not (a0.is_zero() or a1.is_zero()):
        s = pr.mul(a0 + a1, a0 - a1)
        m = pr.mul(a0, a1)
        return (s, m.scale(2))
    if any(x.is_zero() for x in (a0, a1, b0, b1)):
        return (pr.mul(a0, b0) - pr.mul(a1, b1),
                pr.mul(a0, b1) + pr.mul(a1, b0))
    t0, t1 = pr.mul(a0, b0), pr.mul(a1, b1)
    t2 = pr.mul(a0 + a1, b0 + b1)
    return (t0 - t1, t2 - t0 - t1)


def f2_mul_fp(pr, a, k):
    return (pr.mul(a[0], k), pr.mul(a[1], k))


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def f6_v(a):
    return (f2_xi(a[2]), a[0], a[1])


def f6_mul(pr, a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0, t1, t2 = f2_mul(pr, a0, b0), f2_mul(pr, a1, b1), f2_mul(pr, a2, b2)
    t12 = f2_mul(pr, f2_add(a1, a2), f2_add(b1, b2))
    t01 = f2_mul(pr, f2_add(a0, a1), f2_add(b0, b1))
    t02 = f2_mul(pr, f2_add(a0, a2), f2_add(b0, b2))
    c0 = f2_add(t0, f2_xi(f2_sub(t12, f2_add(t1, t2))))
    c1 = f2_add(f2_sub(t01, f2_add(t0, t1)), f2_xi(t2))
    c2 = f2_add(f2_sub(t02, f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f12_mul(pr, a, b):
    """Karatsuba over Fp6: 18 Fp2 products (54 Fp products); a sparse line
    ((a, 0, 0), (0, b, c)) takes 14 of them (the reference's mul_by_line),
    the zero components' products being folded."""
    t0 = f6_mul(pr, a[0], b[0])
    t1 = f6_mul(pr, a[1], b[1])
    t2 = f6_mul(pr, f6_add(a[0], a[1]), f6_add(b[0], b[1]))
    return (f6_add(t0, f6_v(t1)), f6_sub(t2, f6_add(t0, t1)))


def f12_sq(pr, a):
    """The reference's fp12_sq_fast: (f0 + f1)(f0 + v·f1) and f0·f1, two
    Fp6 products (12 Fp2 products, 36 Fp products)."""
    f0, f1 = a
    s = f6_mul(pr, f6_add(f0, f1), f6_add(f0, f6_v(f1)))
    m = f6_mul(pr, f0, f1)
    return (f6_sub(s, f6_add(m, f6_v(m))), f6_add(m, m))


def _f4_sq(pr, a0, a1):
    """(a0 + a1·s)² over Fp4 = Fp2[s]/(s² − ξ): 3 Fp2 squarings."""
    t0 = f2_mul(pr, a0, a0)
    t1 = f2_mul(pr, a1, a1)
    s = f2_add(a0, a1)
    s2 = f2_mul(pr, s, s)
    return f2_add(f2_xi(t1), t0), f2_sub(f2_sub(s2, t0), t1)


def f12_cyclotomic_sq(pr, a):
    """The square of a value of the cyclotomic subgroup (Granger–Scott, in
    the arrangement of blst's cyclotomic_sqr_fp12 over the same tower): 9
    Fp2 squarings, 18 Fp products."""
    (a00, a01, a02), (a10, a11, a12) = a
    t00, t01 = _f4_sq(pr, a00, a11)
    t10, t11 = _f4_sq(pr, a10, a02)
    t20, t21 = _f4_sq(pr, a01, a12)

    def minus(t, x):  # 3t − 2x
        return f2_sub(f2_scale(t, 3), f2_scale(x, 2))

    def plus(t, x):  # 3t + 2x
        return f2_add(f2_scale(t, 3), f2_scale(x, 2))

    return ((minus(t00, a00), minus(t10, a01), minus(t20, a02)),
            (plus(f2_xi(t21), a10), plus(t01, a11), plus(t11, a12)))


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def _frob_consts(n):
    """γ_k = ξ^(k(pⁿ − 1)/6), the factor of w^k under x ↦ x^(pⁿ)."""
    xi = Fq2.from_ints(1, 1)
    return [xi.pow(k * (P ** n - 1) // 6) for k in range(6)]


_FROB = {n: _frob_consts(n) for n in (1, 2)}


def f12_frobenius(pr, a, n):
    """a^(pⁿ): each coefficient conjugated n times and scaled by γ_k, k
    its power of w (coefficient (i, j) multiplies w^(2j + i))."""
    out = []
    for i in range(2):
        row = []
        for j in range(3):
            c = a[i][j]
            if n % 2:
                c = f2_conj(c)
            g = _FROB[n][2 * j + i]
            row.append(f2_mul(pr, c, (const(g.c0.n), const(g.c1.n))))
        out.append(tuple(row))
    return tuple(out)


def f12_of(v):
    """12 forms → the nested Fp12."""
    f2 = [(v[2 * i], v[2 * i + 1]) for i in range(6)]
    return ((f2[0], f2[1], f2[2]), (f2[3], f2[4], f2[5]))


def flat12(a):
    return [x for six in a for two in six for x in two]


def f2s_of(v):
    return [(v[2 * i], v[2 * i + 1]) for i in range(len(v) // 2)]


def flat2(points):
    return [x for two in points for x in two]


# --- the Miller loop steps (gpu/pairing.py double_step, add_step) --------------

_NEG_G1 = (-G1).to_affine()
#: the line coefficients of P = −g1 (affine, zP = 1): yP, zP³ = 1, −xP·zP
NEG_G1_COEFFS = (const(_NEG_G1[1].n), const(1), const(-_NEG_G1[0].n))


def _lines(pr, la, lb_pre, lc_pre, g1c):
    """The line's coefficients scaled by P's (yP, zP³, −xP·zP): ξ·yP·la
    (as ξ·(la·yP), two products), zP³·lb, −xP·zP·lc."""
    yp, zp3, neg_xpzp = g1c
    return (f2_xi(f2_mul_fp(pr, la, yp)), f2_mul_fp(pr, lb_pre, zp3),
            f2_mul_fp(pr, lc_pre, neg_xpzp))


def double_step(pr, T, g1c=NEG_G1_COEFFS):
    Xt, Yt, Zt = T
    X2 = f2_mul(pr, Xt, Xt)
    A = f2_add(f2_add(X2, X2), X2)
    YZ, AX = f2_mul(pr, Yt, Zt), f2_mul(pr, A, Xt)
    B = f2_add(YZ, YZ)
    YB, BZ, AZ = f2_mul(pr, Yt, B), f2_mul(pr, B, Zt), f2_mul(pr, A, Zt)
    B2 = f2_mul(pr, B, B)
    line = _lines(pr, BZ, f2_sub(AX, YB), AZ, g1c)
    A2, XB2, B3 = f2_mul(pr, A, A), f2_mul(pr, Xt, B2), f2_mul(pr, B, B2)
    A2Z, YB3, Z2 = f2_mul(pr, A2, Zt), f2_mul(pr, Yt, B3), f2_mul(pr, B3, Zt)
    XB2_2 = f2_add(XB2, XB2)
    XB2_3 = f2_add(XB2_2, XB2)
    Xn = f2_mul(pr, B, f2_sub(A2Z, XB2_2))
    t = f2_mul(pr, A, f2_sub(XB2_3, A2Z))
    return (Xn, f2_sub(t, YB3), Z2), line


def add_step(pr, T, Q, g1c=NEG_G1_COEFFS):
    Xt, Yt, Zt = T
    Xq, Yq, Zq = Q
    YZq, YqZ = f2_mul(pr, Yt, Zq), f2_mul(pr, Yq, Zt)
    XZq, XqZ = f2_mul(pr, Xt, Zq), f2_mul(pr, Xq, Zt)
    E, Fv = f2_sub(YZq, YqZ), f2_sub(XZq, XqZ)
    EXq, FYq, EZq = f2_mul(pr, E, Xq), f2_mul(pr, Fv, Yq), f2_mul(pr, E, Zq)
    FZq, F2 = f2_mul(pr, Fv, Zq), f2_mul(pr, Fv, Fv)
    line = _lines(pr, FZq, f2_sub(EXq, FYq), EZq, g1c)
    E2, F3 = f2_mul(pr, E, E), f2_mul(pr, Fv, F2)
    Fsum, XF2 = f2_mul(pr, F2, f2_add(XZq, XqZ)), f2_mul(pr, F2, Xt)
    E2Z, XF2Zq = f2_mul(pr, E2, Zt), f2_mul(pr, XF2, Zq)
    YF3, F3Z = f2_mul(pr, F3, Yt), f2_mul(pr, F3, Zt)
    E2ZZq, YF3Zq = f2_mul(pr, E2Z, Zq), f2_mul(pr, YF3, Zq)
    Z3 = f2_mul(pr, F3Z, Zq)
    G = f2_sub(E2ZZq, Fsum)
    X3 = f2_mul(pr, Fv, G)
    t = f2_mul(pr, E, f2_sub(XF2Zq, G))
    return (X3, f2_sub(t, YF3Zq), Z3), line


def line_fp12(line):
    a, b, c = line
    return ((a, f2_zero(), f2_zero()), (f2_zero(), b, c))


# --- the program set -------------------------------------------------------------


def _p_homog():
    """Σ (Jacobian) → Q homogeneous (XZ, Y, Z³), the loop's base point."""
    pr = Program("HOMOG", [("S", 6), ("Q", 6)])
    Xj, Yj, Zj = f2s_of(pr.group("S"))
    Z2 = f2_mul(pr, Zj, Zj)
    pr.output("Q", flat2([f2_mul(pr, Xj, Zj), Yj, f2_mul(pr, Z2, Zj)]))
    return pr


def _p_miller(add, general=False):
    """DBL: f ← f²·ℓ(T, T), T ← 2T; ADD: f ← f·ℓ(T, Q), T ← T + Q. For
    P = −g1 (rlc_finish: Q homogeneous, 6 values); `general`: DBL_P /
    ADD_P, P's coefficients from group P (yP, zP³, −xP·zP) and Q affine
    (x, y; zQ = 1, which folds the products by zQ)."""
    name = ("ADD" if add else "DBL") + ("_P" if general else "")
    groups = [("F", 12), ("T", 6), ("Q", 4 if general else 6)]
    pr = Program(name, groups + ([("P", 3)] if general else []))
    f = f12_of(pr.group("F"))
    T = tuple(f2s_of(pr.group("T")))
    g1c = tuple(pr.group("P")) if general else NEG_G1_COEFFS
    if add:
        Q = f2s_of(pr.group("Q"))
        if general:
            Q.append((const(1), ZERO))
        T, line = add_step(pr, T, tuple(Q), g1c)
    else:
        f = f12_sq(pr, f)
        T, line = double_step(pr, T, g1c)
    pr.output("F", flat12(f12_mul(pr, f, line_fp12(line))))
    pr.output("T", flat2(T))
    return pr


def _p_pcoef():
    """P (Jacobian X, Y, Z) → its line coefficients (Y, Z³, −X·Z)."""
    pr = Program("PCOEF", [("J", 3), ("P", 3)])
    X, Y, Z = pr.group("J")
    Z2, XZ = pr.mul(Z, Z), pr.mul(X, Z)
    pr.output("P", [Y, pr.mul(Z2, Z), -XZ])
    return pr


def _p_mul(name, conj_a=False, conj_b=False, conj_out=False):
    pr = Program(name, [("A", 12), ("B", 12), ("O", 12)])
    a, b = f12_of(pr.group("A")), f12_of(pr.group("B"))
    if conj_a:
        a = f12_conj(a)
    if conj_b:
        b = f12_conj(b)
    r = f12_mul(pr, a, b)
    pr.output("O", flat12(f12_conj(r) if conj_out else r))
    return pr


def _p_inv_norm6():
    """The Fp12 inverse's first norm: N = a0² − v·a1² (Fp6)."""
    pr = Program("INV_N6", [("A", 12), ("N", 6)])
    a0, a1 = f12_of(pr.group("A"))
    n = f6_sub(f6_mul(pr, a0, a0), f6_v(f6_mul(pr, a1, a1)))
    pr.output("N", flat2(n))
    return pr


def _p_inv_norm2():
    """fp6_inv's cofactors A, B, C of N, its norm F (Fp2) and F's norm
    F0² + F1² (Fp) into W[0..9); W[9] is left for the inverse."""
    pr = Program("INV_N2", [("N", 6), ("W", 10)])
    a0, a1, a2 = f2s_of(pr.group("N"))
    A = f2_sub(f2_mul(pr, a0, a0), f2_xi(f2_mul(pr, a1, a2)))
    B = f2_sub(f2_xi(f2_mul(pr, a2, a2)), f2_mul(pr, a0, a1))
    C = f2_sub(f2_mul(pr, a1, a1), f2_mul(pr, a0, a2))
    Fv = f2_add(f2_mul(pr, a0, A),
                f2_xi(f2_add(f2_mul(pr, a2, B), f2_mul(pr, a1, C))))
    norm = pr.mul(Fv[0], Fv[0]) + pr.mul(Fv[1], Fv[1])
    pr.output("W", flat2([A, B, C, Fv]) + [norm])
    return pr


def _p_inv_easy():
    """From f, the cofactors and 1/norm (W[9]): f⁻¹, t = conj(f)·f⁻¹ and
    the easy part's m = t^(p²)·t."""
    pr = Program("INV_EASY", [("A", 12), ("W", 10), ("M", 12)])
    f = f12_of(pr.group("A"))
    w = pr.group("W")
    A, B, C, Fv = f2s_of(w[:8])
    ninv = w[9]
    fi = (pr.mul(Fv[0], ninv), -pr.mul(Fv[1], ninv))
    d = (f2_mul(pr, A, fi), f2_mul(pr, B, fi), f2_mul(pr, C, fi))
    finv = (f6_mul(pr, f[0], d), f6_neg(f6_mul(pr, f[1], d)))
    t = f12_mul(pr, f12_conj(f), finv)
    pr.output("M", flat12(f12_mul(pr, f12_frobenius(pr, t, 2), t)))
    return pr


def _p_cyc_sq(with_mul):
    """R ← R² (cyclotomic), or R ← R²·M."""
    pr = Program("CYC_SQ_MUL" if with_mul else "CYC_SQ",
                 [("R", 12), ("M", 12), ("O", 12)])
    r = f12_cyclotomic_sq(pr, f12_of(pr.group("R")))
    if with_mul:
        r = f12_mul(pr, r, f12_of(pr.group("M")))
    pr.output("O", flat12(r))
    return pr


def _p_conj_mul_frob():
    """t3 = conj(A)·B^p."""
    pr = Program("CONJ_MUL_FROB", [("A", 12), ("B", 12), ("O", 12)])
    a, b = f12_of(pr.group("A")), f12_of(pr.group("B"))
    pr.output("O", flat12(f12_mul(pr, f12_conj(a),
                                  f12_frobenius(pr, b, 1))))
    return pr


def _p_mul_frob2_conj():
    """A·B^(p²)·conj(B)."""
    pr = Program("MUL_FROB2_CONJ", [("A", 12), ("B", 12), ("O", 12)])
    a, b = f12_of(pr.group("A")), f12_of(pr.group("B"))
    u = f12_mul(pr, f12_frobenius(pr, b, 2), f12_conj(b))
    pr.output("O", flat12(f12_mul(pr, a, u)))
    return pr


def _p_g2_add():
    """O ← A + B (Jacobian G2, add-2007-bl: the generic case of
    csrc point_add_complete), and X ← (H, r): H = 0 marks the cases the
    caller takes instead (r = 0: the doubling, else ∞)."""
    pr = Program("G2ADD", [("A", 6), ("B", 6), ("O", 6), ("X", 4)])
    x1, y1, z1 = f2s_of(pr.group("A"))
    x2, y2, z2 = f2s_of(pr.group("B"))
    Z1Z1, Z2Z2 = f2_mul(pr, z1, z1), f2_mul(pr, z2, z2)
    U1, U2 = f2_mul(pr, x1, Z2Z2), f2_mul(pr, x2, Z1Z1)
    t1, t2 = f2_mul(pr, z2, Z2Z2), f2_mul(pr, z1, Z1Z1)
    Z1Z2 = f2_mul(pr, z1, z2)
    H = f2_sub(U2, U1)
    S1, S2 = f2_mul(pr, y1, t1), f2_mul(pr, y2, t2)
    r = f2_scale(f2_sub(S2, S1), 2)
    H2 = f2_add(H, H)
    I, Z3 = f2_mul(pr, H2, H2), f2_mul(pr, f2_add(Z1Z2, Z1Z2), H)
    J, V, R2 = f2_mul(pr, H, I), f2_mul(pr, U1, I), f2_mul(pr, r, r)
    X3 = f2_sub(R2, f2_add(J, f2_add(V, V)))
    t, S1J = f2_mul(pr, r, f2_sub(V, X3)), f2_mul(pr, S1, J)
    pr.output("O", flat2([X3, f2_sub(t, f2_add(S1J, S1J)), Z3]))
    pr.output("X", flat2([H, r]))
    return pr


def _p_g2_dbl():
    """O ← 2A (Jacobian G2, dbl-2009-l: csrc point_double)."""
    pr = Program("G2DBL", [("A", 6), ("O", 6)])
    x, y, z = f2s_of(pr.group("A"))
    A, Bq, YZ = f2_mul(pr, x, x), f2_mul(pr, y, y), f2_mul(pr, y, z)
    XB = f2_add(x, Bq)
    E = f2_scale(A, 3)
    C, T1, Fv = f2_mul(pr, Bq, Bq), f2_mul(pr, XB, XB), f2_mul(pr, E, E)
    D = f2_scale(f2_sub(T1, f2_add(A, C)), 2)
    X3 = f2_sub(Fv, f2_add(D, D))
    t = f2_mul(pr, E, f2_sub(D, X3))
    pr.output("O", flat2([X3, f2_sub(t, f2_scale(C, 8)), f2_add(YZ, YZ)]))
    return pr


def _p_g2_madd():
    """O ← A + (x, y) (Jacobian G2 plus affine, madd-2007-bl: csrc
    point_madd_unsafe; A ≠ ±Q, neither ∞)."""
    pr = Program("G2MADD", [("A", 6), ("Q", 4), ("O", 6)])
    x, y, z = f2s_of(pr.group("A"))
    qx, qy = f2s_of(pr.group("Q"))
    Z2 = f2_mul(pr, z, z)
    U2, ZZZ = f2_mul(pr, qx, Z2), f2_mul(pr, z, Z2)
    H = f2_sub(U2, x)
    S2, HH = f2_mul(pr, qy, ZZZ), f2_mul(pr, H, H)
    I = f2_scale(HH, 4)
    r = f2_scale(f2_sub(S2, y), 2)
    J, V, R2 = f2_mul(pr, H, I), f2_mul(pr, x, I), f2_mul(pr, r, r)
    X3 = f2_sub(R2, f2_add(J, f2_add(V, V)))
    ZH = f2_add(z, H)
    t, YJ, ZH2 = (f2_mul(pr, r, f2_sub(V, X3)), f2_mul(pr, y, J),
                  f2_mul(pr, ZH, ZH))
    pr.output("O", flat2([X3, f2_sub(t, f2_add(YJ, YJ)),
                          f2_sub(ZH2, f2_add(Z2, HH))]))
    return pr


#: the programs a block's other warps run in the fold and the sum tree
FOLD_PROGRAMS = ("MUL", "G2ADD", "G2DBL")
#: the programs of a `miller_loop_pairs` warp (none of rlc_finish's)
MILLER_PROGRAMS = ("PCOEF", "DBL_P", "ADD_P")
#: the programs of an `aggregate_rlc_scale` G2 warp: a half's ladder and
#: the halves' join
AGG_PROGRAMS = ("G2DBL", "G2MADD", "G2ADD")


def programs():
    """The programs, in the order of the header's enum: rlc_finish's, then
    miller_loop_pairs', then aggregate_rlc_scale's own."""
    return [
        _p_g2_add(), _p_g2_dbl(),
        _p_homog(), _p_miller(False), _p_miller(True),
        _p_mul("MUL"), _p_mul("MUL_CONJ_B", conj_b=True),
        _p_mul("MUL_CONJ_OUT", conj_out=True),
        _p_inv_norm6(), _p_inv_norm2(), _p_inv_easy(),
        _p_cyc_sq(False), _p_cyc_sq(True), _p_conj_mul_frob(),
        _p_mul_frob2_conj(),
        _p_pcoef(), _p_miller(False, True), _p_miller(True, True),
        _p_g2_madd(),
    ]


# --- scheduling and scratch allocation -----------------------------------------


def _deps(form):
    return [key[1] for key in form.t if key[0] == "p"]


def schedule(pr, width=WIDTH):
    """Rounds of at most `width` products, each after every product it
    reads; ready products go longest remaining path first. Returns the
    list of rounds (lists of node ids)."""
    n = len(pr.nodes)
    deps = [sorted(set(_deps(a) + _deps(b))) for a, b in pr.nodes]
    users = [[] for _ in range(n)]
    for v, ds in enumerate(deps):
        for d in ds:
            users[d].append(v)
    height = [0] * n
    for v in range(n - 1, -1, -1):  # nodes are created after their deps
        height[v] = 1 + max((height[u] for u in users[v]), default=0)
    done_round = [None] * n
    rounds, left = [], set(range(n))
    while left:
        r = len(rounds)
        ready = [v for v in left
                 if all(done_round[d] is not None and done_round[d] < r
                        for d in deps[v])]
        ready.sort(key=lambda v: (-height[v], v))
        pick = ready[:width]
        for v in pick:
            done_round[v] = r
        left -= set(pick)
        rounds.append(pick)
    return rounds


def allocate(pr, rounds):
    """Scratch slot of each node: a slot whose value was last read in
    round r is free for a product written in a round after r (the
    outputs are read in round len(rounds))."""
    last = {v: r for r, nodes in enumerate(rounds) for v in nodes}
    for r, nodes in enumerate(rounds):
        for v in nodes:
            for form in pr.nodes[v]:
                for d in _deps(form):
                    last[d] = max(last[d], r)
    for _g, _i, form in pr.outputs:
        for d in _deps(form):
            last[d] = len(rounds)
    slot, live, free, top = {}, [], [], 0  # live: (last read, slot)
    for r, nodes in enumerate(rounds):
        free += [s for lr, s in live if lr < r]
        live = [(lr, s) for lr, s in live if lr >= r]
        free.sort()
        for v in sorted(nodes):
            if free:
                s = free.pop(0)
            else:
                s, top = top, top + 1
            slot[v] = s
            live.append((last[v], s))
    return slot, top


# --- the tables --------------------------------------------------------------------


class Tables:
    def __init__(self):
        self.terms = []  # (slot, coef)
        self.tasks = []  # (a_off, a_len, b_off, b_len, dst slot)
        self.rounds = []  # task index where each round starts
        self.outs = []  # (off, len, dst slot)
        self.progs = []  # dict per program
        self.consts = []  # canonical values
        self._const_at = {}

    def const_slot(self, v):
        if v not in self._const_at:
            self._const_at[v] = len(self.consts)
            self.consts.append(v)
        return (KIND_CONST << 12) | self._const_at[v]

    def form(self, f, slot_of):
        """(offset, n_pos | n_neg << 8): the positive terms, then the
        negative ones."""
        off = len(self.terms)
        terms = sorted(f.t.items(), key=lambda kc: (kc[1] < 0, kc[0]))
        n_neg = sum(c < 0 for _, c in terms)
        if not all(-128 <= c <= 127 for _, c in terms) or len(terms) > 255:
            raise ValueError("a form beyond the table's encoding")
        self.terms += [(slot_of(key), c) for key, c in terms]
        return off, (len(terms) - n_neg) | (n_neg << 8)

    def add(self, pr):
        rounds = schedule(pr)
        slot, n_scratch = allocate(pr, rounds)

        def slot_of(key):
            if key[0] == "i":
                return ((KIND_GROUP0 + key[1]) << 12) | key[2]
            if key[0] == "p":
                return (KIND_SCRATCH << 12) | slot[key[1]]
            return self.const_slot(key[1])

        round0 = len(self.rounds)
        for nodes in rounds:
            self.rounds.append(len(self.tasks))
            for v in nodes:
                a, b = pr.nodes[v]
                self.tasks.append((*self.form(a, slot_of),
                                   *self.form(b, slot_of),
                                   (KIND_SCRATCH << 12) | slot[v]))
        out0 = len(self.outs)
        for g, i, f in pr.outputs:
            self.outs.append((*self.form(f, slot_of),
                              ((KIND_GROUP0 + g) << 12) | i))
        if len(pr.outputs) > WIDTH:
            raise ValueError(f"{pr.name}: more outputs than lanes")
        self.progs.append({
            "name": pr.name, "round0": round0, "n_rounds": len(rounds),
            "out0": out0, "n_out": len(pr.outputs), "scratch": n_scratch,
            "products": len(pr.nodes)})


def build_tables():
    t = Tables()
    for pr in programs():
        t.add(pr)
    t.rounds.append(len(t.tasks))
    return t


def _mont_words(v):
    m = v * (1 << 384) % P
    return [(m >> (32 * i)) & 0xFFFFFFFF for i in range(12)]


def header():
    """The text of csrc/finish_programs.cuh."""
    t = build_tables()
    lines = [
        "// The warp programs of rlc_finish's tail, of miller_loop_pairs and",
        "// of aggregate_rlc_scale's G2 ladder (csrc/finish_tail.cuh).",
        "// Generated by `python -m grandine_tpu_torch.gpu.finish_programs`",
        "// from grandine_tpu_torch/gpu/finish_programs.py: do not edit.",
        "//",
        "// A slot is (kind << 12) | index: kinds 0-3 the program's groups,",
        f"// {KIND_SCRATCH} its scratch products, {KIND_CONST} TAIL_CONSTS. "
        "A term is (coef << 16) | slot;",
        "// a form is (offset, n_pos | n_neg << 8): its positive terms, then "
        "its negative ones.",
        "#pragma once",
        "#include <stdint.h>",
        "",
        "namespace bls {",
        "namespace tail {",
        "",
        "enum ProgId {",
    ]
    for p in t.progs:
        lines.append(f"  PROG_{p['name']},  // {p['products']} products, "
                     f"{p['n_rounds']} rounds, {p['scratch']} scratch slots")
    lines += ["  PROG_COUNT", "};", ""]
    def most(names):
        return max(p["scratch"] for p in t.progs if p["name"] in names)

    # warp 0 of rlc_finish runs every program but the other kernels' own
    finish = [p["name"] for p in t.progs
              if p["name"] not in MILLER_PROGRAMS + ("G2MADD",)]
    lines += [f"#define TAIL_SCRATCH {most(finish)}  // scratch Fp values of "
              "warp 0",
              f"#define FOLD_SCRATCH {most(FOLD_PROGRAMS)}  // of a warp that "
              "only folds",
              f"#define MILLER_SCRATCH {most(MILLER_PROGRAMS)}  // of a "
              "miller_loop_pairs warp",
              f"#define AGG_SCRATCH {most(AGG_PROGRAMS)}  // of an "
              "aggregate_rlc_scale G2 warp",
              "", "struct prog_t {",
              "  uint16_t round0, n_rounds, out0, n_out;", "};", ""]

    def array(kind, name, rows, per_line, attr=""):
        out = [f"BLS_GTABLE {kind} {name}[]{attr} = {{"]
        for i in range(0, len(rows), per_line):
            out.append("    " + ", ".join(rows[i:i + per_line]) + ",")
        out.append("};")
        return out

    lines += array("prog_t", "TAIL_PROGS", [
        f"{{{p['round0']}, {p['n_rounds']}, {p['out0']}, {p['n_out']}}}"
        for p in t.progs], 2)
    lines += array("uint16_t", "TAIL_ROUNDS", [str(r) for r in t.rounds], 16)
    lines += array("uint16_t", "TAIL_TASKS", [
        ", ".join(str(x) for x in task) for task in t.tasks], 3)
    lines += array("uint16_t", "TAIL_OUTS", [
        ", ".join(str(x) for x in o) for o in t.outs], 4)
    lines += array("uint32_t", "TAIL_TERMS", [
        f"0x{((c & 0xFFFF) << 16) | s:08x}u" for s, c in t.terms], 6)
    lines += array("uint32_t", "TAIL_CONSTS", [
        ", ".join(f"0x{w:08x}u" for w in _mont_words(v))
        for v in t.consts], 1, " __attribute__((aligned(16)))")
    lines += ["", "}  // namespace tail", "}  // namespace bls", ""]
    return "\n".join(lines)


# --- evaluation on integers (what the kernel computes) -----------------------------


def evaluate(t, prog, groups):
    """Run program `prog` (index) of Tables `t` on `groups` (lists of
    canonical ints, updated in place) as the kernel's interpreter does:
    round by round, then every output computed before any is stored."""
    p = t.progs[prog]
    scratch = {}

    def value(slot):
        kind, idx = slot >> 12, slot & 0xFFF
        if kind == KIND_SCRATCH:
            return scratch[idx]
        if kind == KIND_CONST:
            return t.consts[idx]
        return groups[kind - KIND_GROUP0][idx]

    def form(off, n):
        n = (n & 0xFF) + (n >> 8)
        return sum(c * value(s) for s, c in t.terms[off:off + n]) % P

    for r in range(p["round0"], p["round0"] + p["n_rounds"]):
        done = {}
        for a_off, a_n, b_off, b_n, dst in t.tasks[t.rounds[r]:
                                                   t.rounds[r + 1]]:
            done[dst & 0xFFF] = form(a_off, a_n) * form(b_off, b_n) % P
        scratch.update(done)
    vals = [(dst, form(off, n))
            for off, n, dst in t.outs[p["out0"]:p["out0"] + p["n_out"]]]
    for dst, v in vals:
        groups[(dst >> 12) - KIND_GROUP0][dst & 0xFFF] = v


def tail_runs():
    """The program runs of one live group's tail, in the order of
    csrc/finish_tail.cuh: the Miller loop of (−g1, Σ) and its product with
    the f terms (the first four), then the final exponentiation (five
    |x|-powers of cyclotomic squares). [(name, runs)]."""
    adds = bin(ABS_X).count("1") - 1
    return [("HOMOG", 1), ("DBL", 63), ("ADD", adds), ("MUL_CONJ_B", 1),
            ("INV_N6", 1), ("INV_N2", 1), ("INV_EASY", 1),
            ("CYC_SQ", 5 * (63 - adds)), ("CYC_SQ_MUL", 5 * adds + 1),
            ("MUL_CONJ_OUT", 2), ("CONJ_MUL_FROB", 1),
            ("MUL_FROB2_CONJ", 1), ("MUL", 1)]


def miller_runs():
    """The program runs of one `miller_loop_pairs` warp, in the order of
    csrc/finish_tail.cuh `miller_pair`. [(name, runs)]."""
    return [("PCOEF", 1), ("DBL_P", 63),
            ("ADD_P", bin(ABS_X).count("1") - 1)]


def tail_depth(runs=None):
    """(product rounds, output stages) of one live group's tail (or of
    `runs`, e.g. `miller_runs()`): its dependent depth, each round one Fp
    product a lane, besides the Euclid inversion on one lane and a few
    copies."""
    st = stats()
    runs = tail_runs() if runs is None else runs
    return (sum(st[n][1] * k for n, k in runs), sum(k for _, k in runs))


def prog_index(name):
    return [p.name for p in programs()].index(name)


def stats():
    """{program name: (products, rounds)}."""
    t = build_tables()
    return {p["name"]: (p["products"], p["n_rounds"]) for p in t.progs}


if __name__ == "__main__":
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                        "finish_programs.cuh")
    with open(path, "w") as fh:
        fh.write(header())
    for name, (n, r) in stats().items():
        print(f"{name}: {n} products in {r} rounds")
