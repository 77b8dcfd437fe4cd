"""Stage programs of the warp-wide BLS12-381 kernels.

The Miller loop (``tm_miller``), the chunk product and the final
exponentiation (``tm_final_exp``) run on one warp each, and so does each
G2 point addition of the public-key sums (``tm_g2_aggregate``,
``tm_g2_add``). Their arithmetic is written here once, over symbolic Fp
values, with the formulas of the one-thread code in
``ops/csrc/bls12_381_device.cuh`` (Karatsuba f2/f6/f12 products, the
even/odd f12 squaring, Granger-Scott cyclotomic squaring, the Miller
doubling and addition steps with their line scaling, the inversion
through the even subalgebra, the Jacobian G2 addition and doubling of
``jac_add<fp2>``/``jac_double<fp2>``). Each operation
becomes a small dataflow graph of Fp multiplications, additions,
subtractions, selects (invalid pairs fold the identity line) and one
inversion; known zeros and ones fold away, common subexpressions
merge, and values no output needs are dropped.

A graph is then list-scheduled into *stages*: a stage is up to 64
independent jobs of one kind (Fp multiplications, or additions and
selects, or one inversion), two per lane, and the 32 lanes of the warp
meet at ``__syncwarp()`` after each stage. Values live in shared-memory
slots of 48 bytes (an Fp element, 12 x 32-bit limbs in Montgomery form);
the slots are allocated so that no slot is read and written in one stage
by two lanes, and every program's outputs land in their region only
after its last read of what was there.

The jobs are written to ``ops/csrc/bls12_381_programs.cuh`` as tables;
``run_program`` in ``bls12_381_device.cuh`` interprets them, on the card
and in the CPU harness (``tests/bls_pairing_host.cpp``) alike. Every
value a program computes is an exact field element, so the stage order
cannot change a result: the warp kernels give the one-thread functions'
canonical limbs.

    python -m tendermint_tpu_torch.ops.bls_warp_gen     # rewrite the header

``simulate`` runs the tables in Python (with the stage rules checked) for
the tests.
"""

from __future__ import annotations

import os
import pathlib

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
X_ABS = 0xD201000000010000
R_MONT = 1 << 384
HEADER = pathlib.Path(__file__).resolve().parent / "csrc" / "bls12_381_programs.cuh"

# stage kinds and job opcodes (bls12_381_device.cuh run_program)
K_MUL, K_ALU, K_INV = 0, 1, 2
OP_MUL, OP_ADD, OP_SUB, OP_SEL0, OP_SEL1, OP_INV = 0, 1, 2, 3, 4, 5
JOBS_PER_STAGE = 64  # two a lane
# relative cost of a stage, for the scheduler's priorities
COST = {"mul": 1.0, "alu": 0.12, "inv": 60.0}

# slots: constants, then each kernel's regions, then its temporaries.
# An Fp12 region is 12 slots, coefficient i component c at base + 2 i + c
# (the byte layout [6, 2, 48] of the kernels' operands).
ZERO_SLOT, ONE_SLOT = 0, 1
CONST_END = 16
NSLOTS_MAX = 512  # 9-bit slot fields


def _gamma() -> list[tuple[int, int]]:
    """gamma_i = xi^(i (p - 1) / 6), xi = 1 + u (crypto/bls12_381.py)."""
    def f2_mul(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)

    def f2_pow(a, e):
        r = (1, 0)
        while e:
            if e & 1:
                r = f2_mul(r, a)
            a = f2_mul(a, a)
            e >>= 1
        return r

    return [f2_pow((1, 1), i * ((P - 1) // 6)) for i in range(6)]


GAMMA = _gamma()
CONST_VALUES = [0, 1] + sorted({v for g in GAMMA for v in g} - {0, 1})
assert len(CONST_VALUES) <= CONST_END


# --- symbolic Fp values ---------------------------------------------------


class Graph:
    """Nodes: ('in', slot), ('const', slot), ('mul'|'add'|'sub', a, b),
    ('sel', k, a, b) (a if pair k is valid, else b), ('inv', a). Adds and
    multiplications are commutative in their keys; zeros and ones fold."""

    def __init__(self):
        self.nodes: list[tuple] = []
        self.memo: dict[tuple, int] = {}
        self.zero = self._node(("const", ZERO_SLOT))
        self.one = self._node(("const", ONE_SLOT))

    def _node(self, key: tuple) -> int:
        n = self.memo.get(key)
        if n is None:
            n = len(self.nodes)
            self.nodes.append(key)
            self.memo[key] = n
        return n

    def inp(self, slot: int) -> int:
        return self._node(("in", slot))

    def const(self, value: int) -> int:
        return self._node(("const", CONST_VALUES.index(value % P)))

    def add(self, a: int, b: int) -> int:
        if a == self.zero:
            return b
        if b == self.zero:
            return a
        return self._node(("add", min(a, b), max(a, b)))

    def sub(self, a: int, b: int) -> int:
        if b == self.zero:
            return a
        if a == b:
            return self.zero
        return self._node(("sub", a, b))

    def neg(self, a: int) -> int:
        return self.sub(self.zero, a)

    def mul(self, a: int, b: int) -> int:
        if self.zero in (a, b):
            return self.zero
        if a == self.one:
            return b
        if b == self.one:
            return a
        return self._node(("mul", min(a, b), max(a, b)))

    def sel(self, k: int, a: int, b: int) -> int:
        if a == b:
            return a
        return self._node(("sel", k, a, b))

    def inv(self, a: int) -> int:
        if a == self.zero:
            return a
        return self._node(("inv", a))


# --- the one-thread formulas over symbolic values --------------------------
# Fp2 = (c0, c1); Fp6 = [3 Fp2]; Fp12 = [6 Fp2] (flat sextic, w^6 = xi)


def f2_add(g, a, b):
    return (g.add(a[0], b[0]), g.add(a[1], b[1]))


def f2_sub(g, a, b):
    return (g.sub(a[0], b[0]), g.sub(a[1], b[1]))


def f2_neg(g, a):
    return (g.neg(a[0]), g.neg(a[1]))


def f2_conj(g, a):
    return (a[0], g.neg(a[1]))


def f2_mul(g, a, b):
    """Karatsuba (f2_mul); schoolbook where a coefficient is a known zero,
    which then costs fewer products."""
    if g.zero in (a[0], a[1], b[0], b[1]):
        return (g.sub(g.mul(a[0], b[0]), g.mul(a[1], b[1])),
                g.add(g.mul(a[0], b[1]), g.mul(a[1], b[0])))
    t0 = g.mul(a[0], b[0])
    t1 = g.mul(a[1], b[1])
    m = g.mul(g.add(a[0], a[1]), g.add(b[0], b[1]))
    return (g.sub(t0, t1), g.sub(g.sub(m, t0), t1))


def f2_sqr(g, a):
    m = g.mul(a[0], a[1])
    return (g.mul(g.add(a[0], a[1]), g.sub(a[0], a[1])), g.add(m, m))


def f2_mul_xi(g, a):
    return (g.sub(a[0], a[1]), g.add(a[0], a[1]))


def f2_scale(g, a, k):
    return (g.mul(a[0], k), g.mul(a[1], k))


def f2_inv(g, a):
    t = g.inv(g.add(g.mul(a[0], a[0]), g.mul(a[1], a[1])))
    return (g.mul(a[0], t), g.neg(g.mul(a[1], t)))


def f6_mul(g, a, b):
    t0, t1, t2 = (f2_mul(g, a[i], b[i]) for i in range(3))
    w = f2_mul(g, f2_add(g, a[1], a[2]), f2_add(g, b[1], b[2]))
    c0 = f2_add(g, t0, f2_mul_xi(g, f2_sub(g, f2_sub(g, w, t1), t2)))
    w = f2_mul(g, f2_add(g, a[0], a[1]), f2_add(g, b[0], b[1]))
    c1 = f2_add(g, f2_sub(g, f2_sub(g, w, t0), t1), f2_mul_xi(g, t2))
    w = f2_mul(g, f2_add(g, a[0], a[2]), f2_add(g, b[0], b[2]))
    c2 = f2_add(g, f2_sub(g, f2_sub(g, w, t0), t2), t1)
    return [c0, c1, c2]


def f6_mul_by_v(g, a):
    return [f2_mul_xi(g, a[2]), a[0], a[1]]


def f12_mul(g, a, b):
    ea, oa, eb, ob = a[0::2], a[1::2], b[0::2], b[1::2]
    ee = f6_mul(g, ea, eb)
    oo = f6_mul(g, oa, ob)
    m = f6_mul(g, [f2_add(g, x, y) for x, y in zip(ea, oa)],
               [f2_add(g, x, y) for x, y in zip(eb, ob)])
    voo = f6_mul_by_v(g, oo)
    out = []
    for i in range(3):
        out.append(f2_add(g, ee[i], voo[i]))
        out.append(f2_sub(g, f2_sub(g, m[i], ee[i]), oo[i]))
    return out


def f12_sqr(g, a):
    e, o = a[0::2], a[1::2]
    eo = f6_mul(g, e, o)
    vo = f6_mul_by_v(g, o)
    t = f6_mul(g, [f2_add(g, x, y) for x, y in zip(e, o)],
               [f2_add(g, x, y) for x, y in zip(e, vo)])
    veo = f6_mul_by_v(g, eo)
    out = []
    for i in range(3):
        out.append(f2_sub(g, f2_sub(g, t[i], eo[i]), veo[i]))
        out.append(f2_add(g, eo[i], eo[i]))
    return out


def f12_conj(g, a):
    return [f2_neg(g, c) if i & 1 else c for i, c in enumerate(a)]


def f12_frob(g, a):
    return [f2_mul(g, f2_conj(g, c), (g.const(GAMMA[i][0]), g.const(GAMMA[i][1])))
            for i, c in enumerate(a)]


def f6_inv(g, a):
    c0 = f2_sub(g, f2_sqr(g, a[0]), f2_mul_xi(g, f2_mul(g, a[1], a[2])))
    c1 = f2_sub(g, f2_mul_xi(g, f2_sqr(g, a[2])), f2_mul(g, a[0], a[1]))
    c2 = f2_sub(g, f2_sqr(g, a[1]), f2_mul(g, a[0], a[2]))
    t = f2_add(g, f2_mul_xi(g, f2_add(g, f2_mul(g, a[1], c2), f2_mul(g, a[2], c1))),
               f2_mul(g, a[0], c0))
    ti = f2_inv(g, t)
    return [f2_mul(g, c, ti) for c in (c0, c1, c2)]


def f12_inv(g, a):
    ac = f12_conj(g, a)
    n = f12_mul(g, a, ac)
    i0, i1, i2 = f6_inv(g, [n[0], n[2], n[4]])
    z = (g.zero, g.zero)
    return f12_mul(g, ac, [i0, z, i1, z, i2, z])


def f4_sqr(g, a, b):
    t0, t1 = f2_sqr(g, a), f2_sqr(g, b)
    o1 = f2_sub(g, f2_sub(g, f2_sqr(g, f2_add(g, a, b)), t0), t1)
    return f2_add(g, t0, f2_mul_xi(g, t1)), o1


def _gs_comb(g, tre, tim, are, aim):
    u = f2_sub(g, tre, are)
    hre = f2_add(g, f2_add(g, u, u), tre)
    u = f2_add(g, tim, aim)
    him = f2_add(g, f2_add(g, u, u), tim)
    return hre, him


def f12_cyclo_sqr(g, a):
    """Granger-Scott, as the one-thread f12_cyclo_sqr (its formula, not
    just a squaring: it is exact only in the cyclotomic subgroup)."""
    A0, A1 = f4_sqr(g, a[0], a[3])
    B0, B1 = f4_sqr(g, a[1], a[4])
    C0, C1 = f4_sqr(g, a[2], a[5])
    o = [None] * 6
    o[0], o[3] = _gs_comb(g, A0, A1, a[0], a[3])
    o[2], o[5] = _gs_comb(g, B0, B1, a[2], a[5])
    re = f2_mul_xi(g, C1)
    u = f2_add(g, re, a[1])
    o[1] = f2_add(g, f2_add(g, u, u), re)
    u = f2_sub(g, C0, a[4])
    o[4] = f2_add(g, f2_add(g, u, u), C0)
    return o


def _dbl(g, a):
    return f2_add(g, a, a)


def miller_dbl_step(g, X, Y, Z, xp, yp):
    """miller_dbl_step: the line scaled by 2 Y Z^3 and 2T."""
    A, B = f2_sqr(g, X), f2_sqr(g, Y)
    C = f2_sqr(g, B)
    t = f2_sub(g, f2_sub(g, f2_sqr(g, f2_add(g, X, B)), A), C)
    D = _dbl(g, t)
    E = f2_add(g, _dbl(g, A), A)
    Fq = f2_sqr(g, E)
    Zsq = f2_sqr(g, Z)
    l0 = f2_sub(g, f2_sub(g, f2_mul(g, E, X), B), B)
    l2 = f2_neg(g, f2_scale(g, f2_mul(g, E, Zsq), xp))
    Z3 = _dbl(g, f2_mul(g, Y, Z))
    l3 = f2_scale(g, f2_mul(g, Z3, Zsq), yp)
    X3 = f2_sub(g, f2_sub(g, Fq, D), D)
    C8 = _dbl(g, _dbl(g, _dbl(g, C)))
    Y3 = f2_sub(g, f2_mul(g, E, f2_sub(g, D, X3)), C8)
    return (l0, l2, l3), (X3, Y3, Z3)


def miller_add_step(g, X, Y, Z, xq, yq, xp, yp):
    """miller_add_step: the line through T and Q scaled by Z lambda, T + Q."""
    Zsq = f2_sqr(g, Z)
    Zcu = f2_mul(g, Zsq, Z)
    theta = f2_sub(g, Y, f2_mul(g, yq, Zcu))
    lam = f2_sub(g, X, f2_mul(g, xq, Zsq))
    Zlam = f2_mul(g, Z, lam)
    l0 = f2_sub(g, f2_mul(g, theta, xq), f2_mul(g, Zlam, yq))
    l2 = f2_neg(g, f2_scale(g, theta, xp))
    l3 = f2_scale(g, Zlam, yp)
    h = f2_neg(g, lam)
    i = _dbl(g, _dbl(g, f2_sqr(g, h)))
    j = f2_mul(g, h, i)
    r = _dbl(g, f2_neg(g, theta))
    v = f2_mul(g, X, i)
    X3 = f2_sub(g, f2_sub(g, f2_sub(g, f2_sqr(g, r), j), v), v)
    Y3 = f2_sub(g, f2_mul(g, r, f2_sub(g, v, X3)), _dbl(g, f2_mul(g, Y, j)))
    Z3 = _dbl(g, f2_mul(g, Z, h))
    return (l0, l2, l3), (X3, Y3, Z3)


def line12(g, k, line):
    """The line l0 + l2 w^2 + l3 w^3 of pair k as an Fp12; the identity
    line where the pair is invalid (the plain version's fold)."""
    l0, l2, l3 = line
    z = (g.zero, g.zero)
    s = lambda a, b: (g.sel(k, a[0], b[0]), g.sel(k, a[1], b[1]))  # noqa: E731
    return [s(l0, (g.one, g.zero)), z, s(l2, z), s(l3, z), z, z]


# --- regions ---------------------------------------------------------------


def f12_at(g, base):
    return [(g.inp(base + 2 * i), g.inp(base + 2 * i + 1)) for i in range(6)]


def f12_slots(base, v):
    return [(base + 2 * i + c, v[i][c]) for i in range(6) for c in range(2)]


def f2_at(g, s):
    return (g.inp(s), g.inp(s + 1))


# the Miller kernel: f, P = (px0, py0, px1, py1), Q = (xq0, yq0, xq1, yq1)
# as Fp2, T = (X0, Y0, Z0, X1, Y1, Z1) as Fp2
M_F, M_P, M_Q, M_T, M_TEMP = 16, 28, 32, 40, 52
# the chunk product and the single-operation test programs: Z = op(X, Y)
C_X, C_Y, C_Z, C_TEMP = 16, 28, 40, 52
# the final exponentiation
E_F, E_A, E_B, E_R, E_X, E_O, E_TEMP = 16, 28, 40, 52, 64, 76, 88
# the G2 point sums: the Jacobian points P and Q (coordinate c component k
# at base + 2 c + k), G2_HR's values z1z1, z2z2, u1, s1, h and r (an Fp2
# each), and the result O of G2_ADD_FIN or G2_DBL
G2_P, G2_Q, G2_O = 16, 22, 40
G2_Z1Z1, G2_Z2Z2, G2_U1, G2_S1, G2_H, G2_R = range(28, 40, 2)
G2_TEMP = 46
# the G1 point sums: the same layout over Fp, a coordinate a slot, in a lane
# group's own region, whose only constants are zero and one (slots 0, 1)
G1_P, G1_Q, G1_O = 2, 5, 14
G1_Z1Z1, G1_Z2Z2, G1_U1, G1_S1, G1_H, G1_R = range(8, 14)
G1_TEMP = 17
# jobs a G1 stage: two a lane on a group of four lanes (one a lane on eight)
G1_JOBS_PER_STAGE = 8


def _miller_state(g):
    f = f12_at(g, M_F)
    P = [(g.inp(M_P + 2 * k), g.inp(M_P + 2 * k + 1)) for k in range(2)]
    Q = [(f2_at(g, M_Q + 4 * k), f2_at(g, M_Q + 4 * k + 2)) for k in range(2)]
    T = [tuple(f2_at(g, M_T + 6 * k + 2 * c) for c in range(3)) for k in range(2)]
    return f, P, Q, T


def _miller_out(f, T):
    out = f12_slots(M_F, f)
    for k in range(2):
        for c in range(3):
            out += [(M_T + 6 * k + 2 * c, T[k][c][0]), (M_T + 6 * k + 2 * c + 1, T[k][c][1])]
    return out


def prog_miller_init(g):
    """f = 1, T_k = (xq_k, yq_k, 1)."""
    f = [(g.one, g.zero)] + [(g.zero, g.zero)] * 5
    T = [(f2_at(g, M_Q + 4 * k), f2_at(g, M_Q + 4 * k + 2), (g.one, g.zero))
         for k in range(2)]
    return _miller_out(f, T)


def prog_miller_bit(g, with_add: bool):
    """One bit of |x|: f <- f^2 l_dbl0 l_dbl1 (l_add0 l_add1), T <- 2T (+ Q).
    The lines of the bit multiply together first (the T chains do not
    depend on f, so they run beside f's squaring), then meet f once."""
    f, P, Q, T = _miller_state(g)
    f2 = f12_sqr(g, f)
    lines, T2 = [], []
    for k in range(2):
        line, t = miller_dbl_step(g, *T[k], *P[k])
        lines.append(line12(g, k, line))
        T2.append(t)
    L = f12_mul(g, lines[0], lines[1])
    if with_add:
        lines, T3 = [], []
        for k in range(2):
            line, t = miller_add_step(g, *T2[k], *Q[k], *P[k])
            lines.append(line12(g, k, line))
            T3.append(t)
        T2 = T3
        L = f12_mul(g, L, f12_mul(g, lines[0], lines[1]))
    return _miller_out(f12_mul(g, f2, L), T2)


def prog_miller_final(g):
    """f <- conj(f) (x < 0)."""
    return f12_slots(M_F, f12_conj(g, f12_at(g, M_F)))


def prog_mul12(g):
    return f12_slots(C_Z, f12_mul(g, f12_at(g, C_X), f12_at(g, C_Y)))


def prog_test_sqr(g):
    return f12_slots(C_Z, f12_sqr(g, f12_at(g, C_X)))


def prog_test_line(g):
    """Z = X (l0 + l2 w^2 + l3 w^3), the line at Y's slots 0-5."""
    y = f12_at(g, C_Y)
    z = (g.zero, g.zero)
    return f12_slots(C_Z, f12_mul(g, f12_at(g, C_X), [y[0], z, y[1], y[2], z, z]))


def prog_test_cyclo(g):
    return f12_slots(C_Z, f12_cyclo_sqr(g, f12_at(g, C_X)))


def prog_test_frob(g):
    return f12_slots(C_Z, f12_frob(g, f12_at(g, C_X)))


def prog_test_inv(g):
    return f12_slots(C_Z, f12_inv(g, f12_at(g, C_X)))


def prog_fe_easy(g):
    """F <- f^((p^6 - 1)(p^2 + 1)), X <- F (final_exponentiation's easy
    part; the input is loaded into F)."""
    f = f12_at(g, E_F)
    f1 = f12_mul(g, f12_conj(g, f), f12_inv(g, f))
    f = f12_mul(g, f12_frob(g, f12_frob(g, f1)), f1)
    return f12_slots(E_F, f) + f12_slots(E_X, f)


def prog_fe_rone(g):
    """R <- 1 (the start of a^|x|)."""
    return f12_slots(E_R, [(g.one, g.zero)] + [(g.zero, g.zero)] * 5)


def prog_fe_cyc(g):
    """R <- cyclo_sqr(R)."""
    return f12_slots(E_R, f12_cyclo_sqr(g, f12_at(g, E_R)))


def prog_fe_mulx(g):
    """R <- R X."""
    return f12_slots(E_R, f12_mul(g, f12_at(g, E_R), f12_at(g, E_X)))


def _exp_out(g):
    """a^x = conj(R) once R = a^|x|."""
    return f12_conj(g, f12_at(g, E_R))


def prog_fe_g1(g):
    """A <- f^x conj(f), X <- A."""
    a = f12_mul(g, _exp_out(g), f12_conj(g, f12_at(g, E_F)))
    return f12_slots(E_A, a) + f12_slots(E_X, a)


def prog_fe_g2(g):
    """A <- a^x conj(a), X <- A."""
    a = f12_mul(g, _exp_out(g), f12_conj(g, f12_at(g, E_A)))
    return f12_slots(E_A, a) + f12_slots(E_X, a)


def prog_fe_g3(g):
    """B <- a^x frob(a), X <- B."""
    b = f12_mul(g, _exp_out(g), f12_frob(g, f12_at(g, E_A)))
    return f12_slots(E_B, b) + f12_slots(E_X, b)


def prog_fe_g4(g):
    """X <- b^x."""
    return f12_slots(E_X, _exp_out(g))


def prog_fe_g5(g):
    """O <- (b^x)^x frob^2(b) conj(b) cyclo_sqr(f) f."""
    b = f12_at(g, E_B)
    f = f12_at(g, E_F)
    c = f12_mul(g, f12_mul(g, _exp_out(g), f12_frob(g, f12_frob(g, b))), f12_conj(g, b))
    t = f12_mul(g, f12_cyclo_sqr(g, f), f)
    return f12_slots(E_O, f12_mul(g, c, t))


def _g2_at(g, base):
    return tuple(f2_at(g, base + 2 * c) for c in range(3))


def _f2_slots(base, v):
    return [(base, v[0]), (base + 1, v[1])]


def prog_g2_hr(g):
    """jac_add<fp2>'s first half, P + Q up to its branch: z1z1, z2z2, u1,
    u2, s1, s2, then h = u2 - u1 and r = s2 - s1."""
    (x1, y1, z1), (x2, y2, z2) = _g2_at(g, G2_P), _g2_at(g, G2_Q)
    z1z1, z2z2 = f2_sqr(g, z1), f2_sqr(g, z2)
    u1, u2 = f2_mul(g, x1, z2z2), f2_mul(g, x2, z1z1)
    s1 = f2_mul(g, f2_mul(g, y1, z2), z2z2)
    s2 = f2_mul(g, f2_mul(g, y2, z1), z1z1)
    h, r = f2_sub(g, u2, u1), f2_sub(g, s2, s1)
    out = []
    for base, v in ((G2_Z1Z1, z1z1), (G2_Z2Z2, z2z2), (G2_U1, u1), (G2_S1, s1),
                    (G2_H, h), (G2_R, r)):
        out += _f2_slots(base, v)
    return out


def prog_g2_add_fin(g):
    """jac_add<fp2>'s second half, from i = (2h)^2 to z3, into O."""
    (_, _, z1), (_, _, z2) = _g2_at(g, G2_P), _g2_at(g, G2_Q)
    z1z1, z2z2, u1, s1, h, r = (f2_at(g, s) for s in (
        G2_Z1Z1, G2_Z2Z2, G2_U1, G2_S1, G2_H, G2_R))
    i = f2_sqr(g, _dbl(g, h))
    j = f2_mul(g, h, i)
    rr = _dbl(g, r)
    v = f2_mul(g, u1, i)
    x3 = f2_sub(g, f2_sub(g, f2_sub(g, f2_sqr(g, rr), j), v), v)
    y3 = f2_sub(g, f2_mul(g, rr, f2_sub(g, v, x3)), _dbl(g, f2_mul(g, s1, j)))
    z3 = f2_mul(g, f2_sub(g, f2_sub(g, f2_sqr(g, f2_add(g, z1, z2)), z1z1), z2z2), h)
    return _f2_slots(G2_O, x3) + _f2_slots(G2_O + 2, y3) + _f2_slots(G2_O + 4, z3)


def prog_g2_dbl(g):
    """jac_double<fp2> of P into O (its branch to the identity, y or z
    zero, is the caller's)."""
    x, y, z = _g2_at(g, G2_P)
    a, b = f2_sqr(g, x), f2_sqr(g, y)
    c = f2_sqr(g, b)
    d = _dbl(g, f2_sub(g, f2_sub(g, f2_sqr(g, f2_add(g, x, b)), a), c))
    e = f2_add(g, _dbl(g, a), a)
    x3 = f2_sub(g, f2_sub(g, f2_sqr(g, e), d), d)
    y3 = f2_sub(g, f2_mul(g, e, f2_sub(g, d, x3)), _dbl(g, _dbl(g, _dbl(g, c))))
    z3 = _dbl(g, f2_mul(g, y, z))
    return _f2_slots(G2_O, x3) + _f2_slots(G2_O + 2, y3) + _f2_slots(G2_O + 4, z3)


def _g1_at(g, base):
    return tuple(g.inp(base + c) for c in range(3))


def prog_g1_hr(g):
    """jac_add<fp>'s first half, P + Q up to its branch: z1z1, z2z2, u1,
    u2, s1, s2, then h = u2 - u1 and r = s2 - s1."""
    (x1, y1, z1), (x2, y2, z2) = _g1_at(g, G1_P), _g1_at(g, G1_Q)
    z1z1, z2z2 = g.mul(z1, z1), g.mul(z2, z2)
    u1, u2 = g.mul(x1, z2z2), g.mul(x2, z1z1)
    s1 = g.mul(g.mul(y1, z2), z2z2)
    s2 = g.mul(g.mul(y2, z1), z1z1)
    h, r = g.sub(u2, u1), g.sub(s2, s1)
    return list(zip((G1_Z1Z1, G1_Z2Z2, G1_U1, G1_S1, G1_H, G1_R),
                    (z1z1, z2z2, u1, s1, h, r)))


def prog_g1_add_fin(g):
    """jac_add<fp>'s second half, from i = (2h)^2 to z3, into O."""
    z1, z2 = g.inp(G1_P + 2), g.inp(G1_Q + 2)
    z1z1, z2z2, u1, s1, h, r = (g.inp(s) for s in (
        G1_Z1Z1, G1_Z2Z2, G1_U1, G1_S1, G1_H, G1_R))
    h2 = g.add(h, h)
    i = g.mul(h2, h2)
    j = g.mul(h, i)
    rr = g.add(r, r)
    v = g.mul(u1, i)
    x3 = g.sub(g.sub(g.sub(g.mul(rr, rr), j), v), v)
    sj = g.mul(s1, j)
    y3 = g.sub(g.mul(rr, g.sub(v, x3)), g.add(sj, sj))
    zs = g.add(z1, z2)
    z3 = g.mul(g.sub(g.sub(g.mul(zs, zs), z1z1), z2z2), h)
    return [(G1_O, x3), (G1_O + 1, y3), (G1_O + 2, z3)]


def prog_g1_dbl(g):
    """jac_double<fp> of P into O (its branch to the identity, y or z
    zero, is the caller's)."""
    x, y, z = _g1_at(g, G1_P)
    a, b = g.mul(x, x), g.mul(y, y)
    c = g.mul(b, b)
    xb = g.add(x, b)
    t = g.sub(g.sub(g.mul(xb, xb), a), c)
    d = g.add(t, t)
    e = g.add(g.add(a, a), a)
    x3 = g.sub(g.sub(g.mul(e, e), d), d)
    c2 = g.add(c, c)
    c4 = g.add(c2, c2)
    y3 = g.sub(g.mul(e, g.sub(d, x3)), g.add(c4, c4))
    yz = g.mul(y, z)
    return [(G1_O, x3), (G1_O + 1, y3), (G1_O + 2, g.add(yz, yz))]


# name -> (graph function, first temporary slot)
PROGRAMS = {
    "M_INIT": (prog_miller_init, M_TEMP),
    "M_DBL": (lambda g: prog_miller_bit(g, False), M_TEMP),
    "M_ADD": (lambda g: prog_miller_bit(g, True), M_TEMP),
    "M_FINAL": (prog_miller_final, M_TEMP),
    "MUL12": (prog_mul12, C_TEMP),
    "FE_EASY": (prog_fe_easy, E_TEMP),
    "FE_RONE": (prog_fe_rone, E_TEMP),
    "FE_CYC": (prog_fe_cyc, E_TEMP),
    "FE_MULX": (prog_fe_mulx, E_TEMP),
    "FE_G1": (prog_fe_g1, E_TEMP),
    "FE_G2": (prog_fe_g2, E_TEMP),
    "FE_G3": (prog_fe_g3, E_TEMP),
    "FE_G4": (prog_fe_g4, E_TEMP),
    "FE_G5": (prog_fe_g5, E_TEMP),
    "T_SQR": (prog_test_sqr, C_TEMP),
    "T_LINE": (prog_test_line, C_TEMP),
    "T_CYC": (prog_test_cyclo, C_TEMP),
    "T_FROB": (prog_test_frob, C_TEMP),
    "T_INV": (prog_test_inv, C_TEMP),
    "G2_HR": (prog_g2_hr, G2_TEMP),
    "G2_ADD_FIN": (prog_g2_add_fin, G2_TEMP),
    "G2_DBL": (prog_g2_dbl, G2_TEMP),
    "G1_HR": (prog_g1_hr, G1_TEMP),
    "G1_ADD_FIN": (prog_g1_add_fin, G1_TEMP),
    "G1_DBL": (prog_g1_dbl, G1_TEMP),
}


# --- scheduling and slot allocation ----------------------------------------


def _kind(key) -> str | None:
    op = key[0]
    if op in ("in", "const"):
        return None
    if op == "mul":
        return "mul"
    if op == "inv":
        return "inv"
    return "alu"


def _srcs(key) -> tuple:
    op = key[0]
    if op in ("in", "const"):
        return ()
    if op == "sel":
        return key[2:]
    return key[1:]


def compile_program(name: str, build, temp_base: int,
                    jobs_per_stage: int = JOBS_PER_STAGE, reuse_slots: bool = True) -> dict:
    """Graph -> stages of at most `jobs_per_stage` jobs with slots (a
    temporary's slot is reused once it is dead unless `reuse_slots` is
    False). Returns {"stages": [(kind,
    [job words])], "temps": highest slot + 1, "muls": n, "mul_stages": n,
    "alu_stages": n, "path": dependent multiplications}."""
    g = Graph()
    outs = build(g)
    nodes = g.nodes
    # live nodes (reachable from the outputs)
    live, stack = set(), [n for _, n in outs]
    while stack:
        n = stack.pop()
        if n in live:
            continue
        live.add(n)
        stack.extend(_srcs(nodes[n]))
    users: dict[int, list[int]] = {n: [] for n in live}
    for n in live:
        for s in _srcs(nodes[n]):
            users[s].append(n)
    # priority: weighted longest path to a sink
    order = sorted(live)  # creation order is topological
    prio = {}
    for n in reversed(order):
        k = _kind(nodes[n])
        w = COST[k] if k else 0.0
        prio[n] = w + max((prio[u] for u in users[n]), default=0.0)
    # list scheduling: drain ready additions, then one stage of ready
    # multiplications (or the inversion)
    stage_of = {n: -1 for n in live if _kind(nodes[n]) is None}
    pending = {n for n in live if _kind(nodes[n]) is not None}
    stages: list[tuple[str, list[int]]] = []

    def ready(kind):
        return sorted((n for n in pending if _kind(nodes[n]) == kind and all(
            s in stage_of and stage_of[s] < len(stages) for s in _srcs(nodes[n]))),
            key=lambda n: (-prio[n], n))

    while pending:
        r = ready("alu")
        if not r:
            r = ready("mul")
            kind = "mul"
            if not r:
                r, kind = ready("inv")[:1], "inv"
        else:
            kind = "alu"
        assert r, f"{name}: nothing ready"
        take = r[:jobs_per_stage] if kind != "inv" else r[:1]
        for n in take:
            stage_of[n] = len(stages)
            pending.discard(n)
        stages.append((kind, take))
    nst = len(stages)
    # last read stage of every value
    last = {n: max((stage_of[u] for u in users[n]), default=-1) for n in live}
    # outputs: a computed value whose write comes after the last read of
    # what its slot held goes straight there; anything else (an input, a
    # constant, a value written too early, a value wanted in two slots)
    # is moved there by a final stage
    held_by_slot = {nodes[n][1]: n for n in live if nodes[n][0] == "in"}
    slot_of: dict[int, int] = {}
    for n in live:
        if nodes[n][0] in ("in", "const"):
            slot_of[n] = nodes[n][1]
    moves = []
    out_slots = set()
    for s, n in outs:
        assert s not in out_slots, f"{name}: slot {s} written twice"
        out_slots.add(s)
        old = held_by_slot.get(s)
        if old == n:
            continue  # unchanged
        if _kind(nodes[n]) is not None and n not in slot_of and (
                old is None or stage_of[n] > last[old]):
            slot_of[n] = s
            continue
        moves.append((s, n))
    # a moved value must stay readable until the move stage
    for s, n in moves:
        last[n] = nst
    if moves:
        srcs = {n for _, n in moves}
        for s, _ in moves:
            old = held_by_slot.get(s)
            assert old is None or old not in srcs or slot_of.get(old) != s, (
                f"{name}: a move reads a slot another move writes")
            if old is not None:
                last[old] = max(last[old], nst)
    # temporaries: linear scan in stage order
    free: list[tuple[int, int]] = []  # (slot, free after stage)
    next_slot = temp_base
    for st in range(nst):
        for n in stages[st][1]:
            if n in slot_of:
                continue
            pick = None
            for i, (s, after) in enumerate(free if reuse_slots else ()):
                if after < st:
                    pick = i
                    break
            if pick is None:
                slot_of[n] = next_slot
                next_slot += 1
            else:
                slot_of[n] = free.pop(pick)[0]
            free.append((slot_of[n], last[n]))
    assert next_slot <= NSLOTS_MAX, f"{name}: {next_slot} slots"

    def job(n):
        key = nodes[n]
        op = key[0]
        d = slot_of[n]
        if op == "mul":
            code, a, b = OP_MUL, slot_of[key[1]], slot_of[key[2]]
        elif op == "add":
            code, a, b = OP_ADD, slot_of[key[1]], slot_of[key[2]]
        elif op == "sub":
            code, a, b = OP_SUB, slot_of[key[1]], slot_of[key[2]]
        elif op == "sel":
            code, a, b = OP_SEL0 + key[1], slot_of[key[2]], slot_of[key[3]]
        else:
            code, a, b = OP_INV, slot_of[key[1]], 0
        return code | d << 3 | a << 12 | b << 22

    out_stages = [(kind, [job(n) for n in take]) for kind, take in stages]
    if moves:
        # a move is an addition of zero
        out_stages.append(("alu", [OP_ADD | s << 3 | slot_of[n] << 12 | ZERO_SLOT << 22
                                   for s, n in moves]))
    # dependent multiplications along the longest path
    depth = {}
    for n in order:
        k = _kind(nodes[n])
        w = {"mul": 1, "inv": INV_MULS}.get(k, 0)
        depth[n] = w + max((depth[s] for s in _srcs(nodes[n])), default=0)
    return {
        "name": name,
        "stages": out_stages,
        "temps": max(next_slot, max(s for s, _ in outs) + 1),
        "muls": sum(1 for n in live if _kind(nodes[n]) == "mul"),
        "mul_stages": sum(1 for k, _ in out_stages if k == "mul"),
        "alu_stages": sum(1 for k, _ in out_stages if k == "alu"),
        "inv_stages": sum(1 for k, _ in out_stages if k == "inv"),
        "path": max((depth[n] for _, n in outs), default=0),
        "outs": outs,
    }


# fq_inv is a binary extended Euclid (data-dependent halvings and
# subtractions on one lane), then one multiplication by R^3: on the critical
# path it counts as that one multiplication
INV_MULS = 1


def compile_all() -> dict[str, dict]:
    return {name: compile_program(name, b, t, G1_JOBS_PER_STAGE if name.startswith("G1_")
                                  else JOBS_PER_STAGE)
            for name, (b, t) in PROGRAMS.items()}


# --- the header ------------------------------------------------------------

KIND_CODE = {"mul": K_MUL, "alu": K_ALU, "inv": K_INV}


def _limbs32(v: int) -> list[int]:
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)]


def render(progs: dict[str, dict]) -> str:
    stage_words, jobs, index = [], [], []
    for name, p in progs.items():
        first = len(stage_words)
        for kind, js in p["stages"]:
            assert len(js) <= JOBS_PER_STAGE and len(jobs) < (1 << 23)
            stage_words.append(KIND_CODE[kind] | len(js) << 2 | len(jobs) << 9)
            jobs.extend(js)
        index.append((name, first, len(stage_words) - first, p))
    kernel_slots = {
        prefix: max(p["temps"] for name, p in progs.items() if name.startswith(prefix))
        for prefix in ("M_", "FE_", "T_", "G2_", "G1_")
    }
    kernel_slots["C_"] = max(kernel_slots.pop("T_"), progs["MUL12"]["temps"])
    lines = [
        "// Generated by tendermint_tpu_torch/ops/bls_warp_gen.py; do not edit.",
        "//",
        "// The stage programs of the warp-wide BLS12-381 kernels (run_program in",
        "// bls12_381_device.cuh). A stage word is kind | jobs << 2 | first job << 9",
        "// (kind 0: Fp multiplications, 1: additions, subtractions and selects,",
        "// 2: one inversion); a job is op | dst << 3 | a << 12 | b << 22 over",
        "// shared-memory slots of one Fp element (op 0 mul, 1 add, 2 sub, 3/4",
        "// select on pair 0/1's validity, 5 inversion). Lane l of a warp runs",
        "// jobs l and l + 32 of a stage; the G1 programs, at most 8 jobs a stage,",
        "// run on a group of G lanes, lane l jobs l and l + G.",
        "#pragma once",
        "",
        "#include <stdint.h>",
        "",
        "namespace bdev {",
        "namespace prog {",
        "",
        f"constexpr int NCONST = {len(CONST_VALUES)}, ZERO_SLOT = {ZERO_SLOT}, "
        f"ONE_SLOT = {ONE_SLOT};",
        "",
        "// regions (first slot; an Fp12 is 12 slots, coefficient i component c",
        "// at + 2 i + c): the Miller kernel's f, P, Q, T; the chunk product's",
        "// and the test programs' X, Y, Z = op(X, Y); the final",
        "// exponentiation's F, A, B, R, X, O; the G2 sums' points P, Q, O",
        "// (coordinate c component k at + 2 c + k) and G2_HR's Fp2 values; the",
        "// G1 sums' points P, Q, O (a coordinate a slot) and G1_HR's values, in",
        "// a region whose only constants are slots 0 and 1; and each kernel's",
        "// slot count",
        f"constexpr int M_F = {M_F}, M_P = {M_P}, M_Q = {M_Q}, M_T = {M_T};",
        f"constexpr int C_X = {C_X}, C_Y = {C_Y}, C_Z = {C_Z};",
        f"constexpr int E_F = {E_F}, E_A = {E_A}, E_B = {E_B}, E_R = {E_R}, "
        f"E_X = {E_X}, E_O = {E_O};",
        f"constexpr int G2_P = {G2_P}, G2_Q = {G2_Q}, G2_O = {G2_O};",
        f"constexpr int G2_Z1Z1 = {G2_Z1Z1}, G2_Z2Z2 = {G2_Z2Z2}, G2_U1 = {G2_U1}, "
        f"G2_S1 = {G2_S1}, G2_H = {G2_H}, G2_R = {G2_R};",
        f"constexpr int G1_P = {G1_P}, G1_Q = {G1_Q}, G1_O = {G1_O};",
        f"constexpr int G1_Z1Z1 = {G1_Z1Z1}, G1_Z2Z2 = {G1_Z2Z2}, G1_U1 = {G1_U1}, "
        f"G1_S1 = {G1_S1}, G1_H = {G1_H}, G1_R = {G1_R};",
        f"constexpr int M_SLOTS = {kernel_slots['M_']}, C_SLOTS = {kernel_slots['C_']}, "
        f"FE_SLOTS = {kernel_slots['FE_']}, G2_SLOTS = {kernel_slots['G2_']}, "
        f"G1_SLOTS = {kernel_slots['G1_']};",
        "",
        "// program: first stage, stages; its slots, Fp multiplications and",
        "// dependent multiplications along its longest path",
    ]
    for name, first, n, p in index:
        lines.append(
            f"constexpr int {name}_FIRST = {first}, {name}_N = {n};  "
            f"// {p['temps']} slots, {p['muls']} mul, path {p['path']}")
    lines += [
        "",
        "// the constant slots: 0, 1, and the other coefficients of gamma, as",
        "// Montgomery limbs (R = 2^384)",
        "__constant__ uint32_t CONSTS[NCONST][12] = {",
    ]
    for v in CONST_VALUES:
        lines.append("    {" + ", ".join(f"0x{x:08x}u" for x in _limbs32(v * R_MONT % P)) + "},")
    lines += ["};", "", f"__constant__ uint32_t STAGES[{len(stage_words)}] = {{"]
    for i in range(0, len(stage_words), 8):
        lines.append("    " + " ".join(f"0x{x:08x}u," for x in stage_words[i:i + 8]))
    lines += ["};", "", f"__device__ const uint32_t JOBS[{len(jobs)}] = {{"]
    for i in range(0, len(jobs), 8):
        lines.append("    " + " ".join(f"0x{x:08x}u," for x in jobs[i:i + 8]))
    lines += ["};", "", "}  // namespace prog", "}  // namespace bdev", ""]
    return "\n".join(lines)


def generate() -> str:
    return render(compile_all())


# --- a Python run of the tables ---------------------------------------------


def _decode(word: int) -> tuple[int, int, int, int]:
    return word & 7, (word >> 3) & 511, (word >> 12) & 1023, (word >> 22) & 1023


def simulate(prog: dict, slots: dict[int, int], flags: tuple[bool, bool] = (True, True),
             p: int = P, lanes: int = 32):
    """Run one compiled program on plain field values mod `p` (BLS12-381's
    by default; Montgomery form is a ring isomorphism, so the card's limbs
    are these values times R), in place on `slots`, job i of a stage on
    lane i % `lanes`, a lane's jobs in order (a job word 0 is none). Raises
    if a stage reads or writes a slot that another lane of the same stage
    writes."""
    for kind, js in prog["stages"]:
        lane_of = {}
        for i, w in enumerate(js):
            if w:
                lane_of.setdefault(i % lanes, []).append(w)
        writes, reads = {}, {}
        results = []
        for lane, ws in lane_of.items():
            own = {}  # the lane's writes so far in the stage
            for w in ws:
                op, d, a, b = _decode(w)
                srcs = (a,) if op == OP_INV else (a, b)
                for s in srcs:
                    reads.setdefault(s, set()).add(lane)
                assert writes.get(d, lane) == lane, (
                    f"{prog['name']}: slot {d} written by two lanes in a stage")
                writes[d] = lane
                x = own[a] if a in own else slots[a]
                y = own[b] if b in own else slots.get(b, 0)
                if op == OP_MUL:
                    r = x * y % p
                elif op == OP_ADD:
                    r = (x + y) % p
                elif op == OP_SUB:
                    r = (x - y) % p
                elif op in (OP_SEL0, OP_SEL1):
                    r = x if flags[op - OP_SEL0] else y
                else:
                    r = pow(x, p - 2, p)
                own[d] = r
                results.append((d, r))
        for d, lane in writes.items():
            assert reads.get(d, {lane}) <= {lane}, (
                f"{prog['name']}: slot {d} read and written by two lanes in a stage")
        for d, r in results:
            slots[d] = r
    return slots


def const_slots() -> dict[int, int]:
    return {i: v for i, v in enumerate(CONST_VALUES)}


def main() -> None:
    progs = compile_all()
    for name, p in progs.items():
        print(f"{name}: {len(p['stages'])} stages ({p['mul_stages']} mul, "
              f"{p['alu_stages']} alu, {p['inv_stages']} inv), {p['muls']} muls, "
              f"path {p['path']}, slots {p['temps']}")
    text = render(progs)
    tmp = HEADER.with_suffix(f".tmp{os.getpid()}")
    tmp.write_text(text)
    os.replace(tmp, HEADER)
    print(f"wrote {HEADER} ({len(text)} bytes)")


if __name__ == "__main__":
    main()
