"""BLS12-381 pairing curve: host-side arithmetic (pure Python bigints).

Role: the cryptography behind the fork's L2 batch-point dual-signing —
keygen/sign/verify/aggregate live in crypto/bls_signatures.py; this module
is the curve library underneath (reference consumes go-ethereum's kilic
port, reference blssignatures/bls_signatures.go:1-10; the reference
itself has no first-party pairing code either).

Layout choices (host code — the TPU G1 MSM kernel for aggregation lives in
ops/, this file is the correctness root):

- Fp: plain Python ints mod P (no Montgomery — CPython bigints are fine at
  this layer; the hot path is the TPU, not the host).
- Fp2 = Fp[u]/(u^2+1) as (c0, c1) tuples with function-style ops.
- Fp12 = Fp2[w]/(w^6 - xi), xi = u+1 — a *flat sextic* tower over Fp2
  instead of the textbook 2-3-2 tower: line evaluations in the Miller loop
  are naturally sparse in the w-basis, frobenius is a per-coefficient
  twist by precomputed gamma_i = xi^(i(p-1)/6), and inversion drops to the
  even subalgebra Fp6 = Fp2[w^2] via the w -> -w conjugation.
- G1: Jacobian coordinates over Fp.  G2: Jacobian over Fp2 on the twist
  E': y^2 = x^3 + 4(u+1).
- Pairing: optimal ate, affine twist coordinates in the Miller loop
  (Fp2 inversions are one Fp inversion each — cheap on host), line
  l(P) = (lam*xT - yT) - lam*xp*w^2 + yp*w^3 after clearing w powers
  (constants drop out in the final exponentiation).
- Final exponentiation: easy part via conjugation/frobenius; hard part via
  the BLS12 decomposition 3(p^4-p^2+1)/r = (x-1)^2 (x+p) (x^2+p^2-1) + 3
  (verified numerically at import), exploiting the low hamming weight of x.
  This computes e(P,Q)^3 — an equally valid bilinear pairing (3 does not
  divide r), and every verification equation here only compares pairing
  products against 1.

Everything here is verified by algebraic self-checks in tests/test_bls.py
(bilinearity, group orders, hash-to-curve subgroup membership) since no
external vectors are reachable in this environment.
"""

from __future__ import annotations

# --- parameters -----------------------------------------------------------

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
X_ABS = 0xD201000000010000  # |x|; the BLS parameter x is -X_ABS
H_EFF_G1 = 0xD201000000010001  # effective G1 cofactor (1 - x)

B_G1 = 4

# generators (standard)
G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
G2_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)


# --- Fp2 ------------------------------------------------------------------
# elements are (c0, c1) = c0 + c1*u with u^2 = -1

F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (1, 1)  # u + 1


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    # (a0+a1)(b0+b1) - t0 - t1 = a0b1 + a1b0
    return ((t0 - t1) % P, ((a0 + a1) * (b0 + b1) - t0 - t1) % P)


def f2_sqr(a):
    a0, a1 = a
    # (a0+a1)(a0-a1) + 2 a0 a1 u
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def f2_scale(a, k):
    return (a[0] * k % P, a[1] * k % P)


def f2_conj(a):
    return (a[0], (-a[1]) % P)


def f2_inv(a):
    a0, a1 = a
    norm = (a0 * a0 + a1 * a1) % P
    ninv = pow(norm, P - 2, P)
    return (a0 * ninv % P, (-a1) * ninv % P)


def f2_pow(a, e):
    r = F2_ONE
    while e:
        if e & 1:
            r = f2_mul(r, a)
        a = f2_sqr(a)
        e >>= 1
    return r


def f2_is_zero(a):
    return a[0] % P == 0 and a[1] % P == 0


# --- Fp12 as Fp2[w]/(w^6 - XI) -------------------------------------------
# elements: tuple of 6 Fp2 coefficients (a0..a5), value = sum a_i w^i

F12_ONE = (F2_ONE, F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO)
F12_ZERO = (F2_ZERO,) * 6


def f12_mul(a, b):
    acc = [[0, 0] for _ in range(11)]
    for i in range(6):
        ai = a[i]
        if ai == F2_ZERO:
            continue
        for j in range(6):
            bj = b[j]
            if bj == F2_ZERO:
                continue
            m = f2_mul(ai, bj)
            acc[i + j][0] += m[0]
            acc[i + j][1] += m[1]
    out = []
    for k in range(6):
        c0, c1 = acc[k]
        if k + 6 <= 10:
            h = (acc[k + 6][0] % P, acc[k + 6][1] % P)
            hx = f2_mul(h, XI)
            c0 += hx[0]
            c1 += hx[1]
        out.append((c0 % P, c1 % P))
    return tuple(out)


def f12_sqr(a):
    return f12_mul(a, a)


def f12_conj(a):
    """w -> -w (this is frobenius^6; checked at import)."""
    return (a[0], f2_neg(a[1]), a[2], f2_neg(a[3]), a[4], f2_neg(a[5]))


# gamma_i = XI^(i*(p-1)/6) for frobenius; (p-1) % 6 == 0
_E6 = (P - 1) // 6
_GAMMA = tuple(f2_pow(XI, i * _E6) for i in range(6))
# sanity: frobenius^6 must send w -> -w, i.e. XI^((p^6-1)/6) == -1
_e66 = (P**6 - 1) // 6
assert f2_pow(XI, _e66 % (P * P - 1)) == ((P - 1) % P, 0), "tower: frob^6 != conj"


def f12_frob(a):
    """a^p: conjugate each Fp2 coefficient, twist by gamma_i."""
    return tuple(f2_mul(f2_conj(a[i]), _GAMMA[i]) for i in range(6))


def f12_frob_n(a, n):
    for _ in range(n):
        a = f12_frob(a)
    return a


def _f6_mul(a, b):
    """Fp6 = Fp2[v]/(v^3 - XI) with elements (b0, b1, b2)."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul(XI, f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(
        f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)),
        f2_mul(XI, t2),
    )
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def _f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_sqr(a0), f2_mul(XI, f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul(XI, f2_sqr(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    t = f2_add(
        f2_mul(a0, c0),
        f2_mul(XI, f2_add(f2_mul(a1, c2), f2_mul(a2, c1))),
    )
    ti = f2_inv(t)
    return (f2_mul(c0, ti), f2_mul(c1, ti), f2_mul(c2, ti))


def f12_inv(a):
    """a^-1 via the even subalgebra: n = a * conj(a) has only even w powers
    (w^1,3,5 coefficients cancel), and Fp2[w^2]/( (w^2)^3 - XI ) = Fp6."""
    ac = f12_conj(a)
    n = f12_mul(a, ac)
    assert n[1] == F2_ZERO and n[3] == F2_ZERO and n[5] == F2_ZERO
    n6 = (n[0], n[2], n[4])
    n6i = _f6_inv(n6)
    # a^-1 = conj(a) * n^-1, n^-1 embedded at even coefficients
    n12 = (n6i[0], F2_ZERO, n6i[1], F2_ZERO, n6i[2], F2_ZERO)
    return f12_mul(ac, n12)


def f12_exp_xabs(a):
    """a^|x| exploiting |x| = 2^63+2^62+2^60+2^57+2^48+2^16 (weight 6)."""
    r = F12_ONE
    bits = bin(X_ABS)[2:]
    for bit in bits:
        r = f12_sqr(r)
        if bit == "1":
            r = f12_mul(r, a)
    return r


def f12_eq(a, b):
    return all(a[i] == b[i] for i in range(6))


# --- G1: E(Fp): y^2 = x^3 + 4, Jacobian (X, Y, Z); Z=0 is infinity --------

G1_INF = (1, 1, 0)


def g1_is_inf(p):
    return p[2] == 0


def g1_double(p):
    x, y, z = p
    if z == 0 or y == 0:
        return G1_INF
    a = x * x % P
    b = y * y % P
    c = b * b % P
    d = 2 * ((x + b) * (x + b) - a - c) % P
    e = 3 * a % P
    f = e * e % P
    x3 = (f - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = 2 * y * z % P
    return (x3, y3, z3)


def g1_add(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    if u1 == u2:
        if s1 != s2:
            return G1_INF
        return g1_double(p)
    h = (u2 - u1) % P
    i = (2 * h) * (2 * h) % P
    j = h * i % P
    rr = 2 * (s2 - s1) % P
    v = u1 * i % P
    x3 = (rr * rr - j - 2 * v) % P
    y3 = (rr * (v - x3) - 2 * s1 * j) % P
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) * h % P
    return (x3, y3, z3)


def g1_neg(p):
    return (p[0], (-p[1]) % P, p[2])


def g1_mul(p, k):
    k %= R
    r = G1_INF
    while k:
        if k & 1:
            r = g1_add(r, p)
        p = g1_double(p)
        k >>= 1
    return r


def g1_mul_raw(p, k):
    """Scalar mult without reducing k mod R (cofactor clearing)."""
    r = G1_INF
    while k:
        if k & 1:
            r = g1_add(r, p)
        p = g1_double(p)
        k >>= 1
    return r


def g1_to_affine(p):
    x, y, z = p
    if z == 0:
        return None  # infinity
    if z == 1:  # already affine (wire-decoded / native-returned points)
        return (x, y)
    zi = pow(z, P - 2, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 % P * zi % P)


def g1_from_affine(a):
    if a is None:
        return G1_INF
    return (a[0], a[1], 1)


def g1_on_curve(p):
    a = g1_to_affine(p)
    if a is None:
        return True
    x, y = a
    return (y * y - x * x * x - B_G1) % P == 0


def g1_eq(p, q):
    return g1_to_affine(p) == g1_to_affine(q)


G1_GEN = (G1_X, G1_Y, 1)


# --- G2: twist E'(Fp2): y^2 = x^3 + 4(u+1), Jacobian over Fp2 -------------

B_G2 = f2_scale(XI, 4)
G2_INF = (F2_ONE, F2_ONE, F2_ZERO)


def g2_is_inf(p):
    return f2_is_zero(p[2])


def g2_double(p):
    x, y, z = p
    if f2_is_zero(z) or f2_is_zero(y):
        return G2_INF
    a = f2_sqr(x)
    b = f2_sqr(y)
    c = f2_sqr(b)
    d = f2_scale(f2_sub(f2_sub(f2_sqr(f2_add(x, b)), a), c), 2)
    e = f2_scale(a, 3)
    f = f2_sqr(e)
    x3 = f2_sub(f, f2_scale(d, 2))
    y3 = f2_sub(f2_mul(e, f2_sub(d, x3)), f2_scale(c, 8))
    z3 = f2_scale(f2_mul(y, z), 2)
    return (x3, y3, z3)


def g2_add(p, q):
    if f2_is_zero(p[2]):
        return q
    if f2_is_zero(q[2]):
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = f2_sqr(z1)
    z2z2 = f2_sqr(z2)
    u1 = f2_mul(x1, z2z2)
    u2 = f2_mul(x2, z1z1)
    s1 = f2_mul(f2_mul(y1, z2), z2z2)
    s2 = f2_mul(f2_mul(y2, z1), z1z1)
    if u1 == u2:
        if s1 != s2:
            return G2_INF
        return g2_double(p)
    h = f2_sub(u2, u1)
    i = f2_sqr(f2_scale(h, 2))
    j = f2_mul(h, i)
    rr = f2_scale(f2_sub(s2, s1), 2)
    v = f2_mul(u1, i)
    x3 = f2_sub(f2_sub(f2_sqr(rr), j), f2_scale(v, 2))
    y3 = f2_sub(f2_mul(rr, f2_sub(v, x3)), f2_scale(f2_mul(s1, j), 2))
    z3 = f2_mul(f2_sub(f2_sub(f2_sqr(f2_add(z1, z2)), z1z1), z2z2), h)
    return (x3, y3, z3)


def g2_neg(p):
    return (p[0], f2_neg(p[1]), p[2])


def g2_mul(p, k):
    k %= R
    r = G2_INF
    while k:
        if k & 1:
            r = g2_add(r, p)
        p = g2_double(p)
        k >>= 1
    return r


def g2_to_affine(p):
    x, y, z = p
    if f2_is_zero(z):
        return None
    if z == F2_ONE:  # already affine (wire-decoded / native-returned)
        return (x, y)
    zi = f2_inv(z)
    zi2 = f2_sqr(zi)
    return (f2_mul(x, zi2), f2_mul(f2_mul(y, zi2), zi))


def g2_from_affine(a):
    if a is None:
        return G2_INF
    return (a[0], a[1], F2_ONE)


def g2_on_curve(p):
    a = g2_to_affine(p)
    if a is None:
        return True
    x, y = a
    return f2_sub(f2_sqr(y), f2_add(f2_mul(f2_sqr(x), x), B_G2)) == F2_ZERO


def g2_eq(p, q):
    return g2_to_affine(p) == g2_to_affine(q)


def g2_in_subgroup(p):
    return g2_is_inf(g2_mul_raw(p, R))


def g2_mul_raw(p, k):
    r = G2_INF
    while k:
        if k & 1:
            r = g2_add(r, p)
        p = g2_double(p)
        k >>= 1
    return r


def g1_in_subgroup(p):
    return g1_is_inf(g1_mul_raw(p, R))


G2_GEN = (G2_X, G2_Y, F2_ONE)


# --- pairing --------------------------------------------------------------


def _line(lam, xt, yt, xp, yp):
    """Sparse Fp12 line value through the (untwisted) point with twist
    coords (xt, yt) and slope lam (Fp2), evaluated at P=(xp, yp) in Fp.

    Derivation (see module docstring): after the untwist psi(x,y) =
    (x w^-2, y w^-3) and clearing a w^3 factor (which final-exp kills):
        l = (lam*xt - yt)  -  (lam*xp) w^2  +  yp w^3
    """
    c0 = f2_sub(f2_mul(lam, xt), yt)
    c2 = f2_neg(f2_scale(lam, xp))
    c3 = ((yp % P), 0)
    return (c0, F2_ZERO, c2, c3, F2_ZERO, F2_ZERO)


def miller_loop(pairs):
    """prod_i f_{|x|, Q_i}(P_i), conjugated for x<0. pairs: [(g1_jac, g2_jac)].

    Infinity points are skipped (their pairing factor is 1), matching the
    reference engine's behavior of pairing only what's added.
    """
    prepared = []
    for gp, gq in pairs:
        pa = g1_to_affine(gp)
        qa = g2_to_affine(gq)
        if pa is None or qa is None:
            continue
        prepared.append((pa, qa))
    if not prepared:
        return F12_ONE

    f = F12_ONE
    ts = [q for _, q in prepared]  # affine twist coords (Fp2 pairs)
    bits = bin(X_ABS)[3:]  # skip leading 1: T starts at Q
    for bit in bits:
        f = f12_sqr(f)
        for i, ((xp, yp), (xq, yq)) in enumerate(prepared):
            xt, yt = ts[i]
            # doubling step: lam = 3 xt^2 / (2 yt)
            lam = f2_mul(
                f2_scale(f2_sqr(xt), 3),
                f2_inv(f2_scale(yt, 2)),
            )
            f = f12_mul(f, _line(lam, xt, yt, xp, yp))
            x3 = f2_sub(f2_sqr(lam), f2_scale(xt, 2))
            y3 = f2_sub(f2_mul(lam, f2_sub(xt, x3)), yt)
            ts[i] = (x3, y3)
        if bit == "1":
            for i, ((xp, yp), (xq, yq)) in enumerate(prepared):
                xt, yt = ts[i]
                # addition step T + Q: lam = (yt - yq)/(xt - xq)
                lam = f2_mul(f2_sub(yt, yq), f2_inv(f2_sub(xt, xq)))
                f = f12_mul(f, _line(lam, xt, yt, xp, yp))
                x3 = f2_sub(f2_sub(f2_sqr(lam), xt), xq)
                y3 = f2_sub(f2_mul(lam, f2_sub(xt, x3)), yt)
                ts[i] = (x3, y3)
    # x < 0: f_{x} = conj(f_{|x|}) up to factors killed by final exp
    return f12_conj(f)


# hard-part decomposition check (the classic BLS12 chain computes the CUBE
# of the ate pairing — still bilinear and non-degenerate since gcd(3, r)=1):
#   3*(p^4 - p^2 + 1)/r == (x-1)^2 (x+p) (x^2+p^2-1) + 3
_X_SIGNED = -X_ABS
assert (P**4 - P**2 + 1) % R == 0
assert 3 * ((P**4 - P**2 + 1) // R) == (
    (_X_SIGNED - 1) ** 2 * (_X_SIGNED + P) * (_X_SIGNED**2 + P**2 - 1) + 3
), "BLS12 final-exp decomposition failed"


def _exp_x_signed(a):
    """a^x for the (negative) BLS parameter x."""
    return f12_conj(f12_exp_xabs(a))  # conj == inverse for unitary elements


def final_exponentiation(f):
    # easy part: f^((p^6-1)(p^2+1))
    f = f12_mul(f12_conj(f), f12_inv(f))  # f^(p^6 - 1)
    f = f12_mul(f12_frob_n(f, 2), f)  # ^(p^2 + 1)
    # after the easy part f is unitary: conj(f) == f^-1
    # hard part: f^((x-1)^2 (x+p) (x^2+p^2-1)) * f^3
    a = f12_mul(_exp_x_signed(f), f12_conj(f))  # f^(x-1)
    a = f12_mul(_exp_x_signed(a), f12_conj(a))  # f^((x-1)^2)
    b = f12_mul(_exp_x_signed(a), f12_frob(a))  # ^(x+p)
    c = f12_mul(
        f12_mul(_exp_x_signed(_exp_x_signed(b)), f12_frob_n(b, 2)),
        f12_conj(b),
    )  # ^(x^2+p^2-1)
    return f12_mul(c, f12_mul(f12_sqr(f), f))  # * f^3


def pairing(p, q):
    """e(P in G1, Q in G2) in Fp12."""
    return final_exponentiation(miller_loop([(p, q)]))


def multi_pairing_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 — the verification primitive."""
    return f12_eq(final_exponentiation(miller_loop(pairs)), F12_ONE)


# --- hash to G1: SSWU on the 11-isogenous curve + derived Velu map --------
# see tools/derive_iso11.py for the derivation and self-checks

A_ISO = 0x144698A3B8E9433D693A02C96D4982B0EA985383EE66A8D8E8981AEFD881AC98936F8DA0E0F97F5CF428082D584C1D
B_ISO = 0x12E2908D11688030018B12E8753EEE3B2016C1F0F24F4070A0B9C14FCEF35EF55A23215A316CEAA5D1CC48E98E172BE0
Z_SSWU = 11

# kernel polynomial of the 11-isogeny E' -> E (monic degree 5; low->high),
# emitted by tools/derive_iso11.py (division-polynomial factoring + Velu;
# self-checked there by mapping E'(Fp) points onto E):
ISO11_KERNEL: list[int] = [
    0x133341FB0962A34CB0504A9C4FADA0A5090D38679B4C040D5D1C3AFB023A3409FCC0815FEA66D8B02BBEF9C8B5A66E07,
    0x0264908AF037BCEDE00D054CF5D4775E83EB6CF63C76B969F8ED174FB59FCFF78D201F46F6CFC4ED6552E59CE75177B0,
    0x1335C502C1F54C49ACEEA65E87FD7203BA0F626F305FC0CFD606A5DAE9F3C8E81A4B3B69600129FABD307C69BF319D39,
    0x094440F65F408A6E930E16E3E92DD17BF60D6E9679A8D3D58593DE55AC23703042D609537EB3549AAC234D896CA82944,
    0x04AFE09D5CF4956A23B6B71F59D2B3407B415A774B7BE81BBB6FA99CBC798E0AC98BA725A5BC328016B1C268B4766E85,
    0x1,
]
ISO11_SCALE_U = 11  # compose Velu with (x, y) -> (x/u^2, y/u^3)

_ISO = {}


def _init_iso(kernel: list[int]) -> None:
    """Precompute the polynomial pieces of the Velu isogeny evaluation.

    With h the kernel polynomial (monic, degree d=5), power sums p1..p2 of
    its roots, and B'(x) = x^3 + A'x + B' on the iso-curve:
        Tn = 6(x^2 h' - (x d + p1) h) + 2A' h'
        Un = 4(x^3 h' - (x^2 d + x p1 + p2) h) + 4A'(x h' - d h) + 4B' h'
        N2 = Tn h - Un' h + Un h'
        X(x)  = x + N2/h^2
        Y(x,y)= y (1 + (N2' h - 2 N2 h')/h^3)
    then scale by u: (X/u^2, Y/u^3).
    """

    def ptrim(a):
        while a and a[-1] == 0:
            a.pop()
        return a

    def padd(a, b):
        n = max(len(a), len(b))
        return ptrim(
            [
                ((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % P
                for i in range(n)
            ]
        )

    def psub(a, b):
        n = max(len(a), len(b))
        return ptrim(
            [
                ((a[i] if i < len(a) else 0) - (b[i] if i < len(b) else 0)) % P
                for i in range(n)
            ]
        )

    def pmul(a, b):
        if not a or not b:
            return []
        out = [0] * (len(a) + len(b) - 1)
        for i, ai in enumerate(a):
            for j, bj in enumerate(b):
                out[i + j] = (out[i + j] + ai * bj) % P
        return ptrim(out)

    def pscale(a, k):
        k %= P
        return ptrim([ai * k % P for ai in a])

    def pderiv(a):
        return ptrim([a[i] * i % P for i in range(1, len(a))])

    h = list(kernel)
    d = len(h) - 1
    assert d == 5 and h[-1] == 1
    hp = pderiv(h)
    # power sums via Newton (e_i with signs from monic h)
    e1 = (-h[d - 1]) % P
    e2 = h[d - 2] % P
    p1 = e1
    p2 = (e1 * p1 - 2 * e2) % P
    a_, b_ = A_ISO, B_ISO
    x_ = [0, 1]
    Tn = padd(
        pscale(psub(pmul([0, 0, 1], hp), pmul(padd(pscale(x_, d), [p1]), h)), 6),
        pscale(hp, 2 * a_),
    )
    Un = padd(
        padd(
            pscale(
                psub(
                    pmul([0, 0, 0, 1], hp),
                    pmul(padd(padd(pscale([0, 0, 1], d), pscale(x_, p1)), [p2]), h),
                ),
                4,
            ),
            pscale(psub(pmul(x_, hp), pscale(h, d)), 4 * a_),
        ),
        pscale(hp, 4 * b_),
    )
    N2 = padd(psub(pmul(Tn, h), pmul(pderiv(Un), h)), pmul(Un, hp))
    _ISO["h"] = h
    _ISO["hp"] = hp
    _ISO["N2"] = N2
    _ISO["N2p"] = pderiv(N2)
    u = ISO11_SCALE_U
    _ISO["u2i"] = pow(u * u % P, P - 2, P)
    _ISO["u3i"] = pow(u * u % P * u % P, P - 2, P)


def _peval(a, x):
    r = 0
    for c in reversed(a):
        r = (r * x + c) % P
    return r


def iso11_map(x: int, y: int) -> tuple[int, int]:
    """Evaluate the 11-isogeny E' -> E at an affine iso-curve point."""
    h, hp, N2, N2p = _ISO["h"], _ISO["hp"], _ISO["N2"], _ISO["N2p"]
    hx = _peval(h, x)
    if hx == 0:  # kernel point maps to infinity; cannot happen for SSWU output
        raise ValueError("point in isogeny kernel")
    hx_i = _fp_inv(hx)
    hx2_i = hx_i * hx_i % P
    X = (x + _peval(N2, x) * hx2_i) % P
    num = (_peval(N2p, x) * hx - 2 * _peval(N2, x) * _peval(hp, x)) % P
    Y = y * (1 + num * (hx2_i * hx_i % P)) % P
    return (X * _ISO["u2i"] % P, Y * _ISO["u3i"] % P)


def _sgn0_be(x: int) -> int:
    """draft-06 big-endian sign: 1 if x > (p-1)/2 else 0."""
    return 1 if x > (P - 1) // 2 else 0


# Native fast paths for the pow-heavy hash-to-curve field steps: a python
# pow() here is ~300 us; the C library's Montgomery chain is ~20-40 us.
# Pure-python fallbacks keep this module a complete standalone spec.


def _fp_inv(v: int) -> int:
    try:
        from . import bls_native

        out = bls_native.fp_inv48(v.to_bytes(48, "big"))
        if out is not None:
            return int.from_bytes(out, "big")
    except Exception:
        pass
    return pow(v, P - 2, P)


def _sqrt_fp(v: int) -> int | None:
    try:
        from . import bls_native

        out = bls_native.fp_sqrt48(v.to_bytes(48, "big"))
        if out is not None:
            return int.from_bytes(out, "big") if out else None
    except Exception:
        pass
    s = pow(v, (P + 1) // 4, P)
    return s if s * s % P == v else None


# constant inverses used by every SSWU evaluation (precomputed once)
_A_ISO_INV: int = 0
_ZA_ISO_INV: int = 0


def sswu_iso(u: int) -> tuple[int, int]:
    """Simplified SWU onto the iso-curve E' (draft-06 semantics)."""
    A, B, Z = A_ISO, B_ISO, Z_SSWU
    u2 = u * u % P
    t1 = (Z * Z % P * u2 % P * u2 + Z * u2) % P  # Z^2 u^4 + Z u^2
    if t1 == 0:
        x1 = B * _ZA_ISO_INV % P
    else:
        x1 = (-B) * _A_ISO_INV % P * (1 + _fp_inv(t1)) % P
    gx1 = (x1 * x1 % P * x1 + A * x1 + B) % P
    y1 = _sqrt_fp(gx1)
    if y1 is not None:
        x, y = x1, y1
    else:
        x2 = Z * u2 % P * x1 % P
        gx2 = (x2 * x2 % P * x2 + A * x2 + B) % P
        y2 = _sqrt_fp(gx2)
        assert y2 is not None, "SSWU: neither candidate square (impossible)"
        x, y = x2, y2
    if _sgn0_be(u) != _sgn0_be(y):
        y = (-y) % P
    return x, y


def map_to_curve_g1(fe48: bytes):
    """48-byte big-endian field element -> G1 Jacobian point (in subgroup).

    Mirrors go-ethereum bls12381 G1.MapToCurve semantics: interpret the 48
    bytes as an Fp element (must be < p), SSWU to the iso-curve, 11-isogeny
    to E, clear cofactor by h_eff = 0xd201000000010001.
    """
    if len(fe48) != 48:
        raise ValueError("mapToCurve input must be 48 bytes")
    u = int.from_bytes(fe48, "big")
    if u >= P:
        raise ValueError("mapToCurve input not a canonical field element")
    x, y = sswu_iso(u)
    X, Y = iso11_map(x, y)
    # cofactor clearing: the isogeny image is on E, so the native scalar
    # mult applies directly (~40 us vs ~500 us of python jacobian steps)
    try:
        from . import bls_native

        out = bls_native.g1_mul(
            X.to_bytes(48, "big") + Y.to_bytes(48, "big"),
            H_EFF_G1.to_bytes(32, "big"),
        )
        if out is not None:
            if out == b"\x00" * 96:
                return G1_INF
            return (
                int.from_bytes(out[:48], "big"),
                int.from_bytes(out[48:], "big"),
                1,
            )
    except Exception:
        pass
    return g1_mul_raw((X, Y, 1), H_EFF_G1)


_init_iso(ISO11_KERNEL)
_A_ISO_INV = pow(A_ISO, P - 2, P)
_ZA_ISO_INV = pow(Z_SSWU * A_ISO % P, P - 2, P)
