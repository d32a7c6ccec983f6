"""The rest of the port's core numerics against the JAX package: the
tables and small PAC ops of ``core/rns.py``, the MRC ops of
``core/mrc.py`` (sign, compare, base extension, Olsen scaling, int32
decode, the scaled float decode) and ``core/quantize.py``'s
``quantize`` / ``dequantize``.

Inputs are made with numpy from a seed and go through both packages;
residues and integers must be equal, floats equal bit for bit.  Values
that matter at an edge (ties of the scaling, the ends of int32) are
built from the profile or from powers of two at run time.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import mrc as jmrc
from repro.core import quantize as jq
from repro.core import rns as jrns
from repro_torch.core import mrc, quantize, rns
from repro_torch.core.moduli import PROFILES, get_profile

SLICE = ["rns5", "rns9", "rns12", "rns18", "rns21"]
INT32_MAX, INT32_MIN = 2 ** 31 - 1, -2 ** 31


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


def _bits(a):
    """float32 array -> its bit patterns (so -0.0 != 0.0 and NaN == NaN)."""
    return np.asarray(a, np.float32).view(np.int32)


def _exact_residues(name, vals):
    return rns.encode_exact(name, np.asarray(vals, dtype=object))


def _signed_values(name, n, seed, bits=None):
    """n random python ints below M/2 in magnitude (below 2**bits if
    given), zero and the ends of the signed range among them."""
    p = get_profile(name)
    half = p.M // 2
    rng = np.random.default_rng(seed)
    top = min(half - 1, 2 ** bits) if bits else half - 1
    vals = [int(rng.integers(-2 ** 62, 2 ** 62)) * top // 2 ** 62
            for _ in range(n)]
    return vals + [0, 1, -1, top, -top]


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_tables_extension_match_jax(name):
    t, jt = rns.tables(name), jrns.tables(name)
    np.testing.assert_array_equal(t.ext, jt.ext)
    np.testing.assert_array_equal(t.ext_scaled, jt.ext_scaled)
    np.testing.assert_array_equal(t.W_mod32, jt.W_mod32)
    assert t.M_mod32 == jt.M_mod32 and t.M_mod32.dtype == np.int32
    assert t.Wf == jt.Wf


@pytest.mark.parametrize("name", SLICE + ["rns8_u8"])
def test_pac_small_ops_match_jax(name):
    """rns_sub, rns_neg and the constant ops, with constants of any size
    (past int64 for the wide profiles), bit for bit."""
    p = get_profile(name)
    a = _exact_residues(name, _signed_values(name, 60, seed=1))
    b = _exact_residues(name, _signed_values(name, 60, seed=2))
    ta, tb = _t(a), _t(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_array_equal(rns.rns_sub(name, ta, tb).numpy(),
                                  _np(jrns.rns_sub(name, ja, jb)))
    np.testing.assert_array_equal(rns.rns_neg(name, ta).numpy(),
                                  _np(jrns.rns_neg(name, ja)))
    for c in (0, 3, -5, p.M_f, p.M // 3, -(p.M ** 2 // 7), 2 ** 70 + 9):
        np.testing.assert_array_equal(
            rns.rns_scale_const(name, ta, c).numpy(),
            _np(jrns.rns_scale_const(name, ja, c)))
        np.testing.assert_array_equal(
            rns.rns_add_const(name, ta, c).numpy(),
            _np(jrns.rns_add_const(name, ja, c)))
    # the results decode to the exact integers
    back = rns.decode_exact(name, rns.rns_sub(name, ta, tb).numpy())
    va = rns.decode_exact(name, a)
    vb = rns.decode_exact(name, b)
    half = p.M // 2
    for g, x, y in zip(back, va, vb):
        d = x - y
        if -half <= d < half:
            assert g == d


@pytest.mark.parametrize("name", SLICE)
def test_encode_float_match_jax(name):
    """round_half_even(x * scale), clipped at the float32 value of
    2**31 - 1 (which is 2**31) and cast saturating: NaN to 0, the ends
    of int32 at and past +-2**31, as XLA casts."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(200) * 10.0 ** rng.integers(-3, 6, 200))
    edge = [2.0 ** 31, -2.0 ** 31, 2.0 ** 31 - 128, -(2.0 ** 31 - 128),
            2.0 ** 32, -2.0 ** 33, 3e9, -3e9, 1e30, -1e30, np.inf, -np.inf,
            np.nan, 0.5, 1.5, 2.5, -0.5, -2.5, 0.0, -0.0]
    x = np.concatenate([x, edge]).astype(np.float32)
    for scale in (1.0, 1000.0, 0.37, float(get_profile("rns9").M_f)):
        got = rns.encode_float(name, _t(x), scale).numpy()
        want = _np(jrns.encode_float(name, x, scale))
        np.testing.assert_array_equal(got, want)
    # the two saturated ends decode to the ends of int32
    ends = rns.encode_float(name, _t(np.float32([2.0 ** 31, -2.0 ** 32,
                                                 np.nan])), 1.0)
    assert list(rns.decode_exact(name, ends.numpy())) == [INT32_MAX,
                                                          INT32_MIN, 0]


def test_saturate_int32_is_xla_cast():
    v = np.float32([np.nan, np.inf, -np.inf, 2.0 ** 31, -2.0 ** 31, 2.0 ** 40,
                    -2.0 ** 40, 2.0 ** 31 - 128, 5.0, -7.0])
    got = rns.saturate_int32(_t(v)).numpy()
    np.testing.assert_array_equal(got, _np(jnp.asarray(v).astype(jnp.int32)))


@pytest.mark.parametrize("name", SLICE + ["rns8_u8"])
def test_int8_storage_match_jax(name):
    p = get_profile(name)
    a = _exact_residues(name, _signed_values(name, 30, seed=4))
    if not p.int8_safe:
        with pytest.raises(ValueError, match="int8"):
            rns.to_int8(name, _t(a))
        with pytest.raises(ValueError, match="int8"):
            jrns.to_int8(name, jnp.asarray(a))
        return
    r8 = rns.to_int8(name, _t(a))
    assert r8.dtype == torch.int8
    np.testing.assert_array_equal(r8.numpy(),
                                  _np(jrns.to_int8(name, jnp.asarray(a))))
    back = rns.from_int8(r8)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), a)


@pytest.mark.parametrize("name", SLICE + ["rns8_u8"])
def test_mrc_ops_match_jax(name):
    """compare_ge_const, rns_sign, base_extend and scale_signed (rounded
    and truncated) on random values, bit for bit."""
    p = get_profile(name)
    vals = _signed_values(name, 80, seed=5)
    r = _exact_residues(name, vals)
    tr, jr = _t(r), jnp.asarray(r)
    sign = mrc.rns_sign(name, tr)
    assert sign.dtype == torch.int32
    np.testing.assert_array_equal(sign.numpy(), _np(jmrc.rns_sign(name, jr)))
    assert sign.tolist() == [(v > 0) - (v < 0) for v in vals]
    for c in (0, 1, -1, vals[3], -vals[4], p.M // 5):
        got = mrc.compare_ge_const(name, tr, c).numpy()
        np.testing.assert_array_equal(got,
                                      _np(jmrc.compare_ge_const(name, jr, c)))
    digits = mrc.mrc_digits(name, tr)
    for n_src in (1, p.frac_digits, p.n_digits):
        np.testing.assert_array_equal(
            mrc.base_extend(name, digits, n_src).numpy(),
            _np(jmrc.base_extend(name, jnp.asarray(digits.numpy()), n_src)))
    np.testing.assert_array_equal(mrc.base_extend(name, digits,
                                                  p.n_digits).numpy(), r)
    for rounded in (True, False):
        np.testing.assert_array_equal(
            mrc.scale_signed(name, tr, rounded=rounded).numpy(),
            _np(jmrc.scale_signed(name, jr, rounded=rounded)))


@pytest.mark.parametrize("name", SLICE + ["rns8_u8"])
def test_scale_signed_ties_away_from_zero(name):
    """Ties k * M_f + M_f // 2 (M_f even) and their neighbours, built
    from the profile: the port rounds as the reference does, half away
    from zero, and equals JAX's residues."""
    p = get_profile(name)
    half = p.M // 2
    ks = [0, 1, 2, 3, 17, 2 ** 20 + 1]
    vals = []
    for k in ks:
        for sgn in (1, -1):
            for off in (-1, 0, 1):
                v = sgn * (k * p.M_f + p.M_f // 2 + off)
                if abs(v) < half:
                    vals.append(v)
    r = _exact_residues(name, vals)
    got = mrc.scale_signed(name, _t(r))
    np.testing.assert_array_equal(got.numpy(),
                                  _np(jmrc.scale_signed(name,
                                                        jnp.asarray(r))))

    def away(v):                     # round half away from zero
        q = (abs(v) + p.M_f // 2) // p.M_f
        return q if v >= 0 else -q

    assert list(rns.decode_exact(name, got.numpy())) == [away(v)
                                                         for v in vals]
    if p.M_f % 2 == 0:               # 2.5 -> 3, where half-even gives 2
        tie = 2 * p.M_f + p.M_f // 2
        assert away(tie) == 3 and away(-tie) == -3


@pytest.mark.parametrize("name", SLICE + ["rns8_u8"])
def test_decode_int32_near_int32_ends(name):
    """The int32 decode (wrap-around sums of W_j mod 2**32) at and near
    +-2**31 and on random int32 values, equal to JAX's and exact."""
    rng = np.random.default_rng(6)
    near = [INT32_MAX - k for k in range(4)] + [INT32_MIN + k
                                                  for k in range(4)]
    v = np.concatenate([np.asarray(near + [0, 1, -1]),
                        rng.integers(INT32_MIN, INT32_MAX, 300)]).astype(
        np.int32)
    got = mrc.decode_int32(name, rns.encode_int32(name, _t(v)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), _np(jmrc.decode_int32(name, jrns.encode_int32(name, v))))
    np.testing.assert_array_equal(got.numpy(), v)


@pytest.mark.parametrize("name", SLICE + ["rns8_u8"])
@pytest.mark.parametrize("power", [0, 1, 2])
def test_decode_float_inv_scale_match_jax(name, power):
    """decode_float(inv_scale=M_f**-power): bit for bit against JAX's
    (the scale folded into the float64 weights, one float32 rounding)."""
    p = get_profile(name)
    r = _exact_residues(name, _signed_values(name, 200, seed=7 + power))
    inv = 1.0 / float(p.M_f) ** power
    got = mrc.decode_float(name, _t(r), inv_scale=inv).numpy()
    want = _np(jmrc.decode_float(name, jnp.asarray(r), inv_scale=inv))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _decode_f32_ieee(name, vals, inv):
    """decode_float's arithmetic in numpy float32 (gradual underflow):
    weights W_j * inv rounded once, digit-ascending sum of products."""
    p = get_profile(name)
    w = (rns.tables(name).W_f64 * inv).astype(np.float32)
    out = []
    for v in vals:
        x, d = abs(v), []
        for m in p.moduli:
            d.append(x % m)
            x //= m
        acc = np.float32(0)
        for j in range(p.n_digits):
            acc = np.float32(acc + np.float32(d[j]) * w[j])
        out.append(-acc if v < 0 else acc)
    return np.asarray(out, np.float32)


def test_decode_float_subnormal_weights():
    """ROADMAP C.9: rns9 at M_f**-10 (about 2**-140) puts W_0 and W_1
    below float32's normal range.  The port keeps IEEE subnormals (equal
    to numpy float32); JAX's CPU backend flushes them to zero, so the two
    agree exactly where those digits are 0 (multiples of m_0 * m_1)."""
    name = "rns9"
    p = get_profile(name)
    inv = 1.0 / float(p.M_f) ** 10
    w = rns.tables(name).W_f64 * inv
    assert w[0] < 2.0 ** -126 and w[1] < 2.0 ** -126 <= w[3]
    vals = _signed_values(name, 100, seed=9)
    got = mrc.decode_float(name, _t(_exact_residues(name, vals)),
                           inv_scale=inv).numpy()
    np.testing.assert_array_equal(_bits(got),
                                  _bits(_decode_f32_ieee(name, vals, inv)))
    low = p.moduli[0] * p.moduli[1]
    coarse = [v - v % low for v in vals]
    r = _exact_residues(name, coarse)
    got = mrc.decode_float(name, _t(r), inv_scale=inv).numpy()
    want = _np(jmrc.decode_float(name, jnp.asarray(r), inv_scale=inv))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.count_nonzero(got) > 90


@pytest.mark.parametrize("axis", [None, -1, 0])
def test_quantize_dequantize_match_jax(axis):
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((6, 33)) * 3.0).astype(np.float32)
    x[2] = 0.0                       # an all-zero row: the unit grid
    for bits in (4, 8, 16):
        v, s = quantize.quantize(_t(x), bits, axis=axis)
        jv, js = jq.quantize(jnp.asarray(x), bits, axis=axis)
        np.testing.assert_array_equal(v.numpy(), _np(jv))
        np.testing.assert_array_equal(_bits(s.numpy()), _bits(_np(js)))
        y = quantize.dequantize(v, s)
        assert y.dtype == torch.float32
        np.testing.assert_array_equal(_bits(y.numpy()),
                                      _bits(_np(jq.dequantize(jv, js))))
        assert np.abs(y.numpy() - x).max() <= 0.51 / float(s.min())
        assert math.isfinite(float(s.max()))
