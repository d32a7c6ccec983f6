"""The port's core numerics (repro_torch.core) against the JAX package.

Inputs are made with numpy from a seed and go through both packages;
integer results must be equal, and the float results of the RNS datapath
equal bit for bit (the JAX reference runs eagerly, one rounding per op).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dispatch as jdispatch
from repro.core import mrc as jmrc
from repro.core import quantize as jq
from repro.core import rns as jrns
from repro.core import rns_matmul as jrm
from repro.core.moduli import PROFILES as JPROFILES
from repro_torch.core import dispatch, mrc, quantize, rns
from repro_torch.core import rns_matmul as rm
from repro_torch.core.moduli import PROFILES, get_profile

ALL = sorted(PROFILES)
INT8_SAFE = sorted(n for n, p in PROFILES.items() if p.int8_safe)

# ROADMAP C.1: rns5 value whose float reconstruction is 13505986560.0
# with one rounding per op (an FMA-contracted sum gives 13505985536.0)
C1_VALUE = 4_503_599_542_737_792
C1_FLOAT = 13505986560.0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random_residues(name, n, seed):
    p = get_profile(name)
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, m, n) for m in p.moduli]).astype(
        np.int32)


def test_profiles_match_jax():
    assert sorted(PROFILES) == sorted(JPROFILES)
    for name, p in PROFILES.items():
        jp = JPROFILES[name]
        assert p.moduli == jp.moduli and p.M == jp.M
        assert (p.lazy_chunk, p.int8_safe) == (jp.lazy_chunk, jp.int8_safe)
        assert p.dot_capacity(8, 8) == jp.dot_capacity(8, 8)


@pytest.mark.parametrize("name", ALL)
def test_tables_match_jax(name):
    t, jt = rns.tables(name), jrns.tables(name)
    np.testing.assert_array_equal(t.mrc_inv, jt.mrc_inv)
    np.testing.assert_array_equal(t.half_digits, jt.half_digits)
    np.testing.assert_array_equal(t.W_f64, jt.W_f64)
    assert t.W == jt.W


@pytest.mark.parametrize("name", ALL)
def test_encode_int32_floor_mod(name):
    rng = np.random.default_rng(1)
    v = np.concatenate([
        rng.integers(-2**31 + 1, 2**31 - 1, 200),
        np.array([0, 1, -1, 127, -127, 128, -128, 2**31 - 1, -2**31 + 1,
                  -2**31])]).astype(np.int32)
    got = rns.encode_int32(name, _t(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jrns.encode_int32(name, v)))
    assert (got >= 0).all()


@pytest.mark.parametrize("name", ALL)
def test_mrc_digits_and_sign(name):
    r = _random_residues(name, 300, seed=2)
    np.testing.assert_array_equal(mrc.mrc_digits(name, _t(r)).numpy(),
                                  np.asarray(jmrc.mrc_digits(name, r)))
    np.testing.assert_array_equal(mrc.is_negative(name, _t(r)).numpy(),
                                  np.asarray(jmrc.is_negative(name, r)))


@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("inv_scale", [1.0, 2.0**-20])
def test_decode_float_bit_exact(name, inv_scale):
    p = get_profile(name)
    r = _random_residues(name, 300, seed=3)
    # boundary values: 0, +-1, +-(M/2 - 1), M/2 (the most negative)
    edge = [0, 1, -1, p.M // 2 - 1, -(p.M // 2 - 1), -(p.M // 2)]
    r = np.concatenate([r, rns.encode_exact(name, edge)], axis=1)
    got = mrc.decode_float(name, _t(r), inv_scale=inv_scale).numpy()
    want = np.asarray(jmrc.decode_float(name, jnp.asarray(r),
                                        inv_scale=inv_scale))
    # rns21's W_j overflow float32: inf/NaN where the reference has them
    np.testing.assert_array_equal(got, want)


def test_decode_float_c1_regression():
    r = rns.encode_exact("rns5", [C1_VALUE, -C1_VALUE])
    got = mrc.decode_float("rns5", _t(r)).numpy()
    assert got.tolist() == [C1_FLOAT, -C1_FLOAT]


def test_exact_oracles_round_trip():
    vals = [0, 5, -5, 2**40 + 3, -(2**40) - 7]
    for name in ("rns9", "rns21"):
        r = rns.encode_exact(name, vals)
        np.testing.assert_array_equal(r, jrns.encode_exact(name, vals))
        assert list(rns.decode_exact(name, r)) == vals


def _activations(seed, shape=(3, 5, 16)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x[1, 2] = 0.0                   # an all-zero token: the eps flush
    return x


def test_absmax_scale_per_tensor_row_and_token():
    x = _activations(4)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]],
                    bool)
    got = quantize.absmax_scale(_t(x), 8).numpy()
    np.testing.assert_array_equal(got, np.asarray(jq.absmax_scale(x, 8)))
    for per_token in (False, True):
        with quantize.token_mask(_t(mask), per_token=per_token):
            got = quantize.absmax_scale(_t(x), 8).numpy()
        with jq.token_mask(jnp.asarray(mask), per_token=per_token):
            want = np.asarray(jq.absmax_scale(jnp.asarray(x), 8))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    # decode-style per-row mask [B, 1] on x [B, 1, d]
    xd, md = x[:, :1], mask[:, :1]
    with quantize.token_mask(_t(md)):
        got = quantize.absmax_scale(_t(xd), 8).numpy()
    with jq.token_mask(jnp.asarray(md)):
        want = np.asarray(jq.absmax_scale(jnp.asarray(xd), 8))
    np.testing.assert_array_equal(got, want)
    assert float(quantize.absmax_scale(torch.zeros(4), 8)) == 1.0


def test_quantize_half_way_and_clip():
    # x * s lands exactly on k + 0.5: round half to even, then clip
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.5, 300.0,
                  -300.0, 1e-9], np.float32)
    for s in (1.0, 0.25):
        xs = x / np.float32(s)
        got = quantize.quantize_with_scale(_t(xs), torch.tensor(s), 8)
        want = jq.quantize_with_scale(xs, jnp.float32(s), 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_dispatch_primitives_match_jax(backend):
    """Both port backends (on CPU the wrappers take their plain versions)
    equal the JAX reference primitives, and tally the same ops."""
    x = _activations(5)
    w = np.random.default_rng(6).standard_normal((16, 12)).astype(np.float32)
    with dispatch.count_ops() as c, jdispatch.count_ops() as jc:
        for name in INT8_SAFE:
            s = quantize.absmax_scale(_t(x), 8)
            a = dispatch.convert(name, _t(x), s, bits=8, backend=backend)
            ja = jdispatch.convert(name, x, jq.absmax_scale(x, 8), bits=8,
                                   backend="reference")
            np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
            b = dispatch.convert(name, _t(w), quantize.absmax_scale(_t(w), 8),
                                 bits=8, backend=backend, weight=True)
            jb = jdispatch.convert(name, w, jq.absmax_scale(w, 8), bits=8,
                                   backend="reference", weight=True)
            y = dispatch.matmul(name, a, b, backend=backend)
            jy = jdispatch.matmul(name, ja, jb, backend="reference")
            np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
            f = dispatch.normalize(name, y, backend=backend)
            jf = jdispatch.normalize(name, jy, backend="reference")
            np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert c.as_dict() == {k: getattr(jc, k) for k in c.FIELDS}


@pytest.mark.parametrize("name", ALL)
def test_normalize_matches_jax_without_fallback(name):
    """dispatch.normalize on the kernel backend (its plain version on the
    CPU) equals the JAX reference for every profile, rns21's inf/NaN
    included, and never counts a fallback."""
    r = _random_residues(name, 50, seed=7)
    with dispatch.count_ops() as c:
        out = dispatch.normalize(name, _t(r), backend="cuda")
    assert c.fallbacks == 0 and c.normalizes == 1
    want = jdispatch.normalize(name, jnp.asarray(r), backend="reference")
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_modular_matmul_chunk_schedule():
    """D beyond lazy_chunk: the chunked reduction (rns8_u8, chunk 33025)
    equals the JAX reference's schedule."""
    p = get_profile("rns8_u8")
    D = p.lazy_chunk + 100
    rng = np.random.default_rng(8)
    a = np.stack([rng.integers(0, m, (2, D)) for m in p.moduli]).astype(
        np.int32)
    b = np.stack([rng.integers(0, m, (D, 3)) for m in p.moduli]).astype(
        np.int32)
    got = rm.rns_matmul_res(p, _t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(jrm.rns_matmul_res(p.name, a, b)))


def _cfgs(backend):
    return (rm.RnsDotConfig(profile="rns9", qx=8, qw=8, backend=backend),
            jrm.RnsDotConfig(profile="rns9", qx=8, qw=8,
                             backend="reference"))


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_rns_dot_and_multi_dot_exact(backend):
    cfg, jcfg = _cfgs(backend)
    x = _activations(9, (2, 3, 32))
    rng = np.random.default_rng(10)
    w1, w2 = (rng.standard_normal((32, 24)).astype(np.float32)
              for _ in range(2))
    got = rm.rns_dot(_t(x), _t(w1), cfg).numpy()
    np.testing.assert_array_equal(got, np.asarray(jrm.rns_dot(x, w1, jcfg)))
    with quantize.token_mask(torch.ones(2, 3, dtype=torch.bool),
                             per_token=True):
        outs = rm.rns_multi_dot(_t(x), (_t(w1), _t(w2)), cfg)
    with jq.token_mask(jnp.ones((2, 3), bool), per_token=True):
        jouts = jrm.rns_multi_dot(x, (w1, w2), jcfg)
    for o, jo in zip(outs, jouts):
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo))


def test_fused_backend_raises():
    """The TPU's fused backend name is not the port's: asking for it
    raises and names the port's counterpart, ``cuda_fused``."""
    with pytest.raises(ValueError, match="cuda_fused"):
        dispatch.convert("rns9", torch.ones(2, 8), torch.tensor(1.0),
                         backend="pallas_fused")
