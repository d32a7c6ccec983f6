"""The port's Olsen fractional RNS (``core/fractional.py``), fractional
residue tensors (``RnsTensor.frac_exp``) through the decode, the fused
tails and the dispatch's ``inv_scale``, and the Mandelbrot demo
(``launch/mandelbrot.py``) against the JAX package.

Inputs are made with numpy from a seed and go through both packages.
Residues and escape counts must be equal; floats from ``fr_decode`` and
from every ``frac_exp`` decode equal JAX's reference backend bit for
bit, on every port backend (on the CPU each kernel wrapper takes its
plain version); op counts equal JAX's but for ROADMAP C.8.  The tests
marked ``gpu`` hold the kernels with a scaled weight table to their
plain versions on the card, and the captured demo to the eager one and
to the CPU.
"""

import importlib.util
import math
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dispatch as jdispatch
from repro.core import fractional as jfr
from repro.core import tensor as jt
from repro_torch.core import dispatch
from repro_torch.core import fractional as fr
from repro_torch.core import tensor as rt
from repro_torch.core import mrc
from repro_torch.core.moduli import get_profile
from repro_torch.core.rns import decode_exact
from repro_torch.kernels import build
from repro_torch.kernels.rns_fused import ops as fused_ops
from repro_torch.kernels.rns_normalize import ops as normalize_ops
from repro_torch.launch import mandelbrot as mb

ROOT = Path(__file__).resolve().parents[1]
SLICE = ["rns5", "rns9", "rns12", "rns18", "rns21"]
FIELDS = ("converts", "matmuls", "normalizes", "fused", "fallbacks",
          "weight_converts")
# port backend -> the JAX backend whose op counts it keeps
BACKENDS = {"reference": "reference", "cuda": "pallas_interpret",
            "cuda_fused": "pallas_fused_interpret"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _counts(c) -> dict:
    return {f: getattr(c, f) for f in FIELDS}


def _floats(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _fr_exact(name, x):
    """fr_encode_exact of float32 values through both packages (equal)."""
    got = fr.fr_encode_exact(name, x.astype(object))
    np.testing.assert_array_equal(got, jfr.fr_encode_exact(name,
                                                           x.astype(object)))
    return got


# ------------------------------------------------------- fractional ops ---
@pytest.mark.parametrize("name", SLICE)
def test_fr_ops_match_jax(name):
    """Every op of ``core/fractional.py`` on residues from both packages:
    residues bit for bit, ``fr_decode`` floats bit for bit, the exact
    decodes equal."""
    p = get_profile(name)
    x, y = _floats(40, 1, 3.0), _floats(40, 2, 3.0)
    if p.M_f < 2 ** 31:
        fx, fy = fr.fr_encode(name, _t(x)), fr.fr_encode(name, _t(y))
        np.testing.assert_array_equal(fx.numpy(), _np(jfr.fr_encode(name, x)))
        np.testing.assert_array_equal(fy.numpy(), _np(jfr.fr_encode(name, y)))
    else:
        for mod, arg in ((fr, _t(x)), (jfr, x)):
            with pytest.raises(ValueError, match="fr_encode_exact"):
                mod.fr_encode(name, arg)
        fx, fy = _t(_fr_exact(name, x)), _t(_fr_exact(name, y))
    jx, jy = jnp.asarray(fx.numpy()), jnp.asarray(fy.numpy())
    pairs = {
        "add": (fr.fr_add(name, fx, fy), jfr.fr_add(name, jx, jy)),
        "sub": (fr.fr_sub(name, fx, fy), jfr.fr_sub(name, jx, jy)),
        "neg": (fr.fr_neg(name, fx), jfr.fr_neg(name, jx)),
        "mul_raw": (fr.fr_mul_raw(name, fx, fy), jfr.fr_mul_raw(name, jx, jy)),
        "mul": (fr.fr_mul(name, fx, fy), jfr.fr_mul(name, jx, jy)),
        "normalize": (fr.fr_normalize(name, fr.fr_mul_raw(name, fx, fx)),
                      jfr.fr_normalize(name, jfr.fr_mul_raw(name, jx, jx))),
    }
    for op, (got, want) in pairs.items():
        np.testing.assert_array_equal(got.numpy(), _np(want), err_msg=op)
    for res in (fx, pairs["mul"][0], pairs["sub"][0]):
        for dtype, jdtype in ((None, None), (torch.float64, jnp.float32)):
            got = fr.fr_decode(name, res, dtype=dtype)
            want = jfr.fr_decode(name, jnp.asarray(res.numpy()),
                                 dtype=jdtype)
            if dtype is None:
                np.testing.assert_array_equal(_bits(got.numpy()),
                                              _bits(_np(want)))
            else:                    # JAX runs without x64: float32
                assert got.dtype == torch.float64
        np.testing.assert_array_equal(fr.fr_decode_exact(name, res),
                                      jfr.fr_decode_exact(name, res.numpy()))
    # the exact product, rounded half away from zero
    qx = [int(v) for v in fr.fr_decode_exact(name, fx) * p.M_f]
    qy = [int(v) for v in fr.fr_decode_exact(name, fy) * p.M_f]
    for g, a, b in zip(fr.fr_decode_exact(name, pairs["mul"][0]), qx, qy):
        q = (abs(a * b) + p.M_f // 2) // p.M_f
        assert g == Fraction(q if a * b >= 0 else -q, p.M_f)
    n = np.arange(-20, 21, dtype=np.int32)
    np.testing.assert_array_equal(fr.fr_from_int(name, _t(n)).numpy(),
                                  _np(jfr.fr_from_int(name, n)))
    for c, raw in ((0.0, False), (0.75, False), (-1.25, False), (4.0, True),
                   (-0.3, True)):
        for res, jres in ((fx, jx), (pairs["mul_raw"][0],
                                     pairs["mul_raw"][1])):
            np.testing.assert_array_equal(
                fr.fr_ge_const(name, res, c, raw=raw).numpy(),
                _np(jfr.fr_ge_const(name, jres, c, raw=raw)))


@pytest.mark.parametrize("name", SLICE + ["rns8_u8"])
def test_fr_encode_exact_and_from_int(name):
    """Host encode of floats, Fractions and ints, and the exact decode,
    equal to JAX's (M_f past int64 included)."""
    p = get_profile(name)
    vals = [Fraction(1, 3), Fraction(-7, 5), 0.1, -2.5, 3, -4,
            Fraction(p.M_f // 2 + 1, p.M_f)]
    got = fr.fr_encode_exact(name, np.asarray(vals, dtype=object))
    np.testing.assert_array_equal(got, jfr.fr_encode_exact(
        name, np.asarray(vals, dtype=object)))
    back = fr.fr_decode_exact(name, torch.from_numpy(got))
    assert list(back) == list(jfr.fr_decode_exact(name, got))
    assert back[4] == 3 and back[5] == -4 and back[6] == vals[6]


@pytest.mark.parametrize("name", ["rns5", "rns9", "rns12", "rns8_u8"])
def test_fr_encode_saturates_like_jax(name):
    """round_half_even(x * M_f) cast as XLA casts: at and past 2**31 / M_f
    the ends of int32, NaN 0."""
    p = get_profile(name)
    edge = float(2 ** 31) / p.M_f
    x = np.float32([edge, -edge, 2 * edge, -4 * edge, edge * 0.999,
                    -edge * 0.999, np.inf, -np.inf, np.nan, 0.5 / p.M_f,
                    1.5 / p.M_f, -2.5 / p.M_f])
    got = fr.fr_encode(name, _t(x))
    np.testing.assert_array_equal(got.numpy(), _np(jfr.fr_encode(name, x)))
    ints = [int(v * p.M_f) for v in fr.fr_decode_exact(name, got)]
    assert ints[2] == 2 ** 31 - 1 and ints[3] == -2 ** 31 and ints[8] == 0


@pytest.mark.parametrize("name", ["rns5", "rns9", "rns12", "rns18",
                                  "rns8_u8"])
@pytest.mark.parametrize("n", [1, 64, "chunks"])
def test_fr_dot_deferred_match_jax(name, n):
    """One lazy reduction per ``lazy_chunk`` products, ONE normalization:
    equal to JAX's; ``chunks`` runs past one lazy chunk."""
    p = get_profile(name)
    n = p.lazy_chunk + 3 if n == "chunks" else n
    rng = np.random.default_rng(11)
    xs = np.stack([rng.integers(0, m, (n, 3)) for m in p.moduli],
                  axis=1).astype(np.int32)
    ys = np.stack([rng.integers(0, m, (n, 3)) for m in p.moduli],
                  axis=1).astype(np.int32)
    got = fr.fr_dot_deferred(name, _t(xs), _t(ys))
    np.testing.assert_array_equal(got.numpy(), _np(jfr.fr_dot_deferred(
        name, jnp.asarray(xs), jnp.asarray(ys))))


def test_fr_dot_deferred_is_one_normalization():
    """tests/test_fractional.py's deferred dot: the quantized sum rounded
    once, within 2 / M_f, and the same floats as JAX's."""
    p = get_profile("rns9")
    rng = np.random.default_rng(0)
    xs = rng.uniform(-1, 1, (64, 8)).astype(np.float32)
    ys = rng.uniform(-1, 1, (64, 8)).astype(np.float32)
    fxs = torch.stack([fr.fr_encode(p, _t(xs[i])) for i in range(64)])
    fys = torch.stack([fr.fr_encode(p, _t(ys[i])) for i in range(64)])
    out = fr.fr_decode(p, fr.fr_dot_deferred(p, fxs, fys))
    jout = jfr.fr_decode(p, jfr.fr_dot_deferred(
        p, jnp.asarray(fxs.numpy()), jnp.asarray(fys.numpy())))
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(_np(jout)))
    qx, qy = np.round(xs * p.M_f), np.round(ys * p.M_f)
    want = (qx.astype(object) * qy.astype(object)).sum(0)
    want = [round(Fraction(int(w), p.M_f * p.M_f) * p.M_f) / p.M_f
            for w in want]
    np.testing.assert_allclose(out.numpy(), np.asarray(want, np.float64),
                               atol=2 / p.M_f)


# --------------------------------------------------- fractional tensors ---
def _frac_tensor(mod, conv, digits, name, mag_bits, frac_exp):
    return mod.RnsTensor(conv(digits), conv(np.float32(1.0)), name,
                         mag_bits, frac_exp)


def _frac_operands(name, seed):
    """x [4, 16] float32; fractional digits of x and of w [16, 8] (values
    scaled so that two M_f powers fit rns18's ledger); their mag_bits."""
    p = get_profile(name)
    small = 1.0 / 64 if p.M_f > 2 ** 40 else 1.0
    x = _floats((4, 16), seed, small)
    w = _floats((16, 8), seed + 1, small)
    fx, fw = _fr_exact(name, x), _fr_exact(name, w)

    def bits(d):
        m = max(abs(int(v)) for v in
                np.asarray(decode_exact(name, d), dtype=object).reshape(-1))
        return math.log2(m)
    return x, fx, fw, bits(fx), bits(fw)


def _frac_chain(mod, conv, name, operands, frac_exp, backend):
    """The frac_exp paths: rt_decode (normalize), rt_matmul_decode and
    rt_dot (the fused tails), rt_mul / rt_add, at total frac_exp 1 or 2."""
    x, fx, fw, bx, bw = operands
    W = _frac_tensor(mod, conv, fw, name, bw, 1)
    if frac_exp == 1:
        A = mod.rt_encode(conv(x), name, bits=8, backend=backend)
        Wd = W
        E = W
    else:
        A = _frac_tensor(mod, conv, fx, name, bx, 1)
        Wd = mod.rt_mul(W, W, backend=backend)
        E = mod.rt_add(mod.rt_mul(W, W, backend=backend),
                       mod.rt_mul(W, W, backend=backend))
    return {"decode": mod.rt_decode(mod.rt_matmul(A, W, backend=backend),
                                    backend=backend),
            "matmul_decode": mod.rt_matmul_decode(A, W, backend=backend),
            "dot": mod.rt_dot(conv(x), Wd, bits=8, backend=backend),
            "elementwise": mod.rt_decode(E, backend=backend)}


@pytest.mark.parametrize("name", ["rns5", "rns9", "rns12", "rns18"])
@pytest.mark.parametrize("frac_exp", [1, 2])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_frac_exp_tensors_match_jax_reference(name, frac_exp, backend):
    """RnsTensor(frac_exp=1, 2) decodes through every port backend to the
    floats of JAX's reference backend, bit for bit; the op counts equal
    JAX's on the matching backend (traced, no interpretation)."""
    ops = _frac_operands(name, seed=20 + frac_exp)
    with dispatch.count_ops() as c:
        got = _frac_chain(rt, _t, name, ops, frac_exp, backend)
    want = _frac_chain(jt, jnp.asarray, name, ops, frac_exp, "reference")
    for k in want:
        np.testing.assert_array_equal(_bits(got[k].numpy()),
                                      _bits(_np(want[k])), err_msg=k)
        assert np.isfinite(got[k].numpy()).all()
    jc = jdispatch.trace_op_counts(
        lambda: _frac_chain(jt, jnp.asarray, name, ops, frac_exp,
                            BACKENDS[backend]))
    assert _counts(c) == _counts(jc)
    assert c.fallbacks == 0
    if backend == "cuda_fused":
        assert c.fused == 2
    # the values: x @ w (the dot at frac_exp 2: x @ (w * w)) within the
    # datapath's rounding
    x, w_val = ops[0], np.asarray(fr.fr_decode_exact(name, ops[2]),
                                  np.float64)
    x = x.astype(np.float64)
    for k, ref in (("decode", x @ w_val), ("matmul_decode", x @ w_val),
                   ("dot", x @ (w_val if frac_exp == 1 else w_val ** 2))):
        err = np.abs(got[k].numpy() - ref).max()
        assert err <= 0.05 * np.abs(ref).max(), k


def test_frac_exp_scale_outside_float32_counts():
    """ROADMAP C.8: at rns9, frac_exp 10 (M_f**-10 ~ 2**-140, outside
    float32) the port's kernels take the scaled table, while JAX's
    Pallas path decodes on its reference path and tallies a fallback
    at each of the two decodes (and its fused tail decomposes: no
    ``fused``).  Every other count is equal."""
    name = "rns9"
    rng = np.random.default_rng(30)
    p = get_profile(name)
    a = np.stack([rng.integers(0, m, (3, 24)) for m in p.moduli]).astype(
        np.int32)
    w = np.stack([rng.integers(0, m, (24, 5)) for m in p.moduli]).astype(
        np.int32)

    def chain(mod, conv, backend):
        A = _frac_tensor(mod, conv, a, name, 10.0, 5)
        W = _frac_tensor(mod, conv, w, name, 10.0, 5)
        return (mod.rt_matmul_decode(A, W, backend=backend),
                mod.rt_decode(mod.rt_matmul(A, W, backend=backend),
                              backend=backend))

    for be, jbe in (("cuda_fused", "pallas_fused_interpret"),
                    ("cuda", "pallas_interpret")):
        with dispatch.count_ops() as c:
            got = chain(rt, _t, be)
        jc = _counts(jdispatch.trace_op_counts(
            lambda: chain(jt, jnp.asarray, jbe)))
        fused = 1 if be == "cuda_fused" else 0
        assert jc["fallbacks"] == 2 and jc["fused"] == 0
        want = dict(jc, fallbacks=0, fused=fused)
        assert _counts(c) == want
        ref = chain(rt, _t, "reference")
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(r.numpy()))


@pytest.mark.parametrize("name", ["rns9", "rns12"])
def test_dispatch_inv_scale_every_backend(name):
    """normalize / fused_matmul_normalize / fused_dot with inv_scale on
    every port backend equal mrc.decode_float(inv_scale=) and JAX's
    reference backend, bit for bit; the wrappers' plain versions too."""
    p = get_profile(name)
    rng = np.random.default_rng(40)
    a = np.stack([rng.integers(0, m, (2, 5, 40)) for m in p.moduli]).astype(
        np.int8)
    b = np.stack([rng.integers(0, m, (40, 9)) for m in p.moduli]).astype(
        np.int8)
    x = _floats((2, 5, 40), 41)
    s = np.float32(127.0 / np.abs(x).max())
    for inv in (1.0, 1.0 / p.M_f, 1.0 / float(p.M_f) ** 2):
        want_mm = _np(jdispatch.fused_matmul_normalize(
            name, jnp.asarray(a), jnp.asarray(b), inv_scale=inv,
            backend="reference"))
        want_dot = _np(jdispatch.fused_dot(
            name, jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), bits=8,
            inv_scale=inv, backend="reference"))
        for be in BACKENDS:
            got = dispatch.fused_matmul_normalize(name, _t(a), _t(b),
                                                  inv_scale=inv, backend=be)
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want_mm))
            got = dispatch.fused_dot(name, _t(x), _t(s), _t(b), bits=8,
                                     inv_scale=inv, backend=be)
            np.testing.assert_array_equal(_bits(got.numpy()),
                                          _bits(want_dot))
        r = _t(a[:, 0].astype(np.int32))
        want = _np(jdispatch.normalize(name, jnp.asarray(r.numpy()),
                                       inv_scale=inv, backend="reference"))
        for be in BACKENDS:
            got = dispatch.normalize(name, r, inv_scale=inv, backend=be)
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        np.testing.assert_array_equal(
            _bits(normalize_ops.rns_normalize_plain(
                name, r, inv_scale=inv).numpy()), _bits(want))
        np.testing.assert_array_equal(
            _bits(fused_ops.rns_fused_matmul_normalize_plain(
                name, _t(a), _t(b), inv_scale=inv).numpy()), _bits(want_mm))


@pytest.mark.parametrize("name", ["rns5", "rns9", "rns21"])
def test_scaled_table_carries_the_decode_weights(name):
    """build.rns_tables_c(p, inv_scale): only ``w`` changes, and it holds
    the float32 bits of decode_float's scaled weights (rns21's inf at
    scale 1 turns finite, rns9 at M_f**-10 subnormal)."""
    p = get_profile(name)
    base = build.rns_tables_c(name)
    for power in (1, 2, 10):
        inv = 1.0 / float(p.M_f) ** power
        c = build.rns_tables_c(name, inv)
        w = np.frombuffer(bytes(c.w), np.float32)[:p.n_digits]
        want = mrc.scaled_weights(p, inv, torch.float32,
                                  torch.device("cpu")).numpy()
        np.testing.assert_array_equal(_bits(w), _bits(want))
        for f in ("moduli", "half", "magic", "moff", "mrc_c", "roff"):
            assert bytes(getattr(c, f)) == bytes(getattr(base, f)), f
    assert bytes(build.rns_tables_c(name, 1.0)) == bytes(base)


# ----------------------------------------------------------- leftovers ----
def test_rt_stack_encode_int_headroom_astype_match_jax():
    rng = np.random.default_rng(50)
    v = rng.integers(-2 ** 20, 2 ** 20, (3, 7)).astype(np.int32)
    a, ja = rt.rt_encode_int(_t(v), "rns9"), jt.rt_encode_int(v, "rns9")
    np.testing.assert_array_equal(a.digits.numpy(), _np(ja.digits))
    assert a.digits.dtype == torch.int8 and a.mag_bits == ja.mag_bits
    assert a.headroom_bits() == ja.headroom_bits()
    a32 = a.astype_digits(torch.int32)
    assert a32.digits.dtype == torch.int32 and a32.mag_bits == a.mag_bits
    np.testing.assert_array_equal(rt.rt_decode(a).numpy(),
                                  _np(jt.rt_decode(ja)))
    big = np.asarray([2 ** 40], np.int64)     # past rns5's signed range
    for mod in (rt, jt):
        with pytest.raises(ValueError, match="cannot represent"):
            mod.rt_encode_int(big, "rns5")
    b = rt.rt_encode_int(_t(v * 2), "rns9", mag_bits=30.0)
    jb = jt.rt_encode_int(v * 2, "rns9", mag_bits=30.0)
    st, jst = rt.rt_stack([a, b]), jt.rt_stack([ja, jb])
    np.testing.assert_array_equal(st.digits.numpy(), _np(jst.digits))
    np.testing.assert_array_equal(st.scale.numpy(), _np(jst.scale))
    assert (st.mag_bits, st.frac_exp) == (jst.mag_bits, jst.frac_exp)
    f = dict(vars(a), frac_exp=1)
    with pytest.raises(ValueError, match="frac_exp"):
        rt.rt_stack([a, rt.RnsTensor(**f)])
    with pytest.raises(ValueError, match="frac_exp"):
        rt.rt_add(a, rt.RnsTensor(**f))


# ----------------------------------------------------------- Mandelbrot ---
def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "mandelbrot_rns_example", ROOT / "examples" / "mandelbrot_rns.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mandelbrot_escape_counts_test_grid_match_jax():
    """tests/test_fractional.py's 8 x 8 grid at 20 iterations (its JAX
    loop verbatim, its sentinel 99 read as 'never'): equal escape
    counts, eager and through the step program."""
    p = get_profile("rns12")
    grid, iters = 8, 20
    xs, ys = np.linspace(-2.0, 0.6, grid), np.linspace(-1.2, 1.2, grid)
    cr = np.repeat(xs, grid).astype(np.float32)
    ci = np.tile(ys, grid).astype(np.float32)
    zr, zi = jfr.fr_encode(p, np.zeros_like(cr)), jfr.fr_encode(
        p, np.zeros_like(ci))
    fcr, fci = jfr.fr_encode(p, cr), jfr.fr_encode(p, ci)
    esc = np.full(cr.shape, 99, np.int32)
    for it in range(iters):
        rr = jfr.fr_mul_raw(p, zr, zr)
        ii = jfr.fr_mul_raw(p, zi, zi)
        ri = jfr.fr_mul_raw(p, zr, zi)
        escaped = np.asarray(jfr.fr_ge_const(p, jfr.fr_add(p, rr, ii), 4.0,
                                             raw=True))
        esc = np.where((esc == 99) & escaped, it, esc)
        zr = jfr.fr_add(p, jfr.fr_normalize(p, jfr.fr_sub(p, rr, ii)), fcr)
        zi = jfr.fr_add(p, jfr.fr_normalize(p, jfr.fr_add(p, ri, ri)), fci)
    want = np.where(esc == 99, iters, esc)
    r = mb.MandelbrotRender(p, cr, ci, iters, device="cpu")
    got = r.run()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(r.run(), want)   # a second render resets
    assert r.captures == 0
    got_e, st = mb.render(p, cr, ci, iters, device="cpu", graphs=False)
    np.testing.assert_array_equal(got_e, want)
    assert np.mean(mb.escape_f64(cr, ci, iters) == got) > 0.9


def test_mandelbrot_example_view_matches_jax():
    """examples/mandelbrot_rns.py's default 100 x 32 view at 48
    iterations: the port's escape counts equal the JAX demo's (its
    jitted step), and its float64 yardstick equals the demo's."""
    ex = _jax_example()
    cr, ci = mb.view(100, 32)
    want = ex.mandelbrot_rns("rns12", cr, ci, 48)
    got, st = mb.render("rns12", cr, ci, 48, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.shape == (32, 100) and st["captures"] == 0
    assert st["pixel_iters_per_s"] > 0
    zr, zi = np.zeros_like(cr), np.zeros_like(ci)
    esc64 = np.full(cr.shape, 48, np.int64)
    with np.errstate(over="ignore", invalid="ignore"):
        for it in range(48):
            mag = zr * zr + zi * zi
            esc64 = np.where((esc64 == 48) & (mag >= 4.0), it, esc64)
            zr, zi = zr * zr - zi * zi + cr, 2 * zr * zi + ci
    np.testing.assert_array_equal(mb.escape_f64(cr, ci, 48), esc64)
    assert len(mb.ascii_art(got, 48).splitlines()) == 32


def test_mandelbrot_deep_proof_matches_jax():
    """--deep: rns24_deep (M_f ~ 2**69), two c values one float64 apart,
    30 iterations: the orbits' exact difference equals the one the JAX
    demo's arithmetic gives, and is not 0."""
    d = mb.deep_precision_proof("cpu")
    assert d["f64_equal"] and d["diff"] != 0 and d["frac_bits"] > 53
    deep = mb.deep_profile()
    cs = [Fraction(-743643887037151, 10 ** 15)]
    cs.append(cs[0] + Fraction(1, 10 ** 19))
    ci_f = Fraction(1318259042053300, 10 ** 16)
    enc = jnp.asarray(jfr.fr_encode_exact(deep, np.asarray(cs, dtype=object)))
    ci = jnp.asarray(jfr.fr_encode_exact(deep, np.asarray([ci_f, ci_f],
                                                          dtype=object)))
    zr = zi = jnp.zeros_like(enc)
    for _ in range(30):
        rr = jfr.fr_mul_raw(deep, zr, zr)
        ii = jfr.fr_mul_raw(deep, zi, zi)
        ri = jfr.fr_mul_raw(deep, zr, zi)
        zr = jfr.fr_add(deep, jfr.fr_normalize(deep, jfr.fr_sub(deep, rr,
                                                                ii)), enc)
        zi = jfr.fr_add(deep, jfr.fr_normalize(deep, jfr.fr_add(deep, ri,
                                                                ri)), ci)
    want = jfr.fr_decode_exact(deep, np.asarray(jfr.fr_sub(
        deep, zr[:, 0:1], zr[:, 1:2])))[0]
    assert d["diff"] == want


def test_mandelbrot_cli_on_cpu(capsys):
    mb.main(["--device", "cpu", "--width", "24", "--height", "8",
             "--iters", "12"])
    out = capsys.readouterr().out
    assert "192 pixels x 12 iters" in out and "captures 0" in out
    assert "agreement with float64" in out


# ------------------------------------------------------------- the card ---
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels build and run "
                    "only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name,power", [("rns9", 1), ("rns9", 2),
                                        ("rns9", 10), ("rns12", 2),
                                        ("rns18", 1), ("rns21", 2)])
def test_gpu_scaled_kernels_match_plain(cuda, name, power):
    """B.3, B.4 and B.6 with the scaled weight table, bit for bit against
    their plain versions on the card (rns9 at M_f**-10: subnormal
    weights)."""
    p = get_profile(name)
    inv = 1.0 / float(p.M_f) ** power
    g = torch.Generator(device=cuda).manual_seed(power)
    dt = torch.int8 if p.int8_safe else torch.int32

    def res(shape):
        return torch.stack([torch.randint(0, m, shape, generator=g,
                                          device=cuda)
                            for m in p.moduli]).to(dt)

    r = res((3, 1000)).to(torch.int32)
    assert torch.equal(
        _bits_t(normalize_ops.rns_normalize(p, r, inv_scale=inv)),
        _bits_t(normalize_ops.rns_normalize_plain(p, r, inv_scale=inv)))
    a, b = res((5, 200)), res((200, 70))
    for a_ in (a, a.to(torch.int32)):
        got = fused_ops.rns_fused_matmul_normalize(p, a_, b, inv_scale=inv)
        want = fused_ops.rns_fused_matmul_normalize_plain(p, a_, b,
                                                          inv_scale=inv)
        assert torch.equal(_bits_t(got), _bits_t(want))
    x = torch.randn((5, 200), generator=g, device=cuda)
    s = 127.0 / x.abs().amax(dim=-1, keepdim=True)
    got = fused_ops.rns_fused_dot(p, x, s, b, bits=8, inv_scale=inv)
    want = fused_ops.rns_fused_dot_plain(p, x, s, b, bits=8, inv_scale=inv)
    assert torch.equal(_bits_t(got), _bits_t(want))
    torch.cuda.synchronize()


def _bits_t(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.gpu
def test_gpu_mandelbrot_captured_eager_cpu_equal(cuda):
    cr, ci = mb.view(64, 48)
    got, st = mb.render("rns12", cr, ci, 40, device=cuda)
    assert st["captures"] == 1
    eager, st_e = mb.render("rns12", cr, ci, 40, device=cuda, graphs=False)
    cpu, _ = mb.render("rns12", cr, ci, 40, device="cpu")
    assert st_e["captures"] == 0
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_array_equal(got, cpu)
    d = mb.deep_precision_proof(cuda)
    assert d["f64_equal"] and d["diff"] == mb.deep_precision_proof(
        "cpu")["diff"] != 0
