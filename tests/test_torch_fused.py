"""The port's fused, resident-weight, deferred-MLP slice against the JAX
package: residue tensors (``core/tensor.py``), the fused composites and
their kernels' plain versions, resident weights, the deferred MLP and the
engine on ``ServeConfig(rns_backend="cuda_fused", resident_weights=True,
rns_defer=True)``.

Inputs are made with numpy from a seed and go through both packages.
Residues, scales, ledger bounds and the RNS datapath's floats must be
equal bit for bit; greedy tokens equal; the per-step op counts the JAX
engine's times the number of layers (ROADMAP C.3).  On the CPU every
kernel wrapper takes its plain version; B.5's residues are also held to
the Pallas kernel in interpret mode, B.4 and B.6 to ``ref.py`` (the
interpreted MRC sum is FMA-contracted, ROADMAP C.1).  The tests marked
``gpu`` hold the CUDA kernels to their plain versions on the card.
"""

import copy
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as j_get_config
from repro.core import dispatch as jdispatch
from repro.core import quantize as jq
from repro.core import tensor as jt
from repro.core.rns_matmul import RnsDotConfig as JRnsDotConfig
from repro.kernels.rns_fused import ref as jref
from repro.kernels.rns_fused.ops import rns_fused_encode_matmul as j_enc_mm
from repro.models import layers as jl
from repro.models import model as JM
from repro.models import resident as jres
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.base import get_config
from repro_torch.core import dispatch, quantize
from repro_torch.core import tensor as rt
from repro_torch.core.moduli import get_profile
from repro_torch.core.rns import encode_exact
from repro_torch.core.rns_matmul import RnsDotConfig
from repro_torch.kernels.rns_fused import ops as fused_ops
from repro_torch.models import layers as L
from repro_torch.models import resident
from repro_torch.models.params import params_from_jax
from repro_torch.serve.engine import ContinuousEngine, ServeConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# ROADMAP C.1: rns5 value whose float reconstruction is 13505986560.0
# with one rounding per op (an FMA-contracted sum gives 13505985536.0)
C1_VALUE, C1_FLOAT = 4_503_599_542_737_792, 13505986560.0
FUSED_FIELDS = ("converts", "matmuls", "normalizes", "fused", "fallbacks",
                "weight_converts")


def _t(a):
    return torch.from_numpy(np.array(a))       # a copy; 0-d stays 0-d


def _np(x):
    return np.asarray(x)


def _counts(c) -> dict:
    return {f: getattr(c, f) for f in FUSED_FIELDS}


def _operands(profile, M, D, N, grid, bits=8, seed=0):
    """x [M, D], its scale (scalar or one per row) and weight residues
    [K, D, N] of the profile's dtype, from both packages' convert."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, D)).astype(np.float32)
    w = rng.standard_normal((D, N)).astype(np.float32)
    if grid == "scalar":
        s = np.float32(127.0 / np.abs(x).max())
    else:
        s = (127.0 / np.abs(x).max(axis=1, keepdims=True)).astype(np.float32)
    sw = quantize.absmax_scale(_t(w), bits)
    w_res = dispatch.convert(profile, _t(w), sw, bits=bits)
    return x, s, w_res


# ------------------------------------------------------------- rt_* chain --
@pytest.mark.parametrize("backends", [("reference", "reference"),
                                      ("cuda_fused",
                                       "pallas_fused_interpret")])
def test_rt_chain_matches_jax(backends):
    """encode -> matmul -> mul -> matmul-decode, and the fused head and
    single-op pipeline: digits, scales, ledger bounds and decoded floats
    equal JAX's."""
    be, jbe = backends
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 48)).astype(np.float32)
    w1 = rng.standard_normal((48, 16)).astype(np.float32)
    g = rng.standard_normal((5, 16)).astype(np.float32)
    w2 = rng.standard_normal((16, 9)).astype(np.float32)

    def chain(mod, conv, backend):
        xt = mod.rt_encode(conv(x), "rns9", bits=8, backend=backend)
        w1t = mod.rt_encode(conv(w1), "rns9", bits=8, backend=backend,
                            weight=True)
        w2t = mod.rt_encode(conv(w2), "rns9", bits=8, backend=backend,
                            weight=True)
        h = mod.rt_matmul(xt, w1t, backend=backend, renorm_bits=8)
        gt = mod.rt_encode(conv(g), "rns9", bits=8, backend=backend)
        hm = mod.rt_mul(h, gt, backend=backend, renorm_bits=8)
        y = mod.rt_matmul_decode(hm, w2t, backend=backend, renorm_bits=8)
        head = mod.rt_encode_matmul(conv(x), w1t, bits=8, backend=backend)
        dot = mod.rt_dot(conv(x), w1t, bits=8, backend=backend)
        return [xt, w1t, h, gt, hm, head], [y, dot]

    with dispatch.count_ops() as c:
        ours, ours_f = chain(rt, _t, be)
    with jdispatch.count_ops() as jc:
        theirs, theirs_f = chain(jt, jnp.asarray, jbe)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.digits.numpy().astype(np.int32),
                                      _np(b.digits).astype(np.int32))
        np.testing.assert_array_equal(a.scale.numpy(), _np(b.scale))
        assert a.mag_bits == b.mag_bits and a.profile == b.profile
    for a, b in zip(ours_f, theirs_f):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    np.testing.assert_array_equal(ours[5].digits.numpy(),
                                  ours[2].digits.numpy())  # head == pair
    assert _counts(c) == _counts(jc)


def test_three_linear_chain_decodes_exactly_with_one_normalize():
    """Three chained linears in residues, ONE normalize: the decoded
    floats are the exact integer product, and JAX's bit for bit."""
    rng = np.random.default_rng(4)
    xi = rng.integers(-7, 8, (2, 8)).astype(np.float32)
    ws = [rng.integers(-7, 8, (8, 8)).astype(np.float32) for _ in range(2)]
    ws.append(rng.integers(-7, 8, (8, 4)).astype(np.float32))

    def chain(mod, conv):
        ht = mod.rt_encode(conv(xi), "rns9", bits=8, scale=1.0)
        for w in ws:
            ht = mod.rt_matmul(ht, mod.rt_encode(conv(w), "rns9", bits=8,
                                                 scale=1.0, weight=True))
        return ht, mod.rt_decode(ht)

    with dispatch.count_ops() as c:
        ht, y = chain(rt, _t)
    _, jy = chain(jt, jnp.asarray)
    want = xi.astype(np.int64)
    for w in ws:
        want = want @ w.astype(np.int64)
    np.testing.assert_array_equal(y.numpy(), want.astype(np.float32))
    np.testing.assert_array_equal(y.numpy(), _np(jy))
    assert (c.matmuls, c.normalizes) == (3, 1)
    assert ht.mag_bits == 7 * 4 + 3 * 3


def test_forced_renormalize_matches_jax():
    """rns5 at 12 bits cannot hold the chain: the ledger renormalizes
    mid-chain, as JAX's does, with the same output and counts."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 64)).astype(np.float32)
    ws = [(rng.standard_normal((64, 64)) / 8).astype(np.float32)
          for _ in range(3)]

    def chain(mod, conv):
        ht = mod.rt_encode(conv(x), "rns5", bits=12)
        for w in ws:
            ht = mod.rt_matmul(ht, mod.rt_encode(conv(w), "rns5", bits=12,
                                                 weight=True),
                               renorm_bits=12)
        return mod.rt_decode(ht)

    with dispatch.count_ops() as c:
        y = chain(rt, _t)
    with jdispatch.count_ops() as jc:
        jy = chain(jt, jnp.asarray)
    np.testing.assert_array_equal(y.numpy(), _np(jy))
    assert _counts(c) == _counts(jc)
    assert c.matmuls == 3 and c.normalizes > 1
    with pytest.raises(ValueError, match="cannot hold"):
        rt.rt_matmul(rt.rt_encode(_t(x), "rns5", bits=16),
                     rt.rt_encode(_t(ws[0]), "rns5", bits=16))


def test_rt_mul_add_and_frac_exp():
    rng = np.random.default_rng(8)
    x, y = (rng.standard_normal((32,)).astype(np.float32) for _ in range(2))

    def run(mod, conv):
        p = mod.rt_mul(mod.rt_encode(conv(x), "rns9", bits=12),
                       mod.rt_encode(conv(y), "rns9", bits=12))
        s = mod.rt_add(p, p)
        return s, mod.rt_decode(s)

    s, out = run(rt, _t)
    js, jout = run(jt, jnp.asarray)
    np.testing.assert_array_equal(out.numpy(), _np(jout))
    assert s.mag_bits == js.mag_bits
    # a fractional residue tensor (frac_exp != 0) decodes as JAX's does
    f = rt.rt_decode(rt.RnsTensor(s.digits, s.scale, "rns9", 20.0,
                                  frac_exp=1))
    jf = jt.rt_decode(jt.RnsTensor(js.digits, js.scale, "rns9", 20.0,
                                   frac_exp=1))
    np.testing.assert_array_equal(f.numpy(), _np(jf))
    assert f.numpy().view(np.int32).tolist() == _np(jf).view(
        np.int32).tolist()


# ------------------------------------------- plain fused kernels vs ref ---
@pytest.mark.parametrize("profile", ["rns5", "rns6", "rns9"])
@pytest.mark.parametrize("M", [1, 8, 13])
@pytest.mark.parametrize("grid", ["scalar", "row"])
def test_plain_fused_match_jax_ref(profile, M, grid):
    D, N = 70, 37                   # no multiple of any tile
    x, s, w_res = _operands(profile, M, D, N, grid, seed=M)
    jw = jnp.asarray(w_res.numpy())
    got = fused_ops.rns_fused_encode_matmul(profile, _t(x), _t(s), w_res,
                                            bits=8)
    want = jref.rns_fused_encode_matmul_ref(profile, x, s, jw, bits=8)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    got = fused_ops.rns_fused_dot(profile, _t(x), _t(s), w_res, bits=8)
    want = jref.rns_fused_dot_ref(profile, x, s, jw, bits=8)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    res = fused_ops.rns_fused_encode_matmul_plain(profile, _t(x), _t(s),
                                                  w_res, bits=8)
    w2 = w_res[:, :N, :].contiguous()          # [K, N, N] residues
    for a_res in (res, res.to(torch.int8)):
        got = fused_ops.rns_fused_matmul_normalize(profile, a_res, w2)
        want = jref.rns_fused_matmul_normalize_ref(
            profile, jnp.asarray(a_res.numpy()), jnp.asarray(w2.numpy()))
        np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("profile", ["rns5", "rns9"])
@pytest.mark.parametrize("shape", [(1, 70, 37), (13, 130, 150)])
def test_encode_matmul_residues_match_pallas_interpret(profile, shape):
    M, D, N = shape
    x, s, w_res = _operands(profile, M, D, N, "row", seed=D)
    got = fused_ops.rns_fused_encode_matmul(profile, _t(x), _t(s), w_res,
                                            bits=8)
    want = j_enc_mm(profile, x, s, jnp.asarray(w_res.numpy()), bits=8,
                    interpret=True)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_matmul_normalize_c1_regression():
    a = _t(encode_exact("rns5", [[C1_VALUE], [-C1_VALUE]]))     # [K, 2, 1]
    one = _t(encode_exact("rns5", [[1]]).astype(np.int8))        # [K, 1, 1]
    got = fused_ops.rns_fused_matmul_normalize("rns5", a, one)
    assert got.reshape(-1).tolist() == [C1_FLOAT, -C1_FLOAT]


@pytest.mark.parametrize("shape", [(), (1,), (1, 4, 1), (1, 1), (2, 4, 1),
                                   (4, 1), (2, 1, 1)])
def test_row_scales_cover_what_broadcasts_to_rows(shape):
    """The CUDA wrappers' scale layout: (flat, group) gives every row of
    x [2, 4, 16] the scale that broadcasting gives it; a per-column
    scale is refused."""
    x = torch.zeros(2, 4, 16)
    s = torch.arange(1, 1 + int(np.prod(shape)),
                     dtype=torch.float32).reshape(shape)
    flat, group = fused_ops._row_scales("t", x, s)
    want = torch.broadcast_to(s, (2, 4, 1)).reshape(-1)
    got = flat[torch.arange(8) // group]
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="one scale per row"):
        fused_ops._row_scales("t", x, torch.ones(2, 4, 16))


def test_plain_wrappers_count_no_launches():
    before = dict(fused_ops.launches)
    x, s, w_res = _operands("rns9", 3, 16, 5, "row")
    fused_ops.rns_fused_dot("rns9", _t(x), _t(s), w_res, bits=8)
    fused_ops.rns_fused_encode_matmul("rns9", _t(x), _t(s), w_res, bits=8)
    fused_ops.rns_fused_matmul_normalize(
        "rns9", w_res.transpose(1, 2).contiguous(), w_res)
    assert fused_ops.launches == before


# --------------------------------------------------- dispatch composites ---
def test_per_column_scale_falls_back_visibly():
    x, _, w_res = _operands("rns9", 4, 16, 5, "row", seed=9)
    s_col = np.random.default_rng(9).uniform(1, 30, (1, 16)).astype(
        np.float32)
    with dispatch.count_ops() as c:
        got = dispatch.fused_dot("rns9", _t(x), _t(s_col), w_res, bits=10,
                                 backend="cuda_fused")
    with jdispatch.count_ops() as jc:
        want = jdispatch.fused_dot("rns9", x, s_col,
                                   jnp.asarray(w_res.numpy()), bits=10,
                                   backend="pallas_fused_interpret")
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert _counts(c) == _counts(jc)
    assert (c.fallbacks, c.fused, c.converts) == (1, 0, 1)


@pytest.mark.parametrize("shared", [False, True])
def test_composites_tally_as_jax(shared):
    x, s, w_res = _operands("rns9", 6, 24, 7, "row", seed=11)
    jw = jnp.asarray(w_res.numpy())
    a_res = w_res.transpose(1, 2).contiguous()
    for be, jbe in (("cuda", "pallas_interpret"),
                    ("cuda_fused", "pallas_fused_interpret")):
        with dispatch.count_ops() as c:
            y = dispatch.fused_dot("rns9", _t(x), _t(s), w_res, bits=8,
                                   backend=be, shared_encode=shared)
            r = dispatch.fused_encode_matmul("rns9", _t(x), _t(s), w_res,
                                             bits=8, backend=be)
            z = dispatch.fused_matmul_normalize("rns9", a_res, w_res,
                                                backend=be)
        with jdispatch.count_ops() as jc:
            jy = jdispatch.fused_dot("rns9", x, s, jw, bits=8, backend=jbe,
                                     shared_encode=shared)
            jr = jdispatch.fused_encode_matmul("rns9", x, s, jw, bits=8,
                                               backend=jbe)
            jdispatch.fused_matmul_normalize(
                "rns9", jnp.asarray(a_res.numpy()), jw, backend=jbe)
        np.testing.assert_array_equal(y.numpy(), _np(jy))
        np.testing.assert_array_equal(r.numpy(), _np(jr))
        assert z.shape == (7, 7)
        assert _counts(c) == _counts(jc)
    assert dispatch.is_fused("cuda_fused") and not dispatch.is_fused(None)


# ------------------------------------------------------------ the MLP ----
def _mlp_pair(gated, seed=0, bias=False):
    rng = np.random.default_rng(seed)
    d, ff = 32, 64
    ws = {n: (0.05 * rng.standard_normal(shape)).astype(np.float32)
          for n, shape in (("wi", (d, ff)), ("wg", (d, ff)), ("wo", (ff, d)))}
    if not gated:
        del ws["wg"]
    jp = {n: {"w": jnp.asarray(w)} for n, w in ws.items()}
    p = L.MLP(d, ff, gated, device="cpu", bias=bias)
    with torch.no_grad():
        for n, w in ws.items():
            getattr(p, n).copy_(_t(w))
    if bias:
        for n, bn in (("wi", "bi"), ("wg", "bg"), ("wo", "bo")):
            if n in ws:
                b = (0.1 * rng.standard_normal(ws[n].shape[1])).astype(
                    np.float32)
                jp[n]["b"] = jnp.asarray(b)
                with torch.no_grad():
                    getattr(p, bn).copy_(_t(b))
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    return p, jp, x


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("defer", [False, True])
@pytest.mark.parametrize("backends", [("reference", "reference"),
                                      ("cuda_fused",
                                       "pallas_fused_interpret")])
@pytest.mark.parametrize("res", [False, True])
def test_mlp_paths_match_jax(gated, defer, backends, res):
    """Per-op and deferred, re-encode and resident, unfused and fused:
    the MLP block's floats and op counts equal JAX's."""
    be, jbe = backends
    p, jp, x = _mlp_pair(gated, seed=int(gated) + 2 * int(defer))
    cfg = RnsDotConfig(profile="rns9", qx=8, qw=8, backend=be, defer=defer)
    jcfg = JRnsDotConfig(profile="rns9", qx=8, qw=8, backend=jbe,
                         defer=defer)

    class _C:
        rns_targets = "mlp"

        def __init__(self, r):
            self.rns = r

    if res:
        resident.encode_resident(p, _C(cfg))
        jp = jres.encode_resident(jp, _C(jcfg))
    mask = np.ones((3, 5), bool)
    with dispatch.count_ops() as c, \
            quantize.token_mask(_t(mask), per_token=True):
        y = L.mlp(p, _t(x), gated=gated, act="relu", rns=cfg)
    with jdispatch.count_ops() as jc, \
            jq.token_mask(jnp.asarray(mask), per_token=True):
        jy = jl.mlp(jp, jnp.asarray(x), gated=gated, act="relu", rns=jcfg)
    np.testing.assert_array_equal(y.numpy(), _np(jy))
    assert _counts(c) == _counts(jc)
    if res:
        assert c.weight_converts == 0
    if be == "cuda_fused":
        assert c.fused > 0 and c.fallbacks == 0


def test_linear_on_resident_weight_and_residue_input_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 24)).astype(np.float32)
    w = (0.1 * rng.standard_normal((24, 12))).astype(np.float32)
    cfg = RnsDotConfig(profile="rns9", qx=8, qw=8)
    jcfg = JRnsDotConfig(profile="rns9", qx=8, qw=8)
    res = rt.rt_encode(_t(w), "rns9", bits=8, weight=True)
    jp = {"w": jnp.asarray(w),
          "w_res": jt.rt_encode(jnp.asarray(w), "rns9", bits=8,
                                weight=True)}
    with dispatch.count_ops() as c:
        y = L.linear(_t(w), _t(x), cfg, res=res)
    with jdispatch.count_ops() as jc:
        jy = jl.linear(jp, jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(y.numpy(), _np(jy))
    assert _counts(c) == _counts(jc) and c.weight_converts == 0
    xt = L.linear(_t(w), rt.rt_encode(_t(x), "rns9", bits=8), cfg)
    jxt = jl.linear({"w": jnp.asarray(w)},
                    jt.rt_encode(jnp.asarray(x), "rns9", bits=8), jcfg)
    np.testing.assert_array_equal(xt.digits.numpy(), _np(jxt.digits))
    assert xt.mag_bits == jxt.mag_bits


def test_biased_mlp_warns_and_falls_back_to_per_op():
    p, jp, x = _mlp_pair(True, seed=5, bias=True)
    cfg = RnsDotConfig(profile="rns9", qx=8, qw=8, defer=True)
    jcfg = JRnsDotConfig(profile="rns9", qx=8, qw=8, defer=True)
    with pytest.warns(UserWarning, match="per-op"), \
            dispatch.count_ops() as c:
        y = L.mlp(p, _t(x), gated=True, act="silu", rns=cfg)
    with pytest.warns(UserWarning, match="per-op"), \
            jdispatch.count_ops() as jc:
        jy = jl.mlp(jp, jnp.asarray(x), gated=True, act="silu", rns=jcfg)
    np.testing.assert_array_equal(y.numpy(), _np(jy))
    assert _counts(c) == _counts(jc)

    class _C:
        rns_targets, rns = "mlp", cfg

    resident.encode_resident(p, _C())
    assert not resident.has_resident(p)     # biased MLPs stay per-op
    with pytest.raises(ValueError, match="bias"):
        L.linear(p.wi, rt.rt_encode(_t(x), "rns9", bits=8), cfg, b=p.bi)


# ------------------------------------------------- resident and engine ---
def _cfgs():
    jcfg = dataclasses.replace(j_get_config("smollm-135m", smoke=True),
                               rns=JRnsDotConfig(profile="rns9", qx=8, qw=8),
                               rns_targets="mlp")
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              rns=RnsDotConfig(profile="rns9", qx=8, qw=8),
                              rns_targets="mlp")
    return jcfg, cfg


@pytest.fixture(scope="module")
def smoke():
    jcfg, cfg = _cfgs()
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)[0]
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in (5, 11, 23)]
    return jcfg, jparams, cfg, model, prompts


def test_encode_resident_matches_jax(smoke):
    jcfg, jparams, cfg, model, _ = smoke
    jp = jres.encode_resident(jparams, jcfg)
    ours = resident.encode_resident(copy.deepcopy(model), cfg)
    assert resident.has_resident(ours) and jres.has_resident(jp)
    assert set(resident.resident_profiles(ours).values()) == {"rns9"}
    for i, blk in enumerate(ours.blocks):
        for name in ("wi", "wg", "wo"):
            got = blk.mlp.resident(name)
            want = jp["blocks"]["l0"]["mlp"][name]["w_res"]
            np.testing.assert_array_equal(got.digits.numpy(),
                                          _np(want.digits[i]))
            np.testing.assert_array_equal(got.scale.numpy(),
                                          _np(want.scale[i]))
            assert (got.mag_bits, got.profile) == (want.mag_bits,
                                                   want.profile)
    assert not resident.has_resident(model)


@pytest.mark.parametrize("defer", [False, True])
def test_engine_fused_resident_matches_jax(smoke, defer):
    """The fused resident engine, per-op and deferred: JAX's greedy tokens
    and per-step rns_ops times the number of layers."""
    jcfg, jparams, cfg, model, prompts = smoke
    kw = dict(max_cache=40, max_new_tokens=4, page_size=8, max_seqs=2,
              resident_weights=True, rns_defer=defer)
    jres_, jstats = JEngine(jparams, jcfg, JServeConfig(
        rns_backend="pallas_fused_interpret", **kw)).run(prompts)
    res, stats = ContinuousEngine(copy.deepcopy(model), ServeConfig(
        rns_backend="cuda_fused", **kw), device="cpu").run(prompts)
    assert {r: t.tolist() for r, t in res.items()} == {
        r: t.tolist() for r, t in jres_.items()}
    assert len(stats["steps"]) == len(jstats["steps"])
    for s, js in zip(stats["steps"], jstats["steps"]):
        want = {f: n * cfg.n_layers for f, n in _counts(js["rns_ops"]).items()}
        assert s["rns_ops"].as_dict() == want
    decode = [s["rns_ops"].as_dict() for s in stats["steps"]
              if not s["admitted"] and s["decoded"]]
    per_layer = ({"converts": 2, "matmuls": 3, "normalizes": 2, "fused": 3}
                 if defer else
                 {"converts": 2, "matmuls": 3, "normalizes": 3, "fused": 3})
    assert decode and all(
        d == {**{f: 0 for f in FUSED_FIELDS},
              **{k: v * cfg.n_layers for k, v in per_layer.items()}}
        for d in decode)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_jax_fused_decode_op_counts_written_in_chip_smoke():
    """chip_smoke.py holds the fused deferred resident decode step to what
    the JAX engine's decode step traces for one layer."""
    jcfg, _ = _cfgs()
    jcfg = dataclasses.replace(jcfg, rns=dataclasses.replace(
        jcfg.rns, backend="pallas_fused_interpret", defer=True))
    params = jres.encode_resident(JM.init_model(jax.random.PRNGKey(0),
                                                jcfg)[0], jcfg)
    from repro.serve import kv_cache as jkv

    pcfg = jkv.PagedCacheConfig(page_size=8, n_pages=9, max_seqs=2,
                                max_blocks=4)
    cache = jax.eval_shape(
        lambda: jkv.make_paged_cache(jcfg, pcfg, dtype=jnp.float32))
    counts = jdispatch.trace_op_counts(
        lambda p, t, c: JM.decode_step(p, jcfg, t, c,
                                       active=jnp.ones((2,), bool)),
        params, jnp.zeros((2, 1), jnp.int32), cache)
    assert _chip_smoke().JAX_FUSED_DECODE_RNS_OPS == _counts(counts)


def test_serve_cli_fused_resident(capsys):
    from repro_torch.launch.serve import main

    main(["--continuous", "--rns", "rns9", "--rns-backend", "cuda_fused",
          "--resident-weights", "--device", "cpu", "--requests", "2",
          "--new", "3"])
    out = capsys.readouterr().out
    assert "'fused': 12" in out and "'weight_converts': 0" in out


# ---------------------------------------------------------- on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels build and run "
                    "only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("profile", ["rns5", "rns6", "rns9", "rns21",
                                     "rns8_u8"])
@pytest.mark.parametrize("shape", [(1, 70, 37), (8, 576, 1536),
                                   (13, 130, 150), (8, 1536, 576),
                                   (13, 1100, 70)])
def test_gpu_fused_kernels_match_plain(cuda, profile, shape):
    """Every fused kernel bit-equal to its plain version; the dot and the
    matmul + normalize at every candidate tile the checker allows.
    (8, 1536, 576) and (13, 1100, 70) leave SMs idle, so their K steps
    are split among blocks (``rns_fused.splits_for``)."""
    from repro_torch.kernels import autotune

    M, D, N = shape
    for grid in ("scalar", "row"):
        x, s, w_res = _operands(profile, M, D, N, grid, seed=M)
        x, s, w_res = _t(x).to(cuda), _t(s).to(cuda), w_res.to(cuda)
        legal, _ = autotune.legal_candidates("rns_fused_dot", profile, shape)
        for wrapper, plain, tiles in (
                (fused_ops.rns_fused_dot, fused_ops.rns_fused_dot_plain,
                 legal),
                (fused_ops.rns_fused_encode_matmul,
                 fused_ops.rns_fused_encode_matmul_plain, [{}])):
            want = plain(profile, x, s, w_res, bits=8)
            for blocks in tiles:
                got = wrapper(profile, x, s, w_res, bits=8, **blocks)
                assert torch.equal(got.isnan(), want.isnan()), blocks
                assert torch.equal(got.nan_to_num(), want.nan_to_num()), \
                    (grid, blocks)
    a32 = fused_ops.rns_fused_encode_matmul(profile, x, s, w_res, bits=8)
    w2 = w_res.transpose(1, 2).contiguous()
    a_dtypes = (torch.int32, torch.int8) if get_profile(profile).int8_safe \
        else (torch.int32,)
    legal, _ = autotune.legal_candidates("rns_fused_matmul_normalize",
                                         profile, (M, N, D))
    for dt in a_dtypes:
        want = fused_ops.rns_fused_matmul_normalize_plain(profile,
                                                          a32.to(dt), w2)
        for blocks in legal:
            got = fused_ops.rns_fused_matmul_normalize(profile, a32.to(dt),
                                                       w2, **blocks)
            assert torch.equal(got.nan_to_num(), want.nan_to_num()), \
                (dt, blocks)
    torch.cuda.synchronize()


def _capture_grow_replay(cuda, run, small, big, plain):
    """ROADMAP C.7: capture ``run(*small)`` (a split call) in a CUDA graph
    on its own stream, grow that stream's workspace with ``run(*big)``,
    fill fresh memory, replay: the replay still equals the plain version,
    the fill is untouched, and the buffer the graph holds stays among
    the workspace's pairs."""
    from repro_torch.kernels import workspace

    stream = torch.cuda.Stream(cuda)
    with torch.cuda.stream(stream):
        run(*small)                                 # warm: build, memo
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = run(*small)
    captured = workspace.held(cuda, stream.cuda_stream)
    assert captured, "the captured call did not split"
    with torch.cuda.stream(stream):
        got_big = run(*big)
    torch.cuda.synchronize()
    pairs = workspace.held(cuda, stream.cuda_stream)
    assert len(pairs) > len(captured), "the larger call did not grow it"
    assert all(p[0].data_ptr() == q[0].data_ptr() and
               p[1].data_ptr() == q[1].data_ptr()
               for p, q in zip(captured, pairs))
    fill = [torch.full((p[0].numel(),), 7, dtype=torch.int32, device=cuda)
            for p in captured]
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, plain(*small))
    assert torch.equal(got_big, plain(*big))
    assert all(bool((f == 7).all()) for f in fill)


@pytest.mark.gpu
def test_gpu_rns_matmul_capture_grow_replay(cuda):
    from repro_torch.kernels.rns_matmul import ops as mm

    p = get_profile("rns9")
    rng = np.random.default_rng(5)

    def res(shape):
        return _t(np.stack([rng.integers(0, m, shape) for m in p.moduli])
                  .astype(np.int8)).to(cuda)

    # 9 x 1 x 9 and 9 x 1 x 10 tiles of 32 x 64 leave SMs idle: both split
    small = (res((8, 1536)), res((1536, 576)))
    big = (res((32, 1536)), res((1536, 640)))
    _capture_grow_replay(cuda, lambda a, b: mm.rns_matmul(p, a, b), small,
                         big, lambda a, b: mm.rns_matmul_plain(p, a, b))


@pytest.mark.gpu
def test_gpu_fused_matmul_normalize_capture_grow_replay(cuda):
    p = get_profile("rns9")
    rng = np.random.default_rng(6)

    def res(shape, dt):
        return _t(np.stack([rng.integers(0, m, shape) for m in p.moduli])
                  .astype(dt)).to(cuda)

    # decode's int32 a_res: 18 tiles of 16 x 32 split 6 ways; then 32
    # tiles split 4 ways need more slices
    small = (res((8, 1536), np.int32), res((1536, 576), np.int8))
    big = (res((8, 3072), np.int32), res((3072, 1024), np.int8))
    _capture_grow_replay(
        cuda, lambda a, b: fused_ops.rns_fused_matmul_normalize(p, a, b),
        small, big,
        lambda a, b: fused_ops.rns_fused_matmul_normalize_plain(p, a, b))


@pytest.mark.gpu
def test_gpu_encode_matmul_capture_grow_replay(cuda):
    """B.5 now splits through the same workspace: 18 tiles of 16 x 32 (all
    9 digits a block) at D = 1536 split 6 ways; then 40 tiles at D = 3072,
    3 ways, need more slices and counters."""
    p = get_profile("rns9")
    rng = np.random.default_rng(7)

    def operands(M, D, N):
        x = _t((3 * rng.standard_normal((M, D))).astype(np.float32)).to(cuda)
        s = 127.0 / x.abs().amax(dim=1, keepdim=True)
        b = _t(np.stack([rng.integers(0, m, (D, N)) for m in p.moduli])
               .astype(np.int8)).to(cuda)
        return x, s, b

    _capture_grow_replay(
        cuda, lambda x, s, b: fused_ops.rns_fused_encode_matmul(p, x, s, b,
                                                                bits=8),
        operands(8, 1536, 576), operands(32, 3072, 640),
        lambda x, s, b: fused_ops.rns_fused_encode_matmul_plain(p, x, s, b,
                                                                bits=8))

@pytest.mark.gpu
def test_gpu_matmul_normalize_c1(cuda):
    a = _t(encode_exact("rns5", [[C1_VALUE], [-C1_VALUE]])).to(cuda)
    one = _t(encode_exact("rns5", [[1]]).astype(np.int8)).to(cuda)
    got = fused_ops.rns_fused_matmul_normalize("rns5", a, one)
    assert got.reshape(-1).tolist() == [C1_FLOAT, -C1_FLOAT]


@pytest.mark.gpu
def test_gpu_fused_engine_matches_cpu(cuda, smoke):
    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, cfg, model, prompts = smoke
    kw = dict(max_cache=40, max_new_tokens=5, page_size=8, max_seqs=2,
              rns_backend="cuda_fused", rns_defer=True, resident_weights=True)
    res_cpu, _ = ContinuousEngine(copy.deepcopy(model), ServeConfig(**kw),
                                  device="cpu").run(prompts)
    before = dict(fused_ops.launches)
    res_gpu, stats = ContinuousEngine(copy.deepcopy(model),
                                      ServeConfig(**kw),
                                      device="cuda").run(prompts)
    assert all(fused_ops.launches[k] > before[k] for k in before)
    assert all(s["rns_ops"].fallbacks == 0 for s in stats["steps"])
    assert {r: t.tolist() for r, t in res_gpu.items()} == {
        r: t.tolist() for r, t in res_cpu.items()}
