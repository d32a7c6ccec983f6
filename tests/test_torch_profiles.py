"""Per-layer moduli profiles in the port against the JAX package.

``core/moduli.py``'s ``narrowest_profile``, ``required_digits`` and
``M_f``; ``models/resident.py``'s per-slot profile selection (the JAX
package stacks a period slot's layers and selects once for the stack:
every port layer of the slot must carry the slot's profile and
``mag_bits``); the resident MLP on a narrow profile against the
re-encode MLP and a python-int oracle; and the fused resident engine
with ``per_layer_profiles=True`` against JAX's engine on the
``pallas_fused_interpret`` backend.  Weights come from numpy seeds or
``repro.models.model.init_model`` through ``params_from_jax``.
"""

import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as j_get_config
from repro.core import moduli as jmod
from repro.core.quantize import absmax_scale as j_absmax_scale
from repro.core.quantize import quantize_with_scale as j_quantize
from repro.core.rns_matmul import RnsDotConfig as JRnsDotConfig
from repro.models import layers as jl
from repro.models import model as JM
from repro.models import resident as jres
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.base import get_config
from repro_torch.core import dispatch, moduli, quantize
from repro_torch.core.rns_matmul import RnsDotConfig, rns_resident_dot
from repro_torch.models import layers as L
from repro_torch.models import resident
from repro_torch.models.params import params_from_jax
from repro_torch.serve.engine import ContinuousEngine, ServeConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIELDS = ("converts", "matmuls", "normalizes", "fused", "fallbacks",
          "weight_converts")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _counts(c) -> dict:
    return {f: getattr(c, f) for f in FIELDS}


class _C:
    """Model-config stand-in: the RNS config and its targets."""
    rns_targets = "mlp"
    period = 1

    def __init__(self, rns):
        self.rns = rns


# ------------------------------------------------------------ moduli ----
@pytest.mark.parametrize("cap", sorted(moduli.PROFILES))
def test_narrowest_profile_equals_jax(cap):
    for bits in np.arange(0.0, 150.0, 0.25):
        got = moduli.narrowest_profile(float(bits), cap=cap)
        want = jmod.narrowest_profile(float(bits), cap=cap)
        assert (got.name, got.moduli) == (want.name, want.moduli), bits
    # a profile object as the cap, and nothing narrower than the cap
    p = moduli.get_profile(cap)
    assert moduli.narrowest_profile(1e9, cap=p) is p
    if not p.int8_safe:
        return
    assert all(moduli.narrowest_profile(b, cap=cap).int8_safe
               for b in range(0, 150, 7))


@pytest.mark.parametrize("limit", [128, 256])
@pytest.mark.parametrize("qa,qw", [(8, 8), (8, 16), (16, 16), (4, 12)])
def test_required_digits_equals_jax(qa, qw, limit):
    for n_terms in (0, 1, 2, 7, 64, 576, 1536, 4096, 10 ** 6, 10 ** 9):
        assert moduli.required_digits(n_terms, qa, qw, limit) == \
            jmod.required_digits(n_terms, qa, qw, limit)


def test_profile_M_f_equals_jax():
    for name, p in moduli.PROFILES.items():
        assert p.M_f == jmod.get_profile(name).M_f
        assert p.M_f == math.prod(p.moduli[:p.frac_digits])


# --------------------------------------------- the resident encoder ----
def _smoke(profile="rns9", qx=8, qw=8):
    jcfg = dataclasses.replace(
        j_get_config("smollm-135m", smoke=True),
        rns=JRnsDotConfig(profile=profile, qx=qx, qw=qw), rns_targets="mlp")
    cfg = dataclasses.replace(
        get_config("smollm-135m", smoke=True),
        rns=RnsDotConfig(profile=profile, qx=qx, qw=qw), rns_targets="mlp")
    return jcfg, cfg


@pytest.fixture(scope="module")
def smoke_params():
    jcfg, _ = _smoke()
    return JM.init_model(jax.random.PRNGKey(0), jcfg)[0]


def _assert_slot_equals_jax(model, jp):
    """Every port layer carries its JAX slot's profile, mag_bits, and its
    own stacked entry's digits and scale."""
    j_mlp = jp["blocks"]["l0"]["mlp"]
    profs = resident.resident_profiles(model)
    assert len(profs) == len(model.blocks)      # one entry a layer
    for i, blk in enumerate(model.blocks):
        for name in ("wi", "wg", "wo"):
            got, want = blk.mlp.resident(name), j_mlp[name]["w_res"]
            assert (got.profile, got.mag_bits) == (want.profile,
                                                   want.mag_bits)
            np.testing.assert_array_equal(got.digits.numpy(),
                                          np.asarray(want.digits[i]))
            np.testing.assert_array_equal(got.scale.numpy(),
                                          np.asarray(want.scale[i]))
        assert profs[f"blocks.{i}.mlp"] == j_mlp["wi"]["w_res"].profile


@pytest.mark.parametrize("profile,qx,qw", [("rns9", 8, 8), ("rns12", 8, 8),
                                           ("rns16", 12, 12),
                                           ("rns21", 16, 16)])
def test_per_layer_profiles_and_mag_bits_equal_jax(smoke_params, profile,
                                                   qx, qw):
    jcfg, cfg = _smoke(profile, qx, qw)
    jp = jres.encode_resident(smoke_params, jcfg, per_layer_profiles=True)
    model = params_from_jax(jax.tree.map(np.asarray, smoke_params), cfg,
                            device="cpu")
    with dispatch.count_ops() as c:
        resident.encode_resident(model, cfg, per_layer_profiles=True)
    assert c.weight_converts == 3 * cfg.n_layers
    _assert_slot_equals_jax(model, jp)
    chosen = jp["blocks"]["l0"]["mlp"]["wi"]["w_res"].profile
    assert moduli.get_profile(chosen).range_bits <= \
        moduli.get_profile(profile).range_bits


def test_per_layer_selection_is_per_slot_not_per_layer(smoke_params):
    """One layer with a much larger column sum widens its whole slot in
    JAX (one stacked selection); the port must widen every layer with
    it, though that layer alone would pick a narrower profile."""
    jcfg, cfg = _smoke()
    tree = jax.tree.map(np.asarray, smoke_params)
    for name in ("wi", "wo"):               # layer 2: one full column
        w = np.array(tree["blocks"]["l0"]["mlp"][name]["w"])
        w[2, :, 0] = np.abs(w[2]).max()
        tree["blocks"]["l0"]["mlp"][name]["w"] = w
    jp = jres.encode_resident(jax.tree.map(jnp.asarray, tree), jcfg,
                              per_layer_profiles=True)
    model = params_from_jax(tree, cfg, device="cpu")
    alone, _ = resident._select_profile([model.blocks[0].mlp], cfg.rns, True)
    resident.encode_resident(model, cfg, per_layer_profiles=True)
    _assert_slot_equals_jax(model, jp)
    slot = model.blocks[0].mlp.resident("wi").profile
    assert moduli.get_profile(alone).range_bits < \
        moduli.get_profile(slot).range_bits


def _mlp_pair(gated: bool, seed: int, d=32, ff=64):
    """A port MLP and the JAX MLP param dict on the same numpy weights
    (0.05 x standard normal, as tests/test_resident.py draws them)."""
    rng = np.random.default_rng(seed)
    ws = {"wi": (d, ff), "wo": (ff, d)}
    if gated:
        ws["wg"] = (d, ff)
    ws = {n: (0.05 * rng.standard_normal(s)).astype(np.float32)
          for n, s in ws.items()}
    p = L.MLP(d, ff, gated, device="cpu")
    with torch.no_grad():
        for n, w in ws.items():
            getattr(p, n).copy_(_t(w))
    jp = {n: {"w": jnp.asarray(w)} for n, w in ws.items()}
    return p, jp


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("defer", [False, True])
@pytest.mark.parametrize("per_layer", [False, True])
@pytest.mark.parametrize("backends", [("reference", "reference"),
                                      ("cuda_fused",
                                       "pallas_fused_interpret")])
def test_resident_mlp_bit_identical(gated, defer, per_layer, backends):
    """The resident MLP equals the re-encode MLP bit for bit, on its
    per-layer profile too (``test_resident_mlp_bit_identical``), and
    both equal JAX's resident MLP with the same op counts."""
    be, jbe = backends
    p, jp = _mlp_pair(gated, seed=11 + 2 * int(gated) + int(defer))
    x = np.random.default_rng(12).standard_normal((4, 32)).astype(
        np.float32)
    rns = RnsDotConfig(profile="rns9", qx=8, qw=8, backend=be, defer=defer)
    jrns = JRnsDotConfig(profile="rns9", qx=8, qw=8, backend=jbe,
                         defer=defer)
    y0 = L.mlp(p, _t(x), gated=gated, act="silu", rns=rns)
    resident.encode_resident(p, _C(rns), per_layer_profiles=per_layer)
    with dispatch.count_ops() as c:
        y1 = L.mlp(p, _t(x), gated=gated, act="silu", rns=rns)
    jpr = jres.encode_resident({"mlp": jp}, _C(jrns),
                               per_layer_profiles=per_layer)["mlp"]
    from repro.core import dispatch as jdispatch

    with jdispatch.count_ops() as jc:
        jy = jl.mlp(jpr, jnp.asarray(x), gated=gated, act="silu", rns=jrns)
    assert torch.equal(y0, y1)
    np.testing.assert_array_equal(y1.numpy(), np.asarray(jy))
    assert _counts(c) == _counts(jc) and c.weight_converts == 0
    assert p.resident("wi").profile == jpr["wi"]["w_res"].profile
    if per_layer:
        assert p.resident("wi").profile != "rns9"   # a narrower profile


@pytest.mark.parametrize("defer", [False, True])
def test_full_width_mlp_selected_profile_equals_rns9(defer):
    """One MLP layer at smollm-135m's width (576 -> 1536 -> 576, weights
    N(0, 1/d_in) as ``init_model`` draws them): the profile its weights
    select is narrower than rns9, and the resident MLP on it gives the
    rns9 resident MLP's floats bit for bit."""
    torch.manual_seed(0)
    p = L.MLP(576, 1536, True, device="cpu")
    with torch.no_grad():
        for name in L.MLP.NAMES:
            w = getattr(p, name)
            w.normal_(0.0, 1.0 / math.sqrt(w.shape[0]))
    rns = RnsDotConfig(profile="rns9", qx=8, qw=8, defer=defer)
    wide, narrow = copy.deepcopy(p), copy.deepcopy(p)
    resident.encode_resident(wide, _C(rns))
    resident.encode_resident(narrow, _C(rns), per_layer_profiles=True)
    assert narrow.resident("wi").profile == "rns7"
    x = torch.randn(16, 1, 576)
    with quantize.token_mask(torch.ones(16, 1, dtype=torch.bool)):
        y9 = L.mlp(wide, x, rns=rns)
        y7 = L.mlp(narrow, x, rns=rns)
    assert torch.equal(y7, y9)


def test_narrow_profile_vs_python_int_oracle():
    """The narrow-profile resident dot equals unbounded python-int
    arithmetic on the same quantized operands, rescaled by the
    datapath's own float32 operations."""
    p, jp = _mlp_pair(False, seed=7, d=16, ff=24)
    x = np.random.default_rng(8).standard_normal((3, 16)).astype(np.float32)
    rns = RnsDotConfig(profile="rns9", qx=8, qw=8)
    resident.encode_resident(p, _C(rns), per_layer_profiles=True)
    res = p.resident("wi")
    prof = moduli.get_profile(res.profile)
    jpr = jres.encode_resident({"mlp": jp}, _C(JRnsDotConfig(
        profile="rns9", qx=8, qw=8)), per_layer_profiles=True)["mlp"]
    assert (res.profile, res.mag_bits) == (jpr["wi"]["w_res"].profile,
                                           jpr["wi"]["w_res"].mag_bits)
    assert prof.range_bits < moduli.get_profile("rns9").range_bits

    sx = j_absmax_scale(jnp.asarray(x), 8)
    sw = j_absmax_scale(jp["wi"]["w"], 8)
    qx = np.asarray(j_quantize(jnp.asarray(x), sx, 8), object)
    qw = np.asarray(j_quantize(jp["wi"]["w"], sw, 8), object)
    exact = qx @ qw                                  # unbounded python ints
    assert all(abs(int(v)) * 2 < prof.M for v in exact.ravel())
    y = rns_resident_dot(_t(x), res, dataclasses.replace(
        rns, profile=prof.name))
    recip = np.float32(1.0) / (np.float32(sx) * np.float32(sw))
    want = exact.astype(np.float64).astype(np.float32) * recip
    np.testing.assert_array_equal(y.numpy(), want)


def test_amortized_ledger_bound_is_safe_and_tight():
    """Each resident's mag_bits give back the column-sum bound through
    the ledger formula, and the selected profile holds it."""
    p, _ = _mlp_pair(True, seed=9)
    resident.encode_resident(p, _C(RnsDotConfig(profile="rns9", qx=8, qw=8)),
                             per_layer_profiles=True)
    for name in ("wi", "wg", "wo"):
        res, w = p.resident(name), getattr(p, name).detach().numpy()
        q = np.asarray(j_quantize(jnp.asarray(w),
                                  j_absmax_scale(jnp.asarray(w), 8), 8),
                       np.int64)
        colsum = int(np.abs(q).sum(axis=-2).max())
        got = 7.0 + res.mag_bits + math.log2(w.shape[-2])
        assert got == pytest.approx(7.0 + math.log2(colsum), abs=1e-9)
        assert 7.0 + math.log2(colsum) + 1.0 <= \
            moduli.get_profile(res.profile).signed_bits


def test_per_layer_requires_resident_in_serve_config():
    for cls in (ServeConfig, JServeConfig):
        with pytest.raises(ValueError, match="requires resident_weights"):
            cls(per_layer_profiles=True)
    ServeConfig(per_layer_profiles=True, resident_weights=True)


def test_serve_cli_per_layer_flag_needs_resident(capsys):
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit):
        main(["--continuous", "--rns", "rns9", "--device", "cpu",
              "--per-layer-profiles"])
    assert "requires --resident-weights" in capsys.readouterr().err


def test_serve_cli_per_layer_profiles(capsys):
    from repro_torch.launch.serve import main

    main(["--continuous", "--rns", "rns9", "--rns-backend", "cuda_fused",
          "--resident-weights", "--per-layer-profiles", "--device", "cpu",
          "--requests", "2", "--new", "3"])
    out = capsys.readouterr().out
    assert "per-layer profiles: {'rns6': 4}" in out
    # the CPU runs the step programs eagerly: no graph is captured
    assert "captures decode=0 prefill=0" in out


def test_k7_buckets_have_legal_fused_tiles():
    """The tile checker drops the fused 16x16 tile at rns5-7; every
    full-width bucket the per-layer path gives B.4-B.6 at K = 7 (decode
    8 rows, prefill 144) keeps legal tiles, its default among them."""
    from repro_torch.kernels import autotune

    for kind in ("rns_fused_dot", "rns_fused_encode_matmul",
                 "rns_fused_matmul_normalize"):
        for shape in ((8, 576, 1536), (144, 576, 1536), (8, 1536, 576),
                      (144, 1536, 576)):
            legal, _ = autotune.legal_candidates(kind, "rns7", shape)
            assert autotune.DEFAULTS[kind] in legal, (kind, shape)


# ------------------------------------------------------------ engine ----
@pytest.mark.parametrize("defer", [False, True])
def test_engine_per_layer_profiles_matches_jax(smoke_params, defer):
    """The fused resident engine with per-layer profiles: the JAX
    engine's profiles, greedy tokens and per-step rns_ops times the
    number of layers."""
    jcfg, cfg = _smoke()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in (5, 11, 23)]
    kw = dict(max_cache=40, max_new_tokens=4, page_size=8, max_seqs=2,
              resident_weights=True, per_layer_profiles=True,
              rns_defer=defer)
    jeng = JEngine(smoke_params, jcfg, JServeConfig(
        rns_backend="pallas_fused_interpret", **kw))
    jout, jstats = jeng.run(prompts)
    model = params_from_jax(jax.tree.map(np.asarray, smoke_params), cfg,
                            device="cpu")
    eng = ContinuousEngine(copy.deepcopy(model), ServeConfig(
        rns_backend="cuda_fused", **kw), device="cpu")
    out, stats = eng.run(prompts)
    jprof = set(jres.resident_profiles(jeng.params).values())
    assert set(resident.resident_profiles(eng.model).values()) == jprof
    assert jprof == {"rns6"}
    assert {r: t.tolist() for r, t in out.items()} == {
        r: t.tolist() for r, t in jout.items()}
    assert len(stats["steps"]) == len(jstats["steps"])
    for s, js in zip(stats["steps"], jstats["steps"]):
        want = {f: n * cfg.n_layers
                for f, n in _counts(js["rns_ops"]).items()}
        assert s["rns_ops"].as_dict() == want
        assert s["rns_ops"].weight_converts == 0
