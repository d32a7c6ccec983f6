"""The SSM and hybrid family: the port against the JAX package.

``models/ssm.py`` (Mamba-1 and RWKV-6, both ``impl``s) on the same
weights and inputs as ``repro.models.ssm`` within ``SSM_ATOL`` (float32
sums in another order), including the decode step the port runs without
JAX's identity padding; ``layernorm`` within ``NORM_ATOL``.  Then the
``rwkv6-7b`` and ``jamba-v0.1-52b`` smoke twins: ``params_from_jax``
leaf for leaf, prefill and decode logits within ``LOGIT_ATOL`` and the
state planes within ``STATE_ATOL``, greedy tokens of the bucketed
``Engine`` equal to JAX's ``Engine.generate`` (rows of a batch equal to
JAX's solo runs, ROADMAP C.11), ``rns_op_counts`` JAX's times the
periods (ROADMAP C.3), and the continuous engine and the CLI refusing
both with JAX's message.  The ``gpu`` cases hold captured runs to eager
ones and the card to the CPU.
"""

import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as j_get_config
from repro.core.rns_matmul import RnsDotConfig as JRnsDotConfig
from repro.models import model as JM
from repro.models import ssm as jssm
from repro.models.layers import layernorm as j_layernorm
from repro.serve.engine import ContinuousEngine as JContinuous
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.base import get_config
from repro_torch.core.rns_matmul import RnsDotConfig
from repro_torch.launch import serve as cli
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.models.layers import layernorm
from repro_torch.models.params import params_from_jax
from repro_torch.serve.engine import ContinuousEngine, Engine, ServeConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIELDS = ("converts", "matmuls", "normalizes", "fused", "fallbacks",
          "weight_converts")
ARCHS = ("rwkv6-7b", "jamba-v0.1-52b")
# float32 elementwise recurrences plus sums in another order (XLA's dots
# vs the port's fixed trees and bmm_rows): a few ulps of O(1) values
SSM_ATOL = 1e-5
NORM_ATOL = 1e-6
# |logit| is O(3): float paths differ by float32 rounding through the
# layers, the RNS path by a rare 8-bit requantization flip
LOGIT_ATOL = {"float": 5e-5, "rns9": 5e-3}
STATE_ATOL = 1e-4
FUSED = dict(resident_weights=True, rns_defer=True)
# each path: (RNS on, the JAX engine's overrides, the port's)
PATHS = {"float": (False, {}, {}),
         "rns9": (True, {}, {}),
         "fused": (True, dict(FUSED, rns_backend="pallas_fused_interpret"),
                   dict(FUSED, rns_backend="cuda_fused"))}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _put(module, names, tree):
    """Fill ``module``'s parameters from a JAX layer dict (numpy)."""
    with torch.no_grad():
        params = dict(module.named_parameters())
        for name, path in names.items():
            v = tree
            for k in path:
                v = v[k]
            params[name].copy_(_t(v))
    return module


def _rng_x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


# ------------------------------------------------------------- Mamba -----
MCFG = dict(d_state=4, d_conv=4, expand=2, chunk=16)


@pytest.fixture(scope="module")
def mamba():
    from repro_torch.models.params import _MAMBA

    jcfg = jssm.SSMConfig(kind="mamba", **MCFG)
    jp, _ = jssm.init_mamba(jax.random.PRNGKey(3), 32, jcfg)
    # a nonzero conv bias, so the bias path is exercised
    jp = dict(jp, conv_b=jnp.asarray(_rng_x(9, (64,), 0.1)))
    cfg = ssm.SSMConfig(kind="mamba", **MCFG)
    m = _put(ssm.Mamba(32, cfg, device="cpu"), _MAMBA, _np_tree(jp))
    return jcfg, jp, cfg, m


@pytest.mark.parametrize("T", [1, 5, 40])
@pytest.mark.parametrize("state", [False, True])
def test_mamba_seq_matches_jax(mamba, T, state):
    """``mamba_seq`` over T tokens (40: two whole chunks and a partial
    one), from zeros or from a carried state: y, h_last and the conv
    tail within SSM_ATOL of JAX's."""
    jcfg, jp, cfg, m = mamba
    x = _rng_x(1, (2, T, 32))
    h0 = _rng_x(2, (2, 64, 4), 0.5) if state else None
    c0 = _rng_x(4, (2, 3, 64)) if state else None
    jy, (jh, jtail) = jssm.mamba_seq(
        jp, jnp.asarray(x), jcfg, h0=None if h0 is None else jnp.asarray(h0),
        conv0=None if c0 is None else jnp.asarray(c0))
    y, (h, tail) = ssm.mamba_seq(m, _t(x), cfg,
                                 h0=None if h0 is None else _t(h0),
                                 conv0=None if c0 is None else _t(c0))
    for got, want in ((y, jy), (h, jh), (tail, jtail)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=SSM_ATOL)


@pytest.mark.parametrize("zero_state", [True, False])
def test_mamba_step_matches_jax(mamba, zero_state):
    """One decode token against a zero or a carried state: JAX pads it to
    a whole chunk of identity steps, the port runs the one step."""
    jcfg, jp, cfg, m = mamba
    x = _rng_x(5, (3, 1, 32))
    h0 = np.zeros((3, 64, 4), np.float32) if zero_state else \
        _rng_x(6, (3, 64, 4), 0.5)
    c0 = np.zeros((3, 3, 64), np.float32) if zero_state else \
        _rng_x(7, (3, 3, 64))
    jy, (jh, jtail) = jssm.mamba_step(jp, jnp.asarray(x), jcfg,
                                      (jnp.asarray(h0), jnp.asarray(c0)))
    y, (h, tail) = ssm.mamba_step(m, _t(x), cfg, (_t(h0), _t(c0)))
    for got, want in ((y, jy), (h, jh), (tail, jtail)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=SSM_ATOL)


@pytest.mark.parametrize("n,pad", [(1, 255), (5, 11), (33, 223)])
def test_scan_without_padding_equals_padded(n, pad):
    """JAX pads a chunk with identity steps (a = 1, bx = 0); the port's
    scan skips them.  Every real entry, and the last padded entry
    against the last real one, are bit-equal, so the skip changes no
    value."""
    g = np.random.default_rng(n)
    a = torch.from_numpy(g.uniform(0.5, 1.0, (n, 2, 3)).astype(np.float32))
    b = torch.from_numpy(g.standard_normal((n, 2, 3)).astype(np.float32))
    ap = torch.cat([a, torch.ones((pad, 2, 3))])
    bp = torch.cat([b, torch.zeros((pad, 2, 3))])
    sa, sb = ssm.associative_scan(a, b)
    pa, pb = ssm.associative_scan(ap, bp)
    assert torch.equal(sa, pa[:n]) and torch.equal(sb, pb[:n])
    assert torch.equal(sa[-1], pa[-1]) and torch.equal(sb[-1], pb[-1])
    # and JAX's own scan on the padded chunk gives the same prefixes
    ja, jb = jax.lax.associative_scan(
        lambda l, r: (r[0] * l[0], r[0] * l[1] + r[1]),
        (jnp.asarray(ap.numpy()), jnp.asarray(bp.numpy())), axis=0)
    np.testing.assert_allclose(sb.numpy(), np.asarray(jb)[:n], rtol=0,
                               atol=SSM_ATOL)
    np.testing.assert_allclose(sa.numpy(), np.asarray(ja)[:n], rtol=0,
                               atol=SSM_ATOL)


# ------------------------------------------------------------ RWKV-6 -----
def _rwkv_pair(impl):
    from repro_torch.models.params import _RWKV

    kw = dict(kind="rwkv6", head_dim=8, chunk=16, impl=impl)
    jcfg = jssm.SSMConfig(**kw)
    jp, _ = jssm.init_rwkv6(jax.random.PRNGKey(4), 32, jcfg, 48)
    # nonzero norm biases and scales, so the per-head norm's affine part
    # is exercised
    jp = dict(jp, ln_x={"scale": jnp.asarray(1 + _rng_x(10, (32,), 0.1)),
                        "bias": jnp.asarray(_rng_x(11, (32,), 0.1))})
    cfg = ssm.SSMConfig(**kw)
    m = _put(ssm.RWKV6(32, cfg, 48, device="cpu"), _RWKV, _np_tree(jp))
    return jcfg, jp, cfg, m


@pytest.mark.parametrize("T", [1, 7, 40])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("impl", ["scan", "chunked"])
def test_rwkv6_timemix_matches_jax(impl, state, T):
    """``rwkv6_timemix`` stepwise and in the chunked (GLA) form, from
    zeros or a carried (S, previous token), over 1 (a decode step: JAX
    pads it to a chunk), 7 and 40 tokens: y, S and x_last within
    SSM_ATOL."""
    jcfg, jp, cfg, m = _rwkv_pair(impl)
    x = _rng_x(12, (2, T, 32))
    st = (_rng_x(13, (2, 4, 8, 8), 0.3), _rng_x(14, (2, 1, 32))) \
        if state else None
    jy, (jS, jx) = jssm.rwkv6_timemix(
        jp, jnp.asarray(x), jcfg,
        state=None if st is None else tuple(map(jnp.asarray, st)))
    y, (S, xl) = ssm.rwkv6_timemix(
        m, _t(x), cfg, state=None if st is None else tuple(map(_t, st)))
    for got, want in ((y, jy), (S, jS), (xl, jx)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=SSM_ATOL)


@pytest.mark.parametrize("state", [False, True])
def test_rwkv6_channelmix_matches_jax(state):
    jcfg, jp, cfg, m = _rwkv_pair("scan")
    x = _rng_x(15, (2, 6, 32))
    st = _rng_x(16, (2, 1, 32)) if state else None
    jy, jx = jssm.rwkv6_channelmix(
        jp, jnp.asarray(x), state=None if st is None else jnp.asarray(st))
    y, xl = ssm.rwkv6_channelmix(m, _t(x),
                                 state=None if st is None else _t(st))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                               atol=SSM_ATOL)
    np.testing.assert_array_equal(xl.numpy(), np.asarray(jx))


def test_layernorm_matches_jax():
    x = _rng_x(17, (3, 5, 96), 2.0) + 0.7
    scale, bias = 1 + _rng_x(18, (96,), 0.2), _rng_x(19, (96,), 0.2)
    want = j_layernorm({"scale": jnp.asarray(scale), "bias":
                        jnp.asarray(bias)}, jnp.asarray(x))
    got = layernorm(_t(scale), _t(bias), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=NORM_ATOL)


def test_init_scales_match_jax():
    """``init_mamba`` / ``init_rwkv6``: JAX's fixed values exactly (A_log,
    D, w0), its random ones at its scales."""
    cfg = ssm.SSMConfig(kind="mamba", d_state=16)
    m = ssm.init_mamba(256, cfg, seed=1, device="cpu")
    jp, _ = jssm.init_mamba(jax.random.PRNGKey(1), 256,
                            jssm.SSMConfig(kind="mamba", d_state=16))
    np.testing.assert_array_equal(m.A_log.numpy(), np.asarray(jp["A_log"]))
    np.testing.assert_array_equal(m.D.numpy(), np.asarray(jp["D"]))
    assert abs(float(m.conv_w.std()) - 0.2) < 0.01
    assert abs(float(m.in_proj.std()) * 16 - 1) < 0.02
    dt = torch.nn.functional.softplus(m.dt_proj_b)
    assert 1e-3 <= float(dt.min()) and float(dt.max()) <= 1e-1 + 1e-6
    r = ssm.init_rwkv6(256, ssm.SSMConfig(kind="rwkv6", head_dim=64), 512,
                       seed=1, device="cpu")
    jr, _ = jssm.init_rwkv6(jax.random.PRNGKey(1), 256,
                            jssm.SSMConfig(kind="rwkv6", head_dim=64), 512)
    np.testing.assert_array_equal(r.w0.numpy(), np.asarray(jr["w0"]))
    assert 0 <= float(r.mix.min()) and float(r.mix.max()) <= 1
    assert abs(float(r.u.std()) - 0.1) < 0.01
    assert abs(float(r.ck.std()) * 16 - 1) < 0.02


# ------------------------------------------------------ the smoke twins ---
@pytest.fixture(scope="module")
def twins():
    """{arch: (JAX config, JAX params, port config, port model)}."""
    out = {}
    for arch in ARCHS:
        jcfg = j_get_config(arch, smoke=True)
        jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)[0]
        cfg = get_config(arch, smoke=True)
        out[arch] = (jcfg, jparams, cfg, params_from_jax(
            _np_tree(jparams), cfg, device="cpu"))
    return out


def _rns(jcfg, cfg, on):
    if not on:
        return jcfg, cfg
    return (dataclasses.replace(jcfg, rns=JRnsDotConfig(profile="rns9", qx=8,
                                                        qw=8),
                                rns_targets="mlp"),
            dataclasses.replace(cfg, rns=RnsDotConfig(profile="rns9", qx=8,
                                                      qw=8),
                                rns_targets="mlp"))


def _retarget(model, cfg):
    m = copy.deepcopy(model)
    m.cfg = cfg
    return m


def _layer_planes(jcache, cfg, name, lt):
    """JAX's period-stacked cache plane ``name`` in the port's layout:
    [layers of type ``lt``, B, ...]."""
    p = cfg.period
    return np.stack([np.asarray(jcache[f"l{i % p}"][name])[i // p]
                     for i, t in enumerate(cfg.layer_types) if t == lt])


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_fills_every_leaf(twins, arch):
    """Every JAX leaf lands in its port parameter (``params_from_jax``
    checks every entry of every leaf itself), the counts agree, and the
    port has no parameter JAX lacks."""
    jcfg, jparams, cfg, model = twins[arch]
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert sum(int(np.prod(v.shape)) for _, v in leaves) == sum(
        p.numel() for p in model.parameters())
    assert cfg.period == jcfg.period
    p = cfg.period
    for i, blk in enumerate(model.blocks):
        lp = jparams["blocks"][f"l{i % p}"]
        if hasattr(blk, "mamba"):
            np.testing.assert_array_equal(
                blk.mamba.dt_proj_b.numpy(),
                np.asarray(lp["mamba"]["dt_proj"]["b"][i // p]))
        if hasattr(blk, "rwkv"):
            np.testing.assert_array_equal(
                blk.rwkv.ln_cm.bias.numpy(),
                np.asarray(lp["rwkv"]["ln_cm"]["bias"][i // p]))
            np.testing.assert_array_equal(
                blk.rwkv.u.numpy(), np.asarray(lp["rwkv"]["u"][i // p]))
            assert not hasattr(blk, "ln2")
    tree = _np_tree(jparams)
    tree["blocks"]["l0"]["extra"] = np.zeros((jcfg.n_layers // p, 2))
    with pytest.raises(ValueError, match="landed nowhere"):
        params_from_jax(tree, cfg, device="cpu")


@pytest.mark.parametrize("arch,path", [("rwkv6-7b", "float"),
                                       ("rwkv6-7b", "rns9"),
                                       ("jamba-v0.1-52b", "float")])
def test_prefill_decode_logits_match_jax(twins, arch, path):
    """``prefill`` of a [2, 40] batch (two chunks of the twins' 32) and
    two ``decode_step``s: logits within LOGIT_ATOL of JAX's with the same
    argmax; every cache plane (K/V and the recurrent states) within
    STATE_ATOL."""
    jcfg, jparams, cfg, model = twins[arch]
    jcfg, cfg = _rns(jcfg, cfg, path != "float")
    m = _retarget(model, cfg)
    toks = np.random.default_rng(5).integers(1, cfg.vocab, (2, 40))
    jl, jc = jax.jit(functools.partial(JM.prefill, cache_dtype=jnp.float32),
                     static_argnums=(1, 3))(
        jparams, jcfg, {"tokens": jnp.asarray(toks)}, 48)
    lg, c = M.prefill(m, cfg, torch.from_numpy(toks), 48)
    jdecode = jax.jit(JM.decode_step, static_argnums=(1,))
    for _ in range(2):
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGIT_ATOL[path])
        nxt = np.asarray(jl).argmax(-1)[:, None]
        np.testing.assert_array_equal(lg.argmax(-1).numpy(), nxt[:, 0])
        jl, jc = jdecode(jparams, jcfg, jnp.asarray(nxt), jc)
        lg = M.decode_step(m, cfg, torch.from_numpy(nxt), c)
    for lt, names in M.PLANES.items():
        for name in names if lt in cfg.layer_types else ():
            got = getattr(c, name).numpy()
            want = _layer_planes(jc, cfg, name, lt)
            if name not in M.STATE_PLANES:
                got = got[:, :, :want.shape[2]]
            np.testing.assert_allclose(got, want, rtol=0, atol=STATE_ATOL)


def _jax_layer_cache(cache, cfg, i, slot):
    """Layer ``i``'s part of the port's dense cache as JAX's per-layer
    cache dict (numpy copies)."""
    names = M.PLANES[cfg.layer_types[i]]
    out = {n: jnp.asarray(getattr(cache, n)[slot].numpy().copy())
           for n in names}
    out["lengths"] = jnp.asarray(cache.lengths.numpy().astype(np.int32))
    return out


def test_layers_match_jax_on_the_ports_inputs(twins):
    """The jamba twin on per-op rns9, every layer against JAX's
    ``_apply_layer`` on the same inputs -- the port's hidden state and,
    when decoding, its cache planes: a [2, 40] prefill and two decode
    steps, each layer's output and new state within SSM_ATOL, the logits
    of the port's last hidden state within SSM_ATOL.  End to end, float
    noise of a few ulps (sums in another order than XLA's) flips an 8-bit
    requantization in the twin's eight layers, which moves its logits by
    up to 0.04 (ROADMAP C.14), so this path is held layer by layer."""
    from repro.models import transformer as JT
    from repro.models.model import _logits as j_logits
    from repro_torch.core.quantize import token_mask
    from repro.core.quantize import token_mask as j_token_mask
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import embed

    eng, jeng = _engines(twins, "jamba-v0.1-52b", "rns9", max_cache=48,
                         max_new_tokens=2)
    m, cfg, jcfg, jp = eng.model, eng.cfg, jeng.cfg, jeng.params
    p, slots = cfg.period, T.layer_slots(cfg)
    toks = np.random.default_rng(5).integers(1, cfg.vocab, (2, 40))
    cache = M.make_cache(cfg, 2, 48, device="cpu")
    step_toks = [toks] + [np.random.default_rng(s).integers(
        1, cfg.vocab, (2, 1)) for s in (6, 7)]
    for step, tk in enumerate(step_toks):
        mode = "prefill" if step == 0 else "decode"
        on = np.ones(tk.shape, bool) if step == 0 else None
        with token_mask(None if on is None else torch.from_numpy(on),
                        per_token=True), \
                j_token_mask(None if on is None else jnp.asarray(on),
                             per_token=True):
            h = embed(m.embed, torch.from_numpy(tk))
            ys = []
            for i, blk in enumerate(m.blocks):
                lp = jax.tree.map(lambda a: a[i // p],
                                  jp["blocks"][f"l{i % p}"])
                jc = (_jax_layer_cache(cache, cfg, i, slots[i])
                      if mode == "decode" else None)
                jh, jnew, jpre, _ = JT._apply_layer(
                    lp, jnp.asarray(h.numpy()), jcfg, cfg.layer_types[i],
                    cfg.mlp_types[i], mode=mode, positions=None,
                    kv_mask=None, enc_out=None, cache=jc)
                h, planes, _ = T._apply_layer(blk, h, cfg, mode=mode,
                                              cache=cache, slot=slots[i])
                np.testing.assert_allclose(h.numpy(), np.asarray(jh),
                                           rtol=0, atol=SSM_ATOL)
                if mode == "decode":
                    for n in M.PLANES[cfg.layer_types[i]]:
                        got = getattr(cache, n)[slots[i]].numpy()
                        np.testing.assert_allclose(
                            got, np.asarray(jnew[n]), rtol=0, atol=SSM_ATOL)
                else:
                    for got, want in zip(M._flat(planes), jax.tree.leaves(
                            jpre)):
                        np.testing.assert_allclose(
                            got.numpy(), np.asarray(want), rtol=0,
                            atol=SSM_ATOL)
                    ys.append(planes)
            lg = M._logits(m, h[:, -1:])
            np.testing.assert_allclose(
                lg.numpy(), np.asarray(j_logits(
                    jp, jcfg, jnp.asarray(h[:, -1:].numpy()))), rtol=0,
                atol=SSM_ATOL)
        if mode == "prefill":
            for n, planes in M.stack_planes(cfg, ys).items():
                dst = getattr(cache, n)
                if n in M.STATE_PLANES:
                    dst.copy_(planes)
                else:
                    dst[:, :, :40] = planes
            cache.lengths.fill_(40)
        else:
            cache.lengths += 1


def test_jamba_rns9_first_difference_is_one_requantization(twins):
    """Where C.14's end-to-end gap starts: the port's and JAX's layers,
    each fed its own previous output, stay within float noise (2e-6)
    through the twin's first two layers and layer 2's attention; at
    layer 2's MLP input exactly one of the [2, 40, 64] per-token 8-bit
    codes differs, by one step (row 0, token 3, channel 32: a value a
    few ulps from a rounding boundary of the grid)."""
    from repro.models import transformer as JT
    from repro.models.layers import norm as j_norm
    from repro.core.quantize import token_mask as j_token_mask
    from repro_torch.core.quantize import (absmax_scale,
                                           quantize_with_scale, token_mask)
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import embed

    jcfg, jparams, cfg, model = twins["jamba-v0.1-52b"]
    jcfg, cfg = _rns(jcfg, cfg, True)
    p, slots = cfg.period, T.layer_slots(cfg)
    toks = np.random.default_rng(5).integers(1, cfg.vocab, (2, 40))
    on = np.ones(toks.shape, bool)
    with token_mask(torch.from_numpy(on), per_token=True), \
            j_token_mask(jnp.asarray(on), per_token=True):
        h = embed(model.embed, torch.from_numpy(toks))
        jh = jnp.asarray(h.numpy())
        for i in range(3):
            lp = jax.tree.map(lambda a: a[i // p],
                              jparams["blocks"][f"l{i % p}"])
            mlp_type = cfg.mlp_types[i] if i < 2 else "none"
            jh = JT._apply_layer(lp, jh, jcfg, cfg.layer_types[i], mlp_type,
                                 mode="prefill", positions=None,
                                 kv_mask=None, enc_out=None, cache=None)[0]
            blk = model.blocks[i]
            if i < 2:
                h = T._apply_layer(blk, h, cfg, mode="prefill", cache=None,
                                   slot=slots[i])[0]
            else:
                h = h + T._mix(blk, blk.ln1(h), cfg, mode="prefill",
                               cache=None, slot=slots[i], packed=None,
                               rns_a=None, rns_m=cfg.rns)[0]
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0,
                                       atol=2e-6)
        x = model.blocks[2].ln2(h)
        jx = torch.from_numpy(np.array(j_norm(lp["ln2"], jh, cfg.norm)))
        codes = [quantize_with_scale(t, absmax_scale(t, 8), 8)
                 for t in (x, jx)]
    diff = (codes[0] - codes[1]).abs()
    assert diff.max() == 1
    assert torch.nonzero(diff).tolist() == [[0, 3, 32]]


def test_state_planes_round_to_the_cache_dtype_at_prefill(twins):
    """A bfloat16 cache: the prefill writes conv / x_tm / x_cm rounded
    to bfloat16 into the float32 state planes (JAX stores them at the
    cache dtype) and h / S unrounded; a decode step then keeps float32,
    as JAX's promoted state does -- the step's logits within LOGIT_ATOL
    of JAX's."""
    for arch in ARCHS:
        jcfg, jparams, cfg, model = twins[arch]
        toks = np.random.default_rng(8).integers(1, cfg.vocab, (1, 9))
        jl, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                            16, cache_dtype=jnp.bfloat16)
        lg, c = M.prefill(model, cfg, torch.from_numpy(toks), 16,
                          cache_dtype=torch.bfloat16)
        lt = "rwkv" if arch.startswith("rwkv") else "mamba"
        for name in M.PLANES[lt]:
            got = getattr(c, name)
            assert got.dtype == torch.float32
            want = _layer_planes(jc, cfg, name, lt)
            if name not in ("h", "S"):
                assert torch.equal(got, got.to(torch.bfloat16).float())
            np.testing.assert_allclose(got.numpy(),
                                       want.astype(np.float32), rtol=0,
                                       atol=STATE_ATOL)
        nxt = np.asarray(jl).argmax(-1)[:, None]
        jl2, _ = JM.decode_step(jparams, jcfg, jnp.asarray(nxt), jc)
        lg2 = M.decode_step(model, cfg, torch.from_numpy(nxt), c)
        np.testing.assert_allclose(lg2.numpy(), np.asarray(jl2), rtol=0,
                                   atol=LOGIT_ATOL["float"])


def _engines(twins, arch, path, **kw):
    """(port Engine, JAX Engine) on one path, the same weights."""
    jcfg, jparams, cfg, model = twins[arch]
    rns, jkw, pkw = PATHS[path]
    jcfg, cfg = _rns(jcfg, cfg, rns)
    return (Engine(_retarget(model, cfg), ServeConfig(**kw, **pkw),
                   device="cpu"),
            JEngine(jparams, jcfg, JServeConfig(**kw, **jkw)))


def _batch(vocab, B, T, seed):
    return np.random.default_rng(seed).integers(1, vocab, (B, T)).astype(
        np.int32)


ENGINE_CASES = [("rwkv6-7b", "float"), ("rwkv6-7b", "rns9"),
                ("jamba-v0.1-52b", "float"), ("jamba-v0.1-52b", "rns9"),
                ("jamba-v0.1-52b", "fused")]


@pytest.mark.parametrize("arch,path", ENGINE_CASES)
def test_bucketed_engine_equals_jax(twins, arch, path):
    """A batch of two 9-token prompts: on the float path JAX's batch
    tokens, and on every path each row equal to JAX's solo run of it (a
    row's tokens do not depend on its batch: per-row grids, ROADMAP C.11,
    and batch-invariant sums, C.10)."""
    eng, jeng = _engines(twins, arch, path, max_cache=24, max_new_tokens=6)
    prompts = _batch(twins[arch][2].vocab, 2, 9, seed=1)
    got = eng.generate(prompts)
    assert got.shape == (2, 6)
    if path == "float":
        np.testing.assert_array_equal(got, jeng.generate(prompts))
    for b in range(2):
        solo = eng.generate(prompts[b:b + 1])[0]
        np.testing.assert_array_equal(got[b], solo)
        want = jeng.generate(prompts[b:b + 1])[0]
        if (arch, path, b) == ("jamba-v0.1-52b", "fused", 1):
            # ROADMAP C.14: an 8-bit requantization flip from float-order
            # noise in decode step 4 of this row; every layer is held to
            # JAX's on the same inputs by
            # test_layers_match_jax_on_the_ports_inputs
            np.testing.assert_array_equal(solo[:4], want[:4])
            assert solo[4] != want[4]
        else:
            np.testing.assert_array_equal(solo, want)
    assert eng.captures() == {"prefill(2,9)": 0, "decode(2)": 0,
                              "prefill(1,9)": 0, "decode(1)": 0}


def test_bucketed_engine_freezes_rows_at_eos_like_jax(twins):
    """eos from row 0's stream: row 0 repeats it while its state goes on
    updating with the frozen token; the other row is unaffected -- JAX's
    batch tokens on the float path."""
    eng, _ = _engines(twins, "jamba-v0.1-52b", "float", max_cache=24,
                      max_new_tokens=8)
    prompts = _batch(twins["jamba-v0.1-52b"][2].vocab, 2, 7, seed=4)
    eos = int(eng.generate(prompts)[0, 2])
    eng, jeng = _engines(twins, "jamba-v0.1-52b", "float", max_cache=24,
                         max_new_tokens=8, eos_id=eos)
    got = eng.generate(prompts)
    assert (got[0, 2:] == eos).all()
    np.testing.assert_array_equal(got, jeng.generate(prompts))


@pytest.mark.parametrize("arch,path", [("rwkv6-7b", "rns9"),
                                       ("jamba-v0.1-52b", "rns9"),
                                       ("jamba-v0.1-52b", "fused")])
def test_rns_op_counts_equal_jax_times_periods(twins, arch, path):
    """JAX's tally traces its layer scan's body -- one period -- once, so
    the port's count of every layer's calls is JAX's times the periods
    (the twins: rwkv period 1 of 4 layers, jamba period 4 of 8)."""
    eng, jeng = _engines(twins, arch, path, max_cache=24, max_new_tokens=4)
    periods = eng.cfg.n_layers // eng.cfg.period
    assert periods == {"rwkv6-7b": 4, "jamba-v0.1-52b": 2}[arch]
    for B, T in ((1, 8), (2, 5)):
        theirs = jeng.rns_op_counts(B, T)
        assert eng.rns_op_counts(B, T).as_dict() == {
            f: getattr(theirs, f) * periods for f in FIELDS}


def test_jamba_resident_profiles_per_period_slot(twins):
    """The fused path with per-layer profiles on the jamba twin (period
    4, dense MLPs in slots 0 and 2): each dense MLP takes its period
    slot's profile and ``mag_bits``, JAX's (which encodes one stacked
    master a slot); the Mamba projections and the MoE's routed experts
    stay unencoded."""
    from repro_torch.models.resident import resident_profiles

    eng, jeng = _engines(twins, "jamba-v0.1-52b", "fused", max_cache=24,
                         per_layer_profiles=True)
    p = eng.cfg.period
    got = resident_profiles(eng.model)
    assert sorted(got) == [f"blocks.{i}.mlp" for i in range(0, 8, 2)]
    for i in range(0, eng.cfg.n_layers, 2):
        want = jeng.params["blocks"][f"l{i % p}"]["mlp"]["wi"]["w_res"]
        res = eng.model.blocks[i].mlp.resident("wi")
        assert (res.profile, res.mag_bits) == (want.profile, want.mag_bits)
    assert not any(n.endswith("_digits") for n, _ in
                   eng.model.blocks[1].named_buffers())


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_and_cli_refuse_with_jax_message(twins, arch):
    jcfg, jparams, cfg, model = twins[arch]
    scfg = dict(max_cache=32, page_size=8, max_seqs=2)
    with pytest.raises(NotImplementedError) as theirs:
        JContinuous(jparams, jcfg, JServeConfig(**scfg))
    with pytest.raises(NotImplementedError) as ours:
        ContinuousEngine(_retarget(model, cfg), ServeConfig(**scfg),
                         device="cpu")
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(SystemExit) as cut:
        cli.main(["--arch", arch, "--continuous", "--device", "cpu"])
    assert str(theirs.value) in str(cut.value.code)


def test_cli_serves_bucketed(capsys):
    """The CLI's default (bucketed) serve of the RWKV-6 twin on the CPU."""
    cli.main(["--arch", "rwkv6-7b", "--device", "cpu", "--batch", "2",
              "--prompt-len", "5", "--new", "3"])
    out = capsys.readouterr().out
    assert "rwkv6-7b" in out and "captures" in out


# ------------------------------------------------------------ on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels run "
                    "only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch,path", [("rwkv6-7b", "rns9"),
                                       ("jamba-v0.1-52b", "rns9"),
                                       ("jamba-v0.1-52b", "fused")])
def test_gpu_captured_equals_eager_and_cpu(cuda, twins, arch, path):
    """On the card: the captured bucketed Engine against the eager one
    (the same tokens, one capture a program), and the card's prefill
    logits (kernels) within 5e-3 of the CPU's (plain)."""
    jcfg, _, cfg, model = twins[arch]
    _, cfg = _rns(jcfg, cfg, True)
    kw = PATHS[path][2]
    prompts = _batch(cfg.vocab, 3, 9, seed=2)
    lg = {dev: M.prefill(_retarget(model, cfg).to(dev), cfg,
                         torch.from_numpy(prompts.astype(np.int64)).to(dev),
                         16)[0].cpu() for dev in ("cpu", "cuda")}
    torch.testing.assert_close(lg["cuda"], lg["cpu"], rtol=0, atol=5e-3)
    toks = {}
    for graphs in (False, True):
        eng = Engine(_retarget(model, cfg), ServeConfig(
            max_cache=24, max_new_tokens=6, **kw), device="cuda",
            graphs=graphs)
        toks[graphs] = eng.generate(prompts).tolist()
        if graphs:
            assert set(eng.captures().values()) == {1}
    assert toks[True] == toks[False]
