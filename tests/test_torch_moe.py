"""Mixture-of-Experts and the MoE families: the port against the JAX package.

``models/moe.py``'s ``moe_ffn`` (the gather dispatch) on the same weights
and inputs as ``repro.models.moe.moe_ffn``: routing (top-k ids, capacity
keep) equal exactly, dropless and with drops; ``y`` and ``aux`` within
the stated tolerances.  Then the full DeepSeek-V2 (MLA + MoE, untied
head) and Llama-4-Scout (GQA + MoE) smoke twins: ``params_from_jax``
leaf for leaf, prefill and decode logits against JAX's, and greedy
tokens equal through ``ContinuousEngine`` and the bucketed ``Engine``
with ``rns_ops`` the JAX engine's times the layers (ROADMAP C.3).  The
``gpu`` cases hold captured runs to eager ones and the card to the CPU.
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
from repro.models import moe as jmoe
from repro.models.layers import linear as j_linear
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import Engine as JBucketed
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.base import get_config
from repro_torch.core.rns_matmul import RnsDotConfig
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.params import params_from_jax
from repro_torch.serve.engine import ContinuousEngine, Engine, ServeConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ("deepseek-v2-236b", "llama4-scout-17b-a16e")
FIELDS = ("converts", "matmuls", "normalizes", "fused", "fallbacks",
          "weight_converts")
# float32 sums in another order (XLA vs PyTorch's fixed trees): a few
# ulps of |y| = O(1)
Y_ATOL = 2e-5
# |logit| is O(3); float paths differ by float32 rounding through 4
# layers, the RNS path by a rare 8-bit requantization flip
LOGIT_ATOL = {"float": 5e-5, "rns9": 5e-3}
SERVE = dict(max_cache=48, page_size=8, max_seqs=3, max_new_tokens=5)
PATHS = {"float": (None, {}, {}),
         "rns9": ("mlp", {}, {}),
         "fused": ("mlp", dict(resident_weights=True, rns_defer=True,
                               rns_backend="pallas_fused_interpret"),
                   dict(resident_weights=True, rns_defer=True,
                        rns_backend="cuda_fused"))}


def _rns(jcfg, cfg, targets):
    if targets is None:
        return jcfg, cfg
    return (dataclasses.replace(jcfg, rns=JRnsDotConfig(profile="rns9", qx=8,
                                                        qw=8),
                                rns_targets=targets),
            dataclasses.replace(cfg, rns=RnsDotConfig(profile="rns9", qx=8,
                                                      qw=8),
                                rns_targets=targets))


# ------------------------------------------------------------- moe_ffn ----
def _moe_pair(E, k, n_shared, capacity_factor, d=16, F=24, seed=0):
    jcfg = jmoe.MoEConfig(n_experts=E, top_k=k, d_ff_expert=F,
                          n_shared=n_shared, capacity_factor=capacity_factor)
    cfg = moe.MoEConfig(n_experts=E, top_k=k, d_ff_expert=F,
                        n_shared=n_shared, capacity_factor=capacity_factor)
    jp, _ = jmoe.init_moe(jax.random.PRNGKey(seed), d, jcfg)
    p = moe.MoE(d, cfg, device="cpu")
    with torch.no_grad():
        p.router.copy_(torch.from_numpy(np.asarray(jp["router"]["w"])))
        for name in ("wi", "wg", "wo"):
            getattr(p, name).copy_(torch.from_numpy(np.asarray(jp[name])))
            if n_shared:
                getattr(p.shared, name).copy_(torch.from_numpy(
                    np.asarray(jp["shared"][name]["w"])))
    return jcfg, jp, cfg, p


def _jax_routing(jp, x, jcfg):
    """JAX's top-k ids and capacity keep for x [B, S, d]."""
    B, S, _ = x.shape
    E, k = jcfg.n_experts, jcfg.top_k
    C = max(1, int(S * k / E * jcfg.capacity_factor))
    probs = jax.nn.softmax(j_linear(jp["router"], x).astype(jnp.float32), -1)
    _, top_i = jax.lax.top_k(probs, k)
    _, _, keep = jax.vmap(
        lambda gi: jmoe._dispatch_one_row(gi, S, E, C, k))(top_i)
    return np.asarray(top_i), np.asarray(keep)


# (E, top_k, n_shared, capacity_factor, B, S): dropless (JAX's smoke
# twin's factor), DeepSeek-V2's top-6 with drops, Scout's top-1
MOE_CASES = {
    "dropless": (4, 2, 1, 8.0, 2, 12),
    "drops": (4, 2, 0, 0.5, 2, 12),
    "top6_drops": (8, 6, 2, 0.6, 1, 16),
    "top1_shared": (4, 1, 1, 1.25, 3, 7),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_matches_jax(case):
    """Routing ids and capacity keep equal JAX's exactly (drops where the
    case has them), y within Y_ATOL, aux within 1e-6."""
    E, k, n_shared, cf, B, S = MOE_CASES[case]
    jcfg, jp, cfg, p = _moe_pair(E, k, n_shared, cf, seed=len(case))
    x = np.random.default_rng(3).standard_normal((B, S, 16)).astype(
        np.float32)
    top_i, _, keep, _ = moe.route(p, torch.from_numpy(x), cfg)
    j_top_i, j_keep = _jax_routing(jp, jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(top_i.numpy(), j_top_i)
    np.testing.assert_array_equal(keep.numpy(), j_keep)
    assert bool(keep.all()) == (case == "dropless")
    y, aux = moe.moe_ffn(p, torch.from_numpy(x), cfg)
    jy, jaux = jax.jit(jmoe.moe_ffn, static_argnums=(2,))(
        jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                               atol=Y_ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)


def test_moe_ties_take_the_lower_expert_and_rns_shared():
    """Equal router probabilities (a zero router): JAX's top_k takes the
    lower ids, as the port's stable sort does; the shared MLP on rns9
    (the routed experts stay float) within Y_ATOL of JAX's."""
    jcfg, jp, cfg, p = _moe_pair(4, 2, 1, 8.0, seed=5)
    jp = dict(jp, router={"w": jnp.zeros_like(jp["router"]["w"])})
    with torch.no_grad():
        p.router.zero_()
    x = np.random.default_rng(4).standard_normal((1, 6, 16)).astype(
        np.float32)
    top_i, top_p, _, _ = moe.route(p, torch.from_numpy(x), cfg)
    assert (top_i.numpy() == [0, 1]).all()
    assert (top_p.numpy() == 0.5).all()
    y, _ = moe.moe_ffn(p, torch.from_numpy(x), cfg,
                       rns=RnsDotConfig(profile="rns9", qx=8, qw=8))
    jy, _ = jax.jit(functools.partial(
        jmoe.moe_ffn, rns=JRnsDotConfig(profile="rns9", qx=8, qw=8)),
        static_argnums=(2,))(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                               atol=Y_ATOL)


def test_moe_init_scales_and_scatter_refused():
    """``init_moe`` draws JAX's scales (wi/wg 1/sqrt(d), wo 1/sqrt(F));
    ``dispatch="scatter"`` is no longer refused: it computes JAX's
    scatter combine (the k picks in rank order), equal to the gather
    dispatch within float order; an unknown dispatch raises."""
    cfg = moe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=256, n_shared=1)
    p = moe.init_moe(64, cfg, seed=1, device="cpu")
    for name, d_in in (("wi", 64), ("wg", 64), ("wo", 256), ("router", 64)):
        std = float(getattr(p, name).std())
        assert abs(std * np.sqrt(d_in) - 1) < 0.05, name
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 6, 64)).astype(np.float32))
    y, _ = moe.moe_ffn(p, x, dataclasses.replace(cfg, dispatch="scatter"))
    yg, _ = moe.moe_ffn(p, x, cfg)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    torch.testing.assert_close(y, yg, rtol=0, atol=Y_ATOL)
    with pytest.raises(ValueError, match="dispatch"):
        moe.moe_ffn(p, x, dataclasses.replace(cfg, dispatch="other"))


# ---------------------------------------------------- the smoke twins ----
@pytest.fixture(scope="module")
def twins():
    """{arch: (JAX config, JAX params, port config, port model)}."""
    out = {}
    for arch in ARCHS:
        jcfg = j_get_config(arch, smoke=True)
        jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)[0]
        cfg = get_config(arch, smoke=True)
        out[arch] = (jcfg, jparams, cfg, params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    return out


def _retarget(model, cfg):
    m = copy.deepcopy(model)
    m.cfg = cfg
    return m


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_fills_every_leaf(twins, arch):
    """Every JAX leaf lands in its port parameter (period-stacked leaves
    per layer), and the port has no parameter JAX lacks."""
    jcfg, jparams, cfg, model = twins[arch]
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    n_jax = sum(int(np.prod(v.shape)) for _, v in leaves)
    assert n_jax == sum(p.numel() for p in model.parameters())
    assert cfg.period == jcfg.period == 1
    blocks = jparams["blocks"]["l0"]
    np.testing.assert_array_equal(model.lm_head.numpy(),
                                  np.asarray(jparams["lm_head"]["w"]))
    for i, blk in enumerate(model.blocks):
        np.testing.assert_array_equal(blk.moe.wo.numpy(),
                                      np.asarray(blocks["moe"]["wo"][i]))
        np.testing.assert_array_equal(
            blk.moe.shared.wg.numpy(),
            np.asarray(blocks["moe"]["shared"]["wg"]["w"][i]))
        np.testing.assert_array_equal(
            blk.attn.wo.numpy(), np.asarray(blocks["attn"]["wo"]["w"][i]))
    if arch.startswith("deepseek"):
        np.testing.assert_array_equal(
            model.blocks[3].attn.kv_norm.scale.numpy(),
            np.asarray(blocks["attn"]["kv_norm"]["scale"][3]))


@pytest.mark.parametrize("arch,path", [("deepseek-v2-236b", "float"),
                                       ("deepseek-v2-236b", "rns9"),
                                       ("llama4-scout-17b-a16e", "rns9")])
def test_prefill_decode_logits_match_jax(twins, arch, path):
    """``prefill`` of a [2, 10] batch into a dense cache and two
    ``decode_step``s: logits within LOGIT_ATOL of JAX's, the same
    argmax; the cache planes (K/V or MLA latents) within 1e-4."""
    jcfg, jparams, cfg, model = twins[arch]
    jcfg, cfg = _rns(jcfg, cfg, PATHS[path][0])
    m = _retarget(model, cfg)
    toks = np.random.default_rng(5).integers(1, cfg.vocab, (2, 10))
    jl, jc = jax.jit(functools.partial(JM.prefill, cache_dtype=jnp.float32),
                     static_argnums=(1, 3))(
        jparams, jcfg, {"tokens": jnp.asarray(toks)}, 16)
    lg, c = M.prefill(m, cfg, torch.from_numpy(toks), 16)
    tol = LOGIT_ATOL[path]
    jdecode = jax.jit(JM.decode_step, static_argnums=(1,))
    for _ in range(2):
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=tol)
        nxt = np.asarray(jl).argmax(-1)[:, None]
        np.testing.assert_array_equal(lg.argmax(-1).numpy(), nxt[:, 0])
        jl, jc = jdecode(jparams, jcfg, jnp.asarray(nxt), jc)
        lg = M.decode_step(m, cfg, torch.from_numpy(nxt), c)
    for name in M.plane_shapes(cfg):
        np.testing.assert_allclose(getattr(c, name).numpy(),
                                   np.asarray(jc["l0"][name]), rtol=0,
                                   atol=1e-4)


def _prompts(vocab, lens=(5, 21, 13, 13), seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (t,)).astype(np.int32) for t in lens]


# (arch, path) pairs served through the engines
ENGINE_CASES = [("deepseek-v2-236b", "float"), ("deepseek-v2-236b", "rns9"),
                ("deepseek-v2-236b", "fused"),
                ("llama4-scout-17b-a16e", "float"),
                ("llama4-scout-17b-a16e", "rns9")]


@pytest.fixture(scope="module")
def jax_serves(twins):
    """The JAX ContinuousEngine's (results, stats), once per case."""
    out = {}
    for arch, path in ENGINE_CASES:
        jcfg, jparams, cfg, _ = twins[arch]
        jcfg, _ = _rns(jcfg, cfg, PATHS[path][0])
        out[arch, path] = JEngine(jparams, jcfg, JServeConfig(
            **SERVE, **PATHS[path][1])).run(_prompts(cfg.vocab))
    return out


@pytest.mark.parametrize("arch,path", ENGINE_CASES)
def test_engines_match_jax(twins, jax_serves, arch, path):
    """Four requests of 5-21 tokens through the phase-barrier
    ``ContinuousEngine``: JAX's greedy tokens, every step's rns_ops the
    JAX engine's times the layers.  The bucketed ``Engine`` on the two
    13-token prompts as one [2, 13] batch: those rows' tokens (a JAX
    continuous row is its solo run, as a bucketed row is the port's:
    per-row grids, ROADMAP C.11)."""
    jcfg, jparams, cfg, model = twins[arch]
    _, cfg = _rns(jcfg, cfg, PATHS[path][0])
    kw = PATHS[path][2]
    jres, jstats = jax_serves[arch, path]
    prompts = _prompts(cfg.vocab)
    eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(**SERVE, **kw),
                           device="cpu")
    res, stats = eng.run(prompts)
    want = {r: t.tolist() for r, t in jres.items()}
    assert {r: t.tolist() for r, t in res.items()} == want
    assert len(stats["steps"]) == len(jstats["steps"])
    for s, js in zip(stats["steps"], jstats["steps"]):
        ops = {f: getattr(js["rns_ops"], f) * cfg.n_layers for f in FIELDS}
        assert s["rns_ops"].as_dict() == ops
    beng = Engine(_retarget(model, cfg), ServeConfig(
        max_cache=24, max_new_tokens=SERVE["max_new_tokens"], **kw),
        device="cpu")
    out = beng.generate(np.stack(prompts[2:]))
    assert out.tolist() == [want[2], want[3]]


def test_untied_head_and_unported_families_refused(twins):
    """The untied head is a float ``lm_head`` [d, V]; the configs the
    port refused before slice 3d (non-causal, enc-dec, frontend,
    sinusoidal positions) now build, and ``ContinuousEngine`` refuses the
    enc-dec, frontend and non-causal ones with the JAX engine's
    messages."""
    jcfg, jparams, cfg, model = twins["deepseek-v2-236b"]
    assert model.lm_head.shape == (cfg.d_model, cfg.vocab)
    base = get_config("smollm-135m", smoke=True)
    jbase = j_get_config("smollm-135m", smoke=True)
    scfg = dict(max_cache=32, page_size=8, max_seqs=2)
    for over in (dict(causal=False),
                 dict(enc_dec=True, n_enc_layers=2, n_frontend_tokens=8),
                 dict(frontend="vision", n_frontend_tokens=8),
                 dict(pos_emb="sinusoidal")):
        m = M.Model(dataclasses.replace(base, **over), device="cpu")
        assert len(m.blocks) == base.n_layers
        if over.get("enc_dec"):
            assert len(m.enc_blocks) == 2 and hasattr(m.blocks[0], "xattn")
        if "pos_emb" in over:
            continue
        with pytest.raises(NotImplementedError) as theirs:
            JEngine({}, dataclasses.replace(jbase, **over),
                    JServeConfig(**scfg))
        with pytest.raises(NotImplementedError) as ours:
            ContinuousEngine(m, ServeConfig(**scfg), device="cpu")
        assert str(ours.value) == str(theirs.value)


# ------------------------------------------------------------ on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels run "
                    "only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["rns9", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gpu_captured_equals_eager_and_cpu(cuda, twins, arch, path):
    """On the card: the captured ContinuousEngine and bucketed Engine
    against eager ones (the same tokens, one capture a program), and the
    card's prefill logits (kernels) within 5e-3 of the CPU's (plain)."""
    jcfg, _, cfg, model = twins[arch]
    _, cfg = _rns(jcfg, cfg, PATHS[path][0])
    kw = PATHS[path][2]
    prompts = _prompts(cfg.vocab)
    toks = torch.from_numpy(np.stack([p[:5] for p in prompts]).astype(
        np.int64))
    lg = {dev: M.prefill(_retarget(model, cfg).to(dev), cfg, toks.to(dev),
                         16)[0].cpu() for dev in ("cpu", "cuda")}
    torch.testing.assert_close(lg["cuda"], lg["cpu"], rtol=0, atol=5e-3)
    toks = {}
    for dev, graphs in (("cuda", False), ("cuda", True)):
        eng = ContinuousEngine(_retarget(model, cfg),
                               ServeConfig(**SERVE, **kw), device=dev,
                               graphs=graphs)
        res, _ = eng.run(prompts)
        beng = Engine(_retarget(model, cfg), ServeConfig(
            max_cache=16, max_new_tokens=5, **kw), device=dev,
            graphs=graphs)
        out = beng.generate(np.stack([p[:5] for p in prompts]))
        toks[dev, graphs] = ({r: t.tolist() for r, t in res.items()},
                             out.tolist())
        if graphs:
            assert set(eng.captures().values()) == {1}
            assert set(beng.captures().values()) == {1}
    assert toks["cuda", True] == toks["cuda", False]
