"""DeepSeek-V2's multi-head latent attention (MLA): the port against the JAX
package on the smoke twin's shapes.

Each MLA function of ``models/attention.py`` -- the projections, the
expanded prefill, the absorbed decode over a dense cache, a paged cache,
a speculative-verify window and the packed mixed step -- on the same
weights, inputs and caches as JAX's, on the float path and with
``rns_targets="all"`` (the projections through the RNS datapath: the
first shared conversion's products bit-equal to JAX's).  Then JAX's own
MLA serving cases on its model without experts (``mlp_types=("dense",)
* 4, moe=None``): phase-barrier, chunked, prefix caching with a COW
split, speculative, windowed and bucketed -- JAX's greedy tokens and
step stats, ``rns_ops`` JAX's times the layers (ROADMAP C.3) -- and the
engine's refusals with JAX's messages.  The ``gpu`` cases hold captured
runs to eager ones on the card.
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
from repro.models import attention as jattn
from repro.models import model as JM
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import Engine as JBucketed
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.base import get_config
from repro_torch.core.rns_matmul import RnsDotConfig
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.models.params import params_from_jax
from repro_torch.serve import kv_cache as kv
from repro_torch.serve.engine import ContinuousEngine, Engine, ServeConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIELDS = ("converts", "matmuls", "normalizes", "fused", "fallbacks",
          "weight_converts")
# float32 through the same math in another summation order (values O(1))
FLOAT_ATOL = 2e-5
# rns_targets="all": every projection requantizes to 8 bits, so a float
# difference of an ulp upstream can flip one rounding (a step of ~1/128
# of a row's absmax)
RNS_ATOL = 3e-2
STAT_KEYS = ("step", "admitted", "preempted", "finished", "active",
             "waiting", "new_tokens", "decoded", "decode_rows",
             "page_utilization", "cow_splits", "cache_hit_tokens",
             "pages_allocated_total", "pages_shared_total",
             "pages_window_evicted", "prefill_tokens", "decode_tokens")
CHUNKED = dict(max_cache=48, max_seqs=4, page_size=8, max_new_tokens=6,
               chunked_prefill=True, token_budget=16, chunk_size=8)


def _mla_cfgs():
    """DeepSeek-V2's smoke twin without experts, as JAX's MLA serving
    tests build it."""
    over = dict(mlp_types=("dense",) * 4, moe=None)
    return (dataclasses.replace(j_get_config("deepseek-v2-236b", smoke=True),
                                **over),
            dataclasses.replace(get_config("deepseek-v2-236b", smoke=True),
                                **over))


@pytest.fixture(scope="module")
def mla_model():
    jcfg, cfg = _mla_cfgs()
    jparams = JM.init_model(jax.random.PRNGKey(1), jcfg)[0]
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jcfg, jparams, cfg, model


def _rns(jcfg, cfg, targets):
    if targets is None:
        return jcfg, cfg
    return (dataclasses.replace(jcfg, rns=JRnsDotConfig(profile="rns9", qx=8,
                                                        qw=8),
                                rns_targets=targets),
            dataclasses.replace(cfg, rns=RnsDotConfig(profile="rns9", qx=8,
                                                      qw=8),
                                rns_targets=targets))


def _retarget(model, cfg):
    m = copy.deepcopy(model)
    m.cfg = cfg
    return m


def _jit(fn, **static):
    """``fn`` of (params, x, cfg, ...) jitted with cfg and the keyword
    options static: one XLA compile a function instead of one a
    primitive and shape."""
    return jax.jit(functools.partial(fn, **static), static_argnums=(2,))


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i"
                            else a.copy())


# ---------------------------------------------------------- functions ----
@pytest.mark.parametrize("case", ["float", "float_window", "rns_all"])
def test_mla_functions_match_jax(mla_model, case):
    """Layer 0's MLA: the projections, the expanded prefill, the absorbed
    decode over a dense cache, a paged cache and a [R, 3] verify window,
    and the packed step (decode lanes absorbed, chunk lanes expanded),
    against JAX's on the same weights, inputs and caches (random latents
    on the pages, the trash page included); the written latents where
    JAX writes them.  Outputs within FLOAT_ATOL (float) or RNS_ATOL.  On
    the RNS path ``mla_qkv`` and the dense-cache decode, whose math the
    prefill and the paged decode hold, are left to the float cases and
    to the bucketed engine's test."""
    jcfg, jparams, cfg, model = mla_model
    if case == "float_window":
        jcfg = dataclasses.replace(jcfg, attn_window=5)
        cfg = dataclasses.replace(cfg, attn_window=5)
    jcfg, cfg = _rns(jcfg, cfg, "all" if case == "rns_all" else None)
    jrns, rns = jcfg.rns, cfg.rns
    tol = RNS_ATOL if rns is not None else FLOAT_ATOL
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["l0"]["attn"])
    p = model.blocks[0].attn
    m = cfg.mla
    rng = np.random.default_rng(7)
    B, T, d = 2, 11, cfg.d_model
    x = rng.standard_normal((B, T, d)).astype(np.float32)

    def close(ours, theirs, atol=tol):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=0, atol=atol)

    # the down projections share one conversion of x: on the RNS path
    # the same inputs give bit-equal products
    ours = attn._multi_proj(_t(x), (p.wdq, p.wdkv, p.wkr), rns)
    theirs = jax.jit(jattn._multi_proj, static_argnums=(2,))(
        jnp.asarray(x), (jp["wdq"], jp["wdkv"], jp["wkr"]), jrns)
    for a, b in zip(ours, theirs):
        close(a, b, atol=0 if rns is not None else FLOAT_ATOL)
    if rns is None:         # on the RNS path: mla_attend's math
        pos = np.broadcast_to(np.arange(T), (B, T))
        q, k, v, (ckv, kr) = attn.mla_qkv(p, _t(x), cfg, _t(pos), rns)
        jq, jk, jv, (jckv, jkr) = _jit(jattn.mla_qkv, rns=jrns)(
            jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
        for a, b in ((q, jq), (k, jk), (v, jv), (ckv, jckv), (kr, jkr)):
            close(a, b)
    y, (ckv, kr) = attn.mla_attend(p, _t(x), cfg, rns=rns)
    jy, (jckv, jkr) = _jit(jattn.mla_attend, mode="chunked", rns=jrns)(
        jp, jnp.asarray(x), jcfg)
    close(y, jy)
    close(ckv, jckv)

    # absorbed decode over a dense cache of random latents (on the RNS
    # path: the paged decode's math; test_mla_bucketed_matches_jax)
    lengths = np.array([3, 9])
    x1 = x[:, :1]
    if rns is None:
        S = 16
        c0 = rng.standard_normal((B, S, m.kv_lora_rank)).astype(np.float32)
        k0 = rng.standard_normal((B, S, m.qk_rope_dim)).astype(np.float32)
        dense = M.DenseKV(None, None, _t(lengths), c_kv=_t(c0[None]),
                          k_rope=_t(k0[None]))
        y = attn.mla_decode(p, _t(x1), cfg, dense, 0, rns=rns)
        jy, jc, jk_, _ = _jit(jattn.mla_decode, rns=jrns)(
            jp, jnp.asarray(x1), jcfg, {
                "c_kv": jnp.asarray(c0), "k_rope": jnp.asarray(k0),
                "lengths": jnp.asarray(lengths)})
        close(y, jy)
        close(dense.c_kv[0], jc)
        close(dense.k_rope[0], jk_)

    # paged: one token, a [R, 3] window, the packed step
    P, bs, nb = 9, 4, 4
    bt = np.array([[1, 2, 3, 4], [5, 6, 7, 8]])
    cp = rng.standard_normal((P, bs, m.kv_lora_rank)).astype(np.float32)
    kp = rng.standard_normal((P, bs, m.qk_rope_dim)).astype(np.float32)

    def caches():
        ours = kv.PagedKV(None, None, _t(bt), _t(lengths),
                          ckv_pages=_t(cp[None]), krope_pages=_t(kp[None]))
        theirs = {"ckv_pages": jnp.asarray(cp), "krope_pages":
                  jnp.asarray(kp), "block_table": jnp.asarray(bt),
                  "lengths": jnp.asarray(lengths)}
        return ours, theirs

    for fn, jfn, xin in ((attn.mla_decode_paged, jattn.mla_decode_paged, x1),
                         (attn.mla_decode_paged_window,
                          jattn.mla_decode_paged_window, x[:, :3])):
        ours, theirs = caches()
        y = fn(p, _t(xin), cfg, ours, 0, rns=rns)
        jy, jc, jk_ = _jit(jfn, rns=jrns)(jp, jnp.asarray(xin), jcfg,
                                          theirs)
        close(y, jy)
        close(ours.ckv_pages[0, 1:], np.asarray(jc)[1:])
        close(ours.krope_pages[0, 1:], np.asarray(jk_)[1:])
    N = 8
    seg = np.array([0, 0, 0, 1, -1, 1, 1, -1])
    ppos = np.array([3, 4, 5, 9, 0, 10, 11, 0])
    dec = np.array([False, False, False, True, False, False, False, False])
    xp = rng.standard_normal((1, N, d)).astype(np.float32)
    ours, theirs = caches()
    y = attn.mla_decode_packed(p, _t(xp), cfg, ours, 0, _t(seg), _t(ppos),
                               _t(dec), rns=rns)
    jy, jc, _ = _jit(jattn.mla_decode_packed, rns=jrns)(
        jp, jnp.asarray(xp), jcfg, theirs, jnp.asarray(seg),
        jnp.asarray(ppos), jnp.asarray(dec))
    valid = seg >= 0
    close(y[0][valid], np.asarray(jy)[0][valid])
    close(ours.ckv_pages[0, 1:], np.asarray(jc)[1:])


def test_lane_attention_parts_value_width_and_scale():
    """Keys in parts (a one-head part read by every head), a value width
    other than the query's and an explicit scale: the concatenated
    query/key single-part result within FLOAT_ATOL, and independent of
    how many lanes a pass takes."""
    rng = np.random.default_rng(2)
    N, S, H, dn, dr, dv = 5, 21, 4, 16, 8, 12
    qn = torch.from_numpy(rng.standard_normal((N, H, dn)).astype(np.float32))
    qr = torch.from_numpy(rng.standard_normal((N, H, dr)).astype(np.float32))
    kn = torch.from_numpy(rng.standard_normal((N, S, H, dn)).astype(
        np.float32))
    kr = torch.from_numpy(rng.standard_normal((N, S, 1, dr)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((N, S, H, dv)).astype(
        np.float32))
    lengths = torch.tensor([1, 5, 16, 21, 9])
    parts = attn.lane_attention((qn, qr), (kn, kr), v, lengths, 6,
                                scale_dim=40)
    whole = attn.lane_attention(
        torch.cat([qn, qr], -1), torch.cat([kn, kr.expand(-1, -1, H, -1)],
                                           -1), v, lengths, 6, scale_dim=40)
    assert parts.shape == (N, H, dv)
    torch.testing.assert_close(parts, whole, rtol=0, atol=FLOAT_ATOL)
    old = attn.LANE_ELEMS
    try:
        attn.LANE_ELEMS = H * 32 * 16          # one lane a pass
        torch.testing.assert_close(
            attn.lane_attention((qn, qr), (kn, kr), v, lengths, 6,
                                scale_dim=40), parts, rtol=0, atol=0)
    finally:
        attn.LANE_ELEMS = old


# ------------------------------------------------------------ serving ----
def _prompts(vocab, lens, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (t,)).astype(np.int32) for t in lens]


def _shared_prompts(vocab, seed=6):
    """A 24-token system prompt (three pages of 8) with tails of 4, 9 and
    0 tokens, then the first prompt again (its partial tail: a COW)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, (24,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(1, vocab, (k,)).astype(
        np.int32)]) for k in (4, 9, 0)]
    return prompts + [prompts[0].copy()]


# JAX's MLA serving cases: (RNS targets, prompt lengths or "shared",
# ServeConfig)
SERVES = {
    "barrier": (None, (5, 21, 13), dict(max_cache=64, page_size=8,
                                        max_seqs=2, max_new_tokens=6)),
    "barrier_rns_all": ("all", (5, 21, 13), dict(
        max_cache=48, page_size=8, max_seqs=2, max_new_tokens=5)),
    "chunked": (None, (13, 21, 5, 9), CHUNKED),
    "chunked_rns_spec": ("mlp", (13, 21, 5, 9), dict(
        CHUNKED, spec_decode=True, spec_k=2)),
    "prefix_cow": ("mlp", "shared", dict(
        max_cache=48, page_size=8, max_seqs=2, max_new_tokens=4,
        prefix_cache=True, prompt_pad=40)),
    "spec": (None, (5, 21), dict(max_cache=64, page_size=8, max_seqs=2,
                                 max_new_tokens=6, spec_decode=True,
                                 spec_k=3)),
    "window": (None, (5, 12), dict(max_cache=24, page_size=8, max_seqs=2,
                                   max_new_tokens=6, window_tokens=8)),
    "window_chunked_rns": ("mlp", (5, 12), dict(
        max_cache=24, page_size=8, max_seqs=2, max_new_tokens=6,
        window_tokens=8, chunked_prefill=True, token_budget=16,
        chunk_size=8)),
}


@pytest.mark.parametrize("case", sorted(SERVES))
def test_mla_serving_matches_jax(mla_model, case):
    """The same traffic through JAX's ContinuousEngine and the port's:
    equal greedy tokens, step stats (admissions, COW splits, cached
    tokens, window evictions, ...) and rns_ops JAX's times the layers."""
    jcfg, jparams, cfg, model = mla_model
    targets, lens, kw = SERVES[case]
    jcfg, cfg = _rns(jcfg, cfg, targets)
    prompts = (_shared_prompts(cfg.vocab) if lens == "shared"
               else _prompts(cfg.vocab, lens))
    jres, jstats = JEngine(jparams, jcfg, JServeConfig(**kw)).run(prompts)
    eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(**kw),
                           device="cpu")
    res, stats = eng.run(prompts)
    assert {r: t.tolist() for r, t in res.items()} == {
        r: t.tolist() for r, t in jres.items()}
    assert len(stats["steps"]) == len(jstats["steps"])
    for s, js in zip(stats["steps"], jstats["steps"]):
        assert {k: s[k] for k in STAT_KEYS} == {k: js[k] for k in STAT_KEYS}
        assert s["rns_ops"].as_dict() == {
            f: getattr(js["rns_ops"], f) * cfg.n_layers for f in FIELDS}
    if case == "prefix_cow":
        assert stats["cow_splits"] > 0 and stats["cache_hit_tokens"] > 0
        assert set(eng.programs) == {"decode", "prefill", "cow"}
    if case.startswith("window"):
        assert stats["pages_window_evicted"] > 0
    if case.startswith("chunked"):
        assert any(s["prefill_tokens"] and s["decode_tokens"]
                   for s in stats["steps"])


@pytest.mark.parametrize("targets", [None, "all"])
def test_mla_bucketed_matches_jax(mla_model, targets):
    """The bucketed Engine on a [2, 9] batch: JAX's greedy tokens (its
    solo runs on the RNS path, where a port row quantizes on its own
    grid, ROADMAP C.11), the prefill's rns_ops JAX's times the layers;
    the dense cache holds the latent planes."""
    jcfg, jparams, cfg, model = mla_model
    jcfg, cfg = _rns(jcfg, cfg, targets)
    batch = np.stack(_prompts(cfg.vocab, (9, 9), seed=4))
    kw = dict(max_cache=24, max_new_tokens=5)
    jeng = JBucketed(jparams, jcfg, JServeConfig(**kw))
    want = (jeng.generate(batch) if targets is None else
            np.concatenate([jeng.generate(r[None]) for r in batch]))
    eng = Engine(_retarget(model, cfg), ServeConfig(**kw), device="cpu")
    np.testing.assert_array_equal(eng.generate(batch), want)
    cache = eng._caches[2]
    assert cache.k is None and cache.c_kv.shape == (4, 2, 24, 32)
    if targets is not None:
        jops = jeng.rns_op_counts(B=2, T=9)
        assert eng.rns_op_counts(2, 9).as_dict() == {
            f: getattr(jops, f) * cfg.n_layers for f in FIELDS}


def test_engine_refusals_match_jax(mla_model):
    """Chunked prefill with rns_targets="all" on an MLA model, layer
    types other than attn/mla, enc-dec and non-causal models: both
    engines refuse, with JAX's messages."""
    jcfg, jparams, cfg, model = mla_model
    jall, all_ = _rns(jcfg, cfg, "all")
    kw = dict(max_cache=48, chunked_prefill=True, token_budget=16)
    with pytest.raises(NotImplementedError) as jerr:
        JEngine(jparams, jall, JServeConfig(**kw))
    with pytest.raises(NotImplementedError) as err:
        ContinuousEngine(_retarget(model, all_), ServeConfig(**kw),
                         device="cpu")
    assert str(err.value) == str(jerr.value)
    assert "rns_targets='mlp'" in str(err.value)
    for over in (dict(layer_types=("mla", "mamba", "mla", "mla")),
                 dict(enc_dec=True), dict(causal=False)):
        with pytest.raises(NotImplementedError) as jerr:
            JEngine(jparams, dataclasses.replace(jcfg, **over),
                    JServeConfig(max_cache=48))
        with pytest.raises(NotImplementedError) as err:
            ContinuousEngine(_retarget(model, dataclasses.replace(
                cfg, **over)), ServeConfig(max_cache=48), device="cpu")
        assert str(err.value) == str(jerr.value)


# ------------------------------------------------------------ on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels run "
                    "only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["barrier_rns_all", "chunked_rns_spec",
                                  "prefix_cow", "window_chunked_rns"])
def test_gpu_captured_mla_serving_equals_eager(cuda, mla_model, case):
    """On the card: each serving case captured (one capture a program)
    against the eager engine -- the same greedy tokens and rns_ops --
    and chunked against whole-prompt prefill (ROADMAP C.10)."""
    jcfg, _, cfg, model = mla_model
    targets, lens, kw = SERVES[case]
    _, cfg = _rns(jcfg, cfg, targets)
    prompts = (_shared_prompts(cfg.vocab) if lens == "shared"
               else _prompts(cfg.vocab, lens))
    runs = {}
    for graphs in (False, True):
        eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(**kw),
                               device="cuda", graphs=graphs)
        res, stats = eng.run(prompts)
        runs[graphs] = ({r: t.tolist() for r, t in res.items()},
                        [s["rns_ops"].as_dict() for s in stats["steps"]])
        if graphs:
            assert set(eng.captures().values()) == {1}
    assert runs[True] == runs[False]
    if kw.get("chunked_prefill"):
        whole = {k: v for k, v in kw.items()
                 if k not in ("chunked_prefill", "token_budget",
                              "chunk_size")}
        res, _ = ContinuousEngine(_retarget(model, cfg), ServeConfig(
            **whole), device="cuda").run(prompts)
        assert {r: t.tolist() for r, t in res.items()} == runs[True][0]
