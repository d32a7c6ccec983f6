"""Sliding-window attention with window eviction: the port against the
JAX package on the smoke config.

With ``ServeConfig(window_tokens=W)`` every row attends its last W
tokens and the scheduler recycles the pages behind the window (their
block-table entries become the trash page).  The windowed continuous
stream must equal the JAX bucketed engine's windowed solo run of each
prompt -- which keeps every position in a dense cache and only masks
-- so a position that leaked past the mask would read a recycled page
and move tokens.  The scheduler must make JAX's plans step by step
under ``lookahead`` and ``window_tokens``, and ``lane_attention``'s
window must be JAX's ``decode_attention`` window, a non-finite trash
page included.  Tolerances: tokens, plans and counts exact; attention
outputs within ``ATTN_ATOL``.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as j_get_config
from repro.core.rns_matmul import RnsDotConfig as JRnsDotConfig
from repro.models import attention as jattn
from repro.models import model as JM
from repro.serve import kv_cache as jkv
from repro.serve import scheduler as jsched
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import Engine as JBucketed
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.base import get_config
from repro_torch.core.rns_matmul import RnsDotConfig
from repro_torch.models import attention as attn
from repro_torch.models.params import params_from_jax
from repro_torch.serve import kv_cache as kv
from repro_torch.serve import scheduler as sched
from repro_torch.serve.engine import ContinuousEngine, Engine, ServeConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# float32 attention, XLA's einsum against the port's fixed trees
ATTN_ATOL = 2e-6


@pytest.fixture(scope="module")
def smoke():
    jcfg = j_get_config("smollm-135m", smoke=True)
    cfg = get_config("smollm-135m", smoke=True)
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)[0]
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jcfg, jparams, cfg, model


def _with_rns(jcfg, cfg, rns: bool):
    if not rns:
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


# ------------------------------------------------------------ the engine --
@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("family", ["float_gqa", "rns_gqa"])
def test_windowed_token_identity(smoke, family, chunked):
    """Windowed continuous serving equals JAX's windowed solo run of each
    prompt (and the port's own bucketed engine's), with pages really
    recycled; on the float path without chunking the evictions step by
    step equal JAX's continuous engine's."""
    W, max_new = 8, 6
    jcfg, jparams, cfg, model = smoke
    jcfg, cfg = _with_rns(jcfg, cfg, family == "rns_gqa")
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, cfg.vocab, (L,)).astype(np.int32)
               for L in (5, 12)]
    kw = dict(max_cache=24, max_seqs=2, page_size=8, max_new_tokens=max_new,
              window_tokens=W)
    if chunked:
        kw.update(chunked_prefill=True, token_budget=16, chunk_size=8)
    m = _retarget(model, cfg)
    res, stats = ContinuousEngine(m, ServeConfig(**kw), device="cpu").run(
        prompts)
    assert stats["pages_window_evicted"] > 0
    jsolo = JBucketed(jparams, jcfg, JServeConfig(
        max_cache=24, max_new_tokens=max_new, window_tokens=W))
    solo = Engine(m, ServeConfig(max_cache=24, max_new_tokens=max_new,
                                 window_tokens=W), device="cpu")
    for i, p in enumerate(prompts):
        want = jsolo.generate(p[None])[0].tolist()
        assert res[i].tolist() == want, (family, chunked, i)
        assert solo.generate(p[None])[0].tolist() == want
    if family == "float_gqa" and not chunked:
        _, jstats = JEngine(jparams, jcfg, JServeConfig(**kw)).run(prompts)
        assert [s["pages_window_evicted"] for s in stats["steps"]] == [
            s["pages_window_evicted"] for s in jstats["steps"]]
        assert stats["pages_window_evicted"] == jstats["pages_window_evicted"]


def test_windowed_spec_long_stream_in_a_small_pool(smoke):
    """Windowed speculative serving of a stream far longer than the
    pool's unwindowed bound: the windowed page bound of JAX's engine
    (``resident_blocks``) admits it, and the tokens equal JAX's."""
    jcfg, jparams, cfg, model = smoke
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, (L,)).astype(np.int32)
               for L in (10, 3)]
    kw = dict(max_cache=48, max_seqs=2, page_size=8, max_new_tokens=30,
              window_tokens=12, n_pages=7, spec_decode=True, spec_k=3)
    eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(**kw),
                           device="cpu")
    assert eng.pcfg.resident_blocks == 3
    res, stats = eng.run(prompts)
    jeng = JEngine(jparams, jcfg, JServeConfig(**kw))
    jres, jstats = jeng.run(prompts)
    assert eng.pcfg == kv.PagedCacheConfig(**dataclasses.asdict(jeng.pcfg))
    assert {r: v.tolist() for r, v in res.items()} == {
        r: v.tolist() for r, v in jres.items()}
    assert stats["pages_window_evicted"] == jstats["pages_window_evicted"] > 0
    assert stats["n_preemptions"] == jstats["n_preemptions"]


@pytest.mark.parametrize("n_pages,resident", [(4, None), (4, 3), (3, 3),
                                              (9, 20)])
def test_resident_blocks_validation_equals_jax(n_pages, resident):
    kw = dict(page_size=4, n_pages=n_pages, max_seqs=2, max_blocks=8,
              resident_blocks=resident)
    try:
        jkv.PagedCacheConfig(**kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split("(")[0]):
            kv.PagedCacheConfig(**kw)
    else:
        assert kv.PagedCacheConfig(**kw).resident_blocks == resident


# --------------------------------------------------------- the scheduler --
def _evict_and_preempt(mod, kvmod):
    """JAX's regression trace: a row window-evicted and LIFO-preempted in
    one step readmits cleanly; returns what the trace shows."""
    pcfg = kvmod.PagedCacheConfig(page_size=4, n_pages=6, max_seqs=2,
                                  max_blocks=6, resident_blocks=3)
    s = mod.Scheduler(pcfg, window_tokens=6)
    s.submit(mod.Request(rid=0, tokens=np.ones(4, np.int32), max_new=20))
    s.submit(mod.Request(rid=1, tokens=np.ones(4, np.int32), max_new=20))
    plan = s.schedule()
    old, young = plan.admitted
    for q in (old, young):
        q.length = 12
        q.emitted = [1] * 8
    plan2 = s.schedule()
    fresh = plan2.admitted[0]
    out = {"evictions": s.window_evictions, "old_pages": list(old.pages),
           "preempted": plan2.preempted,
           "young": (young.pages, young.todo),
           "readmitted": [q.rid for q in plan2.admitted],
           "fresh_pages": list(fresh.pages), "free": s.alloc.n_free}
    n_free = s.alloc.n_free
    s.complete(young)                      # stale: a no-op
    out["stale_complete_noop"] = s.alloc.n_free == n_free
    s.complete(old)
    s.complete(fresh)
    out["drained"] = (s.alloc.n_free, len(s._free_slots))
    return out


def test_window_evict_and_preempt_same_step_equals_jax():
    ours = _evict_and_preempt(sched, kv)
    assert ours == _evict_and_preempt(jsched, jkv)
    assert ours["evictions"] == 2 and ours["old_pages"][0] == kv.TRASH_PAGE
    assert ours["preempted"] == [1] and ours["readmitted"] == [1]
    assert ours["young"] == ([], None) and ours["stale_complete_noop"]
    assert kv.TRASH_PAGE not in ours["fresh_pages"]
    assert ours["drained"] == (5, 2)


def _drive(mod, kvmod, traffic, *, lookahead, window, chunked, prefix,
           seed, steps=60):
    """Drive a scheduler with synthetic progress (a random number of
    accepted tokens a decode row a step, chunks as planned); log every
    step's plan, page lists, evictions and free counts."""
    rng = np.random.default_rng(seed)
    pcfg = kvmod.PagedCacheConfig(page_size=4, n_pages=10, max_seqs=3,
                                  max_blocks=9)
    s = mod.Scheduler(pcfg, lookahead=lookahead, window_tokens=window,
                      chunked=chunked, prefix_cache=prefix,
                      token_budget=8 if chunked else 0,
                      chunk_size=4 if chunked else None,
                      prefill_reserve=4 if chunked else 0)
    for rid, (toks, max_new) in enumerate(traffic):
        s.submit(mod.Request(rid=rid, tokens=toks, max_new=max_new))
    log = []
    for _ in range(steps):
        if not s.has_work:
            break
        plan = s.schedule()
        if chunked:
            for g in s.plan_mixed(lookahead):
                q = g.seq
                if g.kind == "chunk":
                    if g.last:
                        q.emitted = [int(q.req.tokens[-1])]
                        q.last_token = q.emitted[0]
                    s.register_chunks(q)
                    continue
                _advance(s, q, rng, lookahead, pcfg)
        else:
            for q in plan.admitted:
                q.emitted = [int(q.req.tokens[-1])]
                q.last_token = q.emitted[0]
                s.register_prefix(q)
            for q in list(s.running.values()):
                if q.emitted and len(q.emitted) < q.req.max_new:
                    _advance(s, q, rng, lookahead, pcfg)
                elif q.emitted:
                    s.complete(q)
        bt, lengths, _, _ = s.tables()
        log.append({
            "admitted": [(q.rid, sorted(q.shared_blocks))
                         for q in plan.admitted],
            "preempted": plan.preempted, "cow": plan.cow, "grew": plan.grew,
            "bt": bt.tolist(), "lengths": lengths.tolist(),
            "evictions": s.window_evictions, "free": s.alloc.n_free,
            "refcounts": [s.alloc.refcount(p) for p in range(pcfg.n_pages)]})
    return log


def _advance(s, q, rng, lookahead, pcfg):
    cap = max(0, min(lookahead - 1, q.req.max_new - len(q.emitted) - 1,
                     len(q.pages) * pcfg.page_size - q.length - 1))
    a = int(rng.integers(0, cap + 1))
    q.emitted.extend([q.length % 5] * (a + 1))
    q.length += a + 1
    q.last_token = q.emitted[-1]
    if (len(q.emitted) >= q.req.max_new
            or q.length + 1 > pcfg.tokens_per_seq):
        s.complete(q)


@pytest.mark.parametrize("lookahead,window,chunked,prefix", [
    (1, 6, False, False), (4, 6, False, False), (4, None, False, True),
    (4, 9, True, False), (3, 5, True, True), (1, 7, True, False)])
def test_scheduler_equals_jax_under_lookahead_and_window(lookahead, window,
                                                         chunked, prefix):
    """Page lists, evictions, free counts, COW splits and preemptions
    equal the JAX scheduler's step by step."""
    seed = lookahead * 7 + (window or 0) + 2 * chunked + prefix
    rng = np.random.default_rng(seed)
    stem = rng.integers(0, 20, 8).astype(np.int32)
    traffic = []
    for i in range(6):
        tail = rng.integers(0, 20, int(rng.integers(1, 10))).astype(np.int32)
        toks = np.concatenate([stem, tail]) if prefix and i % 2 else tail
        traffic.append((toks, int(rng.integers(6, 20))))
    kw = dict(lookahead=lookahead, window=window, chunked=chunked,
              prefix=prefix, seed=seed)
    ours = _drive(sched, kv, traffic, **kw)
    assert ours == _drive(jsched, jkv, traffic, **kw)
    if window is not None:
        assert ours[-1]["evictions"] > 0
    assert ours[-1]["lengths"] == [0, 0, 0]          # drained
    if not prefix:
        assert ours[-1]["free"] == 9                 # every page back


# --------------------------------------------------------- the attention --
def _attn_inputs(rng, R=3, W=4, S=40, H=4, Hk=2, D=16):
    q = rng.standard_normal((R, W, H, D)).astype(np.float32)
    k = rng.standard_normal((R, S, Hk, D)).astype(np.float32)
    v = rng.standard_normal((R, S, Hk, D)).astype(np.float32)
    lengths = np.array([[3, 4, 5, 6], [17, 18, 19, 20], [37, 38, 39, 40]],
                       np.int32)[:, :W]
    return q, k, v, lengths


@pytest.mark.parametrize("window", [None, 1, 6, 16])
def test_lane_attention_window_equals_jax(window):
    """Per-query lengths (a verify window: query i of a row sees its
    row's ``lengths[r, i]`` keys) under a sliding window, and the
    one-token case: within ATTN_ATOL of JAX's ``decode_attention``."""
    rng = np.random.default_rng(0 if window is None else window)
    q, k, v, lengths = _attn_inputs(rng)
    R, W = lengths.shape
    want, _ = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lengths),
                                     window=window)
    rows = np.repeat(np.arange(R), W)
    got = attn.lane_attention(
        torch.from_numpy(q.reshape(R * W, *q.shape[2:])),
        torch.from_numpy(k[rows]), torch.from_numpy(v[rows]),
        torch.from_numpy(lengths.reshape(-1).astype(np.int64)), window)
    np.testing.assert_allclose(got.numpy().reshape(q.shape),
                               np.asarray(want), rtol=0, atol=ATTN_ATOL)
    want1, _ = jattn.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                                      jnp.asarray(v),
                                      jnp.asarray(lengths[:, 0]),
                                      window=window)
    got1 = attn.lane_attention(torch.from_numpy(q[:, 0]),
                               torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(lengths[:, 0].astype(
                                   np.int64)), window)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1)[:, 0],
                               rtol=0, atol=ATTN_ATOL)


@pytest.mark.parametrize("window", [None, 6])
def test_lane_attention_ignores_a_nan_trash_page(window):
    """Keys and values outside a lane's valid window replaced by NaN and
    inf (a trash page or a recycled page holding anything): the output
    is bit-equal to the finite one and within ATTN_ATOL of JAX's on the
    finite inputs."""
    rng = np.random.default_rng(9)
    q, k, v, lengths = _attn_inputs(rng)
    R, W = lengths.shape
    rows = np.repeat(np.arange(R), W)
    n = lengths.reshape(-1)
    kr, vr = k[rows].copy(), v[rows].copy()
    keys = np.arange(k.shape[1])[None]
    dead = keys >= n[:, None]
    if window is not None:
        dead |= keys < (n[:, None] - window)
    kn, vn = kr.copy(), vr.copy()
    kn[dead] = np.nan
    vn[dead] = np.nan
    vn[dead & (keys % 3 == 0)] = np.inf
    args = (torch.from_numpy(q.reshape(R * W, *q.shape[2:])),)
    lens = torch.from_numpy(n.astype(np.int64))
    clean = attn.lane_attention(*args, torch.from_numpy(kr),
                                torch.from_numpy(vr), lens, window)
    dirty = attn.lane_attention(*args, torch.from_numpy(kn),
                                torch.from_numpy(vn), lens, window)
    assert torch.isfinite(dirty).all()
    assert torch.equal(dirty, clean)
    want, _ = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lengths),
                                     window=window)
    np.testing.assert_allclose(dirty.numpy().reshape(q.shape),
                               np.asarray(want), rtol=0, atol=ATTN_ATOL)


# ------------------------------------------------------------ on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels run "
                    "only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("chunked", [False, True])
def test_gpu_windowed_captured_equals_bucketed_solo(cuda, smoke, chunked):
    """On the card, rns9: the captured windowed continuous stream equals
    the eager one and the captured windowed bucketed engine's solo runs,
    with pages recycled."""
    W, max_new = 8, 12
    jcfg, _, cfg, model = smoke
    _, cfg = _with_rns(jcfg, cfg, True)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, cfg.vocab, (L,)).astype(np.int32)
               for L in (5, 12, 20)]
    kw = dict(max_cache=40, max_seqs=2, page_size=8, max_new_tokens=max_new,
              window_tokens=W)
    if chunked:
        kw.update(chunked_prefill=True, token_budget=16, chunk_size=8)
    got = {}
    for graphs in (False, True):
        res, stats = ContinuousEngine(_retarget(model, cfg),
                                      ServeConfig(**kw), device="cuda",
                                      graphs=graphs).run(prompts)
        assert stats["pages_window_evicted"] > 0
        got[graphs] = {r: v.tolist() for r, v in res.items()}
    assert got[True] == got[False]
    solo = Engine(_retarget(model, cfg), ServeConfig(
        max_cache=40, max_new_tokens=max_new, window_tokens=W),
        device="cuda")
    for i, p in enumerate(prompts):
        assert solo.generate(p[None])[0].tolist() == got[True][i], i
    assert set(solo.captures().values()) == {1}
