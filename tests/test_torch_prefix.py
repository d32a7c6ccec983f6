"""Copy-on-write prefix caching: the port against the JAX package.

The refcounted ``PageAllocator``, the content-addressed ``PrefixCache``
and ``copy_pages`` are held to JAX's bit for bit on seeded operation
sequences; the scheduler's plans (admissions with their cached tokens,
COW splits, refcounts, free pages) to the JAX scheduler's step by step;
and the engine with ``prefix_cache=True`` -- phase-barrier and chunked,
on the float path, per-op rns9 and the fused resident deferred rns9
path -- to the JAX engine's greedy tokens and step stats on traffic
that shares a prompt prefix.  The ``gpu`` cases capture the COW copy on
the card and hold the engine to eager.
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
from repro.models import model as JM
from repro.serve import kv_cache as jkv
from repro.serve import scheduler as jsched
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.base import get_config
from repro_torch.core.rns_matmul import RnsDotConfig
from repro_torch.models.params import params_from_jax
from repro_torch.serve import kv_cache as kv
from repro_torch.serve import scheduler as sched
from repro_torch.serve.engine import ContinuousEngine, ServeConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIELDS = ("converts", "matmuls", "normalizes", "fused", "fallbacks",
          "weight_converts")
FUSED = dict(resident_weights=True, rns_defer=True)
PATHS = {
    "float": (False, {}, {}),
    "rns9": (True, {}, {}),
    "fused": (True, dict(FUSED, rns_backend="pallas_fused_interpret"),
              dict(FUSED, rns_backend="cuda_fused")),
}
MODES = {
    "barrier": dict(prompt_pad=40),
    "chunked": dict(chunked_prefill=True, token_budget=16, chunk_size=8),
}
STAT_KEYS = ("step", "admitted", "preempted", "finished", "active",
             "waiting", "new_tokens", "decoded", "decode_rows",
             "page_utilization", "cow_splits", "cache_hit_tokens",
             "pages_allocated_total", "pages_shared_total",
             "prefill_tokens", "decode_tokens")


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
    """A copy of the port's model under ``cfg`` (the same weights)."""
    m = copy.deepcopy(model)
    m.cfg = cfg
    return m


def _shared_prompts(vocab, seed=6):
    """A 24-token system prompt (three pages of 8) with tails of 4, 9, 0
    and 8 tokens, then the first prompt again: full blocks are shared,
    and the repeat adopts the first prompt's partial tail (a COW)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, (24,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(1, vocab, (k,)).astype(
        np.int32)]) for k in (4, 9, 0, 8)]
    return prompts + [prompts[0].copy()]


def _tokens(res) -> dict:
    return {r: t.tolist() for r, t in res.items()}


# ------------------------------------------------------------ allocator --
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_refcounts_equal_jax(seed):
    """A seeded sequence of alloc / incref / free (shared pages, double
    frees, unallocated increfs, bad ids): every result, exception type,
    refcount, counter and the free list's order equal JAX's."""
    rng = np.random.default_rng(seed)
    ours, theirs = kv.PageAllocator(9), jkv.PageAllocator(9)

    def both(op, *args):
        out = []
        for a in (ours, theirs):
            try:
                out.append(("ok", getattr(a, op)(*args)))
            except ValueError as e:
                out.append(("ValueError", str(e)))
        assert out[0] == out[1], (op, args)

    for _ in range(300):
        op = rng.choice(["alloc", "incref", "free", "free"])
        pages = [int(p) for p in rng.integers(0 if op == "free" else 1, 10,
                                              int(rng.integers(1, 4)))]
        if op == "alloc":
            both("alloc", int(rng.integers(0, 4)))
        else:
            both(op, pages)
        assert ours._free == theirs._free
        assert [ours.refcount(p) for p in range(9)] == [
            theirs.refcount(p) for p in range(9)]
        assert (ours.n_free, ours.utilization, ours.pages_allocated,
                ours.pages_shared) == (theirs.n_free, theirs.utilization,
                                       theirs.pages_allocated,
                                       theirs.pages_shared)


@pytest.mark.parametrize("seed", [3, 4])
def test_prefix_cache_equal_jax(seed):
    """A seeded sequence of insert / lookup / peek / evict, with
    over-released (stale) pages: every result, entry, LRU order and
    counter equal JAX's PrefixCache on the same allocator traffic."""
    rng = np.random.default_rng(seed)
    caches = []
    for mod in (kv, jkv):
        a = mod.PageAllocator(24)
        caches.append((a, mod.PrefixCache(a, 4)))
    roots = [rng.integers(0, 9, (12,)).astype(np.int32) for _ in range(3)]

    def prompt():
        r = roots[int(rng.integers(0, 3))]
        n = int(rng.integers(1, 12))
        tail = rng.integers(0, 9, (int(rng.integers(0, 6)),)).astype(np.int32)
        return np.concatenate([r[:n], tail])

    for _ in range(120):
        op = rng.choice(["insert", "lookup", "peek", "evict", "stale"])
        toks = prompt()
        n_evict = int(rng.integers(1, 4))
        outs = []
        for a, pc in caches:
            if op == "insert":
                pages = a.alloc(-(-len(toks) // 4))
                if pages is None:
                    pc.evict(4)
                    pages = a.alloc(-(-len(toks) // 4)) or []
                out = pc.insert(toks, pages)
                a.free(pages)                   # the producer departs
            elif op == "lookup":
                out = pc.lookup(toks)
            elif op == "peek":
                out = pc.peek_cached_tokens(toks)
            elif op == "evict":
                out = pc.evict(n_evict)
            else:
                # over-release one indexed page: its entry goes stale
                live = [p for p, _ in pc._entries.values()
                        if a.refcount(p) >= 1]
                out = live[0] if live else None
                if live:
                    a._ref[live[0]] = 1
                    a.free([live[0]])
            outs.append(out)
        assert outs[0] == outs[1], op
        (a0, c0), (a1, c1) = caches
        assert list(c0._entries.items()) == list(c1._entries.items())
        assert (c0.hits, c0.misses, c0.evictions, c0.stale_drops,
                c0.generation, len(c0)) == (c1.hits, c1.misses, c1.evictions,
                                            c1.stale_drops, c1.generation,
                                            len(c1))
        assert a0._free == a1._free
    assert caches[0][1].stale_drops > 0 and caches[0][1].evictions > 0


def test_copy_pages_bit_equal_to_jax():
    """COW copies in every layer, no-op rows trash onto trash: every
    real page bit-equal to JAX's, the sources untouched."""
    rng = np.random.default_rng(5)
    pages = rng.standard_normal((3, 9, 4, 2, 5)).astype(np.float32)
    src = np.array([2, 0, 7, 0], np.int32)
    dst = np.array([5, 0, 1, 0], np.int32)
    want = np.asarray(jkv.copy_pages(jnp.asarray(pages), jnp.asarray(src),
                                     jnp.asarray(dst)))
    got = torch.from_numpy(pages.copy())
    kv.copy_pages(got, torch.from_numpy(src).long(),
                  torch.from_numpy(dst).long())
    np.testing.assert_array_equal(got.numpy()[:, 1:], want[:, 1:])
    np.testing.assert_array_equal(got.numpy()[:, [5, 1]],
                                  pages[:, [2, 7]])


# ------------------------------------------------------------ scheduler --
def _drive(mod, pcfg_cls, traffic, *, chunked: bool, steps=80):
    """Drive a prefix-caching scheduler as the engine does (prefill at
    admission and register the prefix, or consume packed chunks), one
    token per decode row a step; log every step's plan."""
    pcfg = pcfg_cls(page_size=4, n_pages=10, max_seqs=2, max_blocks=6)
    kw = dict(chunked=True, token_budget=6, chunk_size=4,
              prefill_reserve=3) if chunked else {}
    s = mod.Scheduler(pcfg, prefix_cache=True, **kw)
    for rid, (toks, max_new) in enumerate(traffic):
        s.submit(mod.Request(rid=rid, tokens=toks, max_new=max_new))
    log = []

    def emit(seq):
        seq.emitted.append(seq.length % 7)
        seq.length += 1
        if (len(seq.emitted) >= seq.req.max_new
                or seq.length + 1 > pcfg.tokens_per_seq):
            s.complete(seq)

    for _ in range(steps):
        if not s.has_work:
            break
        plan = s.schedule()
        segs = []
        if chunked:
            segs = s.plan_mixed()
            for g in segs:
                if g.kind == "decode":
                    emit(g.seq)
                    continue
                if g.last:
                    g.seq.emitted = [int(g.seq.req.tokens[-1])]
                s.register_chunks(g.seq)
                if g.seq.emitted and len(g.seq.emitted) >= g.seq.req.max_new:
                    s.complete(g.seq)
        else:
            for seq in plan.admitted:
                s.register_prefix(seq)
                seq.emitted = [int(seq.req.tokens[-1])]
            for seq in list(s.running.values()):
                if len(seq.emitted) >= seq.req.max_new:
                    s.complete(seq)
                else:
                    emit(seq)
        bt, lengths, _, _ = s.tables()
        log.append({
            "admitted": [(q.rid, q.cached_tokens, sorted(q.shared_blocks),
                          s.block_row(q, 6).tolist()) for q in plan.admitted],
            "preempted": plan.preempted, "cow": plan.cow,
            "segs": [(g.seq.rid, g.kind, g.positions.tolist(), g.last)
                     for g in segs],
            "bt": bt.tolist(), "lengths": lengths.tolist(),
            "free": s.alloc.n_free, "entries": len(s.prefix),
            "refcounts": [s.alloc.refcount(p) for p in range(pcfg.n_pages)],
            "counters": (s.alloc.pages_allocated, s.alloc.pages_shared,
                         s.cow_splits, s.cache_hit_tokens)})
    return log


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_prefix_scheduler_plans_equal_jax(seed, chunked):
    """Shared-prefix traffic with repeats: admissions (cached tokens,
    shared blocks, blit rows), COW splits, preemptions, refcounts and
    free pages equal the JAX scheduler's step by step."""
    rng = np.random.default_rng(seed)
    roots = [rng.integers(0, 9, (10,)).astype(np.int32) for _ in range(2)]
    traffic = []
    for _ in range(8):
        r = roots[int(rng.integers(0, 2))]
        tail = rng.integers(0, 9, (int(rng.integers(0, 5)),)).astype(np.int32)
        toks = np.concatenate([r[:int(rng.integers(4, 11))], tail])
        traffic.append((toks, int(rng.integers(2, 6))))
    traffic += [traffic[0], traffic[1]]
    ours = _drive(sched, kv.PagedCacheConfig, traffic, chunked=chunked)
    theirs = _drive(jsched, jkv.PagedCacheConfig, traffic, chunked=chunked)
    assert ours == theirs
    assert any(step["cow"] for step in ours)
    assert ours[-1]["counters"][3] > 0          # cached tokens


def test_preempt_before_prefill_never_registers_pages():
    """A row admitted and preempted in the same schedule() was never
    prefilled: it stashes nothing.  A prefilled row's departure does."""
    pcfg = kv.PagedCacheConfig(page_size=4, n_pages=8, max_seqs=2,
                               max_blocks=4)
    s = sched.Scheduler(pcfg, prefix_cache=True)
    s.submit(sched.Request(rid=0, tokens=np.arange(6, dtype=np.int32),
                           max_new=4))
    (seq,) = s.schedule().admitted
    s._preempt_youngest()
    assert len(s.prefix) == 0
    assert s.prefix.lookup(seq.req.tokens)[1] == 0
    (seq2,) = s.schedule().admitted
    seq2.emitted = [1]
    s.complete(seq2)
    assert s.prefix.lookup(seq2.req.tokens)[1] == 6


def _guard_trace(mod, pcfg_cls):
    """The JAX test's adversarial trace: two page-hungry rows and a late
    small one on a tiny pool, one token a row a step."""
    s = mod.Scheduler(pcfg_cls(page_size=2, n_pages=14, max_seqs=3,
                               max_blocks=8), preempt_shield=2)
    for rid, (n, m) in enumerate(((4, 12), (4, 12), (2, 6))):
        s.submit(mod.Request(rid=rid, tokens=np.ones(n, np.int32),
                             max_new=m))
    trace = []
    for _ in range(40):
        plan = s.schedule()
        for seq in plan.admitted:
            seq.emitted = [0]
        for seq in list(s.running.values()):
            seq.emitted.append(0)
            seq.length += 1
            if len(seq.emitted) >= seq.req.max_new:
                trace.append(("done", seq.rid))
                s.complete(seq)
        trace.append(("step", plan.preempted,
                      sorted(q.rid for q in s.running.values())))
    return trace


def test_starvation_guards_equal_jax():
    """The preemption shield bounds how often one request is bounced,
    as in JAX's scheduler: the same trace step by step."""
    ours = _guard_trace(sched, kv.PagedCacheConfig)
    assert ours == _guard_trace(jsched, jkv.PagedCacheConfig)
    assert ("done", 2) in ours
    assert sum(ev[1].count(2) for ev in ours if ev[0] == "step") <= 2


# ------------------------------------------------------------ the engine --
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("path", sorted(PATHS))
def test_prefix_engine_matches_jax(smoke, path, mode):
    """Shared-prefix traffic with a repeated prompt, phase-barrier
    (prompt_pad 40) and chunked: JAX's greedy tokens and step stats, rns_ops
    times the layers; pages are shared, cached tokens served and a
    partial tail split copy-on-write."""
    jcfg, jparams, cfg, model = smoke
    rns, jkw, pkw = PATHS[path]
    jcfg, cfg = _with_rns(jcfg, cfg, rns)
    prompts = _shared_prompts(cfg.vocab)
    kw = dict(max_cache=48, page_size=8, max_seqs=2, max_new_tokens=4,
              prefix_cache=True, **MODES[mode])
    jres, jstats = JEngine(jparams, jcfg, JServeConfig(**kw, **jkw)).run(
        prompts)
    eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(**kw, **pkw),
                           device="cpu")
    res, stats = eng.run(prompts)
    assert _tokens(res) == _tokens(jres)
    assert res[4].tolist() == res[0].tolist()       # the repeat
    assert len(stats["steps"]) == len(jstats["steps"])
    for s, js in zip(stats["steps"], jstats["steps"]):
        assert {k: s[k] for k in STAT_KEYS} == {k: js[k] for k in STAT_KEYS}
        assert s["rns_ops"].as_dict() == {
            f: getattr(js["rns_ops"], f) * cfg.n_layers for f in FIELDS}
    for k in ("cache_hit_tokens", "cow_splits", "pages_allocated",
              "pages_shared", "n_preemptions"):
        assert stats[k] == jstats[k], k
    assert stats["cache_hit_tokens"] > 0 and stats["pages_shared"] > 0
    assert stats["cow_splits"] > 0
    want = {"mixed"} if mode == "chunked" else {"decode", "prefill"}
    assert set(eng.programs) == want | {"cow"}
    assert stats["captures"] == {k: 0 for k in want | {"cow"}}


def test_identical_prompt_zero_redundant_writes(smoke):
    """The second admission of an identical prompt adopts every block:
    its prefill blits nothing onto them (the shared pages stay bit for
    bit), and the one fresh page it takes is the COW split of the
    partial tail.  Tokens equal the first run's."""
    _, _, cfg, model = smoke
    p = np.random.default_rng(4).integers(1, cfg.vocab, (20,)).astype(
        np.int32)                                   # 2 full blocks + tail
    eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(
        max_cache=40, max_new_tokens=5, page_size=8, max_seqs=1,
        prefix_cache=True), device="cpu")
    first, _ = eng.run([p.copy()])
    shared = sorted(pg for pg, _ in eng.sched.prefix._entries.values())
    assert len(shared) == 3
    frozen = (eng.cache.k_pages[:, shared].clone(),
              eng.cache.v_pages[:, shared].clone())
    allocated = eng.sched.alloc.pages_allocated
    again, stats = eng.run([p.copy()])
    assert list(again.values())[0].tolist() == list(first.values())[0].tolist()
    assert stats["cache_hit_tokens"] == 20 and stats["cow_splits"] == 1
    assert eng.sched.alloc.pages_allocated == allocated + 1
    assert torch.equal(eng.cache.k_pages[:, shared], frozen[0])
    assert torch.equal(eng.cache.v_pages[:, shared], frozen[1])


def test_warm_up_touches_only_the_trash_page(smoke):
    """Building the mixed and COW programs writes no real page."""
    _, _, cfg, model = smoke
    for mode in MODES.values():
        eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(
            max_cache=48, page_size=8, max_seqs=2, prefix_cache=True,
            **mode), device="cpu")
        c = eng.cache
        assert not c.k_pages[:, 1:].any() and not c.v_pages[:, 1:].any()
        assert all(p.ops is not None for p in eng.programs.values())


# ------------------------------------------------------------ on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels run "
                    "only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("path", sorted(PATHS))
def test_gpu_captured_prefix_engine_equals_eager(cuda, smoke, path, mode):
    """The captured engine with the prefix cache (COW copy captured once)
    against the eager one on the card: the same tokens, rns_ops and
    sharing; the repeated prompt equals its first run."""
    jcfg, _, cfg, model = smoke
    rns, _, pkw = PATHS[path]
    _, cfg = _with_rns(jcfg, cfg, rns)
    prompts = _shared_prompts(cfg.vocab)
    kw = dict(max_cache=48, page_size=8, max_seqs=2, max_new_tokens=4,
              prefix_cache=True, **MODES[mode], **pkw)
    out = []
    for graphs in (False, True):
        eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(**kw),
                               device="cuda", graphs=graphs)
        res, stats = eng.run(prompts)
        out.append((_tokens(res), [s["rns_ops"].as_dict()
                                   for s in stats["steps"]],
                    {k: stats[k] for k in ("cache_hit_tokens", "cow_splits",
                                           "pages_shared")},
                    stats["captures"]))
    (want, wops, wshare, wcap), (got, ops, share, cap) = out
    assert got == want and ops == wops and share == wshare
    assert share["cow_splits"] > 0 and got[4] == got[0]
    assert set(cap.values()) == {1} and set(wcap.values()) == {0}
    assert "cow" in cap
