"""Chunked prefill through the packed mixed-phase step, ``prompt_pad`` and
``cache_dtype``: the port against the JAX package on the smoke config.

The port's ``ContinuousEngine(ServeConfig(chunked_prefill=True))`` runs
every step as ONE packed step over ``token_budget`` lanes
(``models/model.py::mixed_step``).  On the same seeded traffic it must
emit the JAX engine's greedy tokens with the same step stats, its
``rns_ops`` the JAX engine's times the layers (ROADMAP C.3), on the
float path, per-op rns9 and the fused resident deferred rns9 path --
through a preemption in mid-chunk and prompts beyond ``prompt_pad`` --
and its scheduler must make the JAX scheduler's packed plans.  The
``gpu`` cases capture the mixed step on the card and hold it to eager.
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
from repro.core.rns_matmul import RnsDotConfig as JRnsDotConfig
from repro.models import model as JM
from repro.models import resident as jresident
from repro.serve import kv_cache as jkv
from repro.serve import scheduler as jsched
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.base import get_config
from repro_torch.core.rns_matmul import RnsDotConfig
from repro_torch.models import model as M
from repro_torch.models.params import params_from_jax
from repro_torch.serve import kv_cache as kv
from repro_torch.serve import scheduler as sched
from repro_torch.serve.engine import ContinuousEngine, ServeConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIELDS = ("converts", "matmuls", "normalizes", "fused", "fallbacks",
          "weight_converts")
# |logit| is O(1); XLA and PyTorch float32 ops differ by a few ulps,
# which a rare 8-bit requantization flip amplifies to ~1e-3
LOGIT_ATOL = 5e-3
# each path: (the model's RNS config or None, the JAX engine's overrides,
# the port's)
FUSED = dict(resident_weights=True, rns_defer=True)
PATHS = {
    "float": (False, {}, {}),
    "rns9": (True, {}, {}),
    "fused": (True, dict(FUSED, rns_backend="pallas_fused_interpret"),
              dict(FUSED, rns_backend="cuda_fused")),
}
CHUNKED = dict(max_cache=48, max_seqs=4, page_size=8, max_new_tokens=6,
               chunked_prefill=True, token_budget=16, chunk_size=8)
# a pool too small for the load: row 1 is preempted in mid-chunk; two
# of the three prompts are longer than prompt_pad
PREEMPT = dict(max_cache=24, max_seqs=3, page_size=4, n_pages=8,
               max_new_tokens=4, chunked_prefill=True, token_budget=8,
               chunk_size=4, prompt_pad=8)
# stats that are not timings
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


def _prompts(vocab, lens=(13, 21, 5, 9), seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (t,)).astype(np.int32) for t in lens]


def _tokens(res) -> dict:
    return {r: t.tolist() for r, t in res.items()}


def _serve_both(smoke, path, prompts, kw):
    """The JAX engine and the port's on one path and config: (port
    engine, port results, port stats, JAX results, JAX stats)."""
    jcfg, jparams, cfg, model = smoke
    rns, jkw, pkw = PATHS[path]
    jcfg, cfg = _with_rns(jcfg, cfg, rns)
    jres, jstats = JEngine(jparams, jcfg, JServeConfig(**kw, **jkw)).run(
        prompts)
    eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(**kw, **pkw),
                           device="cpu")
    res, stats = eng.run(prompts)
    return eng, res, stats, jres, jstats


def _retarget(model, cfg):
    """A copy of the port's model under ``cfg`` (the same weights)."""
    m = copy.deepcopy(model)
    m.cfg = cfg
    return m


def assert_steps_equal(stats, jstats, n_layers):
    """Every step's stats equal the JAX engine's, rns_ops times the
    layers (the JAX engine's scan traces one layer)."""
    assert len(stats["steps"]) == len(jstats["steps"])
    for s, js in zip(stats["steps"], jstats["steps"]):
        assert {k: s[k] for k in STAT_KEYS} == {k: js[k] for k in STAT_KEYS}
        want = {f: getattr(js["rns_ops"], f) * n_layers for f in FIELDS}
        assert s["rns_ops"].as_dict() == want
    for k in ("n_requests", "n_steps", "total_new_tokens", "n_preemptions",
              "cache_hit_tokens", "cow_splits", "pages_allocated",
              "pages_shared"):
        assert stats[k] == jstats[k], k


# ------------------------------------------------------------ the engine --
@pytest.mark.parametrize("path", sorted(PATHS))
def test_chunked_engine_matches_jax(smoke, path):
    """Mixed-length traffic through one mixed program: JAX's greedy
    tokens and step stats; some step really mixes both phases."""
    prompts = _prompts(smoke[2].vocab)
    eng, res, stats, jres, jstats = _serve_both(smoke, path, prompts,
                                                CHUNKED)
    assert _tokens(res) == _tokens(jres)
    assert_steps_equal(stats, jstats, eng.cfg.n_layers)
    assert any(s["prefill_tokens"] > 0 and s["decode_tokens"] > 0
               for s in stats["steps"])
    assert sum(s["prefill_tokens"] for s in stats["steps"]) == sum(
        len(p) for p in prompts)
    assert set(eng.programs) == {"mixed"}
    assert stats["captures"] == {"mixed": 0}        # eager on the CPU
    if eng.cfg.rns is not None:
        assert all(s["rns_ops"].as_dict() == eng.programs["mixed"].ops
                   .as_dict() for s in stats["steps"])


@pytest.mark.parametrize("path", ["float", "rns9"])
def test_chunked_preempts_mid_chunk_beyond_prompt_pad(smoke, path):
    """A pool too small for the load preempts a row in mid-chunk; two
    prompts are longer than prompt_pad (chunked mode streams them in).
    Tokens, preemptions and step stats equal the JAX engine's."""
    prompts = _prompts(smoke[2].vocab, lens=(6, 14, 10), seed=17)
    assert max(len(p) for p in prompts) > PREEMPT["prompt_pad"]
    jcfg, jparams, cfg, model = smoke
    _, cfg = _with_rns(jcfg, cfg, PATHS[path][0])
    eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(**PREEMPT),
                           device="cpu")
    mid_chunk = []
    preempt = eng.sched._preempt_youngest

    def watched():
        running = eng.sched.running.values()
        cands = [s for s in running
                 if s.req.n_preempts < eng.sched.preempt_shield]
        victim = max(cands or running, key=lambda s: s.admit_seq)
        mid_chunk.append(victim.prefilling and victim.todo[0] > 0)
        return preempt()

    eng.sched._preempt_youngest = watched
    res, stats = eng.run(prompts)
    jcfg, _ = _with_rns(jcfg, cfg, PATHS[path][0])
    jres, jstats = JEngine(jparams, jcfg, JServeConfig(**PREEMPT)).run(
        prompts)
    assert any(mid_chunk), "no row was preempted in mid-chunk"
    assert stats["n_preemptions"] > 0
    assert _tokens(res) == _tokens(jres)
    assert_steps_equal(stats, jstats, cfg.n_layers)


def test_one_mixed_program_across_phase_mixes(smoke):
    """Very different traffic through one engine: one mixed program,
    its buffers at the same addresses all along, JAX's tokens each time;
    building it wrote only the trash page."""
    jcfg, jparams, cfg, model = smoke
    kw = dict(CHUNKED, max_new_tokens=4)
    eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(**kw),
                           device="cpu")
    c = eng.cache
    assert not c.k_pages[:, 1:].any() and not c.v_pages[:, 1:].any()
    prog = eng.programs["mixed"]
    ptrs = {k: b.data_ptr() for k, b in prog.inputs.items()}
    jeng = JEngine(jparams, jcfg, JServeConfig(**kw))
    for lens in ((13, 21, 5, 9), (3,), (17, 2), (8, 8, 8, 8)):
        prompts = _prompts(cfg.vocab, lens=lens)
        res, _ = eng.run(prompts)
        jres, _ = jeng.run(prompts)
        assert [v.tolist() for v in res.values()] == [
            v.tolist() for v in jres.values()]
    assert eng.programs == {"mixed": prog}
    assert {k: b.data_ptr() for k, b in prog.inputs.items()} == ptrs
    assert jeng._mixed._cache_size() == 1


def test_mixed_step_logits_match_jax(smoke):
    """One packed step straight through the model: two rows' chunks and
    a decode lane against pages already holding earlier KV, pad lanes
    on the trash page; logits within LOGIT_ATOL of JAX's mixed_step,
    the same argmax, every lane's K/V written where JAX writes it."""
    jcfg, jparams, cfg, model = smoke
    jcfg, cfg = _with_rns(jcfg, cfg, True)
    m = _retarget(model, cfg)
    bs, R, nb = 8, 3, 4
    pcfg = kv.PagedCacheConfig(page_size=bs, n_pages=1 + R * nb, max_seqs=R,
                               max_blocks=nb)
    jpcfg = jkv.PagedCacheConfig(page_size=bs, n_pages=1 + R * nb,
                                 max_seqs=R, max_blocks=nb)
    rng = np.random.default_rng(2)
    bt = np.arange(1, 1 + R * nb, dtype=np.int32).reshape(R, nb)
    # earlier KV: random pages (a row's first chunk and a decode row)
    kpg = rng.standard_normal((cfg.n_layers, 1 + R * nb, bs, cfg.n_kv_heads,
                               cfg.d_head)).astype(np.float32)
    vpg = rng.standard_normal(kpg.shape).astype(np.float32)
    cache = kv.make_paged_cache(cfg, pcfg, device="cpu")
    cache.k_pages.copy_(torch.from_numpy(kpg))
    cache.v_pages.copy_(torch.from_numpy(vpg))
    kv.set_tables(cache, bt, np.zeros(R, np.int32))
    jcache = jkv.set_tables(jkv.make_paged_cache(jcfg, jpcfg,
                                                 dtype=jnp.float32),
                            bt, np.zeros(R, np.int32))
    jcache = {"l0": dict(jcache["l0"], k_pages=jnp.asarray(kpg),
                         v_pages=jnp.asarray(vpg))}
    N = 16
    seg = np.full((N,), -1, np.int32)
    pos = np.zeros((N,), np.int32)
    dec = np.zeros((N,), bool)
    seg[:5], pos[:5] = 0, np.arange(8, 13)          # row 0: second chunk
    seg[5:11], pos[5:11] = 2, np.arange(6)          # row 2: first chunk
    seg[11], pos[11], dec[11] = 1, 19, True         # row 1: decode lane
    valid = seg >= 0
    tok = np.where(valid, rng.integers(1, cfg.vocab, (N,)), 0).astype(np.int32)
    jl, jys = JM.mixed_step(jparams, jcfg, *(jnp.asarray(a) for a in (
        tok, seg, pos, dec, valid)), jcache)
    t = {k: torch.from_numpy(a.astype(np.int64) if a.dtype != bool else a)
         for k, a in dict(tok=tok, seg=seg, pos=pos, dec=dec,
                          valid=valid).items()}
    lg = M.mixed_step(m, cfg, t["tok"], t["seg"], t["pos"], t["dec"],
                      t["valid"], cache)
    jl = np.asarray(jl)
    np.testing.assert_allclose(lg.numpy()[valid], jl[valid], rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_array_equal(lg.argmax(-1).numpy()[valid],
                                  jl.argmax(-1)[valid])
    # the K/V planes land where JAX put them (values within float noise)
    jk = np.asarray(jys["l0"]["k_pages"])
    written = np.abs(jk - kpg) > 0
    np.testing.assert_array_equal(cache.k_pages.numpy()[:, 1:] != kpg[:, 1:],
                                  written[:, 1:])
    np.testing.assert_allclose(cache.k_pages.numpy(), jk, rtol=0, atol=1e-4)


def test_write_packed_tokens_bit_equal_to_jax():
    """Packed scatters: lanes of several rows, pad lanes (seg -1) and a
    position past its row's table go where JAX sends them (the last two
    to the trash page); every real page bit-equal."""
    rng = np.random.default_rng(4)
    P, bs, R, nb, N = 9, 4, 3, 2, 12
    pages = rng.standard_normal((P, bs, 2, 3)).astype(np.float32)
    bt = np.array([[3, 5], [1, 0], [7, 8]], np.int32)
    seg = np.array([0, 0, 0, 2, 2, 1, -1, -1, 1, 0, 2, 2], np.int32)
    pos = np.array([0, 1, 5, 6, 7, 2, 0, 3, 9, 6, 4, 1], np.int32)
    vals = rng.standard_normal((N, 2, 3)).astype(np.float32)
    want = np.asarray(jkv.write_packed_tokens(jnp.asarray(pages),
                                              jnp.asarray(bt),
                                              jnp.asarray(seg),
                                              jnp.asarray(pos),
                                              jnp.asarray(vals)))
    got = torch.from_numpy(pages.copy())
    kv.write_packed_tokens(got, torch.from_numpy(bt).long(),
                           torch.from_numpy(seg).long(),
                           torch.from_numpy(pos).long(),
                           torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])
    assert (got.numpy()[1:] != pages[1:]).any()


# ------------------------------------------------ prompt_pad, cache_dtype --
def test_prompt_pad_rounds_up_to_a_page_and_checks_like_jax(smoke):
    jcfg, jparams, cfg, model = smoke
    for pad in (None, 8, 10, 17, 48):
        kw = dict(max_cache=48, page_size=8, max_seqs=2, prompt_pad=pad)
        eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(**kw),
                               device="cpu")
        jeng = JEngine(jparams, jcfg, JServeConfig(**kw))
        assert eng.prompt_pad == jeng.prompt_pad
        assert eng.programs["prefill"].inputs["tokens"].shape == (
            1, jeng.prompt_pad)
    for engine, scfg in ((ContinuousEngine, ServeConfig),
                         (JEngine, JServeConfig)):
        args = ((_retarget(model, cfg),) if engine is ContinuousEngine
                else (jparams, jcfg))
        extra = {"device": "cpu"} if engine is ContinuousEngine else {}
        with pytest.raises(ValueError, match="prompt_pad"):
            engine(*args, scfg(max_cache=48, page_size=8, prompt_pad=49),
                   **extra)
        eng = engine(*args, scfg(max_cache=48, page_size=8, prompt_pad=8),
                     **extra)
        with pytest.raises(ValueError, match="prompt_pad"):
            eng.submit(np.ones(9, np.int32))


@pytest.mark.parametrize("path", ["float", "rns9"])
def test_prompt_pad_engine_matches_jax(smoke, path):
    """The phase-barrier engine with prompts padded to 24, not to the
    row's 48: JAX's tokens and step stats."""
    prompts = _prompts(smoke[2].vocab, lens=(13, 21, 5))
    kw = dict(max_cache=48, page_size=8, max_seqs=2, max_new_tokens=5,
              prompt_pad=20)
    eng, res, stats, jres, jstats = _serve_both(smoke, path, prompts, kw)
    assert eng.prompt_pad == 24
    assert _tokens(res) == _tokens(jres)
    assert_steps_equal(stats, jstats, eng.cfg.n_layers)


@pytest.mark.parametrize("path", ["float", "rns9"])
def test_cache_dtype_bfloat16_matches_jax(smoke, path):
    """A bfloat16 page pool (writes round to nearest even, reads upcast
    exactly): the JAX engine's tokens with the same cache_dtype."""
    prompts = _prompts(smoke[2].vocab, lens=(13, 21, 5))
    kw = dict(max_cache=48, page_size=8, max_seqs=2, max_new_tokens=6,
              cache_dtype="bfloat16")
    eng, res, stats, jres, jstats = _serve_both(smoke, path, prompts, kw)
    assert eng.cache.k_pages.dtype == torch.bfloat16
    assert eng.cache.v_pages.dtype == torch.bfloat16
    assert _tokens(res) == _tokens(jres)
    assert_steps_equal(stats, jstats, eng.cfg.n_layers)


def test_bfloat16_write_rounds_like_jax():
    """The bf16 pool's writes round as JAX's ``astype``: bit-equal."""
    rng = np.random.default_rng(8)
    pages = np.zeros((5, 4, 2, 3), np.float32)
    bt = np.array([[1, 2], [3, 4]], np.int32)
    lengths = np.array([3, 5], np.int32)
    vals = rng.standard_normal((2, 2, 3)).astype(np.float32)
    want = np.asarray(jkv.write_token(jnp.asarray(pages, jnp.bfloat16),
                                      jnp.asarray(bt), jnp.asarray(lengths),
                                      jnp.asarray(vals)).astype(jnp.float32))
    got = torch.zeros(pages.shape, dtype=torch.bfloat16)
    kv.write_token(got, torch.from_numpy(bt).long(),
                   torch.from_numpy(lengths).long(), torch.from_numpy(vals))
    np.testing.assert_array_equal(got.float().numpy(), want)


# ------------------------------------------------------------ ServeConfig --
@pytest.mark.parametrize("kw,field", [
    (dict(chunked_prefill=True, token_budget=0), "token_budget"),
    (dict(chunked_prefill=True, cache_dtype="bfloat16"), "cache_dtype"),
    (dict(chunk_size=8), "chunk_size"),
    (dict(chunked_prefill=True, chunk_size=0), "chunk_size"),
    (dict(chunked_prefill=True, chunk_size=12, page_size=8), "chunk_size"),
    (dict(chunked_prefill=True, chunk_size=32, token_budget=16),
     "chunk_size"),
    (dict(prefill_reserve=4), "prefill_reserve"),
    (dict(chunked_prefill=True, prefill_reserve=16, token_budget=16),
     "prefill_reserve"),
    (dict(chunked_prefill=True, prefill_reserve=-1, token_budget=16),
     "prefill_reserve"),
    (dict(eos_id=-2), "eos_id"),
    (dict(per_layer_profiles=True), "per_layer_profiles"),
    (dict(window_tokens=0), "window_tokens"),
])
def test_serve_config_errors_match_jax(kw, field):
    """Every cross-field check of JAX's ServeConfig on the ported fields
    raises the same exception type, naming the field."""
    with pytest.raises(ValueError, match=field):
        JServeConfig(max_cache=48, **kw)
    with pytest.raises(ValueError, match=field):
        ServeConfig(max_cache=48, **kw)


# ------------------------------------------------------------ scheduler --
def _drive_mixed(mod, pcfg_cls, traffic, *, prefix_cache=False, steps=80,
                 **kw):
    """Drive a chunked scheduler as the engine does: schedule, pack one
    step, consume its segments (a chunk's last lane is the first token,
    a decode lane one token), register landed blocks, complete rows at
    max_new.  Logs every step's plan."""
    pcfg = pcfg_cls(page_size=4, n_pages=8, max_seqs=3, max_blocks=6)
    s = mod.Scheduler(pcfg, prefix_cache=prefix_cache, chunked=True, **kw)
    for rid, (toks, max_new) in enumerate(traffic):
        s.submit(mod.Request(rid=rid, tokens=toks, max_new=max_new))
    log = []
    for _ in range(steps):
        if not s.has_work:
            break
        plan = s.schedule()
        segs = s.plan_mixed()
        for g in segs:
            seq = g.seq
            if g.kind == "chunk":
                if g.last:
                    seq.emitted = [int(seq.req.tokens[-1])]
                    seq.last_token = seq.emitted[0]
                s.register_chunks(seq)
                if seq.emitted and len(seq.emitted) >= seq.req.max_new:
                    s.complete(seq)
            else:
                seq.emitted.append(seq.length % 7)
                seq.length += 1
                if (len(seq.emitted) >= seq.req.max_new
                        or seq.length + 1 > pcfg.tokens_per_seq):
                    s.complete(seq)
        bt, lengths, active, _ = s.tables()
        log.append({
            "admitted": [(q.rid, q.cached_tokens, sorted(q.shared_blocks))
                         for q in plan.admitted],
            "preempted": plan.preempted, "cow": plan.cow,
            "segs": [(g.seq.rid, g.kind, g.positions.tolist(),
                      None if g.tokens is None else g.tokens.tolist(),
                      g.last) for g in segs],
            "bt": bt.tolist(), "lengths": lengths.tolist(),
            "free": s.alloc.n_free,
            "refcounts": [s.alloc.refcount(p) for p in range(pcfg.n_pages)],
            "allocated": s.alloc.pages_allocated,
            "shared": s.alloc.pages_shared})
    return log


@pytest.mark.parametrize("seed", [4, 5, 7])
def test_mixed_scheduler_plans_equal_jax(seed):
    """Packed segments, preemptions, block tables, free pages and
    refcounts equal the JAX scheduler's step by step."""
    rng = np.random.default_rng(seed)
    traffic = [(rng.integers(0, 50, int(rng.integers(2, 14))).astype(
        np.int32), int(rng.integers(2, 8))) for _ in range(7)]
    kw = dict(token_budget=6, chunk_size=4, prefill_reserve=3)
    ours = _drive_mixed(sched, kv.PagedCacheConfig, traffic, **kw)
    theirs = _drive_mixed(jsched, jkv.PagedCacheConfig, traffic, **kw)
    assert ours == theirs
    assert any(step["preempted"] for step in ours)
    assert any(len({g[1] for g in step["segs"]}) == 2 for step in ours)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fused", [False, True])
def test_jax_mixed_op_counts_written_in_chip_smoke(smoke, fused):
    """chip_smoke.py holds every [serve_chunked] step to the JAX mixed
    step's tally for one layer (traced on the CPU, no FLOPs spent) times
    the layers: the decode step's, per-op and fused resident deferred."""
    jcfg, jparams, _, _ = smoke
    jcfg, _ = _with_rns(jcfg, get_config("smollm-135m", smoke=True), True)
    if fused:
        jcfg = dataclasses.replace(jcfg, rns=dataclasses.replace(
            jcfg.rns, backend="pallas_fused_interpret", defer=True))
        jparams = jresident.encode_resident(jparams, jcfg)
    pcfg = jkv.PagedCacheConfig(page_size=8, n_pages=9, max_seqs=2,
                                max_blocks=4)
    cache = jax.eval_shape(
        lambda: jkv.make_paged_cache(jcfg, pcfg, dtype=jnp.float32))
    zi = jnp.zeros((16,), jnp.int32)
    zb = jnp.zeros((16,), bool)
    counts = jdispatch.trace_op_counts(
        lambda p, t: JM.mixed_step(p, jcfg, t, zi, zi, zb, zb, cache),
        jparams, zi)
    cs = _chip_smoke()
    want = cs.JAX_FUSED_DECODE_RNS_OPS if fused else cs.JAX_DECODE_RNS_OPS
    assert {f: getattr(counts, f) for f in FIELDS} == want


# ------------------------------------------------------------ on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels run "
                    "only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(PATHS))
def test_gpu_captured_mixed_step_equals_eager(cuda, smoke, path):
    """The captured mixed program against the eager one on the card,
    through a preemption in mid-chunk: the same tokens and rns_ops, one
    capture across every phase mix."""
    _, _, cfg, model = smoke
    _, cfg = _with_rns(smoke[0], cfg, PATHS[path][0])
    prompts = _prompts(cfg.vocab, lens=(6, 14, 10, 13, 21), seed=17)
    kw = dict(PREEMPT, max_cache=40, n_pages=12, **PATHS[path][2])
    out = []
    for graphs in (False, True):
        eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(**kw),
                               device="cuda", graphs=graphs)
        res, stats = eng.run(prompts)
        out.append((_tokens(res), [s["rns_ops"].as_dict()
                                   for s in stats["steps"]],
                    stats["captures"], stats["n_preemptions"]))
    (want, wops, wcap, _), (got, ops, cap, npre) = out
    assert got == want and ops == wops
    assert wcap == {"mixed": 0} and cap == {"mixed": 1}
    assert npre > 0
