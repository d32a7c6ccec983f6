"""Speculative (n-gram prompt-lookup) decoding: the port against the JAX
package on the smoke config.

The port's ``ContinuousEngine(ServeConfig(spec_decode=True))`` runs ONE
verify program ([R, spec_k + 1] tokens: ``decode_window``, the argmax,
the greedy accept and the length advance) in place of the decode
program, or spec windows in the mixed step's lanes when chunked.  Its
tokens must be the JAX engine's solo (bucketed) greedy run on the float,
per-op rns9 and deferred rns9 paths, with the prefix cache and under
chunking; its step stats and ``rns_ops`` those of the JAX engine, the
ops times the layers (ROADMAP C.3).  The model, cache and drafting
pieces are held to JAX's one by one.  Tolerances: tokens, counts and
scatters exact; logits within ``LOGIT_ATOL``.
"""

import copy
import dataclasses
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as j_get_config
from repro.core.rns_matmul import RnsDotConfig as JRnsDotConfig
from repro.models import model as JM
from repro.serve import kv_cache as jkv
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import Engine as JBucketed
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.base import get_config
from repro_torch.core.rns_matmul import RnsDotConfig
from repro_torch.models import model as M
from repro_torch.models.params import params_from_jax
from repro_torch.serve import kv_cache as kv
from repro_torch.serve.engine import ContinuousEngine, ServeConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIELDS = ("converts", "matmuls", "normalizes", "fused", "fallbacks",
          "weight_converts")
# |logit| is O(1); XLA and PyTorch float32 ops differ by a few ulps,
# which a rare 8-bit requantization flip amplifies to ~1e-3
LOGIT_ATOL = 5e-3
STAT_KEYS = ("step", "admitted", "preempted", "finished", "active",
             "waiting", "new_tokens", "decoded", "decode_rows",
             "spec_proposed", "spec_accepted", "pages_window_evicted",
             "prefill_tokens", "decode_tokens", "cow_splits",
             "cache_hit_tokens")
SPEC = dict(max_cache=64, max_new_tokens=8, page_size=16, max_seqs=4,
            spec_decode=True, spec_k=3)


@pytest.fixture(scope="module")
def smoke():
    jcfg = j_get_config("smollm-135m", smoke=True)
    cfg = get_config("smollm-135m", smoke=True)
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)[0]
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jcfg, jparams, cfg, model


def _with_rns(jcfg, cfg, defer=None):
    return (dataclasses.replace(jcfg, rns=JRnsDotConfig(
                profile="rns9", qx=8, qw=8, defer=bool(defer)),
                rns_targets="mlp"),
            dataclasses.replace(cfg, rns=RnsDotConfig(
                profile="rns9", qx=8, qw=8, defer=bool(defer)),
                rns_targets="mlp"))


def _retarget(model, cfg):
    m = copy.deepcopy(model)
    m.cfg = cfg
    return m


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (t,)).astype(np.int32) for t in lens]


def _tokens(res) -> dict:
    return {r: t.tolist() for r, t in res.items()}


def _solo(jparams, jcfg, prompt, max_new, max_cache):
    """The JAX bucketed engine's solo greedy run of one prompt."""
    eng = JBucketed(jparams, jcfg, JServeConfig(max_cache=max_cache,
                                                max_new_tokens=max_new))
    return eng.generate(prompt[None])[0].tolist()


def assert_steps_equal(stats, jstats, n_layers):
    assert len(stats["steps"]) == len(jstats["steps"])
    for s, js in zip(stats["steps"], jstats["steps"]):
        assert {k: s[k] for k in STAT_KEYS} == {k: js[k] for k in STAT_KEYS}
        want = {f: getattr(js["rns_ops"], f) * n_layers for f in FIELDS}
        assert s["rns_ops"].as_dict() == want
    for k in ("n_steps", "total_new_tokens", "tokens_per_step",
              "acceptance_rate", "pages_shared", "cow_splits"):
        assert stats[k] == jstats[k], k


# ------------------------------------------------------------ the engine --
def test_spec_tokens_equal_jax_solo_one_verify_program(smoke):
    """Mixed-length traffic: every row's tokens are JAX's solo run, the
    step stats JAX's spec engine's; one verify program and one prefill
    program, no decode program."""
    jcfg, jparams, cfg, model = smoke
    prompts = _prompts(cfg.vocab, (7, 20, 33), seed=0)
    eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(**SPEC),
                           device="cpu")
    res, stats = eng.run(prompts)
    jres, jstats = JEngine(jparams, jcfg, JServeConfig(**SPEC)).run(prompts)
    assert _tokens(res) == _tokens(jres)
    for i, p in enumerate(prompts):
        assert res[i].tolist() == _solo(jparams, jcfg, p, 8, 64), i
    assert_steps_equal(stats, jstats, cfg.n_layers)
    assert set(eng.programs) == {"verify", "prefill"}
    assert stats["captures"] == {"verify": 0, "prefill": 0}   # eager, CPU
    assert stats["total_new_tokens"] == 3 * 8
    assert stats["tokens_per_step"] >= 1.0


@pytest.mark.parametrize("defer", [False, True])
def test_spec_rns_tokens_and_op_counts_equal_jax(smoke, defer):
    """rns9, per-op and deferred: tokens of JAX's solo runs; per step the
    verify program's tallies plus the prefill's per admission, each
    JAX's (traced by the JAX spec engine's ``_rns_ops``) times the
    layers."""
    jcfg, jparams, cfg, model = smoke
    jcfg, cfg = _with_rns(jcfg, cfg, defer)
    prompts = _prompts(cfg.vocab, (7, 33), seed=2)
    kw = dict(SPEC, max_new_tokens=6, max_seqs=2)
    eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(**kw),
                           device="cpu")
    res, stats = eng.run(prompts)
    for i, p in enumerate(prompts):
        assert res[i].tolist() == _solo(jparams, jcfg, p, 6, 64), i
    jeng = JEngine(jparams, jcfg, JServeConfig(**kw))
    jeng.sched.submit(_request())
    jeng.sched.schedule()
    for s in stats["steps"]:
        want = jeng._rns_ops(len(s["admitted"]))
        assert s["rns_ops"].as_dict() == {
            f: getattr(want, f) * cfg.n_layers for f in FIELDS}
        assert s["rns_ops"].as_dict() == eng.programs["verify"].ops.add(
            eng.programs["prefill"].ops, times=len(s["admitted"])).as_dict()
    assert sum(len(s["admitted"]) for s in stats["steps"]) == 2


def test_spec_acceptance_shortens_runs(smoke):
    """Seed 1: the n-gram proposer predicts the smoke model's greedy
    continuation often enough that the run takes fewer verify steps
    than tokens; tokens equal JAX's solo run."""
    jcfg, jparams, cfg, model = smoke
    p = _prompts(cfg.vocab, (12,), seed=1)[0]
    kw = dict(max_cache=96, max_new_tokens=24, page_size=16, max_seqs=1,
              spec_decode=True, spec_k=4)
    eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(**kw),
                           device="cpu")
    res, stats = eng.run([p])
    assert res[0].tolist() == _solo(jparams, jcfg, p, 24, 96)
    assert len(res[0]) == 24
    assert stats["acceptance_rate"] > 0.0
    assert stats["tokens_per_step"] > 1.0
    _, jstats = JEngine(jparams, jcfg, JServeConfig(**kw)).run([p])
    assert (stats["tokens_per_step"], stats["acceptance_rate"]) == (
        jstats["tokens_per_step"], jstats["acceptance_rate"])


def test_spec_eos_stops_row_mid_window(smoke):
    """An eos accepted inside a draft run cuts the row exactly where
    plain decoding stops; the tokens accepted past it are dropped."""
    jcfg, jparams, cfg, model = smoke
    p = _prompts(cfg.vocab, (9,), seed=7)[0]
    kw = dict(max_cache=32, max_new_tokens=8, page_size=16, max_seqs=1)
    full, _ = ContinuousEngine(_retarget(model, cfg), ServeConfig(**kw),
                               device="cpu").run([p])
    toks = full[0].tolist()
    eos = int(toks[2])
    skw = dict(kw, eos_id=eos, spec_decode=True, spec_k=3)
    res, _ = ContinuousEngine(_retarget(model, cfg), ServeConfig(**skw),
                              device="cpu").run([p])
    assert res[0].tolist() == toks[: toks.index(eos) + 1]
    jres, _ = JEngine(jparams, jcfg, JServeConfig(**skw)).run([p])
    assert res[0].tolist() == jres[0].tolist()


def test_spec_with_prefix_cache(smoke):
    """Shared-prefix traffic with both features on: JAX's solo tokens,
    pages shared, one verify, one prefill and one copy program."""
    jcfg, jparams, cfg, model = smoke
    rng = np.random.default_rng(8)
    shared = rng.integers(1, cfg.vocab, (32,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(1, cfg.vocab, (k,))
                               .astype(np.int32)]) for k in (4, 9, 0)]
    kw = dict(max_cache=80, max_new_tokens=8, page_size=16, max_seqs=2,
              prefix_cache=True, spec_decode=True, spec_k=3)
    eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(**kw),
                           device="cpu")
    res, stats = eng.run(prompts)
    for i, p in enumerate(prompts):
        assert res[i].tolist() == _solo(jparams, jcfg, p, 8, 80), i
    assert stats["pages_shared"] > 0
    assert set(eng.programs) == {"verify", "prefill", "cow"}


def test_spec_under_chunking_equals_jax(smoke):
    """Spec windows in the mixed step's lanes (spec_k + 1 a decode row):
    JAX's tokens and step stats, JAX's solo tokens, one mixed program."""
    jcfg, jparams, cfg, model = smoke
    prompts = _prompts(cfg.vocab, (13, 21, 5), seed=11)
    kw = dict(max_cache=48, max_seqs=3, page_size=8, max_new_tokens=8,
              chunked_prefill=True, token_budget=16, chunk_size=8,
              spec_decode=True, spec_k=3)
    eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(**kw),
                           device="cpu")
    res, stats = eng.run(prompts)
    jres, jstats = JEngine(jparams, jcfg, JServeConfig(**kw)).run(prompts)
    assert _tokens(res) == _tokens(jres)
    assert_steps_equal(stats, jstats, cfg.n_layers)
    assert set(eng.programs) == {"mixed"}
    for i, p in enumerate(prompts):
        assert res[i].tolist() == _solo(jparams, jcfg, p, 8, 48), i


@pytest.mark.parametrize("kw", [
    dict(spec_decode=True, spec_k=0),
    dict(spec_decode=True, spec_ngram=0),
    dict(spec_decode=True, spec_k=4, chunked_prefill=True, token_budget=4),
])
def test_spec_serve_config_errors_match_jax(kw):
    with pytest.raises(ValueError) as ours:
        ServeConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        JServeConfig(**kw)
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------- the pieces --
@pytest.mark.parametrize("rns", [False, True])
def test_decode_window_logits_match_jax(smoke, rns):
    """A [R, W] window straight through the model against pages holding
    earlier KV, one row inactive and one row's window running past its
    table: logits within LOGIT_ATOL of JAX's ``decode_window``, the same
    argmax, every window token's K/V written where JAX writes it and
    lengths not advanced."""
    jcfg, jparams, cfg, model = smoke
    if rns:
        jcfg, cfg = _with_rns(jcfg, cfg)
    m = _retarget(model, cfg)
    bs, R, nb, W = 8, 3, 3, 4
    P = 1 + R * nb
    rng = np.random.default_rng(5)
    bt = np.arange(1, P, dtype=np.int32).reshape(R, nb)
    bt[1, 2] = kv.TRASH_PAGE                # row 1 holds two pages
    lengths = np.array([5, 14, 0], np.int32)
    active = np.array([True, True, False])
    kpg = rng.standard_normal((cfg.n_layers, P, bs, cfg.n_kv_heads,
                               cfg.d_head)).astype(np.float32)
    vpg = rng.standard_normal(kpg.shape).astype(np.float32)
    cache = kv.make_paged_cache(cfg, kv.PagedCacheConfig(
        page_size=bs, n_pages=P, max_seqs=R, max_blocks=nb), device="cpu")
    cache.k_pages.copy_(torch.from_numpy(kpg))
    cache.v_pages.copy_(torch.from_numpy(vpg))
    kv.set_tables(cache, bt, lengths)
    jcache = jkv.set_tables(jkv.make_paged_cache(jcfg, jkv.PagedCacheConfig(
        page_size=bs, n_pages=P, max_seqs=R, max_blocks=nb),
        dtype=jnp.float32), bt, lengths)
    jcache = {"l0": dict(jcache["l0"], k_pages=jnp.asarray(kpg),
                         v_pages=jnp.asarray(vpg))}
    tok = rng.integers(1, cfg.vocab, (R, W)).astype(np.int32)
    jl, jys = JM.decode_window(jparams, jcfg, jnp.asarray(tok), jcache,
                               active=jnp.asarray(active))
    lg = M.decode_window(m, cfg, torch.from_numpy(tok.astype(np.int64)),
                         cache, torch.from_numpy(active))
    jl = np.asarray(jl)
    np.testing.assert_allclose(lg.numpy()[active], jl[active], rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_array_equal(lg.argmax(-1).numpy()[active],
                                  jl.argmax(-1)[active])
    jk = np.asarray(jys["l0"]["k_pages"])
    written = np.abs(jk - kpg) > 0
    np.testing.assert_array_equal(cache.k_pages.numpy()[:, 1:] != kpg[:, 1:],
                                  written[:, 1:])
    np.testing.assert_allclose(cache.k_pages.numpy()[:, 1:], jk[:, 1:],
                               rtol=0, atol=1e-4)
    assert cache.lengths.tolist() == lengths.tolist()


def test_write_token_window_bit_equal_to_jax():
    """W consecutive tokens a row from its length: positions past the
    row's table and on unallocated (trash) blocks go to the trash page,
    every real page bit-equal to JAX's scatter."""
    rng = np.random.default_rng(6)
    P, bs, R, nb, W = 10, 4, 3, 3, 4
    pages = rng.standard_normal((P, bs, 2, 3)).astype(np.float32)
    bt = np.array([[3, 5, 0], [1, 2, 4], [7, 8, 9]], np.int32)
    lengths = np.array([6, 10, 1], np.int32)
    vals = rng.standard_normal((R, W, 2, 3)).astype(np.float32)
    want = np.asarray(jkv.write_token_window(
        jnp.asarray(pages), jnp.asarray(bt), jnp.asarray(lengths),
        jnp.asarray(vals)))
    got = torch.from_numpy(pages.copy())
    kv.write_token_window(got, torch.from_numpy(bt).long(),
                          torch.from_numpy(lengths).long(),
                          torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])
    assert (got.numpy()[1:] != pages[1:]).any()


@pytest.mark.parametrize("k,ngram", [(3, 3), (4, 1), (2, 5)])
def test_propose_equals_jax(k, ngram):
    """Prompt-lookup drafts on the same histories (prompt + emitted, a
    small vocabulary so that n-grams repeat): JAX's drafts exactly."""
    rng = np.random.default_rng(k * 10 + ngram)
    ours = types.SimpleNamespace(scfg=ServeConfig(
        spec_decode=True, spec_k=k, spec_ngram=ngram))
    theirs = types.SimpleNamespace(scfg=JServeConfig(
        spec_decode=True, spec_k=k, spec_ngram=ngram))
    hits = 0
    for _ in range(200):
        vocab = int(rng.integers(2, 9))
        seq = types.SimpleNamespace(
            req=types.SimpleNamespace(tokens=rng.integers(
                0, vocab, int(rng.integers(1, 12))).astype(np.int32)),
            emitted=rng.integers(0, vocab, int(rng.integers(0, 10)))
            .tolist())
        got = ContinuousEngine._propose(ours, seq)
        want = JEngine._propose(theirs, seq)
        np.testing.assert_array_equal(got, want)
        hits += bool(got.any())
    assert hits > 50


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_jax_verify_op_counts_written_in_chip_smoke(smoke):
    """chip_smoke holds each [serve_spec] step's rns_ops to the decode
    counts it has written down for one layer; JAX's verify step tallies
    the same (its [R, W] window is one call of each op, like [R, 1])."""
    jcfg, jparams, _, _ = smoke
    jcfg, _ = _with_rns(jcfg, get_config("smollm-135m", smoke=True))
    eng = JEngine(jparams, jcfg, JServeConfig(**SPEC))
    eng.sched.submit(_request())
    eng.sched.schedule()
    counts = eng._rns_ops(0)
    assert {f: getattr(counts, f) for f in FIELDS} == \
        _chip_smoke().JAX_DECODE_RNS_OPS


def _request():
    from repro.serve.scheduler import Request

    return Request(rid=0, tokens=np.ones(5, np.int32), max_new=4)


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
@pytest.mark.parametrize("fused", [False, True])
def test_gpu_captured_spec_equals_eager_and_plain(cuda, smoke, fused,
                                                  chunked):
    """On the card, rns9 (per-op, or fused resident deferred): the
    captured verify (or mixed) program against the eager one, and both
    against plain decoding on the card -- the same tokens, rns_ops and
    one capture a program."""
    jcfg, _, cfg, model = smoke
    _, cfg = _with_rns(jcfg, cfg, fused)
    prompts = _prompts(cfg.vocab, (7, 20, 33), seed=0)
    kw = dict(SPEC)
    if fused:
        kw.update(rns_backend="cuda_fused", rns_defer=True,
                  resident_weights=True)
    if chunked:
        kw.update(chunked_prefill=True, token_budget=16, chunk_size=16)
    plain, _ = ContinuousEngine(
        _retarget(model, cfg), ServeConfig(**dict(kw, spec_decode=False)),
        device="cuda").run(prompts)
    out = []
    for graphs in (False, True):
        eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(**kw),
                               device="cuda", graphs=graphs)
        res, stats = eng.run(prompts)
        out.append((_tokens(res), [s["rns_ops"].as_dict()
                                   for s in stats["steps"]],
                    stats["captures"]))
    (want, wops, wcap), (got, ops, cap) = out
    assert got == want == _tokens(plain) and ops == wops
    if chunked:
        assert wcap == {"mixed": 0} and cap == {"mixed": 1}
    else:
        assert wcap == {"verify": 0, "prefill": 0}
        assert cap == {"verify": 1, "prefill": 1}
