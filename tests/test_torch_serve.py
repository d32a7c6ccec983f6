"""The port's serving slice against the JAX package: smoke smollm-135m on
the rns9 MLP datapath, paged KV cache, scheduler and ContinuousEngine.

Weights come from ``repro.models.model.init_model`` and reach the port
through numpy (``params_from_jax``).  Logits agree within a stated
tolerance: attention, norms and activations are float32 ops whose
implementations (XLA vs PyTorch) differ in the last bits, and the RNS
datapath then quantizes them to 8 bits.  Greedy tokens must be equal.
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
from repro.serve import kv_cache as jkv
from repro.serve import scheduler as jsched
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.base import at_depth, get_config
from repro_torch.core.rns_matmul import RnsDotConfig
from repro_torch.kernels.rns_convert import ops as convert_ops
from repro_torch.kernels.rns_matmul import ops as matmul_ops
from repro_torch.kernels.rns_normalize import ops as normalize_ops
from repro_torch.models import model as M
from repro_torch.models.params import params_from_jax
from repro_torch.serve import kv_cache as kv
from repro_torch.serve import scheduler as sched
from repro_torch.serve.engine import ContinuousEngine, ServeConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# |logit| is O(1) here; XLA and PyTorch float32 kernels differ by a few
# ulps, which a rare 8-bit requantization flip amplifies to ~1e-3
LOGIT_ATOL = 5e-3

PROMPT_LENS = (5, 11, 23)


def _cfgs(n_layers=None):
    jcfg = dataclasses.replace(j_get_config("smollm-135m", smoke=True),
                               rns=JRnsDotConfig(profile="rns9", qx=8, qw=8),
                               rns_targets="mlp")
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              rns=RnsDotConfig(profile="rns9", qx=8, qw=8),
                              rns_targets="mlp")
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers,
                                   layer_types=("attn",) * n_layers,
                                   mlp_types=("dense",) * n_layers)
        cfg = at_depth(cfg, n_layers)
    return jcfg, cfg


@pytest.fixture(scope="module")
def smoke():
    jcfg, cfg = _cfgs()
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)[0]
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, (L,)).astype(np.int32)
               for L in PROMPT_LENS]
    return jcfg, jparams, cfg, model, prompts


def test_config_matches_jax():
    for smoke_ in (True, False):
        j, c = (j_get_config("smollm-135m", smoke=smoke_),
                get_config("smollm-135m", smoke=smoke_))
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
                  "d_ff", "vocab", "rope_theta", "norm", "act", "gated_mlp",
                  "tie_embeddings"):
            assert getattr(j, f) == getattr(c, f), f


def test_prefill_and_decode_logits_match_jax(smoke):
    """Two prompts prefilled ragged, blitted into a paged pool, then one
    batched decode step: both packages' logits agree."""
    jcfg, jparams, cfg, model, prompts = smoke
    bs, Tpad, R, nb = 8, 32, 2, 4
    pcfg = kv.PagedCacheConfig(page_size=bs, n_pages=1 + R * nb, max_seqs=R,
                               max_blocks=nb)
    jpcfg = jkv.PagedCacheConfig(page_size=bs, n_pages=1 + R * nb,
                                 max_seqs=R, max_blocks=nb)
    jcache = jkv.make_paged_cache(jcfg, jpcfg, dtype=jnp.float32)
    cache = kv.make_paged_cache(cfg, pcfg, device="cpu")
    bt = np.arange(1, 1 + R * nb, dtype=np.int32).reshape(R, nb)
    lengths, first = [], []
    jprefill = jax.jit(lambda p, t, n: JM.prefill_ragged(
        p, jcfg, {"tokens": t}, n))
    for r, pr in enumerate(prompts[:R]):
        T = len(pr)
        tok = np.zeros((1, Tpad), np.int32)
        tok[0, :T] = pr
        jl, jys = jprefill(jparams, jnp.asarray(tok), jnp.asarray([T]))
        lg, ys = M.prefill_ragged(model, cfg, torch.from_numpy(tok).long(),
                                  torch.tensor([T]))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGIT_ATOL)
        k, v = jys["l0"]
        z = dict(jcache["l0"])
        z["k_pages"] = jkv.write_prompt_pages(z["k_pages"], bt[r], k)
        z["v_pages"] = jkv.write_prompt_pages(z["v_pages"], bt[r], v)
        jcache = {"l0": z}
        row = torch.from_numpy(bt[r]).long()
        kv.write_prompt_pages(cache.k_pages, row,
                              torch.stack([k[0] for k, _ in ys]))
        kv.write_prompt_pages(cache.v_pages, row,
                              torch.stack([v[0] for _, v in ys]))
        lengths.append(T)
        first.append(int(np.argmax(np.asarray(jl)[0])))
        assert int(torch.argmax(lg[0])) == first[-1]
    jcache = jkv.set_tables(jcache, bt, np.asarray(lengths, np.int32))
    kv.set_tables(cache, bt, np.asarray(lengths))
    active = np.ones((R,), bool)
    tok = np.asarray(first, np.int32)[:, None]
    jl, _ = jax.jit(lambda p, t, c, a: JM.decode_step(p, jcfg, t, c,
                                                      active=a))(
        jparams, jnp.asarray(tok), jcache, jnp.asarray(active))
    lg = M.decode_step(model, cfg, torch.from_numpy(tok).long(), cache,
                       torch.from_numpy(active))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_array_equal(lg.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
    assert cache.lengths.tolist() == [L + 1 for L in lengths]


def _jax_ops(counts) -> dict:
    return {f: getattr(counts, f) for f in (
        "converts", "matmuls", "normalizes", "fused", "fallbacks",
        "weight_converts")}


@pytest.mark.parametrize("pool", [
    dict(max_seqs=2),                   # the third request queues
    dict(max_seqs=3, n_pages=7),        # page growth preempts rows
])
def test_engine_tokens_and_op_counts_match_jax(smoke, pool):
    """3 mixed-length requests: the port's ContinuousEngine emits the JAX
    engine's greedy tokens with the same admissions and preemptions, and
    its per-step RNS op counts are the JAX engine's times the number of
    layers.  (The JAX engine tallies at trace time, and its ``scan``
    traces the period body once, so it counts one layer of this
    period-1 model per phase; the port counts every call it makes.)"""
    jcfg, jparams, cfg, model, prompts = smoke
    kw = dict(max_cache=40, max_new_tokens=5, page_size=8, **pool)
    jres, jstats = JEngine(jparams, jcfg, JServeConfig(**kw)).run(prompts)
    res, stats = ContinuousEngine(model, ServeConfig(**kw),
                                  device="cpu").run(prompts)
    assert {r: t.tolist() for r, t in res.items()} == {
        r: t.tolist() for r, t in jres.items()}
    assert len(stats["steps"]) == len(jstats["steps"])
    assert jcfg.period == 1
    for s, js in zip(stats["steps"], jstats["steps"]):
        assert (s["admitted"], s["preempted"]) == (js["admitted"],
                                                   js["preempted"])
        want = {f: n * cfg.n_layers for f, n in _jax_ops(js["rns_ops"]).items()}
        assert s["rns_ops"].as_dict() == want
    assert stats["total_new_tokens"] == 3 * 5
    assert stats["n_preemptions"] == jstats["n_preemptions"]


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_jax_decode_op_counts_written_in_chip_smoke():
    """chip_smoke.py holds the full-width decode step's counts to what the
    JAX engine reports for smollm-135m rns9 (traced on the CPU, no FLOPs
    spent, at the smoke width): one traced layer whatever the depth."""
    per = []
    for L in (1, 2, 30):
        jcfg, _ = _cfgs(n_layers=L)
        params = jax.eval_shape(
            lambda k: JM.init_model(k, jcfg)[0], jax.random.PRNGKey(0))
        pcfg = jkv.PagedCacheConfig(page_size=8, n_pages=9, max_seqs=2,
                                    max_blocks=4)
        cache = jax.eval_shape(
            lambda: jkv.make_paged_cache(jcfg, pcfg, dtype=jnp.float32))
        counts = jdispatch.trace_op_counts(
            lambda p, t, c: JM.decode_step(p, jcfg, t, c,
                                           active=jnp.ones((2,), bool)),
            params, jnp.zeros((2, 1), jnp.int32), cache)
        per.append(_jax_ops(counts))
    assert per[0] == per[1] == per[2]       # the scan traces one period
    cs = _chip_smoke()
    assert cs.JAX_DECODE_RNS_OPS == per[2]
    assert cs.FULL_LAYERS == get_config("smollm-135m").n_layers


# ---------------------------------------------------------- scheduler ----
def _drive(mod, pcfg_cls, traffic, steps):
    """Run a scheduler on fixed traffic, emulating prefill and one decode
    token per running row per step; returns every step's plan."""
    pcfg = pcfg_cls(page_size=4, n_pages=9, max_seqs=3, max_blocks=6)
    s = mod.Scheduler(pcfg)
    for rid, (toks, max_new) in enumerate(traffic):
        s.submit(mod.Request(rid=rid, tokens=toks, max_new=max_new))
    log = []
    for _ in range(steps):
        if not s.has_work:
            break
        plan = s.schedule()
        for seq in plan.admitted:
            seq.emitted = [int(seq.req.tokens[-1])]
        for seq in list(s.running.values()):
            if len(seq.emitted) >= seq.req.max_new:
                s.complete(seq)
                continue
            seq.emitted.append(seq.length % 7)
            seq.length += 1
            if len(seq.emitted) >= seq.req.max_new:
                s.complete(seq)
        bt, lengths, active, last = s.tables()
        log.append(([q.rid for q in plan.admitted], plan.preempted,
                    plan.grew, bt.tolist(), lengths.tolist(),
                    active.tolist(), s.alloc.n_free))
        # the JAX scheduler's default policy splits no page copy-on-write
        assert getattr(plan, "cow", []) == []
    return log


@pytest.mark.parametrize("seed", [4, 5, 7])
def test_scheduler_plans_equal_jax(seed):
    """Under the JAX scheduler's default policy (the phase-barrier subset
    the port copies) both make the same plans: admissions, preemptions,
    block tables and free pages, step by step."""
    rng = np.random.default_rng(seed)
    traffic = [(rng.integers(0, 50, int(rng.integers(2, 10))).astype(
        np.int32), int(rng.integers(2, 12))) for _ in range(8)]
    ours = _drive(sched, kv.PagedCacheConfig, traffic, 60)
    theirs = _drive(jsched, jkv.PagedCacheConfig, traffic, 60)
    assert ours == theirs
    assert any(step[1] for step in ours)        # preemption exercised


def test_later_slices_raise():
    """``mesh``, the last field that waited for a later slice (A.11),
    now builds a config (tests/test_torch_distributed.py serves on it)."""
    mesh = object()
    scfg = ServeConfig(mesh=mesh)
    assert scfg.mesh is mesh and scfg.digit_axis == "model"


def test_chunked_prefill_and_prefix_cache_construct():
    """The features this slice ports build a config, alone and together."""
    for flags in ({"chunked_prefill": True}, {"prefix_cache": True},
                  {"chunked_prefill": True, "prefix_cache": True,
                   "token_budget": 32, "chunk_size": 16}):
        scfg = ServeConfig(**flags)
        for k, v in flags.items():
            assert getattr(scfg, k) == v


# ---------------------------------------------------------- on the card --
@pytest.mark.gpu
def test_gpu_engine_matches_cpu_and_launches_kernels(smoke):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, cfg, model, prompts = smoke
    kw = dict(max_cache=40, max_new_tokens=5, page_size=8, max_seqs=2)
    res_cpu, _ = ContinuousEngine(model, ServeConfig(**kw),
                                  device="cpu").run(prompts)
    before = (convert_ops.launches, matmul_ops.launches,
              normalize_ops.launches)
    res_gpu, stats = ContinuousEngine(copy.deepcopy(model),
                                      ServeConfig(**kw),
                                      device="cuda").run(prompts)
    after = (convert_ops.launches, matmul_ops.launches,
             normalize_ops.launches)
    assert all(a > b for a, b in zip(after, before))
    assert all(s["rns_ops"].fallbacks == 0 for s in stats["steps"])
    assert {r: t.tolist() for r, t in res_gpu.items()} == {
        r: t.tolist() for r, t in res_cpu.items()}


@pytest.mark.gpu
def test_gpu_rns_projection_bit_equal_to_cpu(smoke):
    """On one float input the RNS datapath is device-independent: the
    card's kernels and the CPU's plain versions give bit-equal floats."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    from repro_torch.core.quantize import token_mask
    from repro_torch.core.rns_matmul import rns_multi_dot

    _, _, cfg, model, _ = smoke
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (3, 5, cfg.d_model)).astype(np.float32))
    ws = (model.blocks[0].mlp.wi.cpu(), model.blocks[0].mlp.wg.cpu())
    mask = torch.ones(3, 5, dtype=torch.bool)
    with token_mask(mask, per_token=True):
        want = rns_multi_dot(x, ws, cfg.rns)
    with token_mask(mask.cuda(), per_token=True):
        got = rns_multi_dot(x.cuda(), tuple(w.cuda() for w in ws), cfg.rns)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
