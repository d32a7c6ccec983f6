"""The engine's step programs (``serve/graphs.py``): the port's
counterpart of the JAX engine's jitted prefill and decode.

On the CPU the programs run eagerly over their static buffers (the
caller asked for the CPU): tokens and per-step ``rns_ops`` equal the JAX
engine's on the traffic of ``test_engine_tokens_and_op_counts_match_jax``,
one program a phase, buffers that keep their addresses, and a warm-up
that touches only the trash page.  The ``gpu`` cases capture on the card
and hold the replayed engine to the eager one (``graphs=False``).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as j_get_config
from repro.core import dispatch as jdispatch
from repro.core.rns_matmul import RnsDotConfig as JRnsDotConfig
from repro.models import model as JM
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.base import at_depth, get_config
from repro_torch.core import dispatch
from repro_torch.core.rns_matmul import RnsDotConfig
from repro_torch.models.params import params_from_jax
from repro_torch.serve import graphs
from repro_torch.serve.engine import ContinuousEngine, ServeConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIELDS = ("converts", "matmuls", "normalizes", "fused", "fallbacks",
          "weight_converts")
FUSED = dict(rns_backend="cuda_fused", rns_defer=True, resident_weights=True)
PATHS = {"per_op": {}, "fused": FUSED,
         "fused_per_layer": dict(FUSED, per_layer_profiles=True)}


def _counts(c) -> dict:
    return {f: getattr(c, f) for f in FIELDS}


@pytest.fixture(scope="module")
def smoke():
    jcfg = dataclasses.replace(j_get_config("smollm-135m", smoke=True),
                               rns=JRnsDotConfig(profile="rns9", qx=8, qw=8),
                               rns_targets="mlp")
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              rns=RnsDotConfig(profile="rns9", qx=8, qw=8),
                              rns_targets="mlp")
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)[0]
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in (5, 11, 23)]
    return jcfg, jparams, cfg, model, prompts


# ---------------------------------------------------------- the class ----
def test_step_program_copies_into_static_buffers():
    buf = {"a": torch.zeros(3), "b": torch.zeros(3, dtype=torch.int64)}
    ptrs = {k: v.data_ptr() for k, v in buf.items()}
    prog = graphs.StepProgram("p", lambda a, b: a * 2 + b, buf)
    assert graphs.build_programs([prog], torch.device("cpu"),
                                 graphs=True) is None
    assert prog.ops.as_dict() == dispatch.OpCounts().as_dict()
    out = prog.run(a=torch.tensor([1.0, 2.0, 3.0]), b=torch.tensor([1, 0, 2]))
    assert out.tolist() == [3.0, 4.0, 8.0]
    assert buf["a"].tolist() == [1.0, 2.0, 3.0]     # copied in place
    assert {k: v.data_ptr() for k, v in buf.items()} == ptrs
    assert prog.captures == 0 and prog.graph is None


# ------------------------------------------------------- on the CPU ----
@pytest.mark.parametrize("pool", [
    dict(max_seqs=2),                   # the third request queues
    dict(max_seqs=3, n_pages=7),        # page growth preempts rows
])
def test_programs_tokens_and_op_counts_match_jax(smoke, pool):
    """The static-buffer programs serve the JAX engine's greedy tokens;
    each step's rns_ops is the decode program's tallies plus the prefill
    program's per admitted prompt, JAX's times the layers; one program a
    phase, each input buffer at one address all along."""
    jcfg, jparams, cfg, model, prompts = smoke
    kw = dict(max_cache=40, max_new_tokens=5, page_size=8, **pool)
    jres, jstats = JEngine(jparams, jcfg, JServeConfig(**kw)).run(prompts)
    eng = ContinuousEngine(copy.deepcopy(model), ServeConfig(**kw),
                           device="cpu")
    progs = dict(eng.programs)
    ptrs = {(p, k): b.data_ptr() for p, prog in progs.items()
            for k, b in prog.inputs.items()}
    res, stats = eng.run(prompts)
    assert {r: t.tolist() for r, t in res.items()} == {
        r: t.tolist() for r, t in jres.items()}
    assert stats["n_preemptions"] == jstats["n_preemptions"]
    assert [(s["admitted"], s["preempted"]) for s in stats["steps"]] == [
        (s["admitted"], s["preempted"]) for s in jstats["steps"]]
    for s, js in zip(stats["steps"], jstats["steps"], strict=True):
        want = {f: n * cfg.n_layers for f, n in _counts(js["rns_ops"]).items()}
        assert s["rns_ops"].as_dict() == want
    assert set(eng.programs) == {"decode", "prefill"}
    assert all(eng.programs[k] is progs[k] for k in progs)
    assert stats["captures"] == {"decode": 0, "prefill": 0}     # eager
    assert {(p, k): b.data_ptr() for p, prog in eng.programs.items()
            for k, b in prog.inputs.items()} == ptrs


def test_program_op_counts_are_jax_traced_phases(smoke):
    """Each program's tallies, taken once when it is built, are what the
    JAX engine traces for that phase, times the layers."""
    jcfg, jparams, cfg, model, _ = smoke
    eng = ContinuousEngine(copy.deepcopy(model), ServeConfig(
        max_cache=40, page_size=8, max_seqs=2), device="cpu")
    jpf = jdispatch.trace_op_counts(
        lambda p, t, n: JM.prefill_ragged(p, jcfg, {"tokens": t}, n),
        jparams, jnp.zeros((1, eng.prompt_pad), jnp.int32),
        jnp.asarray([3], jnp.int32))
    assert eng.programs["prefill"].ops.as_dict() == {
        f: n * cfg.n_layers for f, n in _counts(jpf).items()}
    dec = eng.programs["decode"].ops
    assert (dec.converts, dec.matmuls, dec.normalizes) == (
        5 * cfg.n_layers, 3 * cfg.n_layers, 3 * cfg.n_layers)
    assert eng._rns_ops(2).as_dict() == dec.add(
        eng.programs["prefill"].ops, times=2).as_dict()


@pytest.mark.parametrize("path", sorted(PATHS))
def test_warm_up_touches_only_the_trash_page(smoke, path):
    """Building the programs runs each once on zero tables, a trash
    ``block_row`` and no active row: no real page is written and no
    length moves."""
    _, _, cfg, model, _ = smoke
    eng = ContinuousEngine(copy.deepcopy(model), ServeConfig(
        max_cache=40, page_size=8, max_seqs=2, **PATHS[path]), device="cpu")
    c = eng.cache
    assert not c.k_pages[:, 1:].any() and not c.v_pages[:, 1:].any()
    assert not c.lengths.any() and not c.block_table.any()
    assert all(p.ops is not None for p in eng.programs.values())


# ------------------------------------------------------- on the card ----
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels run "
                    "only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _serve(model, kw, graphs_on, prompts):
    eng = ContinuousEngine(copy.deepcopy(model), ServeConfig(**kw),
                           device="cuda", graphs=graphs_on)
    res, stats = eng.run(prompts)
    return eng, {r: t.tolist() for r, t in res.items()}, stats


def _ops(stats):
    return [s["rns_ops"].as_dict() for s in stats["steps"]]


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(PATHS))
def test_gpu_captured_engine_equals_eager(cuda, smoke, path):
    """Mixed prompt lengths and a preemption: the replayed engine emits
    the eager engine's tokens and rns_ops, and captured each phase once."""
    _, _, cfg, model, _ = smoke
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in (7, 33, 120, 7, 33)]
    kw = dict(max_cache=136, max_new_tokens=6, page_size=8, max_seqs=3,
              n_pages=18, **PATHS[path])
    _, want, wstats = _serve(model, kw, False, prompts)
    eng, got, stats = _serve(model, kw, True, prompts)
    assert got == want
    assert _ops(stats) == _ops(wstats)
    assert stats["n_preemptions"] > 0
    assert stats["captures"] == {"decode": 1, "prefill": 1}
    assert wstats["captures"] == {"decode": 0, "prefill": 0}
    if path == "fused_per_layer":
        from repro_torch.models.resident import resident_profiles

        assert set(resident_profiles(eng.model).values()) == {"rns6"}


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["per_op", "fused"])
def test_gpu_replay_after_workspace_grows(cuda, path):
    """Two full-width layers, whose decode launches split their K steps
    through the capture stream's workspace: a later call on that stream
    grows the workspace and an eager split launch runs on the new pair;
    the graph keeps its old pair, and a second serve on the same engine
    still equals the eager engine."""
    from repro_torch.kernels import workspace
    from repro_torch.kernels.rns_matmul import ops as m_ops
    from repro_torch.models.model import init_model

    cfg = dataclasses.replace(at_depth(get_config("smollm-135m"), 2),
                              rns=RnsDotConfig(profile="rns9", qx=8, qw=8))
    model = init_model(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in (7, 33, 60)]
    kw = dict(max_cache=80, max_new_tokens=5, page_size=16, max_seqs=4,
              **PATHS[path])
    _, want, _ = _serve(model, kw, False, prompts)
    eng, got, _ = _serve(model, kw, True, prompts)
    assert got == want
    stream = eng._capture_stream.cuda_stream
    held = workspace.held(cuda, stream)
    assert held, "no split launch in the captured steps"
    sums, tiles = held[-1][0].numel(), held[-1][1].numel()
    workspace.get(cuda, 2 * sums, 2 * tiles, stream=stream)
    assert len(workspace.held(cuda, stream)) == len(held) + 1
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randint(0, 100, (9, 8, 1536), generator=g, device=cuda,
                      dtype=torch.int32).to(torch.int8)
    b = torch.randint(0, 100, (9, 1536, 576), generator=g, device=cuda,
                      dtype=torch.int32).to(torch.int8)
    with torch.cuda.stream(eng._capture_stream):
        y = m_ops.rns_matmul("rns9", a, b)
    torch.cuda.synchronize()
    assert torch.equal(y.cpu(), m_ops.rns_matmul_plain("rns9", a.cpu(),
                                                       b.cpu()))
    again, _ = eng.run(prompts)
    assert [again[r].tolist() for r in sorted(again)] == [
        want[r] for r in sorted(want)]
