"""The distributed slice of the port (A.11) against the JAX package.

Digit sharding over ``torch.distributed`` ranks, run on the CPU as gloo
ranks that ``repro_torch.launch.mesh.spawn`` starts (one intra-op thread
each, a deadline on every spawn), against JAX's *unsharded* path: the
JAX package's own sharded path is broken on the installed JAX (ROADMAP
C.2), and digit sharding promises the unsharded numbers.  JAX's
8-device recipe (``tests/test_distributed_rns.py``) cut to 4 ranks:

* the rns16 chain ``rt_encode`` -> 3 x ``rt_matmul`` -> ``rt_decode``,
  bit-equal to JAX's and to the port's unsharded one, one digit gather a
  normalize; its residue segment (with a deferred ``rt_mul``) makes no
  collective and holds [16/4, ...] digits a rank;
* ``ContinuousEngine(mesh=)`` per-op, with resident weights and with the
  masters dropped (``encode_resident(drop_masters=True, mesh=)``),
  tokens equal to JAX's unsharded engine, one gather a normalize, each
  rank's resident planes [8/4, ...];
* the DP x digit train step (2 x 2, rns8 ``mlp``) and float DP (4 x 1):
  losses within rtol 1e-5 of the port's single step and within
  test_torch_train's bars of JAX's, one gradient all-reduce a step;
* the rules (``spec_for_axes``, ``first_valid_spec``, ``batch_spec``),
  ``plan_remesh`` and the int8 compression bit-equal to JAX's, and
  ``make_train_step(compress_dci=True)`` against JAX's;
* a rank that raises, or a run past its deadline, fails its spawn in
  time instead of hanging; an engine that would capture a gloo
  collective raises.

The ranks run ``tests/_torch_dist_ranks.py``, which imports only
``repro_torch``; they start first and JAX's side is computed meanwhile.
The ``gpu`` cases hold B.1 (K = 1-4) and B.2 on digit-group profiles to
their plain versions on the card.
"""

import concurrent.futures as cf
import dataclasses
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_dist_ranks as R
from repro.configs.base import get_config as j_get_config
from repro.core import dispatch as jdispatch
from repro.core.rns_matmul import RnsDotConfig as JRnsDotConfig
from repro.core.rns_matmul import rns_dot as j_rns_dot
from repro.core.tensor import rt_decode as j_rt_decode
from repro.core.tensor import rt_encode as j_rt_encode
from repro.core.tensor import rt_matmul as j_rt_matmul
from repro.distributed import compression as jcomp
from repro.distributed import sharding as jsh
from repro.distributed.fault_tolerance import plan_remesh as j_plan_remesh
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.train import train_step as jts
from repro_torch.configs.base import get_config
from repro_torch.core import dispatch
from repro_torch.core.moduli import digit_group, get_profile
from repro_torch.core.rns_matmul import RnsDotConfig, rns_dot
from repro_torch.distributed import compression as comp
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.fault_tolerance import plan_remesh
from repro_torch.kernels import autotune
from repro_torch.kernels.rns_convert import ops as convert_ops
from repro_torch.kernels.rns_matmul import ops as matmul_ops
from repro_torch.launch.mesh import SpawnError, spawn
from repro_torch.models import layers
from repro_torch.models.params import opt_state_from_jax, params_from_jax
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

N_RANKS = 4
SPAWN_S = 300          # the 4-rank run's deadline: a guard against a hang
PROMPT_LENS = (7, 20)
# test_torch_train.py's step bars (ROADMAP C.17)
ADAM = dict(lr=1e-2, warmup_steps=2, total_steps=50, eps=1e-3)
LOSS_TOL = {"float": 1e-5, "rns": 1e-4}
PARAM_RTOL = 1e-4
PARAM_ATOL = {"float": 1e-7, "rns": 1e-2 * ADAM["lr"]}
DP_RTOL = 1e-5         # DP losses against the port's single step
# compress_dci: a gradient element at an int8 rounding boundary, moved
# there by float noise, flips one step of its leaf's scale (ROADMAP
# C.19): at most this share of the parameters and residuals
FLIP_SHARE = 0.01
# C.17's gradient bar, a share of the tensor's largest element
GRAD_BAR = {"float": 1e-4, "rns": 1e-3}


def _np(t):
    return t.detach().cpu().numpy()


def _abstract_mesh(shape, axes=("data", "model")):
    from jax.sharding import AbstractMesh

    try:
        return AbstractMesh(shape, axes)
    except TypeError:
        return AbstractMesh(tuple(zip(axes, shape)))


def _twins(profile):
    jcfg = j_get_config("smollm-135m", smoke=True)
    cfg = get_config("smollm-135m", smoke=True)
    if profile is None:
        return jcfg, cfg
    return (dataclasses.replace(jcfg, rns=JRnsDotConfig(
                profile=profile, qx=8, qw=8), rns_targets="mlp"),
            dataclasses.replace(cfg, rns=RnsDotConfig(
                profile=profile, qx=8, qw=8), rns_targets="mlp"))


# ----------------------------------------------------- the 4-rank run -----
@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Seeded inputs, and the JAX twins' weights for the ranks (files of
    port state dicts, from ``params_from_jax``)."""
    root = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    ws = [(rng.standard_normal((64, 64)) / 8).astype(np.float32)
          for _ in range(3)]
    jcfg, cfg = _twins("rns8")
    jparams = JM.init_model(jax.random.PRNGKey(1), jcfg)[0]
    serve_w = root / "serve.pt"
    torch.save(params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu").state_dict(), serve_w)
    prompts = [rng.integers(1, cfg.vocab, (L,)).astype(np.int32)
               for L in PROMPT_LENS]
    batches = [rng.integers(1, cfg.vocab, (4, 16)).astype(np.int32)
               for _ in range(2)]
    out = dict(x=x, ws=ws, serve_profile="rns8", serve_weights=str(serve_w),
               prompts=prompts, batches=batches, adam=ADAM,
               jparams=jparams)
    for path, profile in (("rns", "rns8"), ("float", None)):
        jcfg, cfg = _twins(profile)
        jstate, _ = jts.init_train_state(jax.random.PRNGKey(0), jcfg)
        f = root / f"train_{path}.pt"
        torch.save(params_from_jax(jax.tree.map(
            np.asarray, jstate["params"]), cfg, device="cpu").state_dict(), f)
        out[f"train_weights_{path}"] = str(f)
        out[f"jstate_{path}"] = jstate
    return out


@pytest.fixture(scope="module")
def ranks(inputs):
    """The 4-rank run, started in the background (JAX's side is computed
    while it runs); ``.result()`` is each rank's dict."""
    args = {k: v for k, v in inputs.items() if not k.startswith("j")}
    pool = cf.ThreadPoolExecutor(1)
    fut = pool.submit(spawn, N_RANKS, R.chain_and_serve, args,
                      timeout_s=SPAWN_S)
    yield fut
    pool.shutdown(wait=True)


def _jax_chain(x, ws):
    ht = j_rt_encode(x, "rns16", bits=8)
    for w in ws:
        ht = j_rt_matmul(ht, j_rt_encode(w, "rns16", bits=8))
    return j_rt_decode(ht)


def test_sharded_chain_bit_equal_to_jax(ranks, inputs):
    """The rns16 chain over 4 ranks (4 digits each) decodes bit for bit
    as JAX's unsharded chain, op by op as the port runs (under ``jit``
    XLA reorders the scales' float products: an ulp), and as the port's
    unsharded one, on every rank (also with weights encoded off the
    context, which each matmul cuts to the rank's digits); each
    normalize gathered the digits once, and nothing else
    communicated."""
    want = np.asarray(_jax_chain(inputs["x"], inputs["ws"]))
    for out in ranks.result():
        assert np.array_equal(_np(out["sharded_chain"]), want)
        assert np.array_equal(_np(out["unsharded_chain"]), want)
        assert np.array_equal(_np(out["whole_operand_chain"]), want)
        ops = out["chain_ops"]
        assert ops["normalizes"] >= 1
        assert out["chain_collectives"] == {
            "gather_digits": ops["normalizes"], "all_reduce_sum": 0,
            "all_reduce_max": 0}


def test_residue_segment_is_collective_free(ranks, inputs):
    """convert + 3 matmuls + a deferred ``rt_mul``: no collective, and
    each rank holds its 4 of the 16 digit planes of JAX's residues."""
    x, ws = inputs["x"], inputs["ws"]
    ht = j_rt_encode(x, "rns16", bits=8)
    for w in ws:
        ht = j_rt_matmul(ht, j_rt_encode(w, "rns16", bits=8))
    from repro.core.tensor import rt_mul as j_rt_mul

    full = np.asarray(j_rt_mul(ht, j_rt_encode(x, "rns16", bits=8)).digits)
    for rank, out in enumerate(ranks.result()):
        assert out["segment_collectives"] == {
            "gather_digits": 0, "all_reduce_sum": 0, "all_reduce_max": 0}
        seg = _np(out["segment_digits"])
        assert seg.shape == (4, 4, 64)
        assert np.array_equal(seg, full[4 * rank:4 * rank + 4])


def test_digit_placement_helpers(ranks):
    """``rt_digit_sharding`` gives JAX's spec (as a tuple);
    ``rt_device_put`` keeps the rank's group of a whole tensor, and
    nothing changes without a context or on a placed tensor."""
    for rank, out in enumerate(ranks.result()):
        assert out["spec"] == ("model", None, None)
        assert out["spec_p"] == (None, "model", None, None)
        full = _np(out["full_digits"])
        assert np.array_equal(_np(out["put"]), full[4 * rank:4 * rank + 4])
        assert out["put_again_same"] and out["no_ctx_put_same"]


@pytest.fixture(scope="module")
def jax_tokens(inputs):
    jcfg, _ = _twins("rns8")
    res, _ = JEngine(inputs["jparams"], jcfg, JServeConfig(
        max_cache=48, max_new_tokens=5, page_size=16, max_seqs=2)).run(
            inputs["prompts"])
    return {i: res[i].tolist() for i in res}


@pytest.mark.parametrize("path", ["perop", "resident", "dropped"])
def test_sharded_engine_tokens_equal_jax(ranks, jax_tokens, path):
    """``ContinuousEngine(ServeConfig(mesh=))`` over 4 ranks (rns8: 2
    digits a rank) gives JAX's unsharded engine's tokens on every rank:
    per-op (weights re-encoded every step), resident weights (each rank
    holding [2, d, n] planes) and resident without float masters; one
    gather a normalize; the stats name the gloo backend."""
    for out in ranks.result():
        assert out[f"serve_{path}"] == jax_tokens
        if path == "dropped":
            assert out["dropped"][:3] == (True, True, True)
            assert out["dropped"][3][0] == 2
            continue
        assert out[f"serve_{path}_gathers"]["gather_digits"] == \
            out[f"serve_{path}_normalizes"] > 0
        assert out[f"serve_{path}_backend"] == "gloo"
        if path == "resident":
            assert out["resident_shape"][0] == 2


def test_gloo_capture_refused(ranks):
    """A captured engine (``graphs=True`` on the card) over a gloo group
    raises before anything reaches the card, naming the way out."""
    for out in ranks.result():
        assert out["capture_refusal"] is not None
        assert "graphs=False" in out["capture_refusal"]


def _single_steps(inputs, path):
    """JAX's jitted step and the port's single TrainStep, 2 steps each
    from the same state: (JAX losses, port losses, port params)."""
    profile = "rns8" if path == "rns" else None
    jcfg, cfg = _twins(profile)
    jstate = inputs[f"jstate_{path}"]
    jstep = jax.jit(jts.make_train_step(jcfg, jadamw.AdamWConfig(**ADAM)))
    tree = jax.tree.map(np.asarray, jstate)
    model = params_from_jax(tree["params"], cfg, device="cpu")
    state = {"model": model.requires_grad_(True),
             "opt": opt_state_from_jax(tree["opt"], cfg, device="cpu")}
    step = ts.make_train_step(cfg, adamw.AdamWConfig(**ADAM))
    jl, pl = [], []
    for toks in inputs["batches"]:
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": toks})
        jl.append(float(jm["loss"]))
        pl.append(float(m["loss"]))
    return jl, pl, dict(state["model"].named_parameters())


@pytest.mark.parametrize("path", ["rns", "float"])
def test_dp_train_step_equals_single(ranks, inputs, path):
    """``make_dp_train_step``: DP x digit on a 2 x 2 mesh (rns8 ``mlp``,
    the RNS backward) and float DP on 4 x 1, 2 steps of [4, 16] tokens:
    losses within rtol 1e-5 of the port's single step and within
    LOSS_TOL of JAX's, every parameter within test_torch_train's bar of
    the single step's; one gradient all-reduce a step, one gather a
    normalize, and (rns) the scales' max all-reduces over the data
    group."""
    jl, pl, params = _single_steps(inputs, path)
    for out in ranks.result():
        dp = out[f"dp_{path}"]
        np.testing.assert_allclose(dp["losses"], pl, rtol=DP_RTOL)
        np.testing.assert_allclose(dp["losses"], jl, rtol=0,
                                   atol=LOSS_TOL[path])
        for name, p in params.items():
            np.testing.assert_allclose(_np(dp["params"][name]), _np(p),
                                       rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL[path], err_msg=name)
        for counts, norms in zip(dp["collectives"], dp["normalizes"]):
            assert counts["all_reduce_sum"] == 1
            assert counts["gather_digits"] == norms
            assert (counts["all_reduce_max"] > 0) == (path == "rns")


def test_rules_on_a_device_mesh_equal_jax(ranks):
    """The rules read a rank's (1, 4) ``DeviceMesh`` as JAX's read its
    mesh of that shape."""
    from jax.sharding import PartitionSpec as P

    mesh = _abstract_mesh((1, 4))
    want = {"spec": tuple(jsh.spec_for_axes(("embed", "mlp", "vocab"),
                                            (64, 256, 49152), mesh)),
            "batch": tuple(jsh.batch_spec(mesh)),
            "dp_size": jsh.dp_size(mesh),
            "first": tuple(jsh.first_valid_spec(
                (4, 8), [P("data", "model"), P("data", None)], mesh))}
    for out in ranks.result():
        assert out["rules"] == want


def test_serve_cli_digit_shard_on_the_cpu():
    """``launch/serve.py --digit-shard`` without a launcher: a world of 1
    (gloo on the CPU), named, and the unsharded CLI's tokens."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve",
           "--continuous", "--rns", "rns9", "--device", "cpu",
           "--requests", "2", "--new", "3"]
    outs = [subprocess.run(cmd + extra, env=env, capture_output=True,
                           text=True, timeout=120)
            for extra in ([], ["--digit-shard"])]
    for o in outs:
        assert o.returncode == 0, o.stderr[-2000:]
    assert "digit sharding over 1 rank(s), gloo" in outs[1].stdout
    assert "digit shards 1 over gloo" in outs[1].stdout
    sample = [[ln for ln in o.stdout.splitlines()
               if ln.startswith("sample:")] for o in outs]
    assert sample[0] == sample[1] and sample[0]


# ---------------------------------------------------- spawn's failures ----
def test_a_rank_that_raises_fails_the_spawn():
    """Rank 1 raises while rank 0 waits for it in a collective: the spawn
    raises with rank 1's traceback in seconds, not at gloo's timeout."""
    t0 = time.monotonic()
    with pytest.raises(SpawnError, match="fails on purpose"):
        spawn(2, R.raises, timeout_s=60)
    assert time.monotonic() - t0 < 40


def test_a_spawn_past_its_deadline_fails():
    t0 = time.monotonic()
    with pytest.raises(SpawnError, match="deadline"):
        spawn(2, R.sleeps, 120, timeout_s=10)
    assert time.monotonic() - t0 < 40


# ----------------------------------------------------- pure functions -----
SPEC_CASES = [((1, 1), ("embed", "mlp"), (64, 256)),
              ((2, 4), ("lora", "heads"), (64, 64)),
              ((2, 4), ("heads", "lora"), (64, 64)),
              ((2, 4), ("mlp", "heads"), (64, 64)),
              ((2, 4), ("vocab",), (49155,)),
              ((2, 4), ("vocab",), (49152,)),
              ((2, 4), ("vocab", "embed"), (51866, 1024)),
              ((2, 4), ("digit", None, None), (16, 8, 8)),
              ((2, 4), ("digit", None, None), (9, 8, 8)),
              ((2, 4), ("batch", None), (6, 3)),
              ((2, 4), ("expert", "embed", "mlp"), (16, 64, 256))]


@pytest.mark.parametrize("shape,axes,dims", SPEC_CASES)
def test_spec_for_axes_equals_jax(shape, axes, dims):
    mesh = _abstract_mesh(shape)
    assert sh.spec_for_axes(axes, dims, mesh) == tuple(
        jsh.spec_for_axes(axes, dims, mesh))


@pytest.mark.parametrize("dims", [(4, 8), (4, 9), (3, 9), (2, 4)])
def test_first_valid_spec_and_batch_spec_equal_jax(dims):
    from jax.sharding import PartitionSpec as P

    mesh = _abstract_mesh((2, 4))
    cands = [P("data", "model"), P("data", None), P(None, None)]
    assert sh.first_valid_spec(dims, [tuple(c) for c in cands], mesh) == \
        tuple(jsh.first_valid_spec(dims, cands, mesh))
    for m in (mesh, _abstract_mesh((2, 2, 4), ("pod", "data", "model"))):
        assert sh.batch_spec(m) == tuple(jsh.batch_spec(m))
        assert sh.dp_axes(m) == jsh.dp_axes(m)
        assert sh.dp_size(m) == jsh.dp_size(m)


@pytest.mark.parametrize("chips,mp", [(512, 16), (496, 16), (8, 16),
                                      (96, 8), (3, 1)])
def test_plan_remesh_equals_jax(chips, mp):
    assert plan_remesh(chips, model_parallel=mp) == j_plan_remesh(
        chips, model_parallel=mp)


def test_int8_compression_bit_equal_to_jax():
    """``compress_int8`` / ``decompress_int8`` and 5 steps of
    ``ef_compress_tree`` / ``decompress_tree``: the int8 values, scales,
    decompressed gradients and error state bit-equal to JAX's (rounding
    half to even: exact ties included)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(1000).astype(np.float32)
    x[:8] = np.float32(np.max(np.abs(x)) / 127) * np.float32(
        [0.5, 1.5, 2.5, -0.5, -1.5, 3.5, 0, 127])
    q, s = comp.compress_int8(torch.from_numpy(x))
    jq, js = jcomp.compress_int8(jnp.asarray(x))
    assert np.array_equal(_np(q), np.asarray(jq))
    assert _np(s) == np.asarray(js)
    assert np.array_equal(_np(comp.decompress_int8(q, s)),
                          np.asarray(jcomp.decompress_int8(jq, js)))
    e = je = None
    for i in range(5):
        g = {"a": rng.standard_normal((8, 16)).astype(np.float32),
             "b": (rng.standard_normal(32) * 1e-3).astype(np.float32)}
        qt, e = comp.ef_compress_tree(
            {k: torch.from_numpy(v) for k, v in g.items()}, e)
        jqt, je = jcomp.ef_compress_tree(
            {k: jnp.asarray(v) for k, v in g.items()}, je)
        dec, jdec = comp.decompress_tree(qt), jcomp.decompress_tree(jqt)
        for k in g:
            assert np.array_equal(_np(qt[k][0]), np.asarray(jqt[k][0]))
            assert np.array_equal(_np(dec[k]), np.asarray(jdec[k]))
            assert np.array_equal(_np(e[k]), np.asarray(je[k]))


@pytest.mark.parametrize("path", ["float", "rns"])
def test_compress_dci_steps_equal_jax(path):
    """``make_train_step(compress_dci=True)``: 2 steps against JAX's from
    the same state, one scale a JAX leaf (a period slot's layers
    together), losses within LOSS_TOL; every parameter and error-feedback
    residual within test_torch_train's bar of JAX's but those an int8
    flip moved (at most FLIP_SHARE of them, each parameter within the 2
    updates' 2 lr); the residuals are in the state and its checkpoint
    tree."""
    jcfg, cfg = _twins("rns9" if path == "rns" else None)
    if path == "rns":
        jcfg = dataclasses.replace(jcfg, rns=dataclasses.replace(
            jcfg.rns, qx=16, qw=16))
        cfg = dataclasses.replace(cfg, rns=dataclasses.replace(
            cfg.rns, qx=16, qw=16))
    jstate, _ = jts.init_train_state(jax.random.PRNGKey(0), jcfg)
    jstep = jax.jit(jts.make_train_step(jcfg, jadamw.AdamWConfig(**ADAM),
                                        compress_dci=True))
    tree = jax.tree.map(np.asarray, jstate)
    state = {"model": params_from_jax(tree["params"], cfg,
                                      device="cpu").requires_grad_(True),
             "opt": opt_state_from_jax(tree["opt"], cfg, device="cpu")}
    step = ts.make_train_step(cfg, adamw.AdamWConfig(**ADAM),
                              compress_dci=True)
    rng = np.random.default_rng(5)
    for _ in range(2):
        toks = rng.integers(1, cfg.vocab, (2, 16)).astype(np.int32)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": toks})
        assert abs(float(m["loss"]) - float(jm["loss"])) < LOSS_TOL[path]
    want = params_from_jax(jax.tree.map(np.asarray, jstate["params"]), cfg,
                           device="cpu")
    got = dict(state["model"].named_parameters())
    assert set(ts.state_tree(state)["ef"]) == set(got)
    jef = dict(params_from_jax(jax.tree.map(np.asarray, jstate["ef"]), cfg,
                               device="cpu").named_parameters())
    flips = total = 0
    for name, p in want.named_parameters():
        d = np.abs(_np(got[name]) - _np(p))
        off = d > PARAM_RTOL * np.abs(_np(p)) + PARAM_ATOL[path]
        # an int8 flip moves one update by at most lr a step
        assert d.max() <= 2 * ADAM["lr"], name
        # a residual is below half an int8 step (|g| / 254 at the
        # leaf's largest |g|): C.17's gradient bar, taken at that scale
        de = np.abs(_np(state["ef"][name]) - _np(jef[name]))
        bar = GRAD_BAR[path] * 254 * np.abs(_np(jef[name])).max() + 1e-9
        flips += int(off.sum()) + int((de > bar).sum())
        total += d.size
    assert flips <= FLIP_SHARE * total, (flips, total)


def test_digit_group_profiles():
    """A digit group is a profile of its own moduli that keeps the whole
    profile's lazy_chunk, resolves by name, and has its own key in the
    block table; the convert and matmul wrappers take it (on the CPU
    their plain versions), giving the whole profile's planes [lo:hi)."""
    g = digit_group("rns9", 3, 6)
    p = get_profile("rns9")
    assert g.moduli == p.moduli[3:6] and g.n_digits == 3
    assert g.lazy_chunk == p.lazy_chunk and g.int8_safe
    assert get_profile("rns9[3:6]") is g
    assert digit_group("rns9", 0, 9) is p
    with pytest.raises(KeyError):
        get_profile("rns10[0:1]")
    with pytest.raises(ValueError):
        digit_group("rns9", 4, 10)
    key, _ = autotune.resolve("rns_convert", g, (64,), torch.device("cpu"),
                              gate=g.n_digits in convert_ops.SUPPORTED_K)
    assert "|rns9[3:6]|" in key
    assert {1, 2, 3, 4} <= set(convert_ops.SUPPORTED_K)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    s = torch.tensor(100.0)
    whole = convert_ops.rns_convert(p, x, s, bits=16)
    for lo, hi in ((0, 1), (1, 3), (3, 6), (5, 9)):
        g = digit_group("rns9", lo, hi)
        assert torch.equal(convert_ops.rns_convert(g, x, s, bits=16),
                           whole[lo:hi])
    a = whole.reshape(9, 5, 64)
    b = convert_ops.rns_convert(p, x.T.contiguous()[:, :48], s, bits=16)
    full = matmul_ops.rns_matmul(p, a, b)
    for lo, hi in ((0, 3), (6, 9), (2, 4)):
        g = digit_group("rns9", lo, hi)
        assert torch.equal(matmul_ops.rns_matmul(g, a[lo:hi], b[lo:hi]),
                           full[lo:hi])


def test_op_counts_amortization_fields_equal_jax():
    """``OpCounts.activation_converts`` and ``normalizes_per_matmul``
    (ROADMAP A.2), as JAX's, on a deferred MLP's counts."""
    kw = dict(converts=3, matmuls=3, normalizes=2, fused=0, fallbacks=0,
              weight_converts=3)
    got, want = dispatch.OpCounts(**kw), jdispatch.OpCounts(**kw)
    assert got.activation_converts == want.activation_converts
    assert got.normalizes_per_matmul == want.normalizes_per_matmul
    assert dispatch.OpCounts().normalizes_per_matmul == 0.0


def test_slice_parallel_keeps_the_per_op_path():
    """``slice_parallel``: ``rns_dot`` bit-equal to JAX's (the per-op
    path, even on a fused backend, as JAX's ``_fused_path``), and a
    deferred MLP warns and falls back to per-op, as JAX's does."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    jcfg = JRnsDotConfig(profile="rns9", qx=8, qw=8, slice_parallel=True)
    cfg = RnsDotConfig(profile="rns9", qx=8, qw=8, slice_parallel=True,
                       backend="cuda_fused")
    with dispatch.count_ops() as ops:
        y = rns_dot(torch.from_numpy(x), torch.from_numpy(w), cfg)
    assert ops.fused == 0 and ops.normalizes == 1
    assert np.array_equal(_np(y), np.asarray(j_rns_dot(x, w, jcfg)))
    mlp = layers.MLP(64, 128)
    with torch.no_grad():
        for p in (mlp.wi, mlp.wg, mlp.wo):
            p.copy_(torch.from_numpy(
                rng.standard_normal(tuple(p.shape)).astype(np.float32) / 8))
    defer = RnsDotConfig(profile="rns9", qx=8, qw=8, defer=True,
                         slice_parallel=True)
    xt = torch.from_numpy(x)
    with pytest.warns(UserWarning, match="slice_parallel"):
        got = layers.mlp(mlp, xt, rns=defer)
    perop = layers.mlp(mlp, xt, rns=dataclasses.replace(defer, defer=False))
    assert torch.equal(got, perop)
    jp = {n: {"w": jnp.asarray(_np(getattr(mlp, n)))}
          for n in ("wi", "wg", "wo")}
    jdefer = JRnsDotConfig(profile="rns9", qx=8, qw=8, defer=True,
                           slice_parallel=True)
    with pytest.warns(UserWarning, match="slice_parallel"):
        want = jlayers.mlp(jp, jnp.asarray(x), rns=jdefer)
    assert np.array_equal(_np(got), np.asarray(want))


def test_digit_context_needs_a_dividing_profile():
    """A profile the digit group does not divide stays whole (rns9 over
    4 ranks), as JAX's ``DigitSharding.shards``; no context, nothing
    changes."""
    class _Mesh:
        mesh_dim_names = ("data", "model")
        mesh = torch.zeros(1, 4)

        def get_local_rank(self, axis):
            return 1

    ds = sh.DigitSharding(_Mesh())
    assert ds.n_shards == 4 and ds.shards(16) and not ds.shards(9)
    assert ds.bounds(16) == (4, 8)
    assert ds.local_profile("rns16").moduli == get_profile(
        "rns16").moduli[4:8]
    jds = jsh.DigitSharding(_abstract_mesh((1, 4)))
    assert jds.shards(16) and not jds.shards(9)
    assert sh.digit_sharding() is None
    with sh.use_digit_sharding(None):
        assert sh.digit_sharding() is None
    with sh.use_digit_sharding(_Mesh()) as got:
        assert sh.digit_sharding() is got
        assert dispatch._digit_ctx("rns9")[0] is None
        assert dispatch._digit_ctx("rns16")[0] is got
        assert not dispatch.fusion_active("rns16", "cuda_fused")
        assert dispatch.fusion_active("rns9", "cuda_fused")
    assert sh.digit_sharding() is None


# -------------------------------------------------------------- card ------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_gpu_convert_on_digit_groups(cuda, K):
    """B.1 at the digit-group sizes (rns9 / 3, rns8 / 4, rns16 / 8, rns8
    / 8 give 3, 2, 2, 1): bit-equal to its plain version, int8 and int32
    residues, aligned and ragged T."""
    g = torch.Generator(device="cpu").manual_seed(K)
    for name, lo in (("rns16", 16 - K), ("rns9", 0)):
        prof = digit_group(name, lo, lo + K)
        for T in (8 * 576, 4 * 33 * 1536 + 3):
            x = (torch.randn(T, generator=g) * 3).to(cuda)
            s = torch.tensor(1000.0, device=cuda)
            for dt in (torch.int8, torch.int32):
                got = convert_ops.rns_convert(prof, x, s, bits=8,
                                              out_dtype=dt)
                want = convert_ops.rns_convert_plain(prof, x, s, bits=8,
                                                     out_dtype=dt)
                assert torch.equal(got, want), (prof.name, T, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("group", ["rns9[0:3]", "rns9[6:9]", "rns8[2:4]",
                                   "rns16[14:16]"])
def test_gpu_matmul_on_digit_groups(cuda, group):
    """B.2 on each rank's moduli (decode and prefill rows of smollm's
    widths): bit-equal to the plain version."""
    prof = get_profile(group)
    g = torch.Generator(device="cpu").manual_seed(0)
    for M_, D, N in ((8, 576, 1536), (8, 1536, 576), (144, 576, 1536)):
        a = torch.stack([torch.randint(0, m, (M_, D), generator=g)
                         for m in prof.moduli]).to(torch.int8).to(cuda)
        b = torch.stack([torch.randint(0, m, (D, N), generator=g)
                         for m in prof.moduli]).to(torch.int8).to(cuda)
        assert torch.equal(matmul_ops.rns_matmul(prof, a, b),
                           matmul_ops.rns_matmul_plain(prof, a, b))
