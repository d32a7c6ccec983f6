"""Training on the port (A slice 4a) against the JAX package.

The straight-through autograd of the RNS products (``rns_dot``,
``rns_multi_dot``: gradients bit-equal to ``jax.grad`` of JAX's
``custom_vjp``s with ``backward_rns``), the float-reference backwards of
``rns_linear_chain`` and the RNS MLPs, train-mode attention (dense and
the ``jnp`` flash), AdamW, the synthetic corpus, checkpoints and the
trainer, and one train step of each dense smoke twin (float and rns9 at
16 bits, also with ``grad_accum=2`` and resident weights) against JAX's
``make_train_step`` from the same parameters and optimizer state.  Also
``remat="full"`` = ``"none"`` bit for bit, ``measure_rns_ops`` = JAX's
x layers (ROADMAP C.3); the other families are in
``tests/test_torch_train_archs.py``.  The ``gpu`` cases hold a card step
to the CPU port's, the captured step to the eager one, and the fused
backend to the per-op one.
"""

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as j_get_config
from repro.core.rns_matmul import RnsDotConfig as JRnsDotConfig
from repro.core.rns_matmul import rns_dot as j_rns_dot
from repro.core.rns_matmul import rns_multi_dot as j_rns_multi_dot
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import resident as jresident
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import get_config
from repro_torch.core.rns_matmul import RnsDotConfig, rns_dot, rns_multi_dot
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models import resident
from repro_torch.models.params import opt_state_from_jax, params_from_jax
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.trainer import Trainer, TrainerConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

logging.disable(logging.INFO)

DENSE = ("smollm-135m", "tinyllama-1.1b", "granite-3-8b", "qwen2.5-32b")
# the loss's sums run in another order than XLA's: float32 noise
LOSS_TOL = {"float": 1e-5, "rns9": 1e-4}
# the gradient's global norm, taken before clipping: it sees the scale of
# the backward (a sum of microbatches where a mean is due) that the
# clipped, eps-normalized first AdamW update hides
GRAD_NORM_RTOL = {"float": 1e-5, "rns9": 1e-4}
# AdamW turns a gradient element near 0 into an update of +-lr whose sign
# is float noise; eps=1e-3 bounds that amplification (1/eps) in the step
# comparisons, so the whole chain (gradients, clipping, update) is held
# to JAX's.  rns9: the 16-bit requantizations of activations and
# cotangents that float-order noise flips move gradients by ~2e-4 of
# their scale (ROADMAP C.17), so an update may differ by up to lr / 100
ADAM = dict(lr=1e-2, warmup_steps=2, total_steps=50, eps=1e-3)
PARAM_RTOL = 1e-4
PARAM_ATOL = {"float": 1e-7, "rns9": 1e-2 * ADAM["lr"]}
BATCH = (2, 16)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(t):
    return t.detach().cpu().numpy()


def _rns_cfgs(backend="reference", **kw):
    return (JRnsDotConfig(profile="rns9", qx=16, qw=16, qg=16, **kw),
            RnsDotConfig(profile="rns9", qx=16, qw=16, qg=16,
                         backend=backend, **kw))


# ------------------------------------------------------ RNS autograd ------
@pytest.mark.parametrize("backward_rns", [True, False])
def test_rns_dot_grads_equal_jax(backward_rns):
    """gx and gw of ``rns_dot`` on the reference backend: bit-equal to
    ``jax.grad`` through JAX's custom_vjp with the RNS backward, within
    1e-6 with float backward products (tests/test_rns_matmul.py:46)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 128)).astype(np.float32)
    w = rng.standard_normal((128, 16)).astype(np.float32)
    r = rng.standard_normal((2, 6, 16)).astype(np.float32)
    jcfg, cfg = _rns_cfgs(backward_rns=backward_rns)
    jy, (jgx, jgw) = jax.value_and_grad(
        lambda x, w: jnp.sum(j_rns_dot(x, w, jcfg) * r), (0, 1))(
            jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    y = rns_dot(xt, wt, cfg)
    assert np.array_equal(_np(y), np.asarray(j_rns_dot(x, w, jcfg)))
    gx, gw = torch.autograd.grad((y * _t(r)).sum(), (xt, wt))
    if backward_rns:
        assert np.array_equal(_np(gx), np.asarray(jgx))
        assert np.array_equal(_np(gw), np.asarray(jgw))
    else:
        np.testing.assert_allclose(_np(gx), np.asarray(jgx), rtol=0,
                                   atol=1e-6 * np.abs(jgx).max())
        np.testing.assert_allclose(_np(gw), np.asarray(jgw), rtol=0,
                                   atol=1e-6 * np.abs(jgw).max())


@pytest.mark.parametrize("backward_rns", [True, False])
def test_rns_multi_dot_grads_equal_jax(backward_rns):
    """``rns_multi_dot``'s shared-conversion backward (x.T encoded once,
    each cotangent once for its two products, gx summed from zeros):
    bit-equal to JAX's ``_rns_multi_bwd``; float products within 1e-6."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    ws = [rng.standard_normal((64, n)).astype(np.float32) for n in (16, 24)]
    rs = [rng.standard_normal((3, 5, n)).astype(np.float32) for n in (16, 24)]
    jcfg, cfg = _rns_cfgs(backward_rns=backward_rns)

    def jloss(x, w1, w2):
        ys = j_rns_multi_dot(x, (w1, w2), jcfg)
        return sum(jnp.sum(y * r) for y, r in zip(ys, rs))

    jg = jax.grad(jloss, (0, 1, 2))(*map(jnp.asarray, (x, *ws)))
    leaves = [_t(a).requires_grad_() for a in (x, *ws)]
    ys = rns_multi_dot(leaves[0], tuple(leaves[1:]), cfg)
    loss = sum((y * _t(r)).sum() for y, r in zip(ys, rs))
    g = torch.autograd.grad(loss, leaves)
    for a, b in zip(g, jg):
        if backward_rns:
            assert np.array_equal(_np(a), np.asarray(b))
        else:
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0,
                                       atol=1e-6 * np.abs(b).max())


def test_rns_config_refuses_what_waits_for_a11():
    """The entry points that waited for the distributed slice (A.11) no
    longer refuse: ``slice_parallel`` keeps the per-primitive path,
    ``compress_dci`` builds a step with error feedback, and the
    data-parallel step wants its mesh (tests/test_torch_distributed.py
    holds each to JAX)."""
    cfg = RnsDotConfig(slice_parallel=True)
    assert cfg.slice_parallel
    step = ts.make_train_step(get_config("smollm-135m", smoke=True),
                              adamw.AdamWConfig(), compress_dci=True)
    assert step.compress_dci
    with pytest.raises(TypeError, match="mesh"):
        ts.make_dp_train_step(get_config("smollm-135m", smoke=True),
                              adamw.AdamWConfig())


def _port_mlp(jp, gated=True):
    m = layers.MLP(jp["wi"]["w"].shape[0], jp["wi"]["w"].shape[1], gated)
    with torch.no_grad():
        for name in ("wi", "wg", "wo") if gated else ("wi", "wo"):
            getattr(m, name).copy_(_t(jp[name]["w"]))
    return m


@pytest.mark.parametrize("kind", ["chain", "deferred", "resident_perop"])
def test_float_reference_backwards_match_jax(kind):
    """The straight-through float-reference backwards of
    ``rns_linear_chain`` (the float chain's), ``mlp_rns_deferred`` and
    ``mlp_rns_resident_perop`` (the float MLP's over the masters;
    resident digits take none): gradients within rtol 1e-5 of JAX's
    (tests/test_rns_tensor.py:223)."""
    rng = np.random.default_rng(10)
    jcfg, cfg = _rns_cfgs(defer=kind == "deferred")
    if kind == "chain":
        x = rng.standard_normal((3, 12)).astype(np.float32)
        ws = [(rng.standard_normal(s) / 4).astype(np.float32)
              for s in ((12, 12), (12, 6))]
        r = rng.standard_normal((3, 6)).astype(np.float32)
        jg = jax.grad(lambda x, *ws: jnp.sum(
            jlayers.rns_linear_chain(x, ws, jcfg) * r),
            tuple(range(3)))(*map(jnp.asarray, (x, *ws)))
        leaves = [_t(a).requires_grad_() for a in (x, *ws)]
        y = layers.rns_linear_chain(leaves[0], tuple(leaves[1:]), cfg)
        assert np.array_equal(_np(y), np.asarray(
            jlayers.rns_linear_chain(jnp.asarray(x), tuple(ws), jcfg)))
        got = torch.autograd.grad((y * _t(r)).sum(), leaves)
    else:
        jp, _ = jlayers.init_mlp(jax.random.PRNGKey(1), 8, 16, gated=True)
        x = rng.standard_normal((3, 4, 8)).astype(np.float32)
        r = rng.standard_normal((3, 4, 8)).astype(np.float32)
        names = ("wi", "wg", "wo")
        m = _port_mlp(jp)
        res = {}
        if kind == "resident_perop":
            for n in names:
                res[n] = jresident._encode_one(jp[n]["w"], "rns9", 16, 15.0)
                m.set_resident(n, resident._encode_one(
                    getattr(m, n), "rns9", 16, 15.0, "reference"))

        def jloss(x, *ws):
            p = {n: dict({"w": w}, **({"w_res": res[n]} if res else {}))
                 for n, w in zip(names, ws)}
            return jnp.sum(jlayers.mlp(p, x, gated=True, act="silu",
                                       rns=jcfg) * r)

        jg = jax.grad(jloss, tuple(range(4)))(
            jnp.asarray(x), *(jp[n]["w"] for n in names))
        for n in names:
            getattr(m, n).requires_grad_(True)
        xt = _t(x).requires_grad_()
        y = layers.mlp(m, xt, gated=True, act="silu", rns=cfg)
        got = torch.autograd.grad((y * _t(r)).sum(),
                                  [xt] + [getattr(m, n) for n in names])
    for a, b in zip(got, jg):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())


# --------------------------------------------------------- attention ------
@pytest.mark.parametrize("causal", [True, False])
def test_train_attention_matches_jax(causal):
    """``dense_attention`` and the ``jnp`` ``flash_attention`` (small
    chunks: several q tiles and KV chunks, a padded last one) against
    JAX's dense attention: values and gradients within 2e-5
    (tests/test_attention.py:41)."""
    rng = np.random.default_rng(1)
    B, T, H, Hk, D = 2, 40, 6, 3, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, T, H, D), (B, T, Hk, D), (B, T, Hk, D)))
    mask = rng.random((B, T)) > 0.2
    mask[:, 0] = True
    r = rng.standard_normal((B, T, H, D)).astype(np.float32)
    jo, jg = jax.value_and_grad(lambda q, k, v: jnp.sum(jattn.dense_attention(
        q, k, v, causal=causal, kv_mask=jnp.asarray(mask)) * r),
        (0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for fn in (attn.dense_attention,
               lambda *a, **kw: attn.flash_attention(*a, q_chunk=16,
                                                     kv_chunk=12, **kw)):
        leaves = [_t(a).requires_grad_() for a in (q, k, v)]
        out = fn(*leaves, causal=causal, kv_mask=_t(mask))
        loss = (out * _t(r)).sum()
        assert abs(float(loss) - float(jo)) < 2e-5 * max(1.0, abs(float(jo)))
        for a, b in zip(torch.autograd.grad(loss, leaves), jg):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0,
                                       atol=2e-5)


# ------------------------------------------------------------ AdamW ------
def test_adamw_minimizes_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200,
                            weight_decay=0.0, schedule="constant")
    params = {"w": torch.tensor([5.0, -3.0], requires_grad=True)}
    opt = adamw.init_opt_state(params)
    for _ in range(150):
        g = torch.autograd.grad((params["w"] ** 2).sum(), params["w"])[0]
        adamw.adamw_update(cfg, {"w": g}, opt, params)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clip():
    clipped, gn = adamw.clip_by_global_norm({"a": torch.tensor([30.0, 40.0])},
                                            1.0)
    assert abs(float(gn) - 50.0) < 1e-4
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_equals_jax(schedule):
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, schedule=schedule,
               min_lr_ratio=0.1)
    for s in (0, 5, 10, 55, 100, 130):
        got = float(adamw.schedule_lr(adamw.AdamWConfig(**cfg),
                                      torch.tensor(s)))
        want = float(jadamw.schedule_lr(jadamw.AdamWConfig(**cfg),
                                        jnp.asarray(s)))
        assert abs(got - want) <= 1e-7 * max(1.0, abs(want)), (s, got, want)


def test_adamw_update_equals_jax():
    """Three updates on the same gradients from the same state (clipped:
    the global norm is above ``grad_clip``): params, m, v, step, lr and
    the norm within 1e-6 relative of JAX's."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((5, 7)), "b": rng.standard_normal(3)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    grads = {k: (3 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in params.items()}
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=20)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jo = jadamw.init_opt_state(jp)
    tp = {k: _t(v) for k, v in params.items()}
    to = adamw.init_opt_state(tp)
    for _ in range(3):
        jp, jo, jm = jadamw.adamw_update(
            jadamw.AdamWConfig(**cfg), {k: jnp.asarray(v)
                                        for k, v in grads.items()}, jo, jp)
        tp, to, tm = adamw.adamw_update(
            adamw.AdamWConfig(**cfg), {k: _t(v) for k, v in grads.items()},
            to, tp)
        for got, want in [(tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])]:
            for k in params:
                np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                           rtol=1e-6)
        assert int(to["step"]) == int(jo["step"])
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


# ------------------------------------------------------------- data ------
@pytest.mark.parametrize("hosts", [1, 2])
def test_synthetic_lm_equals_jax(hosts):
    """The port's corpus is JAX's, batch for batch, bit for bit, and a
    pure function of (seed, step, host)."""
    cfg = dict(vocab=128, seq_len=32, global_batch=8, seed=7)
    for h in range(hosts):
        d = SyntheticLM(DataConfig(**cfg), host_id=h, n_hosts=hosts)
        jd = JSyntheticLM(JDataConfig(**cfg), host_id=h, n_hosts=hosts)
        for step in (0, 5, 6):
            assert np.array_equal(d.batch(step)["tokens"],
                                  jd.batch(step)["tokens"])
        assert np.array_equal(d.batch(5)["tokens"], d.batch(5)["tokens"])
        assert not np.array_equal(d.batch(5)["tokens"], d.batch(6)["tokens"])
    with pytest.raises(ValueError):
        SyntheticLM(DataConfig(**cfg), n_hosts=3)


# ------------------------------------------------------- checkpoints ------
def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "n": {"b": torch.ones((3, 4), dtype=torch.bfloat16),
                  "step": torch.tensor(7, dtype=torch.int32)}}
    d = ckpt.save(str(tmp_path), 42, tree, extra={"tag": "x"})
    assert os.path.basename(d) == "step_000000042"
    assert not any(f.startswith(".tmp") for f in os.listdir(tmp_path))
    like = {"a": torch.zeros(10), "n": {
        "b": torch.zeros((3, 4), dtype=torch.bfloat16),
        "step": torch.tensor(0, dtype=torch.int32)}}
    addr = like["a"].data_ptr()
    back, extra, step = ckpt.restore(d, like)
    assert step == 42 and extra == {"tag": "x"}
    assert back["a"].data_ptr() == addr            # in place
    for a, b in [(tree["a"], back["a"]), (tree["n"]["b"], back["n"]["b"]),
                 (tree["n"]["step"], back["n"]["step"])]:
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, {"a": torch.zeros(9), "n": like["n"]})


def test_latest_valid_skips_corrupt(tmp_path):
    tree = {"w": torch.arange(100, dtype=torch.float32)}
    ckpt.save(str(tmp_path), 1, tree)
    d2 = ckpt.save(str(tmp_path), 2, tree)
    ckpt.corrupt_for_test(d2)
    assert ckpt.latest_valid(str(tmp_path)).endswith("step_000000001")
    assert ckpt.latest_valid(str(tmp_path / "none")) is None


def test_async_checkpoint_snapshots_first(tmp_path):
    """The tree is copied before ``save_async`` returns: a write to the
    live tensor after it is not in the checkpoint."""
    w = torch.ones(64)
    fut = ckpt.save_async(str(tmp_path), 3, {"w": w})
    w.fill_(5.0)
    assert fut.result().endswith("step_000000003")
    assert ckpt.latest_valid(str(tmp_path)).endswith("step_000000003")
    back, _, _ = ckpt.restore(fut.result(), {"w": torch.zeros(64)})
    assert torch.equal(back["w"], torch.ones(64))


def _mk_trainer(tmpdir, total_steps, **kw):
    cfg = get_config("smollm-135m", smoke=True)
    return Trainer(
        cfg, adamw.AdamWConfig(lr=8e-3, warmup_steps=5, total_steps=200,
                               weight_decay=0.0),
        TrainerConfig(total_steps=total_steps, ckpt_every=10,
                      ckpt_dir=str(tmpdir), log_every=100, async_ckpt=False),
        DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, branch=4,
                   noise=0.05), device="cpu", **kw)


def test_loss_decreases(tmp_path):
    _, hist = _mk_trainer(tmp_path, 40).run()
    assert hist[-1] < hist[0] - 0.3, (hist[0], hist[-1])


def test_restart_is_bitwise_resumable(tmp_path):
    """20 straight steps == 10 steps + a new trainer resuming from the
    step-10 checkpoint + 10 steps, bit for bit (params, m, v, step)."""
    state_a, hist_a = _mk_trainer(tmp_path / "a", 20).run()
    _mk_trainer(tmp_path / "b", 10).run()
    state_b, hist_b = _mk_trainer(tmp_path / "b", 20).run()
    assert hist_b == hist_a[10:]
    ta, tb = ts.state_tree(state_a), ts.state_tree(state_b)
    for k in ta["params"]:
        assert torch.equal(ta["params"][k], tb["params"][k]), k
        assert torch.equal(ta["opt"]["m"][k], tb["opt"]["m"][k]), k
        assert torch.equal(ta["opt"]["v"][k], tb["opt"]["v"][k]), k
    assert int(ta["opt"]["step"]) == int(tb["opt"]["step"]) == 20


def test_preemption_checkpoints_and_exits(tmp_path):
    tr = _mk_trainer(tmp_path, 50)
    tr.preempt.trigger_for_test()
    _, hist = tr.run()
    assert len(hist) == 1
    assert ckpt.latest_valid(str(tmp_path)).endswith("step_000000001")


def test_train_cli_on_the_cpu(tmp_path, capsys):
    hist = train_cli.main(["--arch", "smollm-135m", "--smoke", "--steps",
                           "3", "--batch", "2", "--seq", "16", "--rns",
                           "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 3 and all(np.isfinite(hist))
    assert "final loss" in capsys.readouterr().out
    assert ckpt.latest_valid(str(tmp_path)).endswith("step_000000003")


def test_train_cli_eager(tmp_path, monkeypatch):
    """``--eager`` builds the step with ``graphs=False`` (on the CPU the
    same losses as without it)."""
    seen = []
    real = trainer_mod.make_train_step

    def spy(*args, **kwargs):
        seen.append(kwargs["graphs"])
        return real(*args, **kwargs)

    monkeypatch.setattr(trainer_mod, "make_train_step", spy)
    argv = ["--arch", "smollm-135m", "--smoke", "--steps", "2", "--batch",
            "2", "--seq", "16", "--device", "cpu"]
    graphed = train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    eager = train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "b"),
                                   "--eager"])
    assert seen == [True, False]
    assert eager == graphed


# ------------------------------------------------- steps against JAX ------
def _twin(arch, path, **over):
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True), **over)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    if path != "float":
        jr, r = _rns_cfgs()
        jcfg = dataclasses.replace(jcfg, rns=jr, rns_targets="mlp")
        cfg = dataclasses.replace(cfg, rns=r, rns_targets="mlp")
    return jcfg, cfg


def _jax_state(arch, jcfg, seed=0):
    state, _ = jts.init_train_state(jax.random.PRNGKey(seed), jcfg)
    return state


def _tokens(vocab, shape=BATCH, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int32)


def _port_state(jstate, cfg):
    tree = jax.tree.map(np.asarray, jstate)
    model = params_from_jax(tree["params"], cfg, device="cpu")
    return {"model": model, "opt": opt_state_from_jax(tree["opt"], cfg,
                                                      device="cpu")}


def _hold_step_to_jax(jcfg, cfg, path, *, steps_before=1, resident=False,
                      shape=BATCH):
    """JAX's jitted step ``steps_before`` times, then the port's step from
    the same params and optimizer state vs JAX's next one: loss within
    LOSS_TOL, the gradient norm within GRAD_NORM_RTOL, every updated param
    within PARAM_RTOL, the step counts."""
    opt = jadamw.AdamWConfig(**ADAM)
    jstep = jax.jit(jts.make_train_step(jcfg, opt,
                                        resident_weights=resident))
    jstate = _jax_state(jcfg.arch_id, jcfg)
    for i in range(steps_before):
        jstate, _ = jstep(jstate, {"tokens": jnp.asarray(
            _tokens(cfg.vocab, shape, seed=100 + i))})
    state = _port_state(jstate, cfg)
    toks = _tokens(cfg.vocab, shape)
    jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
    step = ts.make_train_step(cfg, adamw.AdamWConfig(**ADAM),
                              resident_weights=resident)
    state, m = step(state, {"tokens": toks})
    assert abs(float(m["loss"]) - float(jm["loss"])) < LOSS_TOL[path], (
        float(m["loss"]), float(jm["loss"]))
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_NORM_RTOL[path])
    want = _port_state(jstate, cfg)
    assert int(state["opt"]["step"]) == int(want["opt"]["step"])
    got = dict(state["model"].named_parameters())
    for name, p in want["model"].named_parameters():
        np.testing.assert_allclose(_np(got[name]), _np(p), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL[path], err_msg=name)
    return state


@pytest.mark.parametrize("path", ["float", "rns9"])
@pytest.mark.parametrize("arch", DENSE)
def test_train_step_equals_jax(arch, path):
    """One train step of each dense twin (qwen's q/k/v biases included),
    float and rns9 with 16-bit operands and the RNS backward, from a
    state JAX has stepped once (``opt_state_from_jax``: m, v, step 1)."""
    jcfg, cfg = _twin(arch, path)
    _hold_step_to_jax(jcfg, cfg, path)


@pytest.mark.parametrize("mode", ["grad_accum", "resident"])
def test_train_step_modes_equal_jax(mode):
    """``grad_accum=2`` (two microbatches of 2 rows, gradients summed in
    float32 then divided) and ``resident_weights=True`` (the masters
    encoded at the step's start, the per-op resident MLP, its float
    backward), rns9, against JAX's step."""
    over = {"grad_accum": 2} if mode == "grad_accum" else {}
    jcfg, cfg = _twin("smollm-135m", "rns9", **over)
    state = _hold_step_to_jax(jcfg, cfg, "rns9", steps_before=0,
                              resident=mode == "resident", shape=(4, 16))
    if mode == "resident":
        mlp = state["model"].blocks[0].mlp
        assert mlp.resident("wi") is not None
        names = set(state["opt"]["m"])
        assert names == {n for n, _ in state["model"].named_parameters()}
        assert not any(n.endswith(("_digits", "_scale")) for n in names)
        resident.strip_resident(state["model"])
        assert not resident.has_resident(state["model"])


def test_remat_full_equals_none_bit_for_bit():
    """Two steps with every layer recomputed in the backward
    (``remat="full"``) give the bits of two steps without."""
    out = {}
    for remat in ("none", "full"):
        _, cfg = _twin("smollm-135m", "rns9", remat=remat)
        model = M.init_model(cfg, seed=3, device="cpu")
        state = {"model": model.requires_grad_(True),
                 "opt": adamw.init_opt_state(dict(model.named_parameters()))}
        step = ts.make_train_step(cfg, adamw.AdamWConfig(**ADAM))
        losses = [float(step(state, {"tokens": _tokens(cfg.vocab, seed=s)})
                        [1]["loss"]) for s in (0, 1)]
        out[remat] = (losses, ts.state_tree(state))
    assert out["none"][0] == out["full"][0]
    a, b = out["none"][1], out["full"][1]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
        assert torch.equal(a["opt"]["v"][k], b["opt"]["v"][k]), k


@pytest.mark.parametrize("defer", [False, True])
def test_measure_rns_ops_equals_jax_times_layers(defer):
    """One loss evaluation's RNS calls: JAX's traced count (one scanned
    layer) times the layers (ROADMAP C.3); no backward counted."""
    jcfg, cfg = _twin("smollm-135m", "rns9")
    jcfg = dataclasses.replace(jcfg, rns=dataclasses.replace(jcfg.rns,
                                                             defer=defer))
    cfg = dataclasses.replace(cfg, rns=dataclasses.replace(cfg.rns,
                                                           defer=defer))
    toks = _tokens(cfg.vocab)
    want = jts.measure_rns_ops(jcfg, {"tokens": jnp.asarray(toks)})
    model = M.init_model(cfg, seed=0, device="cpu")
    got = ts.measure_rns_ops(model, cfg, {"tokens": _t(toks)})
    for f in got.FIELDS:
        assert getattr(got, f) == getattr(want, f) * cfg.n_layers, f


def test_jax_train_op_counts_written_in_chip_smoke():
    """chip_smoke.py's ``JAX_TRAIN_RNS_OPS`` (one smollm-135m loss on the
    per-op rns9 path at 16 bits) is what JAX traces: one scanned layer,
    the same at the smoke width as at the published one."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    jcfg, _ = _twin("smollm-135m", "rns9")
    got = jts.measure_rns_ops(jcfg, {"tokens": jnp.zeros(BATCH, jnp.int32)})
    assert {f: getattr(got, f) for f in smoke.JAX_TRAIN_RNS_OPS} == \
        smoke.JAX_TRAIN_RNS_OPS


# -------------------------------------------------------------- card ------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels run "
                    "only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["float", "rns9"])
def test_gpu_captured_step_equals_eager_and_cpu(cuda, path):
    """On the card: three captured steps equal three eager steps bit for
    bit (loss, every param, m, v), one capture; the first card step's
    loss within LOSS_TOL of the CPU port's, its params within
    PARAM_RTOL; on rns9 the fused backend's steps equal the per-op
    one's bit for bit."""
    _, cfg = _twin("smollm-135m", path)
    if path == "rns9":
        cfg = dataclasses.replace(cfg, rns=dataclasses.replace(
            cfg.rns, backend="cuda"))
    cpu_cfg = cfg if path == "float" else dataclasses.replace(
        cfg, rns=dataclasses.replace(cfg.rns, backend="reference"))
    base = M.init_model(cfg, seed=0, device="cpu")
    batches = [_tokens(cfg.vocab, (4, 32), seed=s) for s in range(3)]

    def run(c, device, graphs, n=3):
        model = M.init_model(c, seed=0, device="cpu").to(device)
        model.load_state_dict(base.state_dict())
        state = {"model": model.requires_grad_(True),
                 "opt": adamw.init_opt_state(dict(model.named_parameters()))}
        step = ts.make_train_step(c, adamw.AdamWConfig(**ADAM), graphs=graphs)
        losses = [float(step(state, {"tokens": b})[1]["loss"])
                  for b in batches[:n]]
        return losses, ts.state_tree(state), step

    l_eager, s_eager, _ = run(cfg, cuda, False)
    l_graph, s_graph, step = run(cfg, cuda, True)
    assert step.captures == 1
    assert l_eager == l_graph
    for k in s_eager["params"]:
        for part in ("params",):
            assert torch.equal(s_eager[part][k], s_graph[part][k]), k
        assert torch.equal(s_eager["opt"]["m"][k], s_graph["opt"]["m"][k])
        assert torch.equal(s_eager["opt"]["v"][k], s_graph["opt"]["v"][k])
    l_cpu, s_cpu, _ = run(cpu_cfg, "cpu", False, n=1)
    l_one, s_one, _ = run(cfg, cuda, False, n=1)
    assert abs(l_one[0] - l_cpu[0]) < LOSS_TOL[path]
    for k, p in s_cpu["params"].items():
        np.testing.assert_allclose(_np(s_one["params"][k]), _np(p),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL[path],
                                   err_msg=k)
    if path == "rns9":
        fused = dataclasses.replace(cfg, rns=dataclasses.replace(
            cfg.rns, backend="cuda_fused"))
        l_fused, s_fused, _ = run(fused, cuda, True)
        assert l_fused == l_graph
        for k in s_fused["params"]:
            assert torch.equal(s_fused["params"][k], s_graph["params"][k]), k
