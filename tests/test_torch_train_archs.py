"""Training the other families on the port (A slice 4b) against the JAX
package.

The smoke twins of ``deepseek-v2-236b`` (MLA + MoE, two shared experts),
``llama4-scout-17b-a16e`` (GQA + MoE top-1 + shared), ``jamba-v0.1-52b``
(Mamba, one GQA layer a period, MoE every other layer), ``rwkv6-7b``
(RWKV-6 time-mix and channel-mix, stepwise and chunked), ``whisper-
medium`` (encoder-decoder, cross-attention, a plain gelu MLP) and
``paligemma-3b`` (a frontend ahead of the tokens, ``gelu_tanh``), their
weights from ``repro.models.model.init_model`` through ``params_from_jax``
and their optimizer state through ``opt_state_from_jax``:

- ``loss_fn``'s loss, CE, aux loss and every gradient against
  ``jax.value_and_grad(repro.models.model.loss_fn)``, float and rns9 at 16
  bits with the RNS backward, and a whole ``TrainStep`` against JAX's
  step (AdamW eps 1e-3, ROADMAP C.17), with resident weights (shared
  experts, the encoder's MLPs) and ``grad_accum`` with a frontend;
- MoE with a dropping capacity on both dispatches, the deepseek twin with
  ``rns_targets="all"``, the encoder's whole-tensor grids, the frontend
  positions out of the loss, ``remat="full"`` = ``"none"`` bit for bit
  with MoE and with an encoder, the trainer's frontend stub,
  ``measure_rns_ops``, ``make_eval_step``, a checkpoint resume of a MoE
  twin and the CLI on one twin of each family;
- RWKV-6 on rns9 (ROADMAP C.18): every RNS projection bit-equal to JAX's
  on the port's inputs, each layer's gradients on the port's own inputs
  and cotangents within the bar.

The ``gpu`` cases hold three captured steps to three eager ones on the
card.  JAX's gradients and its step come from one jitted function, the
body of ``make_train_step`` at ``grad_accum=1`` (``value_and_grad`` of
``loss_fn``, then ``adamw_update``), so that one XLA compile serves both
comparisons; the resident and microbatched cases call
``make_train_step`` itself.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as j_get_config
from repro.core import dispatch as jdispatch
from repro.core.rns_matmul import RnsDotConfig as JRnsDotConfig
from repro.data.pipeline import DataConfig as JDataConfig
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import at_depth, get_config
from repro_torch.core.rns_matmul import RnsDotConfig
from repro_torch.data.pipeline import DataConfig, make_frontend_stub
from repro_torch.launch import train as train_cli
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models import resident
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.params import opt_state_from_jax, params_from_jax
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import Trainer, TrainerConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

logging.disable(logging.INFO)

ARCHS = ("deepseek-v2-236b", "llama4-scout-17b-a16e", "jamba-v0.1-52b",
         "rwkv6-7b", "whisper-medium", "paligemma-3b")
# the loss's sums run in another order than XLA's (C.10): float32 noise;
# rns9: C.17's 16-bit requantization flips
LOSS_TOL = {"float": 1e-5, "rns9": 1e-4}
# every gradient g of the port against JAX's w: |g - w| <= rtol *
# max|w| + floor * (the model's largest gradient).  The floor covers
# gradients that are float noise by the maths (a key bias shifts every
# score of a query alike: its gradient is ~1e-9) and the absolute size of
# a 16-bit flip, which follows the tensor it sits in, not the gradient
rtol_floor = {"float": (1e-4, 1e-6), "rns9": (1e-3, 1e-4)}
GRAD_NORM_RTOL = {"float": 1e-5, "rns9": 1e-4}
ADAM = dict(lr=1e-2, warmup_steps=2, total_steps=50, eps=1e-3)
PARAM_RTOL = 1e-4
# an updated parameter: AdamW at eps 1e-3 turns a gradient's difference
# into up to lr / eps = 10 times it.  float: the recurrent twins'
# embedding rows (summed through 16 sequential steps) carry float32
# noise of ~1e-7; rns9: C.17's flips, lr / 100
PARAM_ATOL = {"float": 2e-6, "rns9": 1e-2 * ADAM["lr"]}
BATCH = (2, 16)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(t):
    return t.detach().cpu().numpy()


def _rwkv_chunked(cfg):
    """The RWKV-6 twin on the chunked (GLA) form the full config runs,
    two chunks over the batch's 16 tokens."""
    return {"ssm": dataclasses.replace(cfg.ssm, impl="chunked", chunk=8)}


def _pair(arch, path, targets="mlp", depth=None, **over):
    """(JAX config, port config) of ``arch``'s smoke twin: float, or rns9
    at 16 bits with the RNS backward on ``targets``; ``arch`` may end in
    ``-chunked`` (the RWKV-6 twin's chunked form)."""
    chunked = arch.endswith("-chunked")
    arch = arch.removesuffix("-chunked")
    jcfg, cfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    if chunked:
        over = dict(_rwkv_chunked(cfg), **over)
    if depth is not None:
        cut = at_depth(cfg, depth)
        over = dict(dict(n_layers=depth, layer_types=cut.layer_types,
                         mlp_types=cut.mlp_types), **over)
    jcfg = dataclasses.replace(jcfg, **over)
    cfg = dataclasses.replace(cfg, **over)
    if path != "float":
        jcfg = dataclasses.replace(jcfg, rns=JRnsDotConfig(
            profile="rns9", qx=16, qw=16, qg=16), rns_targets=targets)
        cfg = dataclasses.replace(cfg, rns=RnsDotConfig(
            profile="rns9", qx=16, qw=16, qg=16, backend="reference"),
            rns_targets=targets)
    return jcfg, cfg


def _batch(cfg, shape=BATCH, seed=0):
    """{"tokens", and "frontend" [B, F, d] N(0, 1) for an audio or vision
    twin}: numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, shape).astype(np.int32)}
    if cfg.frontend is not None:
        b["frontend"] = make_frontend_stub(rng, shape[0],
                                           cfg.n_frontend_tokens, cfg.d_model)
    return b


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_model(tree, cfg):
    return params_from_jax(tree, cfg, device="cpu").requires_grad_(True)


def _port_state(jstate, cfg):
    tree = jax.tree.map(np.asarray, jstate)
    return {"model": _port_model(tree["params"], cfg),
            "opt": opt_state_from_jax(tree["opt"], cfg, device="cpu")}


def _grads(model, cfg, batch):
    params = dict(model.named_parameters())
    loss, parts = M.loss_fn(model, cfg, {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            dict(zip(params, grads)))


def _hold_grads(grads, jgrads, cfg, path):
    """Every gradient of the port within the bar of JAX's (``jgrads``, a
    JAX gradient tree); returns the worst ratio to the bar."""
    want = dict(params_from_jax(jax.tree.map(np.asarray, jgrads), cfg,
                                device="cpu").named_parameters())
    rtol, floor = rtol_floor[path]
    gmax = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for name, w in want.items():
        d = float((grads[name] - w).abs().max())
        lim = rtol * float(w.abs().max()) + floor * gmax
        assert d <= lim, (name, d, lim)
        worst = max(worst, d / lim)
    return worst


_JAX = {}


def _jax_case(arch, path, **kw):
    """JAX's side of a twin, computed once: the state after one step on
    batch seed 100, then on batch seed 0 the loss, its parts, the
    gradients and the stepped state and metrics, all from one jitted
    ``value_and_grad`` + ``adamw_update``."""
    key = (arch, path, tuple(sorted(kw.items())))
    if key in _JAX:
        return _JAX[key]
    jcfg, cfg = _pair(arch, path, **kw)
    opt = jadamw.AdamWConfig(**ADAM)

    @jax.jit
    def step(state, batch):
        (loss, parts), g = jax.value_and_grad(
            lambda p: JM.loss_fn(p, jcfg, batch), has_aux=True)(
                state["params"])
        params, opt_state, om = jadamw.adamw_update(opt, g, state["opt"],
                                                    state["params"])
        return ((loss, parts, g), {"params": params, "opt": opt_state},
                {"loss": loss, "aux": parts["aux"], **om})

    state, _ = jts.init_train_state(jax.random.PRNGKey(0), jcfg)
    _, state, _ = step(state, _jbatch(_batch(cfg, seed=100)))
    batch = _batch(cfg)
    out, new, om = step(state, _jbatch(batch))
    _JAX[key] = (cfg, state, batch, out, new, om)
    return _JAX[key]


GRAD_CASES = [(a, p) for a in ARCHS + ("rwkv6-7b-chunked",)
              for p in ("float", "rns9")
              if not (a.startswith("rwkv6-7b") and p == "rns9")]


def _grad_kw(arch, path):
    # jamba rns9: the twin's first two layers (Mamba + dense MLP, Mamba +
    # MoE: the card's cut), half the XLA compile of its 8
    return {"depth": 2} if arch == "jamba-v0.1-52b" and path == "rns9" \
        else {}


@pytest.mark.parametrize("arch,path", GRAD_CASES)
def test_loss_and_grads_equal_jax(arch, path):
    """loss_fn's loss and CE within LOSS_TOL, the aux loss within 1e-6,
    every gradient within the bar, from the state JAX stepped once.
    RWKV-6 on rns9 is ROADMAP C.18 (below)."""
    cfg, state, batch, (jl, jparts, jg), _, _ = _jax_case(
        arch, path, **_grad_kw(arch, path))
    model = _port_model(jax.tree.map(np.asarray, state["params"]), cfg)
    loss, parts, grads = _grads(model, cfg, batch)
    assert abs(float(loss) - float(jl)) < LOSS_TOL[path]
    assert abs(float(parts["ce"]) - float(jparts["ce"])) < LOSS_TOL[path]
    assert abs(float(parts["aux"]) - float(jparts["aux"])) < 1e-6
    assert (float(parts["aux"]) > 0) == (cfg.moe is not None)
    _hold_grads(grads, jg, cfg, path)


STEP_CASES = {
    "deepseek-v2-236b": "rns9", "llama4-scout-17b-a16e": "rns9",
    "jamba-v0.1-52b": "float", "rwkv6-7b-chunked": "float",
    "whisper-medium": "rns9", "paligemma-3b": "rns9"}


def _hold_step(state, m, cfg, path, jnew, jm):
    assert abs(float(m["loss"]) - float(jm["loss"])) < LOSS_TOL[path]
    assert abs(float(m["aux"]) - float(jm["aux"])) < 1e-6
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_NORM_RTOL[path])
    want = _port_state(jnew, cfg)
    assert int(state["opt"]["step"]) == int(want["opt"]["step"])
    got = dict(state["model"].named_parameters())
    for name, p in want["model"].named_parameters():
        np.testing.assert_allclose(_np(got[name]), _np(p), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL[path], err_msg=name)


@pytest.mark.parametrize("arch", sorted(STEP_CASES))
def test_train_step_equals_jax(arch):
    """A whole ``TrainStep`` from the state JAX stepped once (m, v, step 1
    through ``opt_state_from_jax``) against JAX's step: loss, aux, the
    gradient norm, every updated parameter, the step count."""
    path = STEP_CASES[arch]
    cfg, state, batch, _, jnew, jm = _jax_case(arch, path)
    state = _port_state(state, cfg)
    state, m = ts.make_train_step(cfg, adamw.AdamWConfig(**ADAM))(
        state, batch)
    _hold_step(state, m, cfg, path, jnew, jm)


# arch -> (make_train_step's keywords, config overrides, batch shape)
MODE_CASES = {
    "deepseek-v2-236b-resident": ({"resident_weights": True}, {}, BATCH),
    "whisper-medium-resident": ({"resident_weights": True}, {}, BATCH),
    "paligemma-3b-grad_accum": ({}, {"grad_accum": 2}, (4, 16)),
}


@pytest.mark.parametrize("case", sorted(MODE_CASES))
def test_train_step_modes_equal_jax(case):
    """JAX's ``make_train_step`` itself on rns9: resident weights (the
    shared experts' and the encoder's MLPs encoded at the step's start;
    the masters move, the optimizer holds no digits) and ``grad_accum=2``
    with a frontend (its frames split into microbatches with the
    tokens)."""
    kw, over, shape = MODE_CASES[case]
    arch = case.rsplit("-", 1)[0]
    jcfg, cfg = _pair(arch, "rns9", **over)
    opt = jadamw.AdamWConfig(**ADAM)
    jstep = jax.jit(jts.make_train_step(jcfg, opt, **kw))
    jstate, _ = jts.init_train_state(jax.random.PRNGKey(0), jcfg)
    batch = _batch(cfg, shape)
    state = _port_state(jstate, cfg)
    jnew, jm = jstep(jstate, _jbatch(batch))
    state, m = ts.make_train_step(cfg, adamw.AdamWConfig(**ADAM), **kw)(
        state, batch)
    _hold_step(state, m, cfg, "rns9", jnew, jm)
    if kw:
        mods = resident._mlps(state["model"])
        assert any(".shared" in n or n.startswith("enc_blocks")
                   for n, mlp in mods if mlp.resident("wi") is not None)
        names = set(state["opt"]["m"])
        assert names == {n for n, _ in state["model"].named_parameters()}
        assert not any(n.endswith(("_digits", "_scale")) for n in names)


def test_deepseek_all_targets_equal_jax():
    """``rns_targets="all"``: MLA's projections (the down triple, the up
    pairs, ``wo``) through RNS with their shared conversions, forward and
    backward."""
    cfg, state, batch, (jl, _, jg), _, _ = _jax_case(
        "deepseek-v2-236b", "rns9", targets="all")
    model = _port_model(jax.tree.map(np.asarray, state["params"]), cfg)
    loss, _, grads = _grads(model, cfg, batch)
    assert abs(float(loss) - float(jl)) < LOSS_TOL["rns9"]
    _hold_grads(grads, jg, cfg, "rns9")


# ------------------------------------------------------------------ MoE ----
@pytest.mark.parametrize("dispatch", ["gather", "scatter"])
def test_moe_grads_with_drops_equal_jax(dispatch):
    """``moe_ffn`` under autograd at capacity factor 1.0 (entries
    dropped) with a shared expert: y, the aux loss and the gradients of
    x, the router, every expert stack and the shared MLP against
    ``jax.grad`` of JAX's ``moe_ffn`` (the aux loss's gradient through
    ``me`` only)."""
    E, k, d, F = 4, 2, 16, 24
    jcfg = jmoe.MoEConfig(n_experts=E, top_k=k, d_ff_expert=F, n_shared=1,
                          capacity_factor=1.0, dispatch=dispatch)
    cfg = moe.MoEConfig(n_experts=E, top_k=k, d_ff_expert=F, n_shared=1,
                        capacity_factor=1.0, dispatch=dispatch)
    jp, _ = jmoe.init_moe(jax.random.PRNGKey(4), d, jcfg)
    p = moe.MoE(d, cfg, device="cpu")
    leaves = {"router": jp["router"]["w"], "wi": jp["wi"], "wg": jp["wg"],
              "wo": jp["wo"], **{f"shared.{n}": jp["shared"][n]["w"]
                                 for n in ("wi", "wg", "wo")}}
    with torch.no_grad():
        for name, v in leaves.items():
            p.get_parameter(name).copy_(_t(v))
    p.requires_grad_(True)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, d)).astype(np.float32)
    r = rng.standard_normal((2, 12, d)).astype(np.float32)

    def jloss(jp, x):
        y, aux = jmoe.moe_ffn(jp, x, jcfg)
        return jnp.sum(y * r) + aux, aux

    (jl, jaux), (jgp, jgx) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    xt = _t(x).requires_grad_()
    keep = moe.route(p, xt, cfg)[2]
    assert not bool(keep.all())             # the capacity drops entries
    y, aux = moe.moe_ffn(p, xt, cfg)
    loss = (y * _t(r)).sum() + aux
    names = list(leaves)
    g = torch.autograd.grad(loss, [xt] + [p.get_parameter(n) for n in names])
    assert abs(float(loss) - float(jl)) < 1e-4
    assert abs(float(aux) - float(jaux)) < 1e-6
    want = [jgx, jgp["router"]["w"], jgp["wi"], jgp["wg"], jgp["wo"],
            *(jgp["shared"][n]["w"] for n in ("wi", "wg", "wo"))]
    for name, a, b in zip(["x"] + names, g, want):
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("arch,path", [("deepseek-v2-236b", "rns9"),
                                       ("whisper-medium", "float")])
def test_remat_full_equals_none_bit_for_bit(arch, path):
    """Two steps with every layer recomputed in the backward (the MoE aux
    loss a second output of the checkpointed layer, the encoder's output
    an input of every decoder layer's) give the bits of two steps
    without: losses, aux losses, params, m and v."""
    out = {}
    for remat in ("none", "full"):
        _, cfg = _pair(arch, path, remat=remat)
        model = M.init_model(cfg, seed=3, device="cpu")
        state = {"model": model.requires_grad_(True),
                 "opt": adamw.init_opt_state(dict(model.named_parameters()))}
        step = ts.make_train_step(cfg, adamw.AdamWConfig(**ADAM))
        ms = [step(state, _batch(cfg, seed=s))[1] for s in (0, 1)]
        out[remat] = ([(float(m["loss"]), float(m["aux"])) for m in ms],
                      ts.state_tree(state))
    assert out["none"][0] == out["full"][0]
    assert (out["none"][0][0][1] > 0) == (arch == "deepseek-v2-236b")
    a, b = out["none"][1], out["full"][1]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
        assert torch.equal(a["opt"]["m"][k], b["opt"]["m"][k]), k
        assert torch.equal(a["opt"]["v"][k], b["opt"]["v"][k]), k


# ---------------------------------------------------- encoder, frontend ----
def test_encoder_train_grids_are_whole_tensor(monkeypatch):
    """The training forward's encoder at B = 2 on rns9: every conversion
    of its stream takes one grid over the whole [B, Te, d] tensor (a
    scalar scale), as JAX's ``_encode`` -- not the serving rule's grid a
    row (C.11: one scale a row) -- and its output is JAX's within
    2e-4 (C.17's 16-bit flips after two layers and the final norm)."""
    from repro_torch.core import rns_matmul

    jcfg, cfg = _pair("whisper-medium", "rns9")
    jp, _ = JM.init_model(jax.random.PRNGKey(2), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    frames = _batch(cfg)["frontend"]
    frames[1] *= 3.0
    want = np.asarray(jax.jit(lambda p, f: JM._encode(p, jcfg, f))(
        jp, jnp.asarray(frames)))
    sizes = {}
    real = rns_matmul.absmax_scale

    def spy(x, bits, *a, **kw):
        s = real(x, bits, *a, **kw)
        sizes.setdefault(mode, []).append((tuple(x.shape), s.numel()))
        return s

    monkeypatch.setattr(rns_matmul, "absmax_scale", spy)
    with torch.no_grad():
        for mode in ("train", "serve"):
            out = M._encode(model, cfg, _t(frames), train=mode == "train")
            if mode == "train":
                got = out
    acts = {m: [n for shape, n in v if shape[0] == 2]
            for m, v in sizes.items()}
    assert len(acts["train"]) == 2 * cfg.n_enc_layers      # wi, wo
    assert set(acts["train"]) == {1}
    assert set(acts["serve"]) == {2}
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=2e-4)


def test_frontend_positions_out_of_the_loss():
    """paligemma's logits span [B, F + T, V]; the CE is over the token
    positions' predictions ``logits[:, F:-1]`` alone, so no gradient
    reaches the frontend positions' logits."""
    _, cfg = _pair("paligemma-3b", "float")
    model = M.init_model(cfg, seed=1, device="cpu")
    batch = {k: _t(v) for k, v in _batch(cfg).items()}
    F = cfg.n_frontend_tokens
    logits, _ = M.forward_train(model, cfg, batch)
    assert logits.shape == (2, F + 16, cfg.vocab)
    logits = logits.detach().requires_grad_()
    lg, tg = logits[:, F:-1], batch["tokens"].long()[:, 1:]
    ce = (torch.logsumexp(lg, -1) - lg.gather(-1, tg[..., None])[..., 0]
          ).mean()
    with torch.no_grad():
        loss, parts = M.loss_fn(model, cfg, batch)
    assert float(parts["ce"]) == pytest.approx(float(ce), rel=1e-6)
    assert float(parts["aux"]) == 0.0 and float(loss) == float(parts["ce"])
    g = torch.autograd.grad(ce, logits)[0]
    assert float(g[:, :F].abs().max()) == 0.0
    assert float(g[:, F:-1].abs().max()) > 0.0


@pytest.mark.parametrize("arch", ["whisper-medium", "paligemma-3b"])
def test_trainer_frontend_stub_equals_jax(arch, tmp_path):
    """The Trainer's batch: SyntheticLM's tokens and the frontend stub
    from ``(seed, step, 99)``, bit-equal to JAX's ``Trainer._batch``."""
    jcfg, cfg = _pair(arch, "float")
    kw = dict(vocab=cfg.vocab, seq_len=16, global_batch=4)
    jt = JTrainer(jcfg, jadamw.AdamWConfig(), JTrainerConfig(
        ckpt_dir=str(tmp_path / "j"), seed=5), JDataConfig(**kw))
    t = Trainer(cfg, adamw.AdamWConfig(), TrainerConfig(
        ckpt_dir=str(tmp_path / "t"), seed=5), DataConfig(**kw),
        device="cpu")
    for step in (0, 3):
        want, got = jt._batch(step), t._batch(step)
        assert set(got) == {"tokens", "frontend"} == set(want)
        assert got["frontend"].shape == (4, cfg.n_frontend_tokens,
                                         cfg.d_model)
        for k in got:
            assert np.array_equal(got[k], np.asarray(want[k])), k
    assert not np.array_equal(t._batch(0)["frontend"],
                              t._batch(1)["frontend"])


# ------------------------------------------------------ counts, eval, opt ----
def _enc_count(jcfg, jp, batch):
    """JAX's traced op count of the encoder alone (0 without one)."""
    if not jcfg.enc_dec:
        return None
    return jdispatch.trace_op_counts(lambda p, f: JM._encode(p, jcfg, f),
                                     jp, jnp.asarray(batch["frontend"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_measure_rns_ops_equals_jax_times_periods(arch):
    """One loss evaluation's RNS calls on rns9 (``rns_targets="mlp"``:
    the shared experts, the recurrent layers' projections, the dense and
    encoder MLPs): JAX traces one scanned period of each stack, the port
    counts every layer (ROADMAP C.3), so the port's count is the
    decoder period's times ``n_layers / period`` plus the encoder layer's
    times ``n_enc_layers``."""
    jcfg, cfg = _pair(arch, "rns9")
    batch = _batch(cfg)
    jp, _ = JM.init_model(jax.random.PRNGKey(0), jcfg)
    want = jts.measure_rns_ops(jcfg, _jbatch(batch))
    enc = _enc_count(jcfg, jp, batch)
    model = M.init_model(cfg, seed=0, device="cpu")
    got = ts.measure_rns_ops(model, cfg, {k: _t(v) for k, v in batch.items()})
    assert got.converts > 0
    for f in got.FIELDS:
        e = 0 if enc is None else getattr(enc, f)
        dec = getattr(want, f) - e
        assert getattr(got, f) == dec * (cfg.n_layers // cfg.period) \
            + e * cfg.n_enc_layers, f


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_step_equals_loss(arch):
    """``make_eval_step``: the loss, CE and aux of ``loss_fn``, bit for
    bit, with no gradient."""
    _, cfg = _pair(arch, "rns9")
    model = M.init_model(cfg, seed=0, device="cpu")
    batch = {k: _t(v) for k, v in _batch(cfg).items()}
    out = ts.make_eval_step(cfg)(model, batch)
    loss, parts = M.loss_fn(model, cfg, batch)
    assert not out["loss"].requires_grad
    for k, v in (("loss", loss), ("ce", parts["ce"]), ("aux", parts["aux"])):
        assert torch.equal(out[k], v.detach()), k


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_from_jax_lands_every_leaf(arch):
    """``opt_state_from_jax`` on every leaf of the family (experts,
    router, MLA, Mamba, RWKV, ``enc_blocks``, ``xattn``): each m / v
    entry under its parameter's name, equal to JAX's, the step kept."""
    jcfg, cfg = _pair(arch, "float")
    jp, _ = JM.init_model(jax.random.PRNGKey(1), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    opt = {"m": jax.tree.map(lambda a: 2 * a + 1, tree),
           "v": jax.tree.map(lambda a: a * a, tree),
           "step": np.int32(7)}
    state = opt_state_from_jax(opt, cfg, device="cpu")
    model = params_from_jax(tree, cfg, device="cpu")
    names = {n for n, _ in model.named_parameters()}
    assert set(state["m"]) == set(state["v"]) == names
    for n, p in model.named_parameters():
        assert torch.equal(state["m"][n], 2 * p + 1), n
        assert torch.equal(state["v"][n], p * p), n
    assert int(state["step"]) == 7


# --------------------------------------------------------- trainer, CLI ----
def _mk_trainer(tmpdir, total_steps):
    cfg = get_config("deepseek-v2-236b", smoke=True)
    return Trainer(
        cfg, adamw.AdamWConfig(lr=8e-3, warmup_steps=2, total_steps=50),
        TrainerConfig(total_steps=total_steps, ckpt_every=3,
                      ckpt_dir=str(tmpdir), log_every=100, async_ckpt=False),
        DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4),
        device="cpu")


def test_moe_restart_is_bitwise_resumable(tmp_path):
    """The deepseek twin (MLA + MoE): 6 straight steps == 3 steps + a new
    trainer resuming from the step-3 checkpoint + 3 steps, bit for bit
    (losses, params, m, v, step)."""
    state_a, hist_a = _mk_trainer(tmp_path / "a", 6).run()
    _mk_trainer(tmp_path / "b", 3).run()
    state_b, hist_b = _mk_trainer(tmp_path / "b", 6).run()
    assert hist_b == hist_a[3:]
    ta, tb = ts.state_tree(state_a), ts.state_tree(state_b)
    assert any(".moe.wi" in k for k in ta["params"])
    for k in ta["params"]:
        assert torch.equal(ta["params"][k], tb["params"][k]), k
        assert torch.equal(ta["opt"]["m"][k], tb["opt"]["m"][k]), k
        assert torch.equal(ta["opt"]["v"][k], tb["opt"]["v"][k]), k
    assert int(ta["opt"]["step"]) == int(tb["opt"]["step"]) == 6


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_each_family(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch <arch> --smoke --rns
    --device cpu``: finite losses, a checkpoint at the last step."""
    hist = train_cli.main(["--arch", arch, "--smoke", "--steps", "2",
                           "--batch", "2", "--seq", "16", "--rns",
                           "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 2 and all(np.isfinite(hist))
    assert "final loss" in capsys.readouterr().out
    assert ckpt.latest_valid(str(tmp_path)).endswith("step_000000002")


# ------------------------------------------------------------- C.18 --------
@pytest.mark.parametrize("impl", ["scan", "chunked"])
def test_rwkv_rns9_flips_held_layer_by_layer(impl, monkeypatch):
    """ROADMAP C.18: the RWKV-6 twin on rns9 (every time-mix and
    channel-mix projection an RNS product, ten a layer).  Every RNS
    projection of the loss's forward equals JAX's ``linear`` on the
    port's inputs bit for bit (checked on the stepwise form; the chunked
    one runs the same projections), and the loss is within LOSS_TOL;
    through 4 layers the 16-bit flips of activations and cotangents
    compound past the gradient bar (up to 3.7x at ``embed``), so each
    layer's gradients (its parameters' and its input's) are held on the
    port's own inputs and cotangents, within the bar."""
    arch = "rwkv6-7b" + ("-chunked" if impl == "chunked" else "")
    jcfg, cfg = _pair(arch, "rns9")
    jp, _ = JM.init_model(jax.random.PRNGKey(0), jcfg)
    model = _port_model(jax.tree.map(np.asarray, jp), cfg)
    batch = _batch(cfg)
    seen = []
    real = ssm.linear

    def spy(w, x, rns=None, **kw):
        y = real(w, x, rns, **kw)
        seen.append((_np(x), _np(w), _np(y)))
        return y

    monkeypatch.setattr(ssm, "linear", spy)
    with torch.no_grad():
        loss, _ = M.loss_fn(model, cfg, {"tokens": _t(batch["tokens"])})
    monkeypatch.setattr(ssm, "linear", real)
    assert len(seen) == 10 * cfg.n_layers
    for x, w, y in seen if impl == "scan" else ():
        assert np.array_equal(y, np.asarray(jlayers.linear(
            {"w": jnp.asarray(w)}, jnp.asarray(x), jcfg.rns)))
    jl = JM.loss_fn(jp, jcfg, _jbatch(batch))[0]
    assert abs(float(loss) - float(jl)) < LOSS_TOL["rns9"]
    # each layer on the port's inputs and cotangents
    h = M._embed_tokens(model, cfg, _t(batch["tokens"]).long())
    hs = [h.detach().requires_grad_()]
    for blk in model.blocks:
        hs.append(T._train_layer(blk, hs[-1], cfg, None)[0])
    logits = M._logits(model, hs[-1])
    lg, tg = logits[:, :-1], _t(batch["tokens"]).long()[:, 1:]
    ce = (torch.logsumexp(lg, -1) - lg.gather(-1, tg[..., None])[..., 0]
          ).mean()
    cts = torch.autograd.grad(ce, hs[1:])

    @jax.jit
    def jlayer(lp, x, ct):
        def f(lp, x):
            return JT._apply_layer(lp, x, jcfg, "rwkv", "channelmix",
                                   mode="train", positions=None,
                                   kv_mask=None, enc_out=None, cache=None)[0]
        return jax.vjp(f, lp, x)[1](ct)

    rtol, floor = rtol_floor["rns9"]
    for i, blk in enumerate(model.blocks):
        x = hs[i].detach().requires_grad_()
        y = T._train_layer(blk, x, cfg, None)[0]
        names = [n for n, _ in blk.named_parameters()]
        g = torch.autograd.grad(y, [x] + list(blk.parameters()), cts[i])
        lp = jax.tree.map(lambda a: a[i], jp["blocks"]["l0"])
        jglp, jgx = jlayer(lp, jnp.asarray(_np(x)), jnp.asarray(_np(cts[i])))
        one = jax.tree.map(lambda a: np.zeros_like(np.asarray(a)), jp)
        one["blocks"]["l0"] = jax.tree.map(
            lambda z, v: np.stack([np.asarray(v)] * cfg.n_layers),
            one["blocks"]["l0"], jglp)
        want = params_from_jax(one, cfg, device="cpu").blocks[i]
        pairs = [("x", g[0], torch.as_tensor(np.asarray(jgx)))] + [
            (n, a, want.get_parameter(n)) for n, a in zip(names, g[1:])]
        gmax = max(float(w.abs().max()) for _, _, w in pairs)
        for n, a, w in pairs:
            lim = rtol * float(w.abs().max()) + floor * gmax
            assert float((a - w).abs().max()) <= lim, (i, n)


# -------------------------------------------------------------- card ------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels run "
                    "only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_gpu_captured_step_equals_eager(cuda, arch):
    """On the card, rns9 on the kernels with the twin's config and
    ``remat="full"``: three captured steps equal three eager steps bit
    for bit (losses, aux losses, every param, m, v), one capture."""
    _, cfg = _pair(arch, "rns9", remat="full")
    cfg = dataclasses.replace(cfg, rns=dataclasses.replace(cfg.rns,
                                                           backend="cuda"))
    base = M.init_model(cfg, seed=0, device="cpu")
    batches = [_batch(cfg, (4, 32), seed=s) for s in range(3)]

    def run(graphs):
        model = M.init_model(cfg, seed=0, device="cpu").to(cuda)
        model.load_state_dict(base.state_dict())
        state = {"model": model.requires_grad_(True),
                 "opt": adamw.init_opt_state(dict(model.named_parameters()))}
        step = ts.make_train_step(cfg, adamw.AdamWConfig(**ADAM),
                                  graphs=graphs)
        ms = [step(state, b)[1] for b in batches]
        return ([(float(m["loss"]), float(m["aux"])) for m in ms],
                ts.state_tree(state), step)

    l_eager, s_eager, _ = run(False)
    l_graph, s_graph, step = run(True)
    assert step.captures == 1
    assert l_eager == l_graph
    for k in s_eager["params"]:
        assert torch.equal(s_eager["params"][k], s_graph["params"][k]), k
        assert torch.equal(s_eager["opt"]["m"][k], s_graph["opt"]["m"][k])
        assert torch.equal(s_eager["opt"]["v"][k], s_graph["opt"]["v"][k])
