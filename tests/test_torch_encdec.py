"""The encoder-decoder and prefix-frontend families: the port against the
JAX package.

``whisper-medium`` (an encoder over precomputed audio frames,
sinusoidal positions, cross-attention, layernorm, a plain gelu MLP, a
bias on q/k/v) and ``paligemma-3b`` (256 patch embeddings ahead of the
prompt, scaled embeddings, one KV head, a tied head), on the smoke twins
with weights from ``repro.models.model.init_model`` and frames N(0, 1)
from a numpy seed: ``sinusoidal_positions`` bit for bit; the encoder
within ``ENC_ATOL`` and causal as JAX's is (ROADMAP C.15); ``prefill``
logits and every cache plane (self k/v, cross k/v) and several
``decode_step``s within the stated tolerances -- on the RNS path each
row at B = 1 against JAX and a batch's rows against JAX's solo runs,
which a per-row grid makes equal (ROADMAP C.11); the bucketed
``Engine``'s greedy tokens equal to JAX's on float, per-op rns9 and the
fused resident path (JAX's ``pallas_fused_interpret``); ``rns_op_counts``
JAX's traced tally with C.3's rule applied to each of the two scans; the
per-layer profiles of the encoder as a stack of its own; a non-causal
self-attention model; ``params_from_jax``, ``count_params`` and the CLI;
the continuous engine refusing both archs with JAX's message.  Then
``moe_ffn(dispatch="scatter")`` against JAX's scatter path on the MoE
twins' weights.  The ``gpu`` case holds the card's tokens to the CPU's.
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
from repro.core import dispatch as jdispatch
from repro.core.rns_matmul import RnsDotConfig as JRnsDotConfig
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models.layers import sinusoidal_positions as j_sinusoidal
from repro.models.resident import resident_profiles as j_resident_profiles
from repro.serve.engine import ContinuousEngine as JContinuous
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.base import get_config
from repro_torch.core.rns_matmul import RnsDotConfig
from repro_torch.launch import serve as cli
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.layers import sinusoidal_positions
from repro_torch.models.params import params_from_jax
from repro_torch.models.resident import resident_profiles
from repro_torch.serve.engine import ContinuousEngine, Engine, ServeConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ("whisper-medium", "paligemma-3b")
FIELDS = ("converts", "matmuls", "normalizes", "fused", "fallbacks",
          "weight_converts")
# the encoder's float32 sums in another order (XLA's dots and softmax vs
# the port's fixed trees): a few ulps of O(1) values
ENC_ATOL = 1e-5
# |logit| is O(3): float32 rounding through the layers; the RNS paths
# quantize on the same grids as JAX, so only float order differs
LOGIT_ATOL = 5e-5
PLANE_ATOL = 1e-4
FUSED = dict(resident_weights=True, rns_defer=True)
# each path: (RNS targets, the JAX engine's overrides, the port's)
PATHS = {"float": (None, {}, {}),
         "rns9": ("mlp", {}, {}),
         "all": ("all", {}, {}),
         "fused": ("mlp", dict(FUSED, rns_backend="pallas_fused_interpret"),
                   dict(FUSED, rns_backend="cuda_fused"))}
T = 5                                   # prompt tokens


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


@pytest.fixture(scope="module")
def twins():
    """{arch: (JAX config, JAX params, port config, port model)}."""
    out = {}
    for arch in ARCHS:
        jcfg = j_get_config(arch, smoke=True)
        jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)[0]
        cfg = get_config(arch, smoke=True)
        out[arch] = (jcfg, jparams, cfg, params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    return out


def _inputs(cfg, B, seed):
    """Prompts [B, T] and frames [B, F, d], N(0, 1) float32."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab, (B, T)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model))
    return toks, frames.astype(np.float32)


def _cache_len(cfg):
    """The dense caches' capacity: prompt, prefix and 8 more."""
    return T + (0 if cfg.enc_dec else cfg.n_frontend_tokens) + 8


_JPREFILL = jax.jit(functools.partial(JM.prefill, cache_dtype=jnp.float32),
                    static_argnums=(1, 3))
_JDECODE = jax.jit(JM.decode_step, static_argnums=(1,))


def _jax_prefill(jparams, jcfg, toks, frames, S):
    return _JPREFILL(jparams, jcfg, {"tokens": jnp.asarray(toks),
                                     "frontend": jnp.asarray(frames)}, S)


def _jax_plane(jcache, name):
    """JAX's cache plane ``name`` [n_attn, B, ...] (period 1)."""
    c = jcache["l0"]
    return np.asarray(c["cross"][name[1]] if name in M.CROSS_PLANES
                      else c[name])


# ----------------------------------------------------------- positions ---
@pytest.mark.parametrize("length,d", [(8, 64), (13, 64), (1500, 1024),
                                      (57, 1024), (300, 2048)])
def test_sinusoidal_positions_bit_equal_jax(length, d):
    got = sinusoidal_positions(length, d)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_sinusoidal(length, d)))


# ------------------------------------------------------------- encoder ---
def test_encoder_matches_jax_and_is_causal(twins):
    """``_encode`` on two rows of frames within ENC_ATOL of JAX's; with
    the last frame changed, frames 0 .. Te-2 of the output stay bit-equal
    and the last moves, in JAX and in the port (JAX's encoder attends
    causally: ``enc_causal`` is never read, ROADMAP C.15)."""
    jcfg, jparams, cfg, model = twins["whisper-medium"]
    _, frames = _inputs(cfg, 2, seed=3)
    other = frames.copy()
    other[:, -1] = np.random.default_rng(4).standard_normal(cfg.d_model)
    jenc = jax.jit(JM._encode, static_argnums=(1,))
    outs = {}
    for name, fr in (("a", frames), ("b", other)):
        want = np.asarray(jenc(jparams, jcfg, jnp.asarray(fr)))
        with torch.inference_mode():
            got = M._encode(model, cfg, torch.from_numpy(fr)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ENC_ATOL)
        outs[name] = (got, want)
    for got_b, got_a in zip(outs["b"], outs["a"]):
        np.testing.assert_array_equal(got_b[:, :-1], got_a[:, :-1])
        assert np.abs(got_b[:, -1] - got_a[:, -1]).max() > 1e-3


@pytest.mark.parametrize("window", [None, 100])
def test_causal_lane_runs_equal_one_call(window):
    """A causal prefill of 600 lanes goes to ``lane_attention`` in runs
    of ``CAUSAL_LANES``, each over the keys its last lane sees: bit-equal
    to one call of every lane over all 600 keys (trailing masked keys add
    exact zeros), with and without a window."""
    from repro_torch.models import attention as attn

    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              attn_window=window)
    p = attn.Attention(cfg, device="cpu")
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for w in (p.wq, p.wk, p.wv, p.wo):
            w.normal_(0.0, 0.125, generator=g)
    x = torch.randn((2, 600, cfg.d_model), generator=g)
    assert 600 > 2 * attn.CAUSAL_LANES
    y, (k, v) = attn.gqa_attend(p, x, cfg)
    pos = torch.arange(600)[None].expand(2, 600)
    q, _, _ = attn.gqa_qkv(p, x, cfg, pos)
    lengths = torch.arange(1, 601)
    one = torch.stack([attn.lane_attention(q[b], k[b:b + 1], v[b:b + 1],
                                           lengths, window)
                       for b in range(2)])
    assert torch.equal(y, attn.linear(p.wo, one.reshape(2, 600, -1)))


# ------------------------------------------------------------- prefill ---
@pytest.mark.parametrize("arch,path", [
    ("whisper-medium", "float"), ("whisper-medium", "rns9"),
    ("paligemma-3b", "float"), ("paligemma-3b", "rns9"),
    ("paligemma-3b", "all")])
def test_prefill_and_decode_match_jax(twins, arch, path):
    """``prefill`` then three ``decode_step``s: logits within LOGIT_ATOL
    of JAX's (the same argmax) and every cache plane -- self k/v over
    the F + T or T prompt positions, the cross k/v over the frames --
    within PLANE_ATOL.  Float: a batch of two against JAX's batch.  RNS:
    each row alone against JAX, and the batch's rows bit-equal to the
    rows alone (one grid a row, ROADMAP C.11)."""
    jcfg, jparams, cfg, model = twins[arch]
    jcfg, cfg = _rns(jcfg, cfg, PATHS[path][0])
    m = _retarget(model, cfg)
    toks, frames = _inputs(cfg, 2, seed=5)
    S = _cache_len(cfg)
    rows = [slice(0, 2)] if path == "float" else [slice(0, 1), slice(1, 2)]
    solo = []
    for r in rows:
        jl, jc = _jax_prefill(jparams, jcfg, toks[r], frames[r], S)
        lg, c = M.prefill(m, cfg, torch.from_numpy(toks[r]), S,
                          frontend=torch.from_numpy(frames[r]))
        assert int(c.lengths[0]) == S - 8
        for name in M.plane_shapes(cfg):
            np.testing.assert_allclose(getattr(c, name).numpy(),
                                       _jax_plane(jc, name), rtol=0,
                                       atol=PLANE_ATOL)
        steps = [lg]
        for _ in range(3):
            np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                       atol=LOGIT_ATOL)
            nxt = np.asarray(jl).argmax(-1)[:, None]
            np.testing.assert_array_equal(lg.argmax(-1).numpy(), nxt[:, 0])
            jl, jc = _JDECODE(jparams, jcfg, jnp.asarray(nxt), jc)
            lg = M.decode_step(m, cfg, torch.from_numpy(nxt), c)
            steps.append(lg)
        solo.append(torch.stack(steps))
    if path != "float":
        lg, c = M.prefill(m, cfg, torch.from_numpy(toks), S,
                          frontend=torch.from_numpy(frames))
        every = torch.ones((2,), dtype=torch.bool)
        steps = [lg]
        for i in range(3):
            nxt = torch.cat([s[i].argmax(-1) for s in solo])[:, None]
            steps.append(M.decode_step(m, cfg, nxt, c, every))
        assert torch.equal(torch.stack(steps), torch.cat(solo, dim=1))


def test_prefill_needs_frames_and_room(twins):
    _, _, cfg, model = twins["whisper-medium"]
    toks, frames = _inputs(cfg, 1, seed=6)
    with pytest.raises(ValueError, match="frontend frames"):
        M.prefill(model, cfg, torch.from_numpy(toks), 16)
    _, _, cfg, model = twins["paligemma-3b"]
    with pytest.raises(ValueError, match="capacity"):
        M.prefill(model, cfg, torch.from_numpy(toks), T + 7,
                  frontend=torch.from_numpy(frames))


# --------------------------------------------------------------- engine --
def _jax_solo(twins, arch, path, toks, frames, new=6):
    """JAX's ``Engine.generate`` of each row alone: its prefill (float32
    cache of ``_cache_len`` positions) and decode steps, greedy, through
    the module's jits (shared with the prefill test's compilations) on
    the JAX engine's params and config (resident weights encoded)."""
    jcfg, jparams, cfg, _ = twins[arch]
    jcfg, _ = _rns(jcfg, cfg, PATHS[path][0])
    jeng = JEngine(jparams, jcfg, JServeConfig(
        max_cache=_cache_len(cfg), cache_dtype="float32", **PATHS[path][1]))
    rows = []
    for b in range(len(toks)):
        jl, jc = _jax_prefill(jeng.params, jeng.cfg, toks[b:b + 1],
                              frames[b:b + 1], _cache_len(cfg))
        seq = [np.asarray(jl).argmax(-1)]
        for _ in range(new - 1):
            jl, jc = _JDECODE(jeng.params, jeng.cfg,
                              jnp.asarray(seq[-1][:, None]), jc)
            seq.append(np.asarray(jl).argmax(-1))
        rows.append(np.stack(seq, axis=1))
    return np.concatenate(rows)


def _engine(twins, arch, path, **kw):
    jcfg, _, cfg, model = twins[arch]
    _, cfg = _rns(jcfg, cfg, PATHS[path][0])
    return Engine(_retarget(model, cfg), ServeConfig(
        max_cache=_cache_len(cfg), max_new_tokens=6, **PATHS[path][2],
        **kw), device="cpu")


@pytest.mark.parametrize("path", ["float", "rns9", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_jax(twins, arch, path):
    """A batch of two prompts with their frames through the bucketed
    ``Engine``: each row's greedy tokens JAX's ``Engine.generate`` of it
    alone (JAX's batch rows equal its solo ones on these twins, and the
    port's rows do not depend on their batch: ROADMAP C.10, C.11)."""
    cfg = twins[arch][2]
    toks, frames = _inputs(cfg, 2, seed=7)
    want = _jax_solo(twins, arch, path, toks, frames)
    eng = _engine(twins, arch, path)
    got = eng.generate(toks, frontend=frames)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)
    assert eng.captures() == {"prefill(2,5)": 0, "decode(2)": 0}


def test_generate_checks_frames_and_counts_the_prefix(twins):
    """The capacity check counts paligemma's F prefix positions; frames
    of another shape, or none, are refused."""
    cfg = twins["paligemma-3b"][2]
    toks, frames = _inputs(cfg, 1, seed=8)
    eng = _engine(twins, "paligemma-3b", "float")
    with pytest.raises(ValueError, match="max_cache"):
        eng.generate(toks, frontend=frames, max_new=10)
    assert eng.generate(toks, frontend=frames, max_new=9).shape == (1, 9)
    for bad in (None, frames[:, :3]):
        with pytest.raises(ValueError, match="frontend of shape"):
            eng.generate(toks, frontend=bad)


@pytest.mark.parametrize("path", ["rns9", "all", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rns_op_counts_equal_jax_per_scan(twins, arch, path):
    """JAX's traced prefill tally sees each layer scan's body once: the
    decoder's one period and, for whisper, the encoder's one layer.  The
    port tallies every layer, so its count is the encoder layer's times
    ``n_enc_layers`` plus the decoder layer's times ``n_layers`` (C.3
    for each scan); JAX's own ``rns_op_counts`` of whisper traces no
    frames and raises, the port takes the config's (C.16)."""
    jcfg, jparams, cfg, _ = twins[arch]
    jcfg, _ = _rns(jcfg, cfg, PATHS[path][0])
    jeng = JEngine(jparams, jcfg, JServeConfig(max_cache=_cache_len(cfg),
                                               **PATHS[path][1]))
    B = 2
    frames = jnp.zeros((B, cfg.n_frontend_tokens, cfg.d_model))
    batch = {"tokens": jnp.zeros((B, T), jnp.int32), "frontend": frames}
    whole = jdispatch.trace_op_counts(
        lambda p, b: JM.prefill(p, jeng.cfg, b, S_max=_cache_len(cfg)),
        jeng.params, batch)
    enc = jdispatch.OpCounts()
    if cfg.enc_dec:
        enc = jdispatch.trace_op_counts(
            lambda p, f: JM._encode(p, jeng.cfg, f), jeng.params, frames)
        with pytest.raises(KeyError, match="frontend"):
            jeng.rns_op_counts(B, T)
    want = {f: getattr(enc, f) * cfg.n_enc_layers
            + (getattr(whole, f) - getattr(enc, f)) * cfg.n_layers
            for f in FIELDS}
    if path == "rns9":
        layer = {"whisper-medium": (8, 4, 4), "paligemma-3b": (5, 3, 3)}
        assert (whole.converts, whole.matmuls, whole.normalizes) == \
            layer[arch]
    eng = _engine(twins, arch, path)
    assert eng.rns_op_counts(B, T).as_dict() == want


def test_per_layer_profiles_encoder_is_its_own_stack(twins):
    """With ``per_layer_profiles`` the whisper twin's resident MLPs take
    JAX's profile and ``mag_bits`` of their stack's slot: the decoder's
    (``blocks/l0``) and the encoder's (``enc_blocks/l0``), each the worst
    case over its own layers only."""
    eng = _engine(twins, "whisper-medium", "fused", per_layer_profiles=True)
    jcfg, jparams, cfg, _ = twins["whisper-medium"]
    jcfg, _ = _rns(jcfg, cfg, "mlp")
    jeng = JEngine(jparams, jcfg, JServeConfig(
        max_cache=_cache_len(cfg), per_layer_profiles=True,
        **PATHS["fused"][1]))
    jprof = j_resident_profiles(jeng.params)
    assert sorted(jprof) == ["blocks/l0/mlp", "enc_blocks/l0/mlp"]
    got = resident_profiles(eng.model)
    assert sorted(got) == sorted(
        [f"blocks.{i}.mlp" for i in range(cfg.n_layers)]
        + [f"enc_blocks.{i}.mlp" for i in range(cfg.n_enc_layers)])
    mags = {}
    for stack in ("blocks", "enc_blocks"):
        want = jeng.params[stack]["l0"]["mlp"]
        for name in ("wi", "wo"):
            w = want[name]["w_res"]
            mags[stack, name] = w.mag_bits
            for blk in getattr(eng.model, stack):
                res = blk.mlp.resident(name)
                assert (res.profile, res.mag_bits) == (w.profile,
                                                       w.mag_bits)
    # the two stacks' bounds differ, so one group over both would not
    # have given either
    assert mags["blocks", "wi"] != mags["enc_blocks", "wi"]


def test_non_causal_self_attention_equals_jax():
    """``causal=False`` on the smollm twin through the bucketed Engine:
    every prompt lane attends all the prompt's keys; JAX's tokens."""
    jcfg = dataclasses.replace(j_get_config("smollm-135m", smoke=True),
                               causal=False)
    jparams = JM.init_model(jax.random.PRNGKey(1), jcfg)[0]
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              causal=False)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    toks = np.random.default_rng(9).integers(1, cfg.vocab, (1, 7))
    scfg = dict(max_cache=16, max_new_tokens=5)
    want = JEngine(jparams, jcfg, JServeConfig(**scfg)).generate(toks)
    got = Engine(model, ServeConfig(**scfg), device="cpu").generate(toks)
    np.testing.assert_array_equal(got, want)
    causal = Engine(_retarget(model, dataclasses.replace(cfg, causal=True)),
                    ServeConfig(**scfg), device="cpu").generate(toks)
    assert causal.tolist() != got.tolist()


def test_sinusoidal_decoder_only_serves_on_every_path():
    """A decoder-only model with sinusoidal positions (the smollm twin
    with ``pos_emb="sinusoidal"``): the bucketed Engine's tokens equal
    JAX's, and ``ContinuousEngine`` -- phase-barrier, chunked (the
    packed step adds each lane's position) and speculative (the verify
    window adds positions ``lengths .. lengths + W - 1``) -- gives each
    prompt the tokens of its bucketed solo run."""
    jcfg = dataclasses.replace(j_get_config("smollm-135m", smoke=True),
                               pos_emb="sinusoidal")
    jparams = JM.init_model(jax.random.PRNGKey(3), jcfg)[0]
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              pos_emb="sinusoidal")
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in (6, 11)]
    scfg = dict(max_cache=24, max_new_tokens=5)
    want = JEngine(jparams, jcfg, JServeConfig(**scfg)).generate(
        prompts[0][None])
    eng = Engine(_retarget(model, cfg), ServeConfig(**scfg), device="cpu")
    solo = [eng.generate(p[None])[0].tolist() for p in prompts]
    assert solo[0] == want[0].tolist()
    for kw in ({}, dict(chunked_prefill=True, token_budget=16,
                        chunk_size=8),
               dict(spec_decode=True, spec_k=2)):
        res, _ = ContinuousEngine(_retarget(model, cfg), ServeConfig(
            **scfg, page_size=8, max_seqs=2, **kw), device="cpu").run(
            prompts)
        assert [res[i].tolist() for i in range(2)] == solo, kw


# ------------------------------------------------ params, counts, CLI ----
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_takes_every_leaf(twins, arch):
    """Every JAX leaf lands (``params_from_jax`` checks each entry), the
    counts agree, and the encoder, its norm, ``lnx`` and ``xattn`` (with
    its biases) hold JAX's values."""
    jcfg, jparams, cfg, model = twins[arch]
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert sum(int(np.prod(v.shape)) for _, v in leaves) == sum(
        p.numel() for p in model.parameters())
    if not cfg.enc_dec:
        assert model.enc_blocks is None and not hasattr(model.blocks[0],
                                                        "xattn")
        return
    enc = jparams["enc_blocks"]["l0"]
    for i, blk in enumerate(model.enc_blocks):
        np.testing.assert_array_equal(blk.mlp.wo.numpy(),
                                      np.asarray(enc["mlp"]["wo"]["w"][i]))
        np.testing.assert_array_equal(blk.attn.bq.numpy(),
                                      np.asarray(enc["attn"]["wq"]["b"][i]))
        assert not hasattr(blk, "xattn")
    dec = jparams["blocks"]["l0"]
    for i, blk in enumerate(model.blocks):
        np.testing.assert_array_equal(blk.xattn.bv.numpy(),
                                      np.asarray(dec["xattn"]["wv"]["b"][i]))
        np.testing.assert_array_equal(blk.lnx.bias.numpy(),
                                      np.asarray(dec["lnx"]["bias"][i]))
    np.testing.assert_array_equal(model.enc_norm.scale.numpy(),
                                  np.asarray(jparams["enc_norm"]["scale"]))
    tree = jax.tree.map(np.asarray, jparams)
    tree["enc_blocks"]["l0"]["extra"] = np.zeros((cfg.n_enc_layers, 2))
    with pytest.raises(ValueError, match="landed nowhere"):
        params_from_jax(tree, cfg, device="cpu")


def test_count_params_equals_jax_on_full_configs():
    """0.811 B and 2.509 B parameters, built on the ``meta`` device."""
    for arch, total in (("whisper-medium", 811333632),
                        ("paligemma-3b", 2508662784)):
        assert M.count_params(get_config(arch)) == (total, total)
        assert JM.count_params(j_get_config(arch)) == (total, total)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_bucketed_and_continuous_refuses(twins, arch, capsys):
    """The CLI's bucketed serve of the twin on the CPU, frames drawn
    after the prompts; ``--continuous`` and ``ContinuousEngine`` exit
    with the JAX engine's message."""
    cli.main(["--arch", arch, "--device", "cpu", "--batch", "2",
              "--prompt-len", "5", "--new", "3"])
    out = capsys.readouterr().out
    assert arch in out and "captures decode(2)=0 prefill(2,5)=0" in out
    jcfg, jparams, cfg, model = twins[arch]
    scfg = dict(max_cache=32, page_size=8, max_seqs=2)
    with pytest.raises(NotImplementedError) as theirs:
        JContinuous(jparams, jcfg, JServeConfig(**scfg))
    with pytest.raises(NotImplementedError) as ours:
        ContinuousEngine(model, ServeConfig(**scfg), device="cpu")
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(SystemExit) as cut:
        cli.main(["--arch", arch, "--continuous", "--device", "cpu"])
    assert str(theirs.value) in str(cut.value.code)


# ------------------------------------------------------- MoE scatter -----
@pytest.mark.parametrize("arch", ["deepseek-v2-236b",
                                  "llama4-scout-17b-a16e"])
def test_moe_scatter_equals_jax(arch):
    """``dispatch="scatter"`` on the MoE twin's MoE block: the routing
    (ids, capacity keep) equal to JAX's gather routing, which the
    dispatch does not change, and y within 2e-5 of JAX's scatter path,
    dropless and with drops; it equals the gather dispatch within float
    order (its combine adds the k picks in rank order, not in expert
    order)."""
    jcfg = j_get_config(arch, smoke=True)
    jp = jax.tree.map(np.array, jmoe.init_moe(
        jax.random.PRNGKey(2), jcfg.d_model, jcfg.moe)[0])
    cfg = get_config(arch, smoke=True)
    p = moe.MoE(cfg.d_model, cfg.moe, device="cpu")
    with torch.no_grad():
        p.router.copy_(torch.from_numpy(jp["router"]["w"]))
        for name in ("wi", "wg", "wo"):
            getattr(p, name).copy_(torch.from_numpy(jp[name]))
            getattr(p.shared, name).copy_(torch.from_numpy(
                jp["shared"][name]["w"]))
    x = np.random.default_rng(10).standard_normal((2, 12, cfg.d_model))
    x = x.astype(np.float32)
    for factor in (cfg.moe.capacity_factor, 0.5):
        mcfg = dataclasses.replace(cfg.moe, dispatch="scatter",
                                   capacity_factor=factor)
        jmcfg = dataclasses.replace(jcfg.moe, dispatch="scatter",
                                    capacity_factor=factor)
        _, _, keep, _ = moe.route(p, torch.from_numpy(x), mcfg)
        assert bool(keep.all()) == (factor > 1)
        y, aux = moe.moe_ffn(p, torch.from_numpy(x), mcfg)
        jy, jaux = jax.jit(jmoe.moe_ffn, static_argnums=(2,))(
            jp, jnp.asarray(x), jmcfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=0,
                                   atol=1e-6)
        yg, _ = moe.moe_ffn(p, torch.from_numpy(x), dataclasses.replace(
            mcfg, dispatch="gather"))
        np.testing.assert_allclose(y.numpy(), yg.numpy(), rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="gather|scatter"):
        moe.moe_ffn(p, torch.from_numpy(x), dataclasses.replace(
            cfg.moe, dispatch="alltoall"))


# ------------------------------------------------------------ on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels run "
                    "only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["rns9", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gpu_tokens_equal_cpu(cuda, twins, arch, path):
    """On the card (kernels, captured and eager) the bucketed Engine's
    greedy tokens equal the CPU's (plain versions), one capture a
    program."""
    cfg = twins[arch][2]
    toks, frames = _inputs(cfg, 3, seed=11)
    want = _engine(twins, arch, path).generate(toks, frontend=frames)
    jcfg, _, cfg, model = twins[arch]
    _, cfg = _rns(jcfg, cfg, PATHS[path][0])
    for graphs in (False, True):
        eng = Engine(_retarget(model, cfg), ServeConfig(
            max_cache=_cache_len(cfg), max_new_tokens=6, **PATHS[path][2]),
            device="cuda", graphs=graphs)
        np.testing.assert_array_equal(
            eng.generate(toks, frontend=frames), want)
        assert set(eng.captures().values()) == {int(graphs)}
