"""The bucketed ``Engine``: the port against the JAX package on the smoke
config.

``Engine.generate(prompts [B, T])`` prefills equal-length prompts into a
dense cache and decodes the batch to completion (rows frozen at eos),
through a prefill program per (B, T) bucket and a decode program per B,
built at first use.  Its tokens must be the JAX engine's on the float
path, on per-op rns9 and on the fused resident path; its
``rns_op_counts`` JAX's times the layers (ROADMAP C.3).  Each decode row
quantizes on its own grid in the port (ROADMAP C.11), so on the RNS
path a batch is held to JAX's solo runs of its rows and to the port's
``ContinuousEngine``.  ``prefill`` and ``make_cache`` are held to JAX's.
Tolerances: tokens and counts exact; logits within ``LOGIT_ATOL``, the
cache's K/V within ``KV_ATOL``.
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
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.base import get_config
from repro_torch.core.rns_matmul import RnsDotConfig
from repro_torch.models import model as M
from repro_torch.models.params import params_from_jax
from repro_torch.serve.engine import ContinuousEngine, Engine, ServeConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIELDS = ("converts", "matmuls", "normalizes", "fused", "fallbacks",
          "weight_converts")
# as in tests/test_torch_chunked.py: XLA and PyTorch float32 ops differ
# by a few ulps, which a rare 8-bit requantization flip amplifies
LOGIT_ATOL = 5e-3
KV_ATOL = 1e-4
FUSED = dict(resident_weights=True, rns_defer=True)
# each path: (RNS on, the JAX engine's overrides, the port's)
PATHS = {
    "float": (False, {}, {}),
    "rns9": (True, {}, {}),
    "fused": (True, dict(FUSED, rns_backend="pallas_fused_interpret"),
              dict(FUSED, rns_backend="cuda_fused")),
}


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


def _engines(smoke, path, **kw):
    """(port Engine, JAX Engine) on one path, the same weights."""
    jcfg, jparams, cfg, model = smoke
    rns, jkw, pkw = PATHS[path]
    jcfg, cfg = _with_rns(jcfg, cfg, rns)
    m = copy.deepcopy(model)
    m.cfg = cfg
    return (Engine(m, ServeConfig(**kw, **pkw), device="cpu"),
            JEngine(jparams, jcfg, JServeConfig(**kw, **jkw)))


def _batch(vocab, B, T, seed):
    return np.random.default_rng(seed).integers(1, vocab, (B, T)).astype(
        np.int32)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_generate_equals_jax(smoke, path):
    """A batch of three: on the float path JAX's batch tokens; on the
    RNS paths JAX's solo run of each row (a row's grid is its own).  A
    second bucket re-uses the decode program; every program is built
    once."""
    eng, jeng = _engines(smoke, path, max_cache=32, max_new_tokens=6)
    prompts = _batch(smoke[2].vocab, 3, 9, seed=1)
    got = eng.generate(prompts)
    assert got.shape == (3, 6) and got.dtype == np.int32
    if path == "float":
        np.testing.assert_array_equal(got, jeng.generate(prompts))
    for b in range(3):
        np.testing.assert_array_equal(got[b],
                                      jeng.generate(prompts[b:b + 1])[0])
    again = eng.generate(prompts[:, :5])
    np.testing.assert_array_equal(again[0],
                                  jeng.generate(prompts[:1, :5])[0])
    assert eng.captures() == {"prefill(3,9)": 0, "decode(3)": 0,
                              "prefill(3,5)": 0}
    np.testing.assert_array_equal(eng.generate(prompts), got)
    assert len(eng.programs) == 3


@pytest.mark.parametrize("path", ["float", "rns9"])
def test_generate_freezes_rows_at_eos_like_jax(smoke, path):
    """eos taken from row 0's stream: row 0 repeats it from then on, the
    other rows go on; JAX's tokens (solo runs on the RNS path, where a
    solo row stops one step after its eos)."""
    eng, _ = _engines(smoke, path, max_cache=32, max_new_tokens=8)
    prompts = _batch(smoke[2].vocab, 2, 7, seed=4)
    eos = int(eng.generate(prompts)[0, 2])
    eng, jeng = _engines(smoke, path, max_cache=32, max_new_tokens=8,
                         eos_id=eos)
    got = eng.generate(prompts)
    assert (got[0, 2:] == eos).all()
    if path == "float":
        np.testing.assert_array_equal(got, jeng.generate(prompts))
    else:
        # a solo row stops one step after its eos; the batch goes on
        want = jeng.generate(prompts[:1])[0]
        np.testing.assert_array_equal(got[0, :len(want)], want)
        np.testing.assert_array_equal(got[1], jeng.generate(prompts[1:])[0])


@pytest.mark.parametrize("path", ["rns9", "fused"])
def test_rns_op_counts_equal_jax_times_layers(smoke, path):
    eng, jeng = _engines(smoke, path, max_cache=32, max_new_tokens=4)
    for B, T in ((1, 8), (2, 5)):
        ours = eng.rns_op_counts(B, T).as_dict()
        theirs = jeng.rns_op_counts(B, T)
        assert ours == {f: getattr(theirs, f) * eng.cfg.n_layers
                        for f in FIELDS}
        assert f"decode({B})" not in eng.programs
    assert eng.rns_op_counts(1, 8).as_dict()["fallbacks"] == 0


def test_bucketed_equals_continuous(smoke):
    """The port's two engines on the same rns9 prompts: the same tokens
    (chip_smoke's [serve_bucketed] bar on the card)."""
    _, _, cfg, model = smoke
    _, cfg = _with_rns(smoke[0], cfg, True)
    m = copy.deepcopy(model)
    m.cfg = cfg
    prompts = _batch(cfg.vocab, 3, 11, seed=6)
    got = Engine(m, ServeConfig(max_cache=32, max_new_tokens=6),
                 device="cpu").generate(prompts)
    res, _ = ContinuousEngine(m, ServeConfig(
        max_cache=32, max_new_tokens=6, page_size=8, max_seqs=4),
        device="cpu").run(list(prompts))
    for b in range(3):
        assert got[b].tolist() == res[b].tolist()


def test_generate_refuses_what_it_cannot_hold(smoke):
    eng, _ = _engines(smoke, "float", max_cache=12, max_new_tokens=6)
    with pytest.raises(ValueError, match="max_cache"):
        eng.generate(_batch(smoke[2].vocab, 1, 8, seed=0))
    with pytest.raises(ValueError, match="has no frontend"):
        eng.generate(_batch(smoke[2].vocab, 1, 4, seed=0),
                     frontend=np.zeros((1, 2, 64), np.float32))


@pytest.mark.parametrize("rns", [False, True])
def test_prefill_and_make_cache_equal_jax(smoke, rns):
    """``prefill`` of a [2, 10] batch: logits within LOGIT_ATOL of JAX's
    and the same argmax; the dense cache's K/V within KV_ATOL, zero past
    the prompt, its lengths JAX's; ``make_cache`` and
    ``set_cache_lengths`` as JAX's."""
    jcfg, jparams, cfg, model = smoke
    jcfg, cfg = _with_rns(jcfg, cfg, rns)
    m = copy.deepcopy(model)
    m.cfg = cfg
    toks = _batch(cfg.vocab, 2, 10, seed=3)
    jl, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, 24,
                        cache_dtype=jnp.float32)
    lg, c = M.prefill(m, cfg, torch.from_numpy(toks.astype(np.int64)), 24,
                      cache_dtype=torch.float32)
    jl = np.asarray(jl)
    np.testing.assert_allclose(lg.numpy(), jl, rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_array_equal(lg.argmax(-1).numpy(), jl.argmax(-1))
    for ours, name in ((c.k, "k"), (c.v, "v")):
        theirs = np.asarray(jc["l0"][name])        # [n_layers, B, S, Hk, D]
        assert ours.shape == theirs.shape
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                                   atol=KV_ATOL)
        assert not ours[:, :, 10:].any()
    assert c.lengths.tolist() == np.asarray(jc["l0"]["lengths"])[0].tolist()
    z = M.make_cache(cfg, 3, 16, device="cpu")
    jz = JM.make_cache(jcfg, 3, 16, dtype=jnp.float32)
    assert z.k.shape == jz["l0"]["k"].shape and not z.k.any()
    assert z.lengths.tolist() == [0, 0, 0]
    M.set_cache_lengths(z, np.array([4, 0, 9]))
    jz = JM.set_cache_lengths(jz, jnp.asarray([4, 0, 9], jnp.int32))
    assert z.lengths.tolist() == np.asarray(jz["l0"]["lengths"])[0].tolist()


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
def test_gpu_captured_bucketed_equals_eager_and_continuous(cuda, smoke,
                                                           path):
    """On the card: the captured bucketed engine against the eager one
    and the captured ContinuousEngine on the same prompts -- the same
    tokens, one capture a program, a second bucket and a re-run
    replaying what was captured."""
    _, _, cfg, model = smoke
    rns, _, pkw = PATHS[path]
    _, cfg = _with_rns(smoke[0], cfg, rns)
    prompts = _batch(cfg.vocab, 4, 11, seed=6)
    toks = {}
    for graphs in (False, True):
        m = copy.deepcopy(model)
        m.cfg = cfg
        eng = Engine(m, ServeConfig(max_cache=32, max_new_tokens=6, **pkw),
                     device="cuda", graphs=graphs)
        toks[graphs] = (eng.generate(prompts), eng.generate(prompts[:, :7]),
                        eng.generate(prompts))
    assert all(np.array_equal(a, b) for a, b in zip(toks[False],
                                                    toks[True]))
    np.testing.assert_array_equal(toks[True][0], toks[True][2])
    assert eng.captures() == {"prefill(4,11)": 1, "decode(4)": 1,
                              "prefill(4,7)": 1}
    m = copy.deepcopy(model)
    m.cfg = cfg
    res, _ = ContinuousEngine(m, ServeConfig(
        max_cache=32, max_new_tokens=6, page_size=8, max_seqs=4, **pkw),
        device="cuda").run(list(prompts))
    for b in range(4):
        assert toks[True][0][b].tolist() == res[b].tolist()
