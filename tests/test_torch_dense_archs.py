"""The dense architectures (``tinyllama-1.1b``, ``granite-3-8b``,
``qwen2.5-32b``): the port against the JAX package.

Qwen2's q/k/v bias through ``gqa_qkv`` (float, and rns9 with the bias
added after the shared conversion), attention without positions
(``pos_emb="none"``), the three smoke twins' weights, prefill and decode
logits (within ``LOGIT_ATOL``, the same argmax) and greedy tokens through
the continuous engine (phase-barrier and chunked) and the bucketed
engine, with every step's ``rns_ops`` JAX's times the layers (ROADMAP
C.3).  Also ``count_params`` on the full configs of every ported
architecture, ``list_archs``, and that no module of the port imports
``jax`` or ``repro``.  The ``gpu`` cases hold captured runs to eager
ones and the card to the CPU.
"""

import copy
import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as j_get_config
from repro.configs.base import list_archs as j_list_archs
from repro.core.rns_matmul import RnsDotConfig as JRnsDotConfig
from repro.models import attention as jattn
from repro.models import model as JM
from repro.serve.engine import ContinuousEngine as JContinuous
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.base import get_config, list_archs
from repro_torch.core.rns_matmul import RnsDotConfig
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.models.params import params_from_jax
from repro_torch.serve.engine import ContinuousEngine, Engine, ServeConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("tinyllama-1.1b", "granite-3-8b", "qwen2.5-32b")
FIELDS = ("converts", "matmuls", "normalizes", "fused", "fallbacks",
          "weight_converts")
# q/k/v of O(1): float32 sums in another order (XLA vs the port's fixed
# [64, K] blocks); rns9 shares one conversion and decodes exactly
QKV_ATOL = 1e-5
# |logit| is O(3): float paths differ by float32 rounding through 4
# layers, the RNS path by a rare 8-bit requantization flip
LOGIT_ATOL = {"float": 5e-5, "rns9": 5e-3, "all": 5e-3}
SERVE = dict(max_cache=48, page_size=8, max_seqs=3, max_new_tokens=5)
CHUNKED = dict(chunked_prefill=True, token_budget=16, chunk_size=8)
# path -> rns_targets (None: float)
TARGETS = {"float": None, "rns9": "mlp", "all": "all"}
# the published ranges of tests/test_archs_smoke.py
RANGES = {"smollm-135m": (0.10e9, 0.2e9), "tinyllama-1.1b": (0.9e9, 1.3e9),
          "granite-3-8b": (6e9, 9e9), "qwen2.5-32b": (28e9, 36e9),
          "jamba-v0.1-52b": (45e9, 60e9),
          "llama4-scout-17b-a16e": (90e9, 120e9),
          "deepseek-v2-236b": (200e9, 260e9), "rwkv6-7b": (6e9, 9e9),
          "paligemma-3b": (2e9, 3.5e9), "whisper-medium": (0.6e9, 1.0e9)}


def _rns(jcfg, cfg, path):
    targets = TARGETS[path]
    if targets is None:
        return jcfg, cfg
    return (dataclasses.replace(jcfg, rns=JRnsDotConfig(profile="rns9", qx=8,
                                                        qw=8),
                                rns_targets=targets),
            dataclasses.replace(cfg, rns=RnsDotConfig(profile="rns9", qx=8,
                                                      qw=8),
                                rns_targets=targets))


def _with_biases(jparams, seed=3):
    """JAX's tree with nonzero q/k/v biases (JAX draws them zero)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jparams)
    for lp in tree["blocks"].values():
        for name in ("wq", "wk", "wv"):
            b = lp["attn"][name].get("b")
            if b is not None:
                lp["attn"][name]["b"] = (rng.standard_normal(b.shape) * 0.1
                                         ).astype(np.float32)
    return tree


# ------------------------------------------------- q/k/v bias, positions --
@pytest.mark.parametrize("pos_emb", ["rope", "none"])
@pytest.mark.parametrize("path", ["float", "rns9"])
def test_gqa_qkv_matches_jax(path, pos_emb):
    """Qwen's projections with random biases: JAX's ``gqa_qkv`` (biases
    after the shared RNS conversion) within QKV_ATOL, rotated or not
    (``use_rope = pos_emb == "rope"``)."""
    jcfg = dataclasses.replace(j_get_config("qwen2.5-32b", smoke=True),
                               pos_emb=pos_emb)
    cfg = dataclasses.replace(get_config("qwen2.5-32b", smoke=True),
                              pos_emb=pos_emb)
    assert cfg.qkv_bias and jcfg.qkv_bias
    jp = jax.tree.map(np.asarray, jattn.init_gqa(jax.random.PRNGKey(2),
                                                 jcfg)[0])
    rng = np.random.default_rng(4)
    for name in ("wq", "wk", "wv"):
        jp[name]["b"] = (rng.standard_normal(jp[name]["b"].shape) * 0.1
                         ).astype(np.float32)
    p = attn.Attention(cfg, device="cpu")
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            getattr(p, name).copy_(torch.from_numpy(jp[name]["w"]))
        for name in ("q", "k", "v"):
            getattr(p, "b" + name).copy_(torch.from_numpy(jp["w" + name]["b"]))
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(3, 10)])
    jrns = None if path == "float" else JRnsDotConfig(profile="rns9", qx=8,
                                                      qw=8)
    rns = None if path == "float" else RnsDotConfig(profile="rns9", qx=8,
                                                    qw=8)
    want = jattn.gqa_qkv(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jcfg,
                         jnp.asarray(pos), jrns, use_rope=pos_emb == "rope")
    got = attn.gqa_qkv(p, torch.from_numpy(x), cfg, torch.from_numpy(pos),
                       rns)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=QKV_ATOL)


def test_biases_and_positions_are_config():
    """No bias parameters without ``qkv_bias``; ``pos_emb`` must be one
    of the known schemes."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    p = attn.Attention(cfg, device="cpu")
    assert p.bq is None and p.bk is None and p.bv is None
    q = attn.Attention(get_config("qwen2.5-32b", smoke=True), device="cpu")
    assert q.bk.shape == (cfg.n_kv_heads * cfg.d_head,)
    assert float(q.bq.abs().sum()) == 0.0
    with pytest.raises(ValueError, match="pos_emb"):
        dataclasses.replace(cfg, pos_emb="alibi")


# ----------------------------------------------------- the smoke twins ----
@pytest.fixture(scope="module")
def twins():
    """{arch: (JAX config, JAX params with biases, port config, port
    model)}."""
    out = {}
    for arch in ARCHS:
        jcfg = j_get_config(arch, smoke=True)
        tree = _with_biases(JM.init_model(jax.random.PRNGKey(0), jcfg)[0])
        cfg = get_config(arch, smoke=True)
        out[arch] = (jcfg, jax.tree.map(jnp.asarray, tree), cfg,
                     params_from_jax(tree, cfg, device="cpu"))
    return out


def _retarget(model, cfg):
    m = copy.deepcopy(model)
    m.cfg = cfg
    return m


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_fills_every_leaf(twins, arch):
    """Every JAX leaf lands in its port parameter (``params_from_jax``
    checks every entry of every leaf itself), the counts agree, and the
    twins keep their full config's options."""
    jcfg, jparams, cfg, model = twins[arch]
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert sum(int(np.prod(v.shape)) for _, v in leaves) == sum(
        p.numel() for p in model.parameters())
    full = get_config(arch)
    assert (cfg.qkv_bias, cfg.rope_theta, cfg.tie_embeddings) == (
        full.qkv_bias, full.rope_theta, full.tie_embeddings)
    blocks = jparams["blocks"]["l0"]
    for i, blk in enumerate(model.blocks):
        np.testing.assert_array_equal(blk.attn.wk.numpy(),
                                      np.asarray(blocks["attn"]["wk"]["w"][i]))
        if cfg.qkv_bias:
            np.testing.assert_array_equal(
                blk.attn.bv.numpy(), np.asarray(blocks["attn"]["wv"]["b"][i]))
            assert float(blk.attn.bv.abs().sum()) > 0


LOGIT_CASES = [(a, p) for a in ARCHS for p in ("float", "rns9")] + [
    ("qwen2.5-32b", "all")]


@pytest.mark.parametrize("arch,path", LOGIT_CASES)
def test_prefill_decode_logits_match_jax(twins, arch, path):
    """``prefill`` of a [2, 10] batch into a dense cache and two
    ``decode_step``s: logits within LOGIT_ATOL of JAX's, the same
    argmax; the K/V planes within 1e-4."""
    jcfg, jparams, cfg, model = twins[arch]
    jcfg, cfg = _rns(jcfg, cfg, path)
    m = _retarget(model, cfg)
    toks = np.random.default_rng(5).integers(1, cfg.vocab, (2, 10))
    jl, jc = jax.jit(functools.partial(JM.prefill, cache_dtype=jnp.float32),
                     static_argnums=(1, 3))(
        jparams, jcfg, {"tokens": jnp.asarray(toks)}, 16)
    lg, c = M.prefill(m, cfg, torch.from_numpy(toks), 16)
    jdecode = jax.jit(JM.decode_step, static_argnums=(1,))
    for _ in range(2):
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGIT_ATOL[path])
        nxt = np.asarray(jl).argmax(-1)[:, None]
        np.testing.assert_array_equal(lg.argmax(-1).numpy(), nxt[:, 0])
        jl, jc = jdecode(jparams, jcfg, jnp.asarray(nxt), jc)
        lg = M.decode_step(m, cfg, torch.from_numpy(nxt), c)
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(c, name).numpy(),
                                   np.asarray(jc["l0"][name]), rtol=0,
                                   atol=1e-4)


def _prompts(vocab, lens=(5, 21, 13, 13), seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (t,)).astype(np.int32) for t in lens]


ENGINE_CASES = [("tinyllama-1.1b", "float", False),
                ("granite-3-8b", "rns9", False),
                ("qwen2.5-32b", "rns9", False),
                ("qwen2.5-32b", "rns9", True),
                ("qwen2.5-32b", "all", False)]


@pytest.mark.parametrize("arch,path,chunked", ENGINE_CASES)
def test_engines_match_jax(twins, arch, path, chunked):
    """Four requests of 5-21 tokens through ``ContinuousEngine``
    (phase-barrier, or chunked: 16 lanes, chunks of 8): JAX's greedy
    tokens, every step's rns_ops the JAX engine's times the layers.  The
    bucketed ``Engine`` on the two 13-token prompts as one [2, 13]
    batch: those rows' tokens (a JAX continuous row is its solo run, as
    a bucketed row is the port's: per-row grids, ROADMAP C.11)."""
    jcfg, jparams, cfg, model = twins[arch]
    jcfg, cfg = _rns(jcfg, cfg, path)
    kw = CHUNKED if chunked else {}
    prompts = _prompts(cfg.vocab)
    jres, jstats = JContinuous(jparams, jcfg,
                               JServeConfig(**SERVE, **kw)).run(prompts)
    eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(**SERVE, **kw),
                           device="cpu")
    res, stats = eng.run(prompts)
    want = {r: t.tolist() for r, t in jres.items()}
    assert {r: t.tolist() for r, t in res.items()} == want
    assert len(stats["steps"]) == len(jstats["steps"])
    for s, js in zip(stats["steps"], jstats["steps"]):
        ops = {f: getattr(js["rns_ops"], f) * cfg.n_layers for f in FIELDS}
        assert s["rns_ops"].as_dict() == ops
    if chunked:
        return
    beng = Engine(_retarget(model, cfg), ServeConfig(
        max_cache=24, max_new_tokens=SERVE["max_new_tokens"]), device="cpu")
    out = beng.generate(np.stack(prompts[2:]))
    assert out.tolist() == [want[2], want[3]]
    theirs = JEngine(jparams, jcfg, JServeConfig(
        max_cache=24, max_new_tokens=5)).rns_op_counts(2, 13)
    assert beng.rns_op_counts(2, 13).as_dict() == {
        f: getattr(theirs, f) * cfg.n_layers for f in FIELDS}


# ------------------------------------------------- counts and registry ----
def test_count_params_equals_jax_on_full_configs():
    """``count_params`` on the full published configs of every ported
    architecture (built on the ``meta`` device: nothing allocated) equals
    JAX's ``count_params``, total and active, inside the ranges of
    ``tests/test_archs_smoke.py``."""
    assert sorted(RANGES) == list_archs()
    for arch, (lo, hi) in RANGES.items():
        total, active = M.count_params(get_config(arch))
        assert (total, active) == JM.count_params(j_get_config(arch)), arch
        assert lo <= total <= hi and active <= total, arch
        assert M.count_params_analytic(get_config(arch),
                                       active_only=True) == active


def test_list_archs_and_unregistered():
    """The port registers all ten of JAX's archs; an unknown arch raises
    ``KeyError`` naming the registered ones."""
    assert list_archs() == sorted(
        ["smollm-135m", "tinyllama-1.1b", "granite-3-8b", "qwen2.5-32b",
         "deepseek-v2-236b", "llama4-scout-17b-a16e", "rwkv6-7b",
         "jamba-v0.1-52b", "whisper-medium", "paligemma-3b"])
    assert list_archs() == j_list_archs()
    with pytest.raises(KeyError, match="whisper-medium"):
        get_config("whisper-large")
    for arch in list_archs():
        full, smoke = get_config(arch), get_config(arch, smoke=True)
        j = j_get_config(arch)
        assert (full.n_layers, full.d_model, full.d_ff, full.vocab,
                full.layer_types, full.mlp_types, full.pos_emb, full.norm,
                full.qkv_bias, full.rope_theta) == (
            j.n_layers, j.d_model, j.d_ff, j.vocab, j.layer_types,
            j.mlp_types, j.pos_emb, j.norm, j.qkv_bias, j.rope_theta)
        js = j_get_config(arch, smoke=True)
        assert (smoke.n_layers, smoke.layer_types, smoke.mlp_types,
                smoke.ssm) == (js.n_layers, js.layer_types, js.mlp_types,
                               js.ssm and type(smoke.ssm)(
                                   **dataclasses.asdict(js.ssm)))


# (D, N) of every RNS projection this slice adds: tinyllama, granite,
# qwen (MLP and q/k/v/o under "all"), Scout's shared expert, RWKV-6's
# time-mix / decay low rank / channel-mix, Mamba's in/x/dt/out and
# Jamba's MLP
NEW_PROJECTIONS = [(2048, 5632), (5632, 2048), (4096, 12800), (12800, 4096),
                   (5120, 27648), (27648, 5120), (5120, 5120), (5120, 1024),
                   (5120, 8192), (8192, 5120), (4096, 4096), (4096, 64),
                   (64, 4096), (4096, 14336), (14336, 4096), (4096, 16384),
                   (8192, 288), (256, 8192), (8192, 4096)]


def test_new_shapes_have_legal_tiles():
    """At decode [8, 1, .] and bucketed prefill [8, 33, .] rows, every new
    projection's shape gets a legal default tile and legal candidates
    from the block table (``kernels/autotune.py``) under the Hopper
    tile checker (``analysis/kernel_audit.py``), for every RNS kernel."""
    from repro_torch.kernels import autotune

    shapes = {}
    for M in (8, 8 * 33):
        for D, N in NEW_PROJECTIONS:
            for kind in ("rns_matmul", "rns_fused_dot",
                         "rns_fused_encode_matmul",
                         "rns_fused_matmul_normalize"):
                shapes.setdefault(kind, []).append((M, D, N))
            shapes.setdefault("rns_convert", []).extend([(M * D,), (D * N,)])
            shapes.setdefault("rns_normalize", []).append((M * N,))
    for kind, kind_shapes in shapes.items():
        for shape in kind_shapes:
            legal, dropped = autotune.legal_candidates(kind, "rns9", shape)
            assert legal and not dropped, (kind, shape, dropped)
            assert autotune._violations(kind, "rns9", shape,
                                        autotune.DEFAULTS[kind]) == []
            autotune.resolve(kind, "rns9", shape, torch.device("cpu"))


_NO_JAX = """
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
assert "repro_torch.models.ssm" in names
print(len(names))
"""


def test_port_imports_no_jax_and_no_reference():
    """Every module of ``src/repro_torch`` (``models/ssm.py`` among them)
    imports in a process where ``jax`` and ``repro`` cannot be
    imported."""
    out = subprocess.run([sys.executable, "-c", _NO_JAX],
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) > 30


# ------------------------------------------------------------ on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels run "
                    "only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["rns9", "all"])
def test_gpu_qwen_captured_equals_eager_and_cpu(cuda, twins, path):
    """On the card: Qwen's twin (q/k/v biases) through the captured
    ContinuousEngine and bucketed Engine against eager ones (the same
    tokens, one capture a program), and the card's prefill logits
    (kernels) within 5e-3 of the CPU's (plain)."""
    jcfg, _, cfg, model = twins["qwen2.5-32b"]
    _, cfg = _rns(jcfg, cfg, path)
    prompts = _prompts(cfg.vocab)
    toks = torch.from_numpy(np.stack([p[:5] for p in prompts]).astype(
        np.int64))
    lg = {dev: M.prefill(_retarget(model, cfg).to(dev), cfg, toks.to(dev),
                         16)[0].cpu() for dev in ("cpu", "cuda")}
    torch.testing.assert_close(lg["cuda"], lg["cpu"], rtol=0, atol=5e-3)
    out = {}
    for graphs in (False, True):
        eng = ContinuousEngine(_retarget(model, cfg), ServeConfig(**SERVE),
                               device="cuda", graphs=graphs)
        res, _ = eng.run(prompts)
        beng = Engine(_retarget(model, cfg), ServeConfig(
            max_cache=16, max_new_tokens=5), device="cuda", graphs=graphs)
        out[graphs] = ({r: t.tolist() for r, t in res.items()},
                       beng.generate(toks.numpy()).tolist())
        if graphs:
            assert set(eng.captures().values()) == {1}
            assert set(beng.captures().values()) == {1}
    assert out[True] == out[False]
