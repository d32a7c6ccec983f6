"""Serving engines: bucketed batching and continuous batching over a
paged KV cache.

:class:`Engine` is the port of ``repro.serve.engine``'s bucketed engine:
equal-length prompts [B, T] prefilled into a dense cache, then decoded
together to completion.  Its prefill and decode are step programs built
at a bucket's first use and kept: the prefill keyed by (B, T), the decode
by B (the JAX engine re-jits per bucket).

:class:`ContinuousEngine` is the port of ``repro.serve.engine``'s engine
of the same name.  On its phase-barrier path each :meth:`step` admits
and evicts through the host-side scheduler, prefills every admitted
prompt whole (right-padded to ``prompt_pad``, a whole number of pages;
per-row lengths make the padding inert), then runs ONE batched greedy
decode step over every running row.  Finished rows free their pages the
same step; when the pool runs dry the youngest row is preempted and
re-prefilled later.

With ``chunked_prefill`` every step is instead ONE packed mixed-phase
step over a fixed ``token_budget`` of lanes, which carries decode rows
and prefill chunks of at most ``chunk_size`` tokens together
(``models/model.py::mixed_step``); prompts longer than ``prompt_pad``
stream in chunk by chunk.  With ``prefix_cache`` rows whose prompts
share a prefix share its KV pages (copy-on-write: a row splits a shared
page before its first write into it).

With ``spec_decode`` (self-speculative n-gram prompt-lookup decoding)
each decode row proposes ``spec_k`` draft tokens from its own history
and ONE verify step scores [last token, drafts] for every row; the
greedy accept keeps the stream token-identical to plain decoding while
it emits up to ``spec_k + 1`` tokens a row a step (chunked: a row's
window takes ``spec_k + 1`` lanes of the mixed step).  With
``window_tokens`` every row attends only its last ``window_tokens``
tokens and the scheduler recycles the pages behind the window, so a row
holds a bounded number of pages however long it runs.

The prefill (with the blit of its K/V planes into the pages), the
decode step (with its argmax), the verify step (with its argmax, the
greedy accept and the length advance), the mixed step (with its
per-lane argmax) and the copy-on-write page copy are step programs
(``serve/graphs.py``) over static buffers whose shapes depend only on
the engine's geometry, as the JAX engine jits each once.  An engine
builds the programs its config serves: decode (verify with
``spec_decode``) and prefill, or mixed when chunked, and the copy with
the prefix cache.  On the card each is captured once in a CUDA graph at
engine build and replayed every step; ``graphs=False`` (or the CPU)
runs them eagerly.

Each step reports the RNS primitive calls of its phases (``rns_ops``),
as the JAX engine does: the decode (or verify) program's tallies plus
the prefill program's once per admitted prompt, or the mixed program's
every step when chunked, each taken once when the program is built.  The port
tallies every call of every layer, so that is the number of periods
(``n_layers // period``; ``n_layers`` for smollm-135m) times what the
JAX engine reports, whose trace-time tally sees its layer ``scan`` body
-- one period -- once (ROADMAP C.3).  The continuous engine pages
attention caches of decoder-only models only and refuses the recurrent
(RWKV-6, Mamba) layers, encoder-decoder and frontend models and
non-causal attention with the JAX engine's messages; the bucketed engine
serves them all.

``ServeConfig(rns_backend="cuda_fused", rns_defer=True,
resident_weights=True)`` serves the fused path: MLP weights encoded once
at engine build, the deferred MLP chain, the fused kernels; with
``per_layer_profiles=True`` each layer's weights are encoded on the
narrowest profile that holds its chain (``models/resident.py``).

Digit sharding (``ServeConfig.mesh``, a ``DeviceMesh``, and
``digit_axis``): every step program runs under
``use_digit_sharding(mesh, digit_axis)``, so each rank's residues hold
its digit group and each normalize gathers the digits once
(``core/dispatch.py``); resident weights keep only the rank's group.
Every rank runs the engine on the same prompts and gives the same
tokens.  A gloo group's collectives go through the host: an engine that
would capture one (``graphs=True`` on the card) raises; an nccl group
(one rank a card) is captured with the rest of the step.  ``stats`` (and
``Engine.last_stats``) name the group's backend.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.distributed import sharding
from repro_torch.models import model as M
from repro_torch.serve import kv_cache as kv
from repro_torch.serve.graphs import StepProgram, build_programs
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["ServeConfig", "Engine", "ContinuousEngine"]

_CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class ServeConfig:
    """Engine knobs.  ``eos_id = -1`` means "never stop early"."""

    max_cache: int = 512
    max_new_tokens: int = 32
    eos_id: int = -1
    cache_dtype: str = "float32"    # KV page pool: float32|bfloat16|float16
    # RNS execution overrides (None: keep the model config's)
    rns_backend: str | None = None  # "auto"|"reference"|"cuda"|"cuda_fused"
    rns_defer: bool | None = None   # residue-domain MLP chaining
    # encode every RNS-target MLP weight once at engine build
    resident_weights: bool = False
    # with resident_weights: each period slot of layers on the narrowest
    # profile that holds its MLP chain
    per_layer_profiles: bool = False
    page_size: int = 16
    max_seqs: int = 8
    n_pages: int | None = None
    prompt_pad: int | None = None   # prefill pad length (None: seq capacity)
    # copy-on-write prefix caching: rows sharing a prompt prefix map their
    # block tables onto shared pages; the prefill blit skips shared blocks
    # and a row splits a shared page the first time it writes into one
    prefix_cache: bool = False
    # chunked prefill: ONE packed step a scheduler step over
    # ``token_budget`` lanes of decode rows and prefill chunks of at most
    # ``chunk_size`` tokens (None: no cap beyond the budget); while a row
    # prefills, ``prefill_reserve`` lanes go to chunks (None: half the
    # budget)
    chunked_prefill: bool = False
    token_budget: int = 64
    chunk_size: int | None = None
    prefill_reserve: int | None = None
    # self-speculative (n-gram prompt-lookup) decoding: every step scores
    # [last token, spec_k drafts] a row in ONE verify step (spec_k + 1
    # lanes a row when chunked); the greedy accept keeps the tokens
    spec_decode: bool = False
    spec_k: int = 3                 # draft tokens a step (window spec_k+1)
    spec_ngram: int = 3             # longest n-gram the lookup matches
    # sliding-window attention: a row attends its last window_tokens
    # tokens, and the pages behind the window go back to the pool
    window_tokens: int | None = None
    # residue-channel sharding: a DeviceMesh whose ``digit_axis``
    # partitions the RNS digit axis (one group of moduli a rank; digits
    # meet only at MRC normalization).  None: one rank, unchanged.
    mesh: object | None = None
    digit_axis: str = "model"

    def __post_init__(self):
        if self.eos_id < -1:
            raise ValueError(
                f"eos_id={self.eos_id}: use a token id, or -1 to disable "
                "early stopping")
        if self.spec_decode and self.spec_k < 1:
            raise ValueError(
                f"spec_k={self.spec_k}: speculative decoding needs at "
                "least one draft token per step")
        if self.spec_decode and self.spec_ngram < 1:
            raise ValueError(f"spec_ngram={self.spec_ngram}: need >= 1")
        if self.per_layer_profiles and not self.resident_weights:
            raise ValueError(
                "per_layer_profiles selects moduli at weight-encode time; "
                "it requires resident_weights=True")
        if self.chunked_prefill:
            if self.token_budget < 1:
                raise ValueError(
                    f"token_budget={self.token_budget}: chunked_prefill "
                    "needs at least one packed lane per step")
            if self.spec_decode and self.token_budget < self.spec_k + 1:
                raise ValueError(
                    f"token_budget={self.token_budget} < spec_k+1="
                    f"{self.spec_k + 1}: a speculative decode row needs "
                    "spec_k+1 lanes in one mixed step; raise token_budget "
                    "or lower spec_k")
            if self.cache_dtype != "float32":
                raise ValueError(
                    f"cache_dtype={self.cache_dtype!r}: chunked prefill "
                    "re-reads earlier chunks' KV from the page pool, so "
                    "the cache must be lossless (float32) to stay "
                    "token-identical to whole-prompt prefill")
        if self.chunk_size is not None:
            if not self.chunked_prefill:
                raise ValueError("chunk_size is only meaningful with "
                                 "chunked_prefill=True")
            if self.chunk_size < 1:
                raise ValueError(f"chunk_size={self.chunk_size}: need >= 1")
            if self.chunk_size % self.page_size:
                raise ValueError(
                    f"chunk_size={self.chunk_size} is not a multiple of "
                    f"page_size={self.page_size}: chunk boundaries must "
                    "align with KV pages so completed blocks register "
                    "with the prefix cache as chunks land")
            if self.chunk_size > self.token_budget:
                raise ValueError(
                    f"chunk_size={self.chunk_size} > token_budget="
                    f"{self.token_budget}: a chunk can never exceed the "
                    "packed lanes available in one step")
        if self.prefill_reserve is not None:
            if not self.chunked_prefill:
                raise ValueError("prefill_reserve is only meaningful with "
                                 "chunked_prefill=True")
            if not 0 <= self.prefill_reserve < self.token_budget:
                raise ValueError(
                    f"prefill_reserve={self.prefill_reserve}: must be in "
                    f"[0, token_budget={self.token_budget}) so decode "
                    "rows keep making progress")
        if self.window_tokens is not None and self.window_tokens < 1:
            raise ValueError(
                f"window_tokens={self.window_tokens}: a sliding window "
                "must retain at least the current token (use None for "
                "full attention)")


def _apply_rns_policy(model_cfg, scfg: ServeConfig):
    """Fold the serve-side overrides into the model config: the RNS
    backend and defer policy, and the sliding window (``attn_window``,
    which both engines thread to attention: the bucketed engine's solo
    run with the same ``window_tokens`` is what the continuous stream is
    token-identical to)."""
    if scfg.window_tokens is not None:
        model_cfg = dataclasses.replace(model_cfg,
                                        attn_window=scfg.window_tokens)
    if model_cfg.rns is None or (scfg.rns_backend is None
                                 and scfg.rns_defer is None):
        return model_cfg
    rns = model_cfg.rns
    if scfg.rns_backend is not None:
        rns = dataclasses.replace(rns, backend=scfg.rns_backend)
    if scfg.rns_defer is not None:
        rns = dataclasses.replace(rns, defer=scfg.rns_defer)
    return dataclasses.replace(model_cfg, rns=rns)


def _maybe_resident(model, cfg, scfg: ServeConfig):
    """Encode resident weights once, at engine build, when asked to (with
    a mesh, this rank's digit group of each)."""
    if scfg.resident_weights and cfg.rns is not None:
        from repro_torch.models.resident import encode_resident

        encode_resident(model, cfg,
                        per_layer_profiles=scfg.per_layer_profiles,
                        mesh=scfg.mesh, digit_axis=scfg.digit_axis)


def _with_digit_ctx(fn, scfg: ServeConfig):
    """``fn`` run under the digit-sharding context of ``scfg.mesh`` (its
    warm-up, its capture and every eager run); ``fn`` itself without a
    mesh."""
    if scfg.mesh is None:
        return fn

    def wrapped(*args, **kwargs):
        with sharding.use_digit_sharding(scfg.mesh, scfg.digit_axis):
            return fn(*args, **kwargs)

    return wrapped


def _dist_stats(scfg: ServeConfig) -> dict:
    """The digit group's size and its collectives' backend ({} without a
    mesh)."""
    if scfg.mesh is None:
        return {}
    ds = sharding.DigitSharding(scfg.mesh, scfg.digit_axis)
    return {"digit_shards": ds.n_shards, "collective_backend": ds.backend}


class _Programs:
    """Step programs of an engine (``self.programs``, by name) and the
    host staging of their inputs (``self._staging``)."""

    device: torch.device
    programs: dict[str, StepProgram]
    _staging: dict[tuple[str, str], torch.Tensor]

    def _install(self, programs, graphs: bool):
        """Stage, warm and (on the card, with ``graphs``) capture
        ``programs``; returns the capture stream (None: eager).  Host
        staging is pinned on the card, so the copies into the static
        buffers are asynchronous; every step ends in a pull of its
        outputs, so a staging buffer is free again by the next step."""
        programs = list(programs)
        pin = self.device.type == "cuda"
        for prog in programs:
            prog.fn = _with_digit_ctx(prog.fn, self.scfg)
            self.programs[prog.name] = prog
            for name, buf in prog.inputs.items():
                self._staging[(prog.name, name)] = torch.empty(
                    buf.shape, dtype=buf.dtype, pin_memory=pin)
        return build_programs(programs, self.device, graphs=graphs)

    def captures(self) -> dict[str, int]:
        """Graphs captured per program (0 everywhere when eager)."""
        return {name: p.captures for name, p in self.programs.items()}

    def _run(self, prog: str, **values):
        """Write host arrays into ``prog``'s staging buffers and run it
        on them; returns its static outputs."""
        staged = {}
        for name, value in values.items():
            buf = self._staging[(prog, name)]
            buf.numpy()[...] = np.asarray(value).reshape(buf.shape)
            staged[name] = buf
        return self.programs[prog].run(**staged)


class Engine(_Programs):
    """Bucketed batching: equal-length prompts, the batch runs to
    completion, on ``device`` (``model`` moved there in place; with
    ``resident_weights`` its MLP weights encoded in place).

    A (B, T) bucket's prefill program (``models/model.py::prefill`` into
    a dense cache of ``max_cache`` positions, and the argmax) and a
    batch size's decode program (``decode_step`` over that cache, and
    the argmax) are built at first use and kept: captured once each on
    the card, eager with ``graphs=False`` or on the CPU.  Each decode
    row quantizes on its own grid (the step's ``active`` mask is all
    ones), so a row's tokens do not depend on its batch (ROADMAP C.11).
    It serves every model of the port: the recurrent (RWKV-6, Mamba)
    layers' states live in the dense cache's state planes, which the
    prefill writes and each decode step updates in place (a row frozen
    at eos goes on updating its state with its frozen token, as in JAX);
    a model with a frontend takes each prompt's ``n_frontend_tokens``
    embeddings (``generate(frontend=)``) as a further input of the
    prefill program, and an encoder-decoder model's cross planes live in
    the dense cache beside its K/V.  The exactness audit is a later
    slice of the port."""

    def __init__(self, model: M.Model, scfg: ServeConfig, *, device="cuda",
                 graphs: bool = True):
        if scfg.cache_dtype not in _CACHE_DTYPES:
            raise ValueError(f"cache_dtype={scfg.cache_dtype!r}: one of "
                             f"{sorted(_CACHE_DTYPES)}")
        sharding.check_capturable(scfg.mesh, (scfg.digit_axis,), device,
                                  graphs)
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.cfg = _apply_rns_policy(model.cfg, scfg)
        _maybe_resident(self.model, self.cfg, scfg)
        self.scfg = scfg
        self.graphs = graphs
        self.programs: dict[str, StepProgram] = {}
        self._staging = {}
        self._caches: dict[int, M.DenseKV] = {}     # B -> dense cache

    def _cache(self, B: int) -> M.DenseKV:
        """The dense cache of batch size B, shared by its buckets."""
        if B not in self._caches:
            self._caches[B] = M.make_cache(
                self.cfg, B, self.scfg.max_cache, device=self.device,
                dtype=_CACHE_DTYPES[self.scfg.cache_dtype])
        return self._caches[B]

    def _bucket(self, B: int, T: int, *, decode: bool = True):
        """Build (once) the (B, T) prefill program and, with ``decode``,
        the B decode program; returns their names.  A model with a
        frontend's prefill also takes the frames [B, F, d] (F the
        config's ``n_frontend_tokens``)."""
        cache = self._cache(B)
        names = (f"prefill({B},{T})", f"decode({B})")
        new = []
        cfg = self.cfg

        @torch.inference_mode()
        def prefill(tokens, frontend=None):
            logits, _ = M.prefill(self.model, cfg, tokens,
                                  self.scfg.max_cache, frontend=frontend,
                                  cache=cache)
            return torch.argmax(logits, dim=-1)

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        # the prefill first: its warm-up sets the lengths the decode
        # warm-up writes at (both write only positions a later prefill
        # or step overwrites before reading)
        if names[0] not in self.programs:
            inputs = {"tokens": zeros(B, T)}
            if cfg.frontend is not None:
                inputs["frontend"] = zeros(B, cfg.n_frontend_tokens,
                                           cfg.d_model,
                                           dtype=torch.float32)
            new.append(StepProgram(names[0], prefill, inputs))
        if decode and names[1] not in self.programs:
            every_row = torch.ones((B,), dtype=torch.bool,
                                   device=self.device)

            @torch.inference_mode()
            def step(token):
                logits = M.decode_step(self.model, cfg, token, cache,
                                       every_row)
                return torch.argmax(logits, dim=-1)

            new.append(StepProgram(names[1], step, {"token": zeros(B, 1)}))
        if new:
            self._install(new, self.graphs)
        return names

    def rns_op_counts(self, B: int = 1, T: int = 8) -> dispatch.OpCounts:
        """RNS primitive calls of one [B, T] prefill: the (B, T) prefill
        program's tally, taken when it is built (with the config's
        ``n_frontend_tokens`` frames where the model takes a frontend;
        the JAX engine traces an encoder-decoder prefill without frames
        and raises, ROADMAP C.16).  The port tallies every layer's calls,
        the JAX engine one traced period of each layer scan: the port's
        count is JAX's times the periods (``n_layers // period``, and
        ``n_enc_layers`` for the encoder's scan; ROADMAP C.3)."""
        name, _ = self._bucket(B, T, decode=False)
        return self.programs[name].ops

    def generate(self, prompts, frontend=None, max_new: int | None = None):
        """prompts [B, T] (equal lengths) -> [B, n_new] int32 greedy
        tokens; ``frontend`` [B, F, d] the prompts' frame or patch
        embeddings, which a model with a frontend needs (F its config's
        ``n_frontend_tokens``; a prefix model's rows hold F + T prompt
        positions).  A row that emits ``eos_id`` repeats it from then
        on; the batch stops when every row has.  ``last_stats`` then
        holds the call's host times: ``ttft_s`` (the prefill, its tokens
        pulled) and ``step_time_s`` (each decode step)."""
        cfg = self.cfg
        prompts = np.asarray(prompts, np.int64)
        B, T = prompts.shape
        max_new = max_new or self.scfg.max_new_tokens
        inputs = {"tokens": prompts}
        F = 0
        if cfg.frontend is None:
            if frontend is not None:
                raise ValueError(f"{cfg.arch_id} has no frontend")
        else:
            want = (B, cfg.n_frontend_tokens, cfg.d_model)
            if frontend is None or tuple(np.shape(frontend)) != want:
                raise ValueError(f"{cfg.arch_id}: frontend of shape {want} "
                                 "needed")
            inputs["frontend"] = np.asarray(frontend, np.float32)
            F = 0 if cfg.enc_dec else cfg.n_frontend_tokens
        if F + T + max_new - 1 > self.scfg.max_cache:
            raise ValueError(
                f"prompt length {F + T} + max_new {max_new} - 1 > "
                f"max_cache {self.scfg.max_cache}")
        pre, dec = self._bucket(B, T)
        t0 = time.perf_counter()
        tok = self._run(pre, **inputs).cpu().numpy()
        self.last_stats = {"ttft_s": time.perf_counter() - t0,
                           "step_time_s": [], **_dist_stats(self.scfg)}
        done = np.zeros((B,), bool)
        out = [tok]
        for _ in range(max_new - 1):
            t0 = time.perf_counter()
            done = done | (tok == self.scfg.eos_id)
            nxt = self._run(dec, token=tok[:, None]).cpu().numpy()
            tok = np.where(done, tok, nxt)
            out.append(tok)
            self.last_stats["step_time_s"].append(time.perf_counter() - t0)
            if done.all():
                break
        return np.stack(out, axis=1).astype(np.int32)


class ContinuousEngine(_Programs):
    """In-flight batching over a paged KV cache, on ``device`` (``model``
    is moved there in place, as ``nn.Module.to`` does, and with
    ``resident_weights`` its MLP weights are encoded onto it in place).

    ``graphs=False`` runs the step programs eagerly on the card too: the
    reference a captured engine is held to."""

    def __init__(self, model: M.Model, scfg: ServeConfig, *, device="cuda",
                 graphs: bool = True):
        if scfg.cache_dtype not in _CACHE_DTYPES:
            raise ValueError(f"cache_dtype={scfg.cache_dtype!r}: one of "
                             f"{sorted(_CACHE_DTYPES)}")
        cfg = _apply_rns_policy(model.cfg, scfg)
        # the JAX engine's checks, with its messages
        bad = sorted({t for t in cfg.layer_types if t not in ("attn", "mla")})
        if bad:
            raise NotImplementedError(
                f"continuous batching pages attn/mla caches only; "
                f"{cfg.arch_id} has layer types {bad}")
        if cfg.enc_dec or cfg.frontend is not None:
            raise NotImplementedError(
                "continuous batching is decoder-only (no enc-dec / frontend)")
        if not cfg.causal:
            raise NotImplementedError("continuous batching requires causal "
                                      "attention (padded prefill relies on it)")
        if scfg.chunked_prefill and cfg.rns is not None \
                and cfg.rns_targets == "all" and "mla" in cfg.layer_types:
            raise NotImplementedError(
                "chunked_prefill with rns_targets='all' on an MLA model: "
                "packed chunk tokens re-expand gathered latents, and the "
                "original per-token quantization grids of earlier chunks "
                "are not recoverable from the cache; use rns_targets='mlp'")
        sharding.check_capturable(scfg.mesh, (scfg.digit_axis,), device,
                                  graphs)
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        _maybe_resident(self.model, self.cfg, scfg)
        self.scfg = scfg
        bs = scfg.page_size
        max_blocks = -(-scfg.max_cache // bs)
        n_pages = scfg.n_pages or 1 + scfg.max_seqs * max_blocks
        self.spec_window = scfg.spec_k + 1 if scfg.spec_decode else 1
        resident = None
        if scfg.window_tokens is not None:
            # window + lookahead tokens straddle at most this many pages
            resident = -(-(scfg.window_tokens + self.spec_window) // bs) + 1
        self.pcfg = kv.PagedCacheConfig(page_size=bs, n_pages=n_pages,
                                        max_seqs=scfg.max_seqs,
                                        max_blocks=max_blocks,
                                        resident_blocks=resident)
        # one prefill shape: every prompt is right-padded to prompt_pad,
        # a whole number of pages
        self.prompt_pad = _round_up(
            scfg.prompt_pad or self.pcfg.tokens_per_seq, bs)
        if self.prompt_pad > self.pcfg.tokens_per_seq:
            raise ValueError(
                f"prompt_pad {self.prompt_pad} exceeds per-seq cache "
                f"capacity {self.pcfg.tokens_per_seq}")
        self.chunked = scfg.chunked_prefill
        reserve = scfg.prefill_reserve
        if reserve is None:
            reserve = max(1, scfg.token_budget // 2)
        self.sched = Scheduler(self.pcfg, prefix_cache=scfg.prefix_cache,
                               lookahead=self.spec_window,
                               chunked=self.chunked,
                               token_budget=scfg.token_budget,
                               chunk_size=scfg.chunk_size,
                               prefill_reserve=reserve if self.chunked else 0,
                               window_tokens=scfg.window_tokens)
        self.cache = kv.make_paged_cache(
            self.cfg, self.pcfg, device=self.device,
            dtype=_CACHE_DTYPES[scfg.cache_dtype])
        self._tables_dirty = True
        self._active = np.zeros((self.pcfg.max_seqs,), bool)
        self._next_rid = 0
        self._step_idx = 0
        self.results: dict[int, np.ndarray] = {}
        self.latencies: dict[int, float] = {}
        self.ttfts: dict[int, float] = {}
        self._build_programs(graphs)

    # ---------------------------------------------------- step programs --
    def _build_programs(self, graphs: bool):
        """The config's step programs over static buffers, warmed up and
        (on the card, with ``graphs``) captured on the trash page: the
        zeroed block table, a zero ``block_row``, pad lanes (``seg =
        -1``) and trash-onto-trash copies send every warm-up write to
        page 0, and ``active`` all False advances no length."""
        R = self.pcfg.max_seqs
        nbp = self.prompt_pad // self.pcfg.page_size
        N = self.scfg.token_budget
        dev = self.device

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        @torch.inference_mode()
        def decode(token, active):
            logits = M.decode_step(self.model, self.cfg, token, self.cache,
                                   active)
            # argmax on the device: the host pulls R ints, not R x vocab
            return torch.argmax(logits, dim=-1)

        @torch.inference_mode()
        def verify(window, active, caps):
            # the JAX engine's _verify_fn: draft i + 1 survives iff it is
            # the argmax after window position i and every earlier draft
            # survived; lengths advance by accepted + 1 on the device, in
            # lockstep with the host's counters
            logits = M.decode_window(self.model, self.cfg, window,
                                     self.cache, active)
            g = torch.argmax(logits, dim=-1)                 # [R, W]
            match = (g[:, :-1] == window[:, 1:]).to(torch.int64)
            a = torch.minimum(torch.cumprod(match, dim=1).sum(dim=1), caps)
            self.cache.lengths += torch.where(active, a + 1, 0)
            return g, a

        @torch.inference_mode()
        def prefill(tokens, length, block_row):
            logits, ys = M.prefill_ragged(self.model, self.cfg, tokens,
                                          length)
            # JAX's _ingest_fn: each plane (K/V or MLA latents) into its
            # pool
            pools = self.cache.pools()
            for name, planes in M.stack_planes(self.cfg, ys).items():
                kv.write_prompt_pages(pools[name], block_row, planes[:, 0])
            return torch.argmax(logits, dim=-1)

        @torch.inference_mode()
        def mixed(tokens, seg, pos, dec, valid):
            logits = M.mixed_step(self.model, self.cfg, tokens, seg, pos,
                                  dec, valid, self.cache)
            return torch.argmax(logits, dim=-1)

        @torch.inference_mode()
        def cow(src, dst):
            for pages in self.cache.pools().values():
                kv.copy_pages(pages, src, dst)

        self.programs: dict[str, StepProgram] = {}
        if self.chunked:
            self.programs["mixed"] = StepProgram("mixed", mixed, {
                "tokens": zeros(N), "seg": torch.full((N,), -1, device=dev),
                "pos": zeros(N), "dec": zeros(N, dtype=torch.bool),
                "valid": zeros(N, dtype=torch.bool)})
        elif self.scfg.spec_decode:
            # ONE [R, W] verify program replaces the [R, 1] decode
            self.programs["verify"] = StepProgram("verify", verify, {
                "window": zeros(R, self.spec_window),
                "active": zeros(R, dtype=torch.bool), "caps": zeros(R)})
        else:
            self.programs["decode"] = StepProgram("decode", decode, {
                "token": zeros(R, 1), "active": zeros(R, dtype=torch.bool)})
        if not self.chunked:
            self.programs["prefill"] = StepProgram("prefill", prefill, {
                "tokens": zeros(1, self.prompt_pad),
                "length": torch.ones((1,), dtype=torch.int64, device=dev),
                "block_row": zeros(nbp)})
        if self.scfg.prefix_cache:
            self.programs["cow"] = StepProgram("cow", cow, {
                "src": zeros(R), "dst": zeros(R)})
        # a COW copy is followed by the step's program on the same
        # stream, whose outputs are pulled: its staging is free by then
        self._staging = {}
        self._capture_stream = self._install(self.programs.values(), graphs)

    def _rns_ops(self, n_prefills: int) -> dispatch.OpCounts:
        """This step's RNS tallies (the JAX engine's rule): the mixed
        program's when chunked, else the decode (or, with
        ``spec_decode``, the verify) program's plus the prefill
        program's once per admitted prompt."""
        if self.cfg.rns is None:
            return dispatch.OpCounts()
        if self.chunked:
            return self.programs["mixed"].ops
        step = "verify" if self.scfg.spec_decode else "decode"
        return self.programs[step].ops.add(self.programs["prefill"].ops,
                                           times=n_prefills)

    def _apply_cow(self, cow):
        """Run the scheduler's COW splits on the device (before any write
        lands on them).  Fixed [R] ``src``/``dst`` (trash for no-op rows)
        keep one program; rounds take one split a slot, so a real ``dst``
        never repeats within one copy."""
        R = self.pcfg.max_seqs
        while cow:
            this_round, rest, seen = [], [], set()
            for e in cow:
                if e[0] in seen:
                    rest.append(e)
                else:
                    seen.add(e[0])
                    this_round.append(e)
            src = np.full((R,), kv.TRASH_PAGE, np.int64)
            dst = np.full((R,), kv.TRASH_PAGE, np.int64)
            for slot, _b, s, d in this_round:
                src[slot], dst[slot] = s, d
            self._run("cow", src=src, dst=dst)
            cow = rest
            if cow and self.device.type == "cuda":
                # the next round rewrites the pinned staging buffers that
                # this round's copy may still be reading
                torch.cuda.synchronize(self.device)

    def _propose(self, seq) -> np.ndarray:
        """Prompt-lookup (n-gram) drafting: match the row's trailing
        n-gram (longest first, at most ``spec_ngram``) against its own
        prompt + generation history and propose the ``spec_k`` tokens
        that followed its most recent earlier occurrence.  A miss pads
        with zeros: a draft is accepted only if it equals the model's
        greedy choice, so correctness never depends on the drafts."""
        k = self.scfg.spec_k
        hist = np.concatenate([seq.req.tokens,
                               np.asarray(seq.emitted, np.int32)])
        out = np.zeros((k,), np.int32)
        for n in range(min(self.scfg.spec_ngram, len(hist) - 1), 0, -1):
            pat = hist[-n:]
            base = hist[:-1]                 # a start needs a next token
            if len(base) < n:
                continue
            wins = np.lib.stride_tricks.sliding_window_view(base, n)
            hits = np.flatnonzero((wins == pat).all(axis=1))
            if len(hits):
                j = int(hits[-1]) + n
                d = hist[j:j + k]
                out[: len(d)] = d
                return out
        return out

    def _cap(self, seq) -> int:
        """Drafts a row may accept this step: within its ``max_new``
        budget and its KV on real pages (not the trash page)."""
        remaining = seq.req.max_new - len(seq.emitted)
        return max(0, min(self.spec_window - 1, remaining - 1,
                          len(seq.pages) * self.pcfg.page_size
                          - seq.length - 1))

    def _accept(self, seq, drafts, ar: int, bonus: int, cap: int) -> int:
        """Emit a row's ``ar`` accepted drafts and the greedy token after
        them (cut after an eos), advance its length by ``ar + 1`` (as the
        verify step did on the device) and finish it when done; returns
        the tokens emitted."""
        toks = [int(t) for t in drafts[:ar]] + [int(bonus)]
        if self.scfg.eos_id >= 0 and self.scfg.eos_id in toks:
            toks = toks[: toks.index(self.scfg.eos_id) + 1]
        seq.emitted.extend(toks)
        seq.last_token = seq.emitted[-1]
        seq.length += ar + 1
        if self.spec_window > 1:
            self._spec_accepted += ar
            self._spec_proposed += cap
        if self._done(seq):
            self._step_finished.append(seq.rid)
            self._finish(seq)
        return len(toks)

    # ------------------------------------------------------------ intake --
    def submit(self, prompt, max_new: int | None = None) -> int:
        """Queue one request; returns its request id."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        max_new = max_new or self.scfg.max_new_tokens
        if not self.chunked and len(prompt) > self.prompt_pad:
            raise ValueError(
                f"prompt length {len(prompt)} > prompt_pad {self.prompt_pad}; "
                "raise ServeConfig.prompt_pad or turn on chunked_prefill")
        rid = self._next_rid
        self._next_rid += 1
        self.sched.submit(Request(rid=rid, tokens=prompt, max_new=max_new,
                                  submit_time=time.perf_counter()))
        return rid

    # ----------------------------------------------------------- stepping --
    def _first_token(self, seq, tok0: int, now: float):
        seq.emitted = [tok0]
        seq.last_token = tok0
        ttft = now - seq.req.submit_time
        self.ttfts[seq.rid] = ttft
        self._step_ttfts.append(ttft)

    def _do_prefill(self, seq):
        T = len(seq.req.tokens)
        tokens = np.zeros((self.prompt_pad,), np.int64)
        tokens[:T] = seq.req.tokens
        nbp = self.prompt_pad // self.pcfg.page_size
        # blocks shared through the prefix cache map to the trash page:
        # their KV is resident, the blit skips them
        tok0 = self._run("prefill", tokens=tokens, length=T,
                         block_row=self.sched.block_row(seq, nbp))
        self.sched.register_prefix(seq)
        self._first_token(seq, int(tok0.cpu()[0]), time.perf_counter())
        # length stays at T: the decode step writes tok0's KV at position T

    def _finish(self, seq):
        self.results[seq.rid] = np.asarray(seq.emitted, np.int32)
        self.latencies[seq.rid] = time.perf_counter() - seq.req.submit_time
        self.sched.complete(seq)
        self._tables_dirty = True

    def _done(self, seq) -> bool:
        """Whether a row that just emitted is finished."""
        return (len(seq.emitted) >= seq.req.max_new
                or seq.emitted[-1] == self.scfg.eos_id
                or seq.length + 1 > self.pcfg.tokens_per_seq)

    def _decode_vanilla(self, last) -> int:
        """One [R, 1] decode for every running row; returns #new tokens."""
        nxt = self._run("decode", token=last, active=self._active)
        nxt = nxt.cpu().numpy()
        n_tokens = 0
        for seq in list(self.sched.running.values()):
            tok = int(nxt[seq.slot])
            seq.emitted.append(tok)
            seq.last_token = tok
            seq.length += 1
            n_tokens += 1
            if self._done(seq):
                self._step_finished.append(seq.rid)
                self._finish(seq)
        return n_tokens

    def _decode_spec(self, last) -> int:
        """One [R, W] draft-propose + verify for every running row:
        ``accepted + 1`` tokens a row (between 1 and W), the stream of
        plain decoding by the greedy accept rule.  Returns #new tokens."""
        R, W = self.pcfg.max_seqs, self.spec_window
        window = np.zeros((R, W), np.int64)
        caps = np.zeros((R,), np.int64)
        for seq in self.sched.running.values():
            window[seq.slot, 0] = seq.last_token
            window[seq.slot, 1:] = self._propose(seq)
            caps[seq.slot] = self._cap(seq)
        g, a = self._run("verify", window=window, active=self._active,
                         caps=caps)
        g, a = g.cpu().numpy(), a.cpu().numpy()
        n_tokens = 0
        for seq in list(self.sched.running.values()):
            ar = int(a[seq.slot])
            n_tokens += self._accept(seq, window[seq.slot, 1:], ar,
                                     g[seq.slot, ar], int(caps[seq.slot]))
        return n_tokens

    def _stats(self, t0, plan, *, n_tokens, decode_rows, prefill_tokens,
               n_prefills) -> dict:
        alloc = self.sched.alloc
        return {
            "step": self._step_idx,
            "admitted": [s.rid for s in plan.admitted],
            "preempted": plan.preempted,
            "finished": self._step_finished,
            "active": len(self.sched.running),
            "waiting": len(self.sched.waiting),
            "new_tokens": n_tokens,
            "decoded": decode_rows > 0,
            "decode_rows": decode_rows,
            "page_utilization": alloc.utilization,
            # prefix-cache accounting (this plan + cumulative counters)
            "cow_splits": len(plan.cow),
            "cache_hit_tokens": sum(s.cached_tokens for s in plan.admitted),
            "pages_allocated_total": alloc.pages_allocated,
            "pages_shared_total": alloc.pages_shared,
            "pages_window_evicted": self.sched.window_evictions,
            # speculative accounting (this step)
            "spec_proposed": self._spec_proposed,
            "spec_accepted": self._spec_accepted,
            "rns_ops": self._rns_ops(n_prefills),
            "prefill_tokens": prefill_tokens,
            "decode_tokens": n_tokens,
            "ttft_ms": (1e3 * float(np.mean(self._step_ttfts))
                        if self._step_ttfts else 0.0),
            "step_time_s": time.perf_counter() - t0,
        }

    def _step_mixed(self) -> dict:
        """One packed mixed-phase step: admit, COW-split, then ONE run of
        the mixed program over [token_budget] lanes of decode rows
        (first, round-robin) and prefill chunks (FCFS).  The tail lane
        of a prompt's last chunk gives its first token."""
        t0 = time.perf_counter()
        self._step_finished: list[int] = []
        self._step_ttfts: list[float] = []
        self._spec_accepted = self._spec_proposed = 0
        plan = self.sched.schedule()
        if plan.cow:
            # duplicate shared pages BEFORE any packed write lands on them
            self._apply_cow(plan.cow)
        W = self.spec_window
        segs = self.sched.plan_mixed(W)
        N = self.scfg.token_budget
        tok = np.zeros((N,), np.int64)
        sg = np.full((N,), -1, np.int64)
        ps = np.zeros((N,), np.int64)
        dc = np.zeros((N,), bool)
        vd = np.zeros((N,), bool)
        caps: dict[int, int] = {}
        off = prefill_tokens = decode_lanes = 0
        for s in segs:
            s.offset, n = off, s.n
            sg[off:off + n] = s.seq.slot
            ps[off:off + n] = s.positions
            vd[off:off + n] = True
            if s.kind == "decode":
                dc[off:off + n] = True
                tok[off] = s.seq.last_token
                if W > 1:
                    tok[off + 1:off + W] = self._propose(s.seq)
                caps[s.seq.slot] = self._cap(s.seq)
                decode_lanes += n
            else:
                tok[off:off + n] = s.tokens
                prefill_tokens += n
            off += n
        n_tokens = 0
        if segs:
            # tables go up every step: they shift under admission, growth
            # and COW, and the packed step reads positions directly
            bt, lengths, active, _last = self.sched.tables()
            kv.set_tables(self.cache, bt, lengths)
            self._active = active
            self._tables_dirty = False
            g = self._run("mixed", tokens=tok, seg=sg, pos=ps, dec=dc,
                          valid=vd).cpu().numpy()
            now = time.perf_counter()
            for s in segs:
                seq = s.seq
                if s.kind == "chunk":
                    if s.last:
                        self._first_token(seq, int(g[s.offset + s.n - 1]),
                                          now)
                        n_tokens += 1
                    # full blocks become prefix-cache hits as they land
                    self.sched.register_chunks(seq)
                    if seq.emitted and (
                            len(seq.emitted) >= seq.req.max_new
                            or seq.emitted[-1] == self.scfg.eos_id):
                        self._step_finished.append(seq.rid)
                        self._finish(seq)
                else:
                    # the verify step's greedy accept, on the host
                    w = tok[s.offset:s.offset + s.n]
                    gr = g[s.offset:s.offset + s.n]
                    cap, ar = caps[seq.slot], 0
                    while ar < cap and w[ar + 1] == gr[ar]:
                        ar += 1
                    n_tokens += self._accept(seq, w[1:], ar, gr[ar], cap)
        elif self.sched.running:
            raise RuntimeError("mixed step planned no segments while rows "
                               "are running: scheduler liveness bug")
        self._step_idx += 1
        return self._stats(t0, plan, n_tokens=n_tokens,
                           decode_rows=decode_lanes // W,
                           prefill_tokens=prefill_tokens, n_prefills=0)

    def step(self) -> dict:
        """One scheduler step: admit/evict, prefill admits, COW-split
        shared pages, then decode every running row (or, chunked, one
        packed mixed step).  Returns the step's stats, with ``rns_ops``
        the primitive tallies of its phases."""
        if self.chunked:
            return self._step_mixed()
        t0 = time.perf_counter()
        self._step_finished: list[int] = []
        self._step_ttfts: list[float] = []
        self._spec_accepted = self._spec_proposed = 0
        plan = self.sched.schedule()
        if plan.admitted or plan.preempted or plan.grew or plan.cow:
            self._tables_dirty = True
        for seq in plan.admitted:
            self._do_prefill(seq)
        if plan.cow:
            # duplicate shared pages BEFORE any decode write lands on them
            self._apply_cow(plan.cow)
        # admission produced one token per new row: it may be done
        for seq in list(self.sched.running.values()):
            if seq.emitted and (len(seq.emitted) >= seq.req.max_new
                                or seq.emitted[-1] == self.scfg.eos_id):
                self._step_finished.append(seq.rid)
                self._finish(seq)
        n_tokens = 0
        decode_rows = len(self.sched.running)
        if self.sched.running:
            bt, lengths, active, last = self.sched.tables()
            if self._tables_dirty or not np.array_equal(active,
                                                        self._active):
                # topology changed: push fresh tables; otherwise the
                # decode step's own length bump matches the host
                kv.set_tables(self.cache, bt, lengths)
                self._active = active
                self._tables_dirty = False
            if self.scfg.spec_decode:
                n_tokens = self._decode_spec(last)
            else:
                n_tokens = self._decode_vanilla(last)
        self._step_idx += 1
        return self._stats(
            t0, plan, n_tokens=n_tokens, decode_rows=decode_rows,
            prefill_tokens=sum(len(s.req.tokens) for s in plan.admitted),
            n_prefills=len(plan.admitted))

    def run(self, prompts=None, max_new: int | None = None):
        """Serve until drained.  Returns (results {rid: tokens}, stats)."""
        rids = [self.submit(p, max_new) for p in (prompts or [])]
        t0 = time.perf_counter()
        steps = []
        while self.sched.has_work:
            steps.append(self.step())
        dt = time.perf_counter() - t0
        done = rids if rids else list(self.results)
        out = {r: self.results.pop(r) for r in done if r in self.results}
        lat = [self.latencies.pop(r) for r in done if r in self.latencies]
        ttft = [self.ttfts.pop(r) for r in done if r in self.ttfts]
        total = sum(len(v) for v in out.values())
        decode_rows = sum(s["decode_rows"] for s in steps)
        proposed = sum(s["spec_proposed"] for s in steps)
        stats = {
            "n_requests": len(done),
            "n_steps": len(steps),
            "total_new_tokens": total,
            "wall_s": dt,
            "tokens_per_s": total / dt if dt > 0 else 0.0,
            "latency_p50_s": float(np.percentile(lat, 50)) if lat else 0.0,
            "latency_p99_s": float(np.percentile(lat, 99)) if lat else 0.0,
            "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft else 0.0,
            "ttft_p95_s": float(np.percentile(ttft, 95)) if ttft else 0.0,
            "mean_page_utilization": float(
                np.mean([s["page_utilization"] for s in steps]))
            if steps else 0.0,
            "n_preemptions": sum(len(s["preempted"]) for s in steps),
            # speculative decoding: tokens a row per decode step (> 1 iff
            # drafts are accepted) and the acceptance rate over eligible
            # (capped) drafts
            "tokens_per_step": (sum(s["new_tokens"] for s in steps)
                                / decode_rows if decode_rows else 0.0),
            "acceptance_rate": (sum(s["spec_accepted"] for s in steps)
                                / proposed if proposed else 0.0),
            # prefix caching: cumulative allocator and COW traffic
            "cache_hit_tokens": sum(s["cache_hit_tokens"] for s in steps),
            "cow_splits": sum(s["cow_splits"] for s in steps),
            "pages_allocated": self.sched.alloc.pages_allocated,
            "pages_shared": self.sched.alloc.pages_shared,
            # sliding window: pages recycled by eviction, cumulative
            "pages_window_evicted": self.sched.window_evictions,
            "captures": self.captures(),
            "steps": steps,
            **_dist_stats(self.scfg),
        }
        return out, stats
