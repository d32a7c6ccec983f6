"""Continuous batching over a paged KV cache (phase-barrier engine).

:class:`ContinuousEngine` is the port of ``repro.serve.engine``'s engine
of the same name, on its phase-barrier path: each :meth:`step` admits
and evicts through the host-side scheduler, prefills every admitted
prompt whole (right-padded to ``prompt_pad``; per-row lengths make the
padding inert), then runs ONE batched greedy decode step over every
running row.  Finished rows free their pages the same step; when the
pool runs dry the youngest row is preempted and re-prefilled later.

The prefill (with the blit of its K/V planes into the pages) and the
decode step (with its argmax) are two step programs
(``serve/graphs.py``) over static buffers whose shapes depend only on
the engine's geometry, as the JAX engine jits each once.  On the card
each is captured once in a CUDA graph at engine build and replayed every
step; ``graphs=False`` (or the CPU) runs them eagerly.

Each step reports the RNS primitive calls of its phases (``rns_ops``),
as the JAX engine does: the decode program's tallies plus the prefill
program's once per admitted prompt, each taken once when the program is
built.  The port tallies every call of every layer, so for smollm-135m
that is ``n_layers`` times what the JAX engine reports, whose
trace-time tally sees its layer ``scan`` body once (ROADMAP C.3).

``ServeConfig(rns_backend="cuda_fused", rns_defer=True,
resident_weights=True)`` serves the fused path: MLP weights encoded once
at engine build, the deferred MLP chain, the fused kernels; with
``per_layer_profiles=True`` each layer's weights are encoded on the
narrowest profile that holds its chain (``models/resident.py``).

Chunked prefill, speculative decoding, prefix caching, sliding windows
and digit sharding are later slices of the port: :class:`ServeConfig`
refuses them.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.models import model as M
from repro_torch.serve import kv_cache as kv
from repro_torch.serve.graphs import StepProgram, build_programs
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["ServeConfig", "ContinuousEngine"]


@dataclasses.dataclass
class ServeConfig:
    """Engine knobs.  ``eos_id = -1`` means "never stop early"."""

    max_cache: int = 512
    max_new_tokens: int = 32
    eos_id: int = -1
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
    # later slices of the port: setting any of these raises
    mesh: object | None = None
    prefix_cache: bool = False
    spec_decode: bool = False
    chunked_prefill: bool = False
    window_tokens: int | None = None

    _LATER = ("mesh", "prefix_cache", "spec_decode", "chunked_prefill",
              "window_tokens")

    def __post_init__(self):
        if self.eos_id < -1:
            raise ValueError(
                f"eos_id={self.eos_id}: use a token id, or -1 to disable "
                "early stopping")
        if self.per_layer_profiles and not self.resident_weights:
            raise ValueError(
                "per_layer_profiles selects moduli at weight-encode time; "
                "it requires resident_weights=True")
        on = [f for f in self._LATER if getattr(self, f) not in (None, False)]
        if on:
            raise NotImplementedError(
                f"ServeConfig({', '.join(on)}): later slices of the port; "
                "this slice serves the phase-barrier path")


def _apply_rns_policy(model_cfg, scfg: ServeConfig):
    """Fold the serve-side RNS backend and defer overrides into the
    model config."""
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
    """Encode resident weights once, at engine build, when asked to."""
    if scfg.resident_weights and cfg.rns is not None:
        from repro_torch.models.resident import encode_resident

        encode_resident(model, cfg,
                        per_layer_profiles=scfg.per_layer_profiles)


class ContinuousEngine:
    """In-flight batching over a paged KV cache, on ``device`` (``model``
    is moved there in place, as ``nn.Module.to`` does, and with
    ``resident_weights`` its MLP weights are encoded onto it in place).

    ``graphs=False`` runs the step programs eagerly on the card too: the
    reference a captured engine is held to."""

    def __init__(self, model: M.Model, scfg: ServeConfig, *, device="cuda",
                 graphs: bool = True):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.cfg = _apply_rns_policy(model.cfg, scfg)
        _maybe_resident(self.model, self.cfg, scfg)
        self.scfg = scfg
        bs = scfg.page_size
        max_blocks = -(-scfg.max_cache // bs)
        n_pages = scfg.n_pages or 1 + scfg.max_seqs * max_blocks
        self.pcfg = kv.PagedCacheConfig(page_size=bs, n_pages=n_pages,
                                        max_seqs=scfg.max_seqs,
                                        max_blocks=max_blocks)
        # one prefill shape: every prompt is right-padded to a row's capacity
        self.prompt_pad = self.pcfg.tokens_per_seq
        self.sched = Scheduler(self.pcfg)
        self.cache = kv.make_paged_cache(self.cfg, self.pcfg,
                                         device=self.device)
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
        """The decode and prefill programs over static buffers, warmed up
        and (on the card, with ``graphs``) captured on the trash page: the
        zeroed block table and a zero ``block_row`` send every warm-up
        write to page 0, and ``active`` all False advances no length."""
        R = self.pcfg.max_seqs
        nbp = self.prompt_pad // self.pcfg.page_size
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
        def prefill(tokens, length, block_row):
            logits, ys = M.prefill_ragged(self.model, self.cfg, tokens,
                                          length)
            kv.write_prompt_pages(self.cache.k_pages, block_row,
                                  torch.stack([k[0] for k, _ in ys]))
            kv.write_prompt_pages(self.cache.v_pages, block_row,
                                  torch.stack([v[0] for _, v in ys]))
            return torch.argmax(logits, dim=-1)

        self.programs = {
            "decode": StepProgram("decode", decode, {
                "token": zeros(R, 1), "active": zeros(R, dtype=torch.bool)}),
            "prefill": StepProgram("prefill", prefill, {
                "tokens": zeros(1, self.prompt_pad),
                "length": torch.ones((1,), dtype=torch.int64, device=dev),
                "block_row": zeros(nbp)}),
        }
        # host staging of each step's inputs, pinned on the card so the
        # copies into the static buffers are asynchronous; every step
        # ends in a pull of its argmax, so a buffer is free again by the
        # next step
        pin = dev.type == "cuda"
        self._staging = {
            name: torch.empty(buf.shape, dtype=buf.dtype, pin_memory=pin)
            for prog in self.programs.values()
            for name, buf in prog.inputs.items()}
        self._capture_stream = build_programs(self.programs.values(), dev,
                                              graphs=graphs)

    def captures(self) -> dict[str, int]:
        """Graphs captured per phase (0 everywhere when eager)."""
        return {name: p.captures for name, p in self.programs.items()}

    def _stage(self, **values) -> dict[str, torch.Tensor]:
        """Write host arrays into the staging buffers; returns them."""
        out = {}
        for name, value in values.items():
            buf = self._staging[name]
            buf.numpy()[...] = np.asarray(value).reshape(buf.shape)
            out[name] = buf
        return out

    def _rns_ops(self, n_prefills: int) -> dispatch.OpCounts:
        """This step's RNS tallies: the decode program's plus the prefill
        program's once per admitted prompt (the JAX engine's rule)."""
        if self.cfg.rns is None:
            return dispatch.OpCounts()
        return self.programs["decode"].ops.add(self.programs["prefill"].ops,
                                               times=n_prefills)

    # ------------------------------------------------------------ intake --
    def submit(self, prompt, max_new: int | None = None) -> int:
        """Queue one request; returns its request id."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        max_new = max_new or self.scfg.max_new_tokens
        if len(prompt) > self.prompt_pad:
            raise ValueError(f"prompt length {len(prompt)} > prompt_pad "
                             f"{self.prompt_pad}")
        rid = self._next_rid
        self._next_rid += 1
        self.sched.submit(Request(rid=rid, tokens=prompt, max_new=max_new,
                                  submit_time=time.perf_counter()))
        return rid

    # ----------------------------------------------------------- stepping --
    def _do_prefill(self, seq):
        T = len(seq.req.tokens)
        tokens = np.zeros((self.prompt_pad,), np.int64)
        tokens[:T] = seq.req.tokens
        nbp = self.prompt_pad // self.pcfg.page_size
        tok0 = self.programs["prefill"].run(**self._stage(
            tokens=tokens, length=T,
            block_row=self.sched.block_row(seq, nbp)))
        tok0 = int(tok0.cpu()[0])
        seq.emitted = [tok0]
        seq.last_token = tok0
        ttft = time.perf_counter() - seq.req.submit_time
        self.ttfts[seq.rid] = ttft
        self._step_ttfts.append(ttft)
        # length stays at T: the decode step writes tok0's KV at position T

    def _finish(self, seq):
        self.results[seq.rid] = np.asarray(seq.emitted, np.int32)
        self.latencies[seq.rid] = time.perf_counter() - seq.req.submit_time
        self.sched.complete(seq)
        self._tables_dirty = True

    def _decode_vanilla(self, last) -> int:
        """One [R, 1] decode for every running row; returns #new tokens."""
        nxt = self.programs["decode"].run(**self._stage(
            token=last, active=self._active))
        nxt = nxt.cpu().numpy()
        n_tokens = 0
        for seq in list(self.sched.running.values()):
            tok = int(nxt[seq.slot])
            seq.emitted.append(tok)
            seq.last_token = tok
            seq.length += 1
            n_tokens += 1
            if (len(seq.emitted) >= seq.req.max_new
                    or tok == self.scfg.eos_id
                    or seq.length + 1 > self.pcfg.tokens_per_seq):
                self._step_finished.append(seq.rid)
                self._finish(seq)
        return n_tokens

    def step(self) -> dict:
        """One scheduler step: admit/evict, prefill admits, then decode
        every running row.  Returns the step's stats, with ``rns_ops``
        the primitive tallies of its phases."""
        t0 = time.perf_counter()
        self._step_finished: list[int] = []
        self._step_ttfts: list[float] = []
        plan = self.sched.schedule()
        if plan.admitted or plan.preempted or plan.grew:
            self._tables_dirty = True
        for seq in plan.admitted:
            self._do_prefill(seq)
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
            n_tokens = self._decode_vanilla(last)
        self._step_idx += 1
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
            "page_utilization": self.sched.alloc.utilization,
            "rns_ops": self._rns_ops(len(plan.admitted)),
            "prefill_tokens": sum(len(s.req.tokens) for s in plan.admitted),
            "decode_tokens": n_tokens,
            "ttft_ms": (1e3 * float(np.mean(self._step_ttfts))
                        if self._step_ttfts else 0.0),
            "step_time_s": time.perf_counter() - t0,
        }

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
            "captures": self.captures(),
            "steps": steps,
        }
        return out, stats
