"""Serving launcher: bucketed batching, or continuous batching over the
paged KV cache.

Bucketed (equal-length prompts, the batch run to completion):

    PYTHONPATH=src python -m repro_torch.launch.serve --rns rns9 --full \\
        --batch 8 --prompt-len 33 --new 16

Continuous, the residue-domain MLP datapath (rns9) at the full published
width of smollm-135m, on the card:

    PYTHONPATH=src python -m repro_torch.launch.serve --continuous \\
        --rns rns9 --full --requests 6 --prompt-lens 7,33,120 --new 16

``--arch`` takes any architecture the port registers
(``configs.base.list_archs()``): ``rwkv6-7b`` and ``jamba-v0.1-52b``
have recurrent layers, ``whisper-medium`` an encoder and
``paligemma-3b`` a prefix of patch embeddings, and these serve through
the bucketed engine only (``--continuous`` exits with the engine's
refusal, as the JAX CLI does); ``qwen2.5-32b`` carries its q/k/v bias.
The frontend's embeddings are N(0, 1) stubs drawn after the prompts from
the same generator, as the JAX CLI draws them, and the bucketed cache
counts paligemma's 256 prefix positions (the JAX CLI's does not, and
fails at full width: ROADMAP C.16).  Without ``--full`` it serves the
reduced smoke twin, as the JAX CLI does.  ``--device cpu`` runs the
plain PyTorch path instead of the kernels.  ``--rns-backend cuda_fused
--resident-weights`` serves through
the fused kernels on MLP weights encoded once at build; add
``--per-layer-profiles`` to encode each layer on the narrowest profile
that holds it.  On the card the engine captures its prefill and its
decode step once each in CUDA graphs (it prints ``captures decode=1
prefill=1``); ``--eager`` runs them without graphs.
``--chunked-prefill [--token-budget N] [--chunk-size N]`` serves every
step as one packed mixed-phase step (captured once: ``captures
mixed=1``); ``--prefix-cache`` shares KV pages among prompts with a
common prefix (copy-on-write); ``--spec-decode [--spec-k N]`` decodes
speculatively through one verify step (``captures prefill=1
verify=1``); ``--window-tokens N`` attends the last N tokens and
recycles the pages behind them.  The bucketed engine captures one
prefill per (batch, prompt length) and one decode per batch size
(``captures decode(8)=1 prefill(8,33)=1``); ``--window-tokens`` applies
to it too.

``--digit-shard`` shards the RNS residue channels over the ranks of the
world (``ServeConfig.mesh``: a ``("data", "model")`` mesh of 1 x n,
``launch/mesh.py``): each rank holds K/n moduli and the digits meet once
a normalize.  Under ``torch.distributed.run`` the world is the one it
started, else a world of 1; only rank 0 prints.  Several ranks on one
card share it over gloo, whose collectives go through the host and
cannot be captured, so they serve with ``--eager``:

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 3 \
        -m repro_torch.launch.serve --continuous --rns rns9 --full \
        --digit-shard --eager
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time

import numpy as np

from repro_torch.configs.base import get_config, list_archs
from repro_torch.core.rns_matmul import RnsDotConfig
from repro_torch.data.pipeline import make_frontend_stub
from repro_torch.models.model import init_model
from repro_torch.serve.engine import ContinuousEngine, Engine, ServeConfig

__all__ = ["request_prompts", "build_model", "serve", "serve_bucketed",
           "main"]


def request_prompts(vocab: int, requests: int, prompt_lens, seed: int = 0):
    """``requests`` random prompts (from ``seed``) cycling through
    ``prompt_lens``: the traffic :func:`serve` sends."""
    lens = [int(x) for x in prompt_lens]
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (lens[i % len(lens)],)).astype(np.int32)
            for i in range(requests)]


def build_model(arch: str = "smollm-135m", *, full: bool = False,
                rns: str | None = None, device="cuda"):
    """The model :func:`serve` serves: random weights from seed 0, the
    MLP datapath on ``rns`` (qx = qw = 8) when given."""
    cfg = get_config(arch, smoke=not full)
    if rns:
        cfg = dataclasses.replace(cfg, rns=RnsDotConfig(profile=rns, qx=8,
                                                        qw=8),
                                  rns_targets="mlp")
    return init_model(cfg, seed=0, device=device)


def serve_bucketed(arch: str = "smollm-135m", *, full: bool = False,
                   rns: str | None = None, batch: int = 8,
                   prompt_len: int = 32, new: int = 16,
                   rns_backend: str | None = None,
                   rns_defer: bool | None = None,
                   resident_weights: bool = False,
                   per_layer_profiles: bool = False,
                   window_tokens: int | None = None, prompts=None,
                   max_cache: int | None = None, device="cuda",
                   graphs: bool = True, mesh=None):
    """Build the model (:func:`build_model`) and generate for ``batch``
    random prompts of ``prompt_len`` tokens (seed 0), or the [B, T]
    ``prompts`` when given, through the bucketed :class:`Engine`: once
    (its programs built, captured on the card) and once more warm.  A
    model with a frontend takes stub embeddings [B, F, d] drawn after the
    prompts from the same generator; the cache holds a prefix model's F
    positions too.  Returns (engine,
    tokens [B, new], stats) with each call's wall seconds and tokens/s,
    and the warm call's TTFT and step times.  ``mesh``: digit sharding
    (``ServeConfig.mesh``)."""
    model = build_model(arch, full=full, rns=rns, device=device)
    cfg = model.cfg
    rng = np.random.default_rng(0)
    if prompts is None:
        prompts = rng.integers(0, cfg.vocab, (batch, prompt_len))
    prompts = np.asarray(prompts, np.int32)
    frontend, F = None, 0
    if cfg.frontend is not None:
        frontend = make_frontend_stub(rng, prompts.shape[0],
                                      cfg.n_frontend_tokens, cfg.d_model)
        F = 0 if cfg.enc_dec else cfg.n_frontend_tokens
    engine = Engine(model, ServeConfig(
        max_cache=max_cache or F + prompts.shape[1] + new + 8,
        max_new_tokens=new, rns_backend=rns_backend, rns_defer=rns_defer,
        resident_weights=resident_weights,
        per_layer_profiles=per_layer_profiles,
        window_tokens=window_tokens, mesh=mesh), device=device,
        graphs=graphs)
    stats = {}
    for run in ("first", "warm"):
        t0 = time.perf_counter()
        out = engine.generate(prompts, frontend=frontend)
        dt = time.perf_counter() - t0
        stats[run] = {"wall_s": dt, "tokens_per_s": out.size / dt}
    stats.update(engine.last_stats, captures=engine.captures())
    return engine, out, stats


def serve(arch: str = "smollm-135m", *, full: bool = False,
          rns: str | None = None, requests: int = 12,
          prompt_lens=(7, 33, 120), new: int = 16, page_size: int = 16,
          max_seqs: int = 8, n_pages: int | None = None,
          rns_backend: str | None = None, rns_defer: bool | None = None,
          resident_weights: bool = False, per_layer_profiles: bool = False,
          prefix_cache: bool = False, chunked_prefill: bool = False,
          token_budget: int = 64, chunk_size: int | None = None,
          spec_decode: bool = False, spec_k: int = 3, spec_ngram: int = 3,
          window_tokens: int | None = None, prompt_pad: int | None = None,
          prompts=None, device="cuda", graphs: bool = True, mesh=None):
    """Build the model (random weights from seed 0) and serve
    :func:`request_prompts` (seed 0), or ``prompts`` when given (then
    ``prompt_lens`` is not read).  Returns (engine, results, stats).
    ``rns_defer`` and ``prompt_pad`` (no CLI flags, as in the JAX CLI)
    go to ``ServeConfig``; ``graphs=False`` serves eagerly.  The engine
    resolves its kernels' tiles when it captures its steps, so the block
    table in force at this call is the one it serves with.  ``mesh``:
    digit sharding (``ServeConfig.mesh``)."""
    model = build_model(arch, full=full, rns=rns, device=device)
    cfg = model.cfg
    if prompts is None:
        prompts = request_prompts(cfg.vocab, requests, prompt_lens)
        longest = max(int(x) for x in prompt_lens)
    else:
        longest = max(len(p) for p in prompts)
    engine = ContinuousEngine(model, ServeConfig(
        max_cache=longest + new + 8, max_new_tokens=new,
        page_size=page_size, max_seqs=max_seqs, prompt_pad=prompt_pad,
        n_pages=n_pages, rns_backend=rns_backend, rns_defer=rns_defer,
        resident_weights=resident_weights,
        per_layer_profiles=per_layer_profiles, prefix_cache=prefix_cache,
        chunked_prefill=chunked_prefill, token_budget=token_budget,
        chunk_size=chunk_size, spec_decode=spec_decode, spec_k=spec_k,
        spec_ngram=spec_ngram, window_tokens=window_tokens, mesh=mesh),
        device=device, graphs=graphs)
    results, stats = engine.run(prompts)
    return engine, results, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list_archs())
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over the paged KV cache "
                         "(default: the bucketed engine)")
    ap.add_argument("--batch", type=int, default=8,
                    help="prompts in the bucketed engine's batch")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="the bucketed engine's prompt length")
    ap.add_argument("--full", action="store_true",
                    help="the full published config, not the smoke twin")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-lens", default="7,33,120",
                    help="comma list; requests cycle through these lengths")
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-seqs", type=int, default=8)
    ap.add_argument("--n-pages", type=int, default=None)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="copy-on-write prefix caching: sequences sharing "
                         "a prompt prefix share physical KV pages")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="packed mixed-phase batching: prefill chunks and "
                         "decode rows share ONE captured step over a fixed "
                         "token budget (tokens stay identical to "
                         "whole-prompt prefill)")
    ap.add_argument("--token-budget", type=int, default=64,
                    help="packed lanes per mixed step (--chunked-prefill)")
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="max prefill tokens per row per mixed step; must "
                         "be a multiple of --page-size")
    ap.add_argument("--spec-decode", action="store_true",
                    help="self-speculative (n-gram prompt-lookup) "
                         "decoding through one captured [R, k+1] verify "
                         "step (continuous engine only; tokens stay "
                         "those of plain decoding)")
    ap.add_argument("--spec-k", type=int, default=3,
                    help="draft tokens per speculative step")
    ap.add_argument("--window-tokens", type=int, default=None,
                    help="sliding-window attention: each row attends at "
                         "most this many trailing tokens, and the "
                         "continuous engine recycles the KV pages behind "
                         "the window")
    ap.add_argument("--rns", metavar="PROFILE", default=None,
                    help="run the MLP datapath in residues on PROFILE "
                         "(e.g. rns9)")
    ap.add_argument("--rns-backend", default=None,
                    help="auto (kernels on the card) | reference | cuda | "
                         "cuda_fused (the fused kernels)")
    ap.add_argument("--resident-weights", action="store_true",
                    help="encode the RNS MLP weights once at engine build")
    ap.add_argument("--per-layer-profiles", action="store_true",
                    help="encode each layer on the narrowest RNS profile "
                         "that holds its chain (needs --resident-weights)")
    ap.add_argument("--eager", action="store_true",
                    help="run the step programs without CUDA graphs")
    ap.add_argument("--digit-shard", action="store_true",
                    help="shard RNS residue channels over the ranks of "
                         "the world (torch.distributed.run's, else one); "
                         "needs --rns with a digit count the ranks divide")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.per_layer_profiles and not args.resident_weights:
        ap.error("--per-layer-profiles requires --resident-weights")
    args.mesh = _digit_mesh(args)
    quiet = args.mesh is not None and args.mesh.get_rank() != 0
    with contextlib.redirect_stdout(
            open(os.devnull, "w") if quiet else sys.stdout):
        if not args.continuous:
            _bucketed(args)
            return
        try:
            engine, res, stats = _serve_continuous(args)
        except NotImplementedError as e:    # the engine's refusal
            raise SystemExit(f"{args.arch}: {e}") from None
        _report(args, engine, res, stats)


def _digit_mesh(args):
    """The 1 x n digit mesh over the world's ranks (``--digit-shard``),
    or None."""
    if not args.digit_shard:
        return None
    from repro_torch.distributed.sharding import DigitSharding
    from repro_torch.launch.mesh import init_world, make_digit_mesh

    init_world("gloo" if args.device == "cpu" else None)
    mesh = make_digit_mesh()            # every rank on "model"
    ds = DigitSharding(mesh)
    if mesh.get_rank() == 0:
        print(f"digit sharding over {ds.n_shards} rank(s), "
              f"{ds.backend} collectives (residue channels; "
              "docs/distributed.md)")
    return mesh


def _serve_continuous(args):
    return serve(
        args.arch, full=args.full, rns=args.rns, requests=args.requests,
        prompt_lens=args.prompt_lens.split(","), new=args.new,
        page_size=args.page_size, max_seqs=args.max_seqs,
        n_pages=args.n_pages, rns_backend=args.rns_backend,
        resident_weights=args.resident_weights,
        per_layer_profiles=args.per_layer_profiles,
        prefix_cache=args.prefix_cache,
        chunked_prefill=args.chunked_prefill,
        token_budget=args.token_budget, chunk_size=args.chunk_size,
        spec_decode=args.spec_decode, spec_k=args.spec_k,
        window_tokens=args.window_tokens, device=args.device,
        graphs=not args.eager, mesh=args.mesh)


def _report(args, engine, res, stats):
    if args.per_layer_profiles:
        from collections import Counter

        from repro_torch.models.resident import resident_profiles

        print("per-layer profiles:",
              dict(Counter(resident_profiles(engine.model).values())))
    if args.prefix_cache:
        print(f"prefix cache: hit_tokens={stats['cache_hit_tokens']} "
              f"pages_shared={stats['pages_shared']} "
              f"pages_allocated={stats['pages_allocated']} "
              f"cow_splits={stats['cow_splits']}")
    if args.spec_decode:
        print(f"speculative: tokens/step={stats['tokens_per_step']:.2f} "
              f"acceptance={stats['acceptance_rate']:.2f} "
              f"(window {engine.spec_window})")
    if args.window_tokens:
        print(f"sliding window: {args.window_tokens} tokens retained per "
              f"row, pages_window_evicted={stats['pages_window_evicted']}")
    if args.chunked_prefill:
        mixed = sum(1 for s in stats["steps"]
                    if s["prefill_tokens"] > 0 and s["decode_tokens"] > 0)
        print(f"chunked prefill: budget={engine.scfg.token_budget} lanes "
              f"ttft p50={stats['ttft_p50_s']:.3f}s "
              f"p95={stats['ttft_p95_s']:.3f}s  mixed steps={mixed}")
    print("captures " + " ".join(
        f"{k}={v}" for k, v in sorted(stats["captures"].items())))
    if "collective_backend" in stats:
        print(f"digit shards {stats['digit_shards']} over "
              f"{stats['collective_backend']}")
    print(f"served {stats['n_requests']} requests in {stats['n_steps']} "
          f"steps / {stats['wall_s']:.2f}s -> "
          f"{stats['tokens_per_s']:.1f} tok/s")
    print(f"latency p50={stats['latency_p50_s']:.3f}s "
          f"p99={stats['latency_p99_s']:.3f}s  "
          f"ttft p50={stats['ttft_p50_s']:.3f}s  "
          f"preemptions={stats['n_preemptions']}")
    if stats["steps"]:
        print("rns_ops (last step):",
              stats["steps"][-1]["rns_ops"].as_dict())
    print("sample:", res[0][:16])


def _bucketed(args):
    if args.spec_decode or args.chunked_prefill or args.prefix_cache:
        raise SystemExit("--spec-decode, --chunked-prefill and "
                         "--prefix-cache serve through the continuous "
                         "engine: pass --continuous")
    engine, out, stats = serve_bucketed(
        args.arch, full=args.full, rns=args.rns, batch=args.batch,
        prompt_len=args.prompt_len, new=args.new,
        rns_backend=args.rns_backend, resident_weights=args.resident_weights,
        per_layer_profiles=args.per_layer_profiles,
        window_tokens=args.window_tokens, device=args.device,
        graphs=not args.eager, mesh=args.mesh)
    print(f"{args.arch}: generated {out.shape} tokens in "
          f"{stats['first']['wall_s']:.2f}s "
          f"({stats['first']['tokens_per_s']:.1f} tok/s incl. build)")
    print(f"warm: {stats['warm']['tokens_per_s']:.1f} tok/s, "
          f"ttft={stats['ttft_s']:.3f}s")
    print("captures " + " ".join(
        f"{k}={v}" for k, v in sorted(stats["captures"].items())))
    print("sample:", out[0][:16])


if __name__ == "__main__":
    main()
