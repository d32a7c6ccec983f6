"""Serving launcher: continuous batching over the paged KV cache.

The residue-domain MLP datapath (rns9) at the full published width of
smollm-135m, on the card:

    PYTHONPATH=src python -m repro_torch.launch.serve --continuous \\
        --rns rns9 --full --requests 6 --prompt-lens 7,33,120 --new 16

Without ``--full`` it serves the reduced smoke twin, as the JAX CLI
does.  ``--device cpu`` runs the plain PyTorch path instead of the
kernels.  ``--rns-backend cuda_fused --resident-weights`` serves through
the fused kernels on MLP weights encoded once at build; add
``--per-layer-profiles`` to encode each layer on the narrowest profile
that holds it.  On the card the engine captures its prefill and its
decode step once each in CUDA graphs (it prints ``captures decode=1
prefill=1``); ``--eager`` runs them without graphs.  The bucketed engine
is a later slice of the port.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.core.rns_matmul import RnsDotConfig
from repro_torch.models.model import init_model
from repro_torch.serve.engine import ContinuousEngine, ServeConfig

__all__ = ["request_prompts", "serve", "main"]


def request_prompts(vocab: int, requests: int, prompt_lens, seed: int = 0):
    """``requests`` random prompts (from ``seed``) cycling through
    ``prompt_lens``: the traffic :func:`serve` sends."""
    lens = [int(x) for x in prompt_lens]
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (lens[i % len(lens)],)).astype(np.int32)
            for i in range(requests)]


def serve(arch: str = "smollm-135m", *, full: bool = False,
          rns: str | None = None, requests: int = 12,
          prompt_lens=(7, 33, 120), new: int = 16, page_size: int = 16,
          max_seqs: int = 8, n_pages: int | None = None,
          rns_backend: str | None = None, rns_defer: bool | None = None,
          resident_weights: bool = False, per_layer_profiles: bool = False,
          device="cuda", graphs: bool = True):
    """Build the model (random weights from seed 0) and serve
    :func:`request_prompts` (seed 0).  Returns (engine, results, stats).
    ``rns_defer`` (no CLI flag, as in the JAX CLI) selects the deferred
    MLP through ``ServeConfig``; ``graphs=False`` serves eagerly.  The
    engine resolves its kernels' tiles when it captures its steps, so
    the block table in force at this call is the one it serves with."""
    cfg = get_config(arch, smoke=not full)
    if rns:
        cfg = dataclasses.replace(cfg, rns=RnsDotConfig(profile=rns, qx=8,
                                                        qw=8),
                                  rns_targets="mlp")
    model = init_model(cfg, seed=0, device=device)
    lens = [int(x) for x in prompt_lens]
    engine = ContinuousEngine(model, ServeConfig(
        max_cache=max(lens) + new + 8, max_new_tokens=new,
        page_size=page_size, max_seqs=max_seqs, n_pages=n_pages,
        rns_backend=rns_backend, rns_defer=rns_defer,
        resident_weights=resident_weights,
        per_layer_profiles=per_layer_profiles), device=device,
        graphs=graphs)
    results, stats = engine.run(request_prompts(cfg.vocab, requests, lens))
    return engine, results, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over the paged KV cache "
                         "(the only engine of this slice)")
    ap.add_argument("--full", action="store_true",
                    help="the full published config, not the smoke twin")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-lens", default="7,33,120",
                    help="comma list; requests cycle through these lengths")
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-seqs", type=int, default=8)
    ap.add_argument("--n-pages", type=int, default=None)
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
                    help="run the prefill and decode steps without CUDA "
                         "graphs")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.continuous:
        raise SystemExit("the bucketed Engine is a later slice of the port; "
                         "pass --continuous")
    if args.per_layer_profiles and not args.resident_weights:
        ap.error("--per-layer-profiles requires --resident-weights")
    engine, res, stats = serve(
        args.arch, full=args.full, rns=args.rns, requests=args.requests,
        prompt_lens=args.prompt_lens.split(","), new=args.new,
        page_size=args.page_size, max_seqs=args.max_seqs,
        n_pages=args.n_pages, rns_backend=args.rns_backend,
        resident_weights=args.resident_weights,
        per_layer_profiles=args.per_layer_profiles, device=args.device,
        graphs=not args.eager)
    if args.per_layer_profiles:
        from collections import Counter

        from repro_torch.models.resident import resident_profiles

        print("per-layer profiles:",
              dict(Counter(resident_profiles(engine.model).values())))
    print("captures " + " ".join(
        f"{k}={v}" for k, v in sorted(stats["captures"].items())))
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


if __name__ == "__main__":
    main()
