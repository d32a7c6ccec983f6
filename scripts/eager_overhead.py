#!/usr/bin/env python3
"""Host cost of the port's RNS kernel wrappers, in eager calls on one card.

    python3 scripts/eager_overhead.py [--src DIR] [--label NAME]

imports ``repro_torch`` from DIR (default: this checkout's ``src``), so
that two checkouts -- for example a parent commit unpacked under
``build/`` and this one -- can be timed in turns, each in a process of
its own, in one call on one card.  Every RNS wrapper is called on the
decode-step inputs of full-width smollm-135m on rns9 (8 decode rows,
d_model 576, d_ff 1536, int8 weight residues), made from seed 0, with
its tiles left to the wrapper (an empty block table: the defaults, so
both checkouts launch the same kernels).  For each wrapper it prints
the median over REPS runs of CALLS back-to-back eager calls timed
between CUDA events (what a serving loop pays per call, host included)
and the device time per call from CUDA-graph replays, and, where the
checkout has a block table, the host time of one memoized
``autotune.resolve`` (the lookup every wrapper call makes).  The last
line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS, REPS = 500, 7


def _eager_us(torch, fn) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) * 1e3 / CALLS)
    return statistics.median(runs)


def _device_us(torch, fn, iters: int = 20) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (5 * iters)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(
        ROOT / "build" / "eager_overhead_empty_table.json")
    import torch

    if not torch.cuda.is_available():
        print("eager_overhead.py: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.core.moduli import get_profile
    from repro_torch.kernels.rns_convert.ops import rns_convert
    from repro_torch.kernels.rns_fused import ops as f
    from repro_torch.kernels.rns_matmul.ops import rns_matmul
    from repro_torch.kernels.rns_normalize.ops import rns_normalize

    assert Path(repro_torch.__file__).resolve().is_relative_to(src)
    p = get_profile("rns9")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def res(shape, dtype):
        return torch.stack([torch.randint(0, m, shape, generator=g,
                                          device=dev) for m in p.moduli]
                           ).to(dtype)

    x_ff = torch.randn((8, 1, 1536), generator=g, device=dev)
    x_d = torch.randn((8, 1, 576), generator=g, device=dev)
    s_ff = 127.0 / x_ff.abs().amax(dim=-1, keepdim=True)
    s_d = 127.0 / x_d.abs().amax(dim=-1, keepdim=True)
    a_d, a_ff = res((8, 1, 576), torch.int8), res((8, 1, 1536), torch.int32)
    w_up, w_down = res((576, 1536), torch.int8), res((1536, 576), torch.int8)
    r_ff = res((8, 1, 1536), torch.int32)
    calls = {
        "rns_convert [8,1,1536]": lambda: rns_convert(
            p, x_ff, s_ff, bits=8, out_dtype=torch.int8),
        "rns_matmul [9,8,1,576]@[9,576,1536]": lambda: rns_matmul(
            p, a_d, w_up),
        "rns_normalize [9,8,1,1536]": lambda: rns_normalize(p, r_ff),
        "rns_fused_dot x[8,1,576]@[9,576,1536]": lambda: f.rns_fused_dot(
            p, x_d, s_d, w_up, bits=8),
        "rns_fused_encode_matmul x[8,1,576]@[9,576,1536]":
            lambda: f.rns_fused_encode_matmul(p, x_d, s_d, w_up, bits=8),
        "rns_fused_matmul_normalize [9,8,1,1536]@[9,1536,576]":
            lambda: f.rns_fused_matmul_normalize(p, a_ff, w_down),
    }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {}
    for name, fn in calls.items():
        out[name] = {"eager_us": _eager_us(torch, fn),
                     "device_us": _device_us(torch, fn)}
        print(f"  {name:54s} eager {out[name]['eager_us']:.2f} us, device "
              f"{out[name]['device_us']:.2f} us", flush=True)
    resolve_us = None
    try:
        from repro_torch.kernels import autotune
    except ImportError:             # a checkout without the block table
        autotune = None
    if autotune is not None:
        shape = (x_ff.numel(),)
        autotune.resolve("rns_convert", p, shape, dev, bt=None)
        n = 200_000
        t0 = time.perf_counter()
        for _ in range(n):
            autotune.resolve("rns_convert", p, shape, dev, bt=None)
        resolve_us = (time.perf_counter() - t0) * 1e6 / n
        print(f"  autotune.resolve, memo hit: {resolve_us:.3f} us (host)")
    print(json.dumps({"label": args.label or str(src), "card": smi,
                      "calls": CALLS, "reps": REPS, "wrappers": out,
                      "resolve_hit_us": resolve_us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
