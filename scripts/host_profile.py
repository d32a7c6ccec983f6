#!/usr/bin/env python3
"""Where the host spends one full-width decode step of the port, on one card.

    python3 scripts/host_profile.py [--top 25] [--steps 5] [--out FILE]

Builds full-width smollm-135m on rns9 (random weights from seed 0) on
each serve path of ``chip_smoke.py`` -- per-op, and fused resident
deferred -- and serves its traffic (6 requests cycling prompt lengths
7/33/120, 16 new tokens, 8 decode rows) through ``ContinuousEngine``,
eager (``graphs=False``) and captured.  Once every request is admitted,
each decode-only step is timed on the host clock (ending in the argmax
pull, which waits for the card), and ``--steps`` of them run under
``cProfile``: the top ``--top`` functions by cumulative time, per step.
cProfile adds a cost to every Python call and none to native code, so
its totals run above the unprofiled step times printed beside them.
Both the cumulative and the self-time rankings are printed.
The card's name and power limit come first; the last line is one JSON
object (with ``--out``, also written to FILE).
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PATHS = {"serve": {},
         "serve_fused": dict(rns_backend="cuda_fused", rns_defer=True,
                             resident_weights=True)}


def _engine(torch, serve_kw: dict, graphs: bool):
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.core.rns_matmul import RnsDotConfig
    from repro_torch.launch.serve import request_prompts
    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import ContinuousEngine, ServeConfig

    cfg = dataclasses.replace(get_config("smollm-135m"),
                              rns=RnsDotConfig(profile="rns9", qx=8, qw=8))
    model = init_model(cfg, seed=0, device="cuda")
    eng = ContinuousEngine(model, ServeConfig(
        max_cache=120 + 16 + 8, max_new_tokens=16, max_seqs=8, **serve_kw),
        device="cuda", graphs=graphs)
    for p in request_prompts(cfg.vocab, 6, (7, 33, 120)):
        eng.submit(p)
    return eng


def _decode_steps(eng, n: int):
    """Step until n decode-only steps have run; yields before each."""
    done = 0
    while eng.sched.has_work and done < n:
        if eng.sched.waiting or not eng.sched.running:
            eng.step()                      # admissions: not measured
            continue
        yield
        done += 1


def profile_path(torch, serve_kw: dict, graphs: bool, steps: int,
                 top: int) -> dict:
    eng = _engine(torch, serve_kw, graphs)
    eng.step()                              # admit all six, prefill them
    wall = []
    for _ in _decode_steps(eng, steps):
        t0 = time.perf_counter()
        eng.step()
        wall.append(time.perf_counter() - t0)
    eng = _engine(torch, serve_kw, graphs)  # the same steps, profiled
    eng.step()
    prof = cProfile.Profile()
    n = 0
    for _ in _decode_steps(eng, steps):
        prof.enable()
        eng.step()
        prof.disable()
        n += 1
    st = pstats.Stats(prof)
    rows = []
    for (file, line, fn), (cc, nc, tt, ct, _) in st.stats.items():
        rows.append({"function": f"{Path(file).name}:{line}({fn})",
                     "calls_per_step": nc / n, "tottime_ms": 1e3 * tt / n,
                     "cumtime_ms": 1e3 * ct / n})
    total = sum(r["tottime_ms"] for r in rows)
    return {"graphs": graphs, "steps": n,
            "step_ms_unprofiled_median": 1e3 * statistics.median(wall),
            "step_ms_profiled": total,
            "top": sorted(rows, key=lambda r: -r["cumtime_ms"])[:top],
            "top_self": sorted(rows, key=lambda r: -r["tottime_ms"])[:top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("host_profile.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi)
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "paths": {}}
    for path, kw in PATHS.items():
        for graphs in (False, True):
            r = profile_path(torch, kw, graphs, args.steps, args.top)
            mode = "captured" if graphs else "eager"
            out["paths"][f"{path}_{mode}"] = r
            print(f"[{path} {mode}] decode step {r['step_ms_unprofiled_median']:.3f}"
                  f" ms unprofiled (median of {r['steps']}), "
                  f"{r['step_ms_profiled']:.3f} ms under cProfile")
            for key in ("top", "top_self"):
                print(f"  by {'cumulative' if key == 'top' else 'self'} "
                      "time, per step:")
                for row in r[key]:
                    print(f"  {row['cumtime_ms']:9.3f} cum "
                          f"{row['tottime_ms']:9.3f} self ms "
                          f"{row['calls_per_step']:8.1f} calls  "
                          f"{row['function']}")
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
