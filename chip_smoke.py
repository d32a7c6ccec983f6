#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit.  Phases (any failure makes the exit code non-zero):

  [build]     compile the three CUDA kernels from the checkout's sources
              (one nvcc each, in parallel) and print ``ptxas -v``;
  [serve]     full-width smollm-135m with the rns9 MLP datapath through
              ContinuousEngine.run on mixed-length requests (after one
              short warm-up request), with every kernel's launch count
              set to 0 just before and read after, and a copy kept of
              each distinct call the wrappers see; then
              the same traffic re-served under torch.profiler for the
              device's idle share;
  [kernels]   hold each kernel bit for bit against its plain PyTorch
              version on the card, on the inputs [serve] gave it (every
              distinct shape) and on boundary cases of every profile, and
              time kernel, plain version and (rns_matmul) torch._int_mm;
  [identity]  the same seeded weights and prompts at a reduced depth on the
              card (kernels) and on the CPU (plain path): one RNS
              projection bit-equal, first-step logits within LOGIT_TOL,
              every greedy token equal.

Then it prints the card's name and power limit, one ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

FULL_LAYERS = 30
# What the JAX engine reports as one decode step's rns_ops for smollm-135m
# rns9 (written down from tests/test_torch_serve.py, which traces the JAX
# engine on the CPU).  Its layer scan is traced once, so this is one layer;
# the port counts every call: FULL_LAYERS times these per decode step.
JAX_DECODE_RNS_OPS = {"converts": 5, "matmuls": 3, "normalizes": 3,
                      "fused": 0, "fallbacks": 0, "weight_converts": 3}

# NVIDIA H100 SXM data-sheet peaks (700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12

SERVE = dict(requests=6, prompt_lens=(7, 33, 120), new=16, max_seqs=8)
IDENTITY_LAYERS = 4
# Card vs CPU first-step logits (|logit| <= ~2 at this config).  The two
# devices' float32 ops (attention, norms) differ in the last bits; the
# 8-bit requantization of every MLP input turns such a difference into a
# rounding flip, and flips cascade over the layers.  [identity] prints
# the size of that effect on the CPU alone (every weight of one float
# matrix moved by one ulp) and the datapath's own 8-bit error against
# plain float; the bar must sit below the latter, so that a card path
# which dropped the RNS datapath fails.
LOGIT_TOL = 0.05


def _time_ms(torch, fn, iters: int) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in a
    CUDA graph and replayed between CUDA events, so that the host's
    launch overhead (Python, ctypes) stays out of the number."""
    for _ in range(3):              # warm: build, table caches, allocator
        fn()
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
    reps = 5
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def _eager_ms(torch, fn, iters: int) -> float:
    """Time of one eager call, host overhead included (CUDA events around
    ``iters`` back-to-back calls): what the serving loop pays."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_abs_err(torch, got, want) -> float:
    """0 when bit-equal; NaNs must sit at the same places."""
    if got.dtype.is_floating_point:
        if not torch.equal(got.isnan(), want.isnan()):
            return float("inf")
        got, want = got.nan_to_num(nan=0.0), want.nan_to_num(nan=0.0)
        same = (got == want)        # equal infs give no error
        diff = (got.double() - want.double()).abs()
        return float(torch.where(same, 0.0, diff).max())
    return float((got.long() - want.long()).abs().max())


def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels.rns_convert import ops as c_ops
    from repro_torch.kernels.rns_matmul import ops as m_ops
    from repro_torch.kernels.rns_normalize import ops as n_ops

    t0 = time.perf_counter()
    logs = build.build_all({"rns_convert": c_ops.SOURCE,
                            "rns_matmul": m_ops.SOURCE,
                            "rns_normalize": n_ops.SOURCE})
    print(f"[build] ok in {time.perf_counter() - t0:.1f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")


def _residues(torch, p, shape, g, dev):
    return torch.stack([torch.randint(0, m, shape, generator=g, device=dev)
                        for m in p.moduli]).to(torch.int32)


def phase_kernels(torch, dev, record, calls):
    """Bit-exactness and times of the three kernels on the inputs [serve]
    gave them, plus boundary cases; fills ``record``."""
    from repro_torch.core.moduli import PROFILES, get_profile
    from repro_torch.core.rns import encode_exact

    if not calls:
        raise AssertionError("no main-path calls recorded: [serve] did not "
                             "run, so there are no main-path inputs")
    g = torch.Generator(device=dev).manual_seed(0)
    mods = _counters()
    bad = []

    def case(kernel, label, fn, plain, nbytes, ops, rate, timed=True,
             library=None, calls_in_serve=None):
        got, want = fn(), plain()
        err = _max_abs_err(torch, got, want)
        entry = {"case": label, "max_abs_err": err}
        if calls_in_serve is not None:
            entry["calls_in_serve"] = calls_in_serve
        if timed:
            b, by = _bound(nbytes, ops, rate)
            entry.update(ms=_time_ms(torch, fn, 20),
                         plain_ms=_time_ms(torch, plain, 5),
                         bound_ms=b, bound_by=by, library_ms=None,
                         eager_ms=_eager_ms(torch, fn, 50))
            if library is not None:
                entry["library_ms"], entry["library_note"] = library()
        record.setdefault(kernel, []).append(entry)
        if err != 0:
            bad.append(f"{kernel} {label}: max_abs_err={err}")
        print(f"  {kernel:14s} {label:40s} " + " ".join(
            f"{k}={v}" for k, v in entry.items() if k != "case"))

    def int_mm(a, b):
        """Per-digit torch._int_mm over [K, M, D] @ [K, D, N] (no mod)."""
        def run():
            return [torch._int_mm(a[s], b[s]) for s in range(a.shape[0])]

        def timed():
            try:
                run()
            except RuntimeError as e:
                return None, f"torch._int_mm refuses this shape: {e}"[:160]
            return (_time_ms(torch, run, 5),
                    "per-digit torch._int_mm (no mod), one call per digit")
        if a.shape[1] <= 16:
            return lambda: (None, "torch._int_mm needs more than 16 rows")
        return timed

    # ---- the main path's own inputs: every distinct call of [serve]
    for entry in sorted(calls.values(),
                        key=lambda e: (e["kernel"], -e["calls"])):
        kernel, prof, args, kw = (entry["kernel"], entry["profile"],
                                  entry["args"], entry["kw"])
        p = get_profile(prof)
        K = p.n_digits
        library = None
        if kernel == "rns_convert":
            x, s = args
            T = x.numel()
            out_bytes = 1 if kw.get("out_dtype", torch.int8) == torch.int8 \
                else 4
            label = f"x{list(x.shape)} scale{list(s.shape)}"
            nbytes = x.element_size() * T + 4 * s.numel() + K * T * out_bytes
            ops, rate = T, F32_OPS_PER_S
        elif kernel == "rns_matmul":
            a, b = args
            _, D, N = b.shape
            M = a.numel() // (K * D)
            label = f"{list(a.shape)}@{list(b.shape)}"
            nbytes = K * (M * D * a.element_size() + D * N * b.element_size()
                          + 4 * M * N)
            ops, rate = 2 * K * M * N * D, INT8_OPS_PER_S
            library = int_mm(a.reshape(K, M, D), b)
        else:
            r, = args
            T = r[0].numel()
            label = f"{list(r.shape)}"
            nbytes = r.element_size() * K * T + 4 * T
            ops, rate = 2 * K * T, F32_OPS_PER_S
        mod = mods[kernel]
        wrapper, plain = getattr(mod, kernel), getattr(mod, kernel + "_plain")
        case(kernel, label,
             lambda w=wrapper: w(prof, *args, **kw),
             lambda f=plain: f(prof, *args, **kw),
             nbytes, ops, rate, library=library,
             calls_in_serve=entry["calls"])

    # ---- boundary cases: every profile, odd shapes, ROADMAP C.1
    c_ops, m_ops, n_ops = (mods[k] for k in ("rns_convert", "rns_matmul",
                                             "rns_normalize"))
    for name in sorted(PROFILES):
        p = get_profile(name)
        x = 50 * torch.randn((4, 3, 96), generator=g, device=dev)
        x.view(-1)[:4] = torch.tensor([0.25, -0.25, 0.75, -63.75])  # k+0.5
        s = torch.tensor(2.0, device=dev)
        od = torch.int8 if p.int8_safe else torch.int32
        case("rns_convert", f"{name} half-way/clip [4,3,96]",
             lambda: c_ops.rns_convert(p, x, s, bits=8, out_dtype=od),
             lambda: c_ops.rns_convert_plain(p, x, s, bits=8, out_dtype=od),
             0, 0, 1, timed=False)
    for name in sorted(n for n, p in PROFILES.items() if p.int8_safe):
        p = get_profile(name)
        a = _residues(torch, p, (37, 300), g, dev).to(torch.int8)
        b = _residues(torch, p, (300, 70), g, dev).to(torch.int8)
        case("rns_matmul", f"{name} [K,37,300]@[K,300,70]",
             lambda: m_ops.rns_matmul(p, a, b),
             lambda: m_ops.rns_matmul_plain(p, a, b), 0, 0, 1, timed=False)
    c1 = torch.as_tensor(encode_exact("rns5", [4_503_599_542_737_792,
                                               -4_503_599_542_737_792]),
                         device=dev)
    case("rns_normalize", "rns5 ROADMAP C.1",
         lambda: n_ops.rns_normalize("rns5", c1),
         lambda: torch.tensor([13505986560.0, -13505986560.0], device=dev),
         0, 0, 1, timed=False)
    for name in sorted(PROFILES):
        p = get_profile(name)
        r = _residues(torch, p, (4096,), g, dev)
        case("rns_normalize", f"{name} uniform [K,4096]",
             lambda: n_ops.rns_normalize(p, r),
             lambda: n_ops.rns_normalize_plain(p, r), 0, 0, 1, timed=False)
    torch.cuda.synchronize()
    if bad:
        raise AssertionError("kernels disagree with their plain versions:\n"
                             + "\n".join(bad))
    print("[kernels] ok: every kernel bit-equal to its plain version")


def _counters():
    from repro_torch.kernels.rns_convert import ops as c_ops
    from repro_torch.kernels.rns_matmul import ops as m_ops
    from repro_torch.kernels.rns_normalize import ops as n_ops

    return {"rns_convert": c_ops, "rns_matmul": m_ops,
            "rns_normalize": n_ops}


@contextlib.contextmanager
def _recording(torch, calls: dict):
    """Keep, for each distinct call the three wrappers see (kernel,
    profile, input shapes and dtypes, options), its number of calls and
    a copy of its first call's inputs: what [kernels] checks and times.
    The wrappers themselves, and their launch counts, are untouched."""
    mods = _counters()
    saved = {name: getattr(mod, name) for name, mod in mods.items()}

    def recorder(name, fn):
        def call(profile, *tensors, **kw):
            key = (name, getattr(profile, "name", profile),
                   tuple((tuple(t.shape), str(t.dtype)) if torch.is_tensor(t)
                         else repr(t) for t in tensors),
                   tuple(sorted((k, repr(v)) for k, v in kw.items())))
            entry = calls.get(key)
            if entry is None:
                calls[key] = entry = {
                    "kernel": name, "profile": profile, "calls": 0,
                    "args": tuple(t.detach().clone() if torch.is_tensor(t)
                                  else t for t in tensors),
                    "kw": dict(kw)}
            entry["calls"] += 1
            return fn(profile, *tensors, **kw)
        return call

    for name, mod in mods.items():
        setattr(mod, name, recorder(name, saved[name]))
    try:
        yield calls
    finally:
        for name, mod in mods.items():
            setattr(mod, name, saved[name])


def phase_serve(torch, launches: dict, calls: dict):
    from repro_torch.launch.serve import serve

    mods = _counters()
    # one short request first, so that first-use costs (kernel libraries
    # loaded, cuBLAS handles, the caching allocator) stay out of the
    # measured run: without it one call's TTFT p50 was 2.1 s, not 0.9 s
    serve("smollm-135m", full=True, rns="rns9", device="cuda", requests=1,
          prompt_lens=(7,), new=2, max_seqs=SERVE["max_seqs"])
    torch.cuda.synchronize()
    for m in mods.values():
        m.launches = 0
    t0 = time.perf_counter()
    with _recording(torch, calls):
        engine, results, stats = serve("smollm-135m", full=True, rns="rns9",
                                       device="cuda", **SERVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.update({k: m.launches for k, m in mods.items()})
    cfg = engine.cfg
    assert cfg.n_layers == FULL_LAYERS and cfg.d_model == 576
    steps = stats["steps"]
    decode_only = [s for s in steps if not s["admitted"] and s["decoded"]]
    per_step = {k: v * FULL_LAYERS for k, v in JAX_DECODE_RNS_OPS.items()}
    for s in steps:
        phases = len(s["admitted"]) + int(s["decoded"])
        want = {k: v * phases for k, v in per_step.items()}
        assert s["rns_ops"].as_dict() == want, (s["step"], s["rns_ops"])
    assert all(v > 0 for v in launches.values()), launches
    calls_by_kernel = {k: sum(e["calls"] for e in calls.values()
                              if e["kernel"] == k) for k in mods}
    assert calls_by_kernel == launches, (calls_by_kernel, launches)
    assert all(s["rns_ops"].fallbacks == 0 for s in steps)
    assert len(results) == SERVE["requests"]
    for toks in results.values():
        assert len(toks) == SERVE["new"]
        assert ((toks >= 0) & (toks < cfg.vocab)).all()
    out = {
        "tokens_per_s": stats["tokens_per_s"],
        "wall_s": stats["wall_s"], "setup_and_run_s": wall,
        "steps": len(steps), "tokens": stats["total_new_tokens"],
        "prompt_pad": engine.prompt_pad, "decode_rows": engine.pcfg.max_seqs,
        "ttft_p50_s": stats["ttft_p50_s"],
        "latency_p50_s": stats["latency_p50_s"],
        "decode_step_ms_median": 1e3 * statistics.median(
            s["step_time_s"] for s in decode_only) if decode_only else None,
        "decode_step_rns_ops": (decode_only[0]["rns_ops"].as_dict()
                                if decode_only else None),
        "launches": dict(launches),
        "distinct_calls": len(calls),
    }
    out.update(_profile_serve(torch, engine, results, stats["wall_s"]))
    print(json.dumps({"serve": out}))
    print("[serve] ok")


def _profile_serve(torch, engine, results, unprofiled_wall_s) -> dict:
    """Device busy share over the [serve] traffic (prefills and decode
    steps, the same prompts), re-served on the warm engine under
    torch.profiler.  The profiler's host cost lengthens that run, so the
    share is given against its own wall time and against the unprofiled
    run's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import request_prompts

    prompts = request_prompts(engine.cfg.vocab, SERVE["requests"],
                              SERVE["prompt_lens"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again, _ = engine.run(prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    same = ([results[r].tolist() for r in sorted(results)]
            == [again[r].tolist() for r in sorted(again)])
    busy_us, by_name = 0.0, {}
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0.0)
        if getattr(ev, "device_type", None) is not None and \
                str(ev.device_type).endswith("CUDA") and dt:
            busy_us += dt
            for k in ("rns_convert", "rns_matmul", "rns_normalize"):
                if k in ev.key:
                    by_name[k] = by_name.get(k, 0.0) + dt / 1e3
    out = {"profiled_run": "the [serve] traffic re-served under "
                           "torch.profiler on the warm engine",
           "profiled_wall_s": wall, "profiled_tokens_equal": same}
    if busy_us == 0:
        out["device_idle_share"] = "no device time in the profile: " \
                                   "not measured"
        return out
    busy_s = busy_us / 1e6
    out.update(device_busy_ms=busy_us / 1e3,
               device_idle_share=1 - busy_s / wall,
               device_idle_share_vs_unprofiled_wall=(
                   1 - busy_s / unprofiled_wall_s),
               kernel_device_ms=by_name)
    return out


def phase_identity(torch):
    from repro_torch.configs.base import get_config
    from repro_torch.core.rns_matmul import RnsDotConfig
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ContinuousEngine, ServeConfig
    import numpy as np

    cfg = dataclasses.replace(get_config("smollm-135m"),
                              n_layers=IDENTITY_LAYERS,
                              rns=RnsDotConfig(profile="rns9", qx=8, qw=8))
    cpu_model = M.init_model(cfg, seed=1, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (7, 33, 60)]
    # the RNS projections alone are device-independent: the same float
    # input gives bit-equal outputs on the card (kernels) and the CPU
    from repro_torch.core.quantize import token_mask
    from repro_torch.core.rns_matmul import rns_multi_dot

    x = torch.randn((3, 5, cfg.d_model),
                    generator=torch.Generator().manual_seed(3))
    ws = (cpu_model.blocks[0].mlp.wi, cpu_model.blocks[0].mlp.wg)
    with token_mask(torch.ones(3, 5, dtype=torch.bool), per_token=True):
        yc = rns_multi_dot(x, ws, cfg.rns)
    with token_mask(torch.ones(3, 5, dtype=torch.bool, device="cuda"),
                    per_token=True):
        yg = rns_multi_dot(x.cuda(), tuple(w.cuda() for w in ws), cfg.rns)
    same = all(torch.equal(g.cpu(), c) for g, c in zip(yg, yc))
    print(f"  rns_multi_dot on one float input, card == cpu bit for bit: "
          f"{same}")
    if not same:
        raise AssertionError("RNS projections differ between card and cpu")
    # what a last-bit difference alone does on the CPU: every weight of
    # layer 0's attention output projection (a float op) moved by one ulp
    nudged = copy.deepcopy(cpu_model)
    w = nudged.blocks[0].attn.wo
    w.data = torch.nextafter(w.data, torch.full_like(w.data, float("inf")))
    worst = quant = ulp = 0.0
    float_cfg = dataclasses.replace(cfg, rns=None)
    for pr in prompts:
        tok = torch.as_tensor(pr[None].astype(np.int64))
        n = torch.tensor([len(pr)])
        lc, _ = M.prefill_ragged(cpu_model, cfg, tok, n)
        lg, _ = M.prefill_ragged(gpu_model, cfg, tok.cuda(), n.cuda())
        lf, _ = M.prefill_ragged(cpu_model, float_cfg, tok, n)
        ln, _ = M.prefill_ragged(nudged, cfg, tok, n)
        worst = max(worst, float((lg.cpu() - lc).abs().max()))
        quant = max(quant, float((lf - lc).abs().max()))
        ulp = max(ulp, float((ln - lc).abs().max()))
    kw = dict(max_cache=80, max_new_tokens=8, page_size=16, max_seqs=4)
    res_g, _ = ContinuousEngine(gpu_model, ServeConfig(**kw),
                                device="cuda").run(prompts)
    res_c, _ = ContinuousEngine(cpu_model, ServeConfig(**kw),
                                device="cpu").run(prompts)
    match = sum(int(a == b) for r in res_c
                for a, b in zip(res_c[r].tolist(), res_g[r].tolist()))
    total = sum(len(v) for v in res_c.values())
    print(f"  first-step logits max |card - cpu| = {worst} "
          f"(tolerance {LOGIT_TOL}); on the cpu alone, one ulp on one "
          f"float weight matrix: {ulp}; rns9 8-bit datapath vs float on "
          f"the cpu: {quant}")
    print(f"  matching greedy tokens: {match}/{total}")
    if not LOGIT_TOL < quant:
        raise AssertionError(f"tolerance {LOGIT_TOL} would not tell the "
                             f"datapath ({quant}) from plain float")
    if not worst <= LOGIT_TOL:
        raise AssertionError(f"first-step logits differ by {worst}")
    if match != total:
        raise AssertionError(f"greedy tokens differ: {match}/{total}")
    print("[identity] ok")


def _kernel_line(record: dict, launches: dict) -> dict:
    meta = {
        "rns_convert": ("src/repro_torch/kernels/rns_convert/csrc/"
                        "rns_convert.cu",
                        "src/repro/kernels/rns_convert/kernel.py:38"),
        "rns_matmul": ("src/repro_torch/kernels/rns_matmul/csrc/rns_matmul.cu",
                       "src/repro/kernels/rns_matmul/kernel.py:51"),
        "rns_normalize": ("src/repro_torch/kernels/rns_normalize/csrc/"
                          "rns_normalize.cu",
                          "src/repro/kernels/rns_normalize/kernel.py:93"),
    }
    out = []
    for name, (src, replaces) in meta.items():
        cases = record.get(name, [])
        timed = [c for c in cases if "ms" in c]
        # the head of the line: the main-path input called most in [serve]
        head = max(timed, key=lambda c: c.get("calls_in_serve", 0),
                   default={})
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": max((c["max_abs_err"] for c in cases),
                               default=None),
            "ms": head.get("ms"), "plain_ms": head.get("plain_ms"),
            "bound_ms": head.get("bound_ms"),
            "bound_by": head.get("bound_by"),
            "library_ms": head.get("library_ms"),
            "case": head.get("case"), "cases": timed})
    return {"kernels": out}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: run it from the root of a checkout "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} on {torch.cuda.get_device_name(0)}")
    record, launches, calls, failed = {}, {}, {}, []
    for name, fn in [("build", phase_build),
                     ("serve", lambda: phase_serve(torch, launches, calls)),
                     ("kernels",
                      lambda: phase_kernels(torch, dev, record, calls)),
                     ("identity", lambda: phase_identity(torch))]:
        print(f"[{name}]", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:           # report the phase, go on with the next
            traceback.print_exc()
            failed.append(name)
            print(f"[{name}] FAILED", flush=True)
        print(f"[{name}] {time.perf_counter() - t0:.1f}s", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi)
    print(json.dumps(_kernel_line(record, launches)))
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
