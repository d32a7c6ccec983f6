#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit.  Phases (any failure makes the exit code non-zero):

  [build]       compile every CUDA source of the checkout (one nvcc
                each, all in parallel; every compiled tile is a template
                instantiation), print each build's time and
                ``ptxas -v``, and hold each instantiation's registers to
                the tile checker's register model; count the tensor-core
                instructions in the SASS (``cuobjdump -sass``): IMMA in
                rns_matmul and HMMA in flash_attention, neither may be 0;
  [serve]       full-width smollm-135m with the rns9 MLP datapath through
                ContinuousEngine.run on mixed-length requests (after one
                short warm-up request): the per-op path, weights
                re-encoded every step, three kernels.  Every kernel's
                launch count is set to 0 just before and read after, and
                a copy is kept of each distinct call the wrappers see;
                then the same traffic is re-served under torch.profiler
                for the device's idle share;
  [serve_fused] the same traffic on the fused path: resident weights
                (encoded once at engine build), the deferred MLP and the
                fused kernels (``rns_backend="cuda_fused"``), with the
                launches of every decode step held to 30 each of the
                three fused kernels and rns_convert, and none of
                rns_matmul or rns_normalize;
  [tune]        with the block table pointed at a fresh file under
                build/, tune every kernel kind at every shape bucket the
                two serves gave the wrappers (on the recorded inputs),
                and flash_attention at smollm-135m's attention geometry
                (Tq = Tk = 120 and 2048, causal): every legal candidate
                is held against the plain version and timed, and every
                candidate the checker drops is printed with its reason;
  [serve_tuned] the [serve] and [serve_fused] traffic again, once each,
                with the tuned table in force (and re-served under
                torch.profiler, as the untuned serves are): greedy
                tokens bit-equal to the untuned serves, the same
                launches per decode step, every launch on its bucket's
                row, and its numbers beside the untuned run's;
  [kernels]     hold all seven kernels against their plain PyTorch
                versions on the card -- the six RNS kernels bit for bit
                on the inputs both serves gave them (every distinct
                shape), at every candidate tiling on one main-path input
                each, and on boundary cases of every profile (rns8_u8's
                int32 residues included; rns_matmul at every candidate
                tile, its K steps split among blocks);
                flash_attention within 2e-5 (float32; plus one step of
                the type in bfloat16) on ragged and full-width shapes,
                at every candidate tile --
                and time kernel, plain
                version and the library yardstick (torch._int_mm,
                scaled_dot_product_attention);
  [identity]    the same seeded weights and prompts at a reduced depth:
                per-op path on the card (kernels) vs the CPU (plain path)
                -- one RNS projection bit-equal, first-step logits within
                LOGIT_TOL, every greedy token equal; on the card, the
                fused resident per-op path vs the re-encode per-op path
                -- logits and tokens bit-equal; the deferred fused path on
                the card vs the CPU -- logits within LOGIT_TOL, every
                greedy token equal.

Then it prints the card's name and power limit, one ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import re
import shutil
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
# The same for the fused path (resident weights, deferred MLP, fused
# backend), from tests/test_torch_fused.py: per layer, wi is a fused
# encode+matmul, wg a fused dot, the gate one convert, wo a fused
# matmul+normalize.
JAX_FUSED_DECODE_RNS_OPS = {"converts": 2, "matmuls": 3, "normalizes": 2,
                            "fused": 3, "fallbacks": 0, "weight_converts": 0}
FUSED_SERVE = dict(rns_backend="cuda_fused", rns_defer=True,
                   resident_weights=True)
# kernel launches of one full-width decode step on each path
DECODE_LAUNCHES = {
    "serve": {"rns_convert": 150, "rns_matmul": 90, "rns_normalize": 90,
              "rns_fused_encode_matmul": 0, "rns_fused_matmul_normalize": 0,
              "rns_fused_dot": 0, "flash_attention": 0},
    "serve_fused": {"rns_convert": 30, "rns_matmul": 0, "rns_normalize": 0,
                    "rns_fused_encode_matmul": 30,
                    "rns_fused_matmul_normalize": 30, "rns_fused_dot": 30,
                    "flash_attention": 0},
}
RNS_KERNELS = ("rns_convert", "rns_matmul", "rns_normalize",
               "rns_fused_encode_matmul", "rns_fused_matmul_normalize",
               "rns_fused_dot")
# the block table [tune] writes and [serve_tuned] serves with
TUNE_CACHE = ROOT / "build" / "chip_smoke_autotune.json"
# flash_attention at smollm-135m's attention geometry (9 query heads, 3
# KV heads of 64), at a prompt of the serve traffic and at the model's
# published 2048-token context: (B, Tq, Tk, H, Hk, D)
FLASH_FULL = [(1, 120, 120, 9, 3, 64), (1, 2048, 2048, 9, 3, 64)]
# the ragged shapes of tests/test_flash_kernel.py
FLASH_RAGGED = [(1, 128, 128, 2, 1, 16), (2, 96, 200, 4, 2, 32),
                (1, 17, 33, 2, 2, 64), (1, 130, 257, 2, 1, 32),
                (2, 7, 5, 2, 2, 16), (1, 65, 64, 2, 1, 16)]

# NVIDIA H100 SXM data-sheet peaks (700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
# the tensor-core instruction each kernel's SASS must hold
SASS_MMA = {"rns_matmul": "IMMA", "flash_attention": "HMMA"}

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


def _register_model(entry: str):
    """The tile checker's registers per thread for one compiled entry
    (its mangled name), or None for an entry the model does not cover."""
    from repro_torch.analysis import kernel_audit as ka

    if (m := re.search(r"rns_convert_kernelI(.)E", entry)):
        return ka.registers_per_thread("rns_convert",
                                       res_bytes=1 if m[1] == "a" else 4)
    if (m := re.search(r"rns_normalize_kernelILi(\d+)E", entry)):
        return ka.registers_per_thread("rns_normalize", int(m[1]))
    if (m := re.search(r"rns_fused_kernelI..Li(\d+)E", entry)):
        K = int(m[1])
        return ka.registers_per_thread(
            "rns_fused_dot" if K else "rns_fused_encode_matmul", K)
    if "rns_matmul_kernel" in entry:
        return ka.registers_per_thread("rns_matmul")
    if "flash_attention_kernel" in entry:
        return ka.registers_per_thread("flash_attention")
    return None


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build

    sources = {m.SOURCE.stem: m.SOURCE for m in set(_kernel_mods().values())}

    def one(name):              # one nvcc each, all started together
        t = time.perf_counter()
        log = build.build_all({name: sources[name]})[name]
        return log, time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        done = dict(zip(sources, pool.map(one, sources)))
    logs = {name: log for name, (log, _) in done.items()}
    print(f"[build] ok in {time.perf_counter() - t0:.1f}s: "
          f"{len(logs)} libraries (" + ", ".join(
              f"{n} {t:.1f}s" for n, (_, t) in sorted(done.items())) + ")")
    over = []
    for name, log in sorted(logs.items()):   # one line per compiled kernel
        entry = spill = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill stores" in line:
                spill = line.split(",")[1].strip()
            elif "registers" in line and entry:
                regs = int(line.split("Used")[1].split("registers")[0])
                model = _register_model(entry)
                print(f"  {name}: {entry} {regs} registers (model "
                      f"{model}), {spill}")
                if model is None or regs > model:
                    over.append(f"{name} {entry}: {regs} > {model}")
    if over:
        raise AssertionError("instantiations over the tile checker's "
                             "register model:\n" + "\n".join(over))
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name, op in SASS_MMA.items():
        lib = build.library_path(name, sources[name])
        sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True, timeout=300)
        n = sum(op in line for line in sass.stdout.splitlines())
        print(f"  {name}: {n} {op} instructions in the SASS "
              f"(cuobjdump -sass {lib.name})")
        if not n:
            raise AssertionError(f"{name}: no {op} instruction in its SASS "
                                 f"(cuobjdump rc {sass.returncode}: "
                                 f"{sass.stderr.strip()[:200]})")


def _kernel_mods():
    """{kernel (wrapper) name: ops module}; the module's ``launches`` is
    an int, or a dict by wrapper name for the fused kernels."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rns_convert import ops as c_ops
    from repro_torch.kernels.rns_fused import ops as f_ops
    from repro_torch.kernels.rns_matmul import ops as m_ops
    from repro_torch.kernels.rns_normalize import ops as n_ops

    return {"rns_convert": c_ops, "rns_matmul": m_ops,
            "rns_normalize": n_ops, "rns_fused_encode_matmul": f_ops,
            "rns_fused_matmul_normalize": f_ops, "rns_fused_dot": f_ops,
            "flash_attention": fa_ops}


def _launches() -> dict:
    out = {}
    for name, mod in _kernel_mods().items():
        n = mod.launches
        out[name] = n[name] if isinstance(n, dict) else n
    return out


def _reset_launches():
    for name, mod in _kernel_mods().items():
        if isinstance(mod.launches, dict):
            mod.launches[name] = 0
        else:
            mod.launches = 0


def _residues(torch, p, shape, g, dev):
    return torch.stack([torch.randint(0, m, shape, generator=g, device=dev)
                        for m in p.moduli]).to(torch.int32)


def _cost(torch, kernel, K, args, kw):
    """(label, bytes, ops, rate) of one call: each input read once, each
    output written once; matmul ops at the int8 rate."""
    if kernel == "rns_convert":
        x, s = args
        T = x.numel()
        out_bytes = 1 if kw.get("out_dtype", torch.int8) == torch.int8 \
            else 4
        return (f"x{list(x.shape)} scale{list(s.shape)}",
                x.element_size() * T + 4 * s.numel() + K * T * out_bytes,
                T, F32_OPS_PER_S)
    if kernel == "rns_normalize":
        r, = args
        T = r[0].numel()
        return (f"{list(r.shape)}", r.element_size() * K * T + 4 * T,
                2 * K * T, F32_OPS_PER_S)
    if kernel in ("rns_matmul", "rns_fused_matmul_normalize"):
        a, b = args
        _, D, N = b.shape
        M = a.numel() // (K * D)
        out = K * M * N * 4 if kernel == "rns_matmul" else M * N * 4
        return (f"{list(a.shape)}{a.dtype}@{list(b.shape)}",
                a.element_size() * K * M * D + b.element_size() * K * D * N
                + out, 2 * K * M * N * D, INT8_OPS_PER_S)
    x, s, b = args                  # rns_fused_encode_matmul / rns_fused_dot
    _, D, N = b.shape
    M = x.numel() // D
    out = K * M * N * 4 if kernel == "rns_fused_encode_matmul" else M * N * 4
    return (f"x{list(x.shape)} scale{list(s.shape)}@{list(b.shape)}",
            4 * M * D + 4 * s.numel() + b.element_size() * K * D * N + out,
            2 * K * M * N * D, INT8_OPS_PER_S)


def _flash_inputs(torch, dev, shape, dtype, seed):
    """q [B,Tq,H,D], k and v [B,Tk,Hk,D], standard normal from ``seed``."""
    B, Tq, Tk, H, Hk, D = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device=dev).to(dtype)
                 for s in ((B, Tq, H, D), (B, Tk, Hk, D), (B, Tk, Hk, D)))


def _blk(blocks) -> str:
    return "/".join(f"{k}{v}" for k, v in blocks.items())


def phase_tune(torch, dev, calls, launches, tuned):
    """Tune every kind at every bucket of the recorded main-path calls
    (on the call of each bucket called most) and flash_attention at
    FLASH_FULL, into the fresh table TUNE_CACHE; fills ``tuned``
    (bucket -> default and tuned blocks, each candidate's time)."""
    from repro_torch.kernels import autotune, wrappers

    if not calls:
        raise AssertionError("no main-path calls recorded: nothing to tune")
    fns = wrappers()
    by_bucket = {}          # bucket key -> (kind, profile, (args, kw))
    for entry in sorted(calls.values(), key=lambda e: -e["calls"]):
        kind = entry["kernel"]
        fns[kind][0](entry["profile"], *entry["args"], **entry["kw"])
        by_bucket.setdefault(autotune.last_launch[kind][0], (
            kind, entry["profile"], (entry["args"], entry["kw"])))
    for i, shape in enumerate(FLASH_FULL):
        qkv = _flash_inputs(torch, dev, shape, torch.float32, 10 + i)
        fns["flash_attention"][0]("float32", *qkv, causal=True)
        by_bucket.setdefault(autotune.last_launch["flash_attention"][0], (
            "flash_attention", "float32", (qkv, {"causal": True})))
    torch.cuda.synchronize()
    _reset_launches()
    for bucket, (kind, prof, call) in by_bucket.items():
        shape = tuple(int(d) for d in bucket.split("|")[2].split("x"))
        bench = autotune.default_bench(kind, prof, shape, "cuda", call=call)
        times: dict = {}

        def timed(blocks, bench=bench, times=times):
            t = bench(blocks)
            times[_blk(blocks)] = min(t, times.get(_blk(blocks), t))
            return t

        best = autotune.tune(kind, prof, shape, "cuda", bench_fn=timed)
        _, dropped = autotune.legal_candidates(kind, prof, shape)
        default = autotune.DEFAULTS[kind]
        tuned[bucket] = {
            "kind": kind, "default": dict(default), "tuned": best,
            "default_us": (times[_blk(default)] * 1e6
                           if _blk(default) in times else None),
            "tuned_us": times[_blk(best)] * 1e6,
            "us": {k: v * 1e6 for k, v in times.items()},
            "dropped": [[c, why] for c, why in dropped]}
        print(f"  {bucket}: " + " ".join(
            f"{k}={v * 1e6:.2f}us" for k, v in times.items())
            + f" -> {_blk(best)} (default {_blk(default)})")
        for cand, why in dropped:
            print(f"    dropped {cand}: {why}")
    torch.cuda.synchronize()
    launches["tune"] = run = _launches()
    rows = json.loads(TUNE_CACHE.read_text())["entries"]
    missing = sorted(set(by_bucket) - set(rows))
    if missing:
        raise AssertionError(f"no table row for {missing}")
    kinds = {v[0] for v in by_bucket.values()}
    if kinds != set(autotune.DEFAULTS) or not all(run.values()):
        raise AssertionError(f"tuned kinds {sorted(kinds)}, launches {run}")
    print(f"[tune] ok: {len(by_bucket)} rows in {TUNE_CACHE.name} for "
          f"{len(kinds)} kinds; launches {run}")


@contextlib.contextmanager
def _table(path: Path):
    """Resolve tiles through the block table at ``path`` (a missing file
    is an empty table: the defaults)."""
    from repro_torch.kernels import autotune

    saved = os.environ["REPRO_TORCH_AUTOTUNE_CACHE"]
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(path)
    autotune.clear_cache()
    try:
        yield
    finally:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = saved
        autotune.clear_cache()


METRICS = ("tokens_per_s", "ttft_p50_s", "decode_step_ms_median",
           "device_busy_ms")


def phase_serve_tuned(torch, launches, calls, untuned):
    """[serve] and [serve_fused] once more each, with the table [tune]
    wrote: tokens bit-equal to the untuned serves, every launch on its
    bucket's row, the numbers beside the untuned run's."""
    for path, kw, ops in (("serve", {}, JAX_DECODE_RNS_OPS),
                          ("serve_fused", FUSED_SERVE,
                           JAX_FUSED_DECODE_RNS_OPS)):
        if path not in untuned:
            raise AssertionError(f"[{path}] did not run: nothing to "
                                 "compare with")
        base, base_tokens = untuned[path]
        with _table(TUNE_CACHE):
            run, tokens = phase_serve(torch, path, launches, calls, kw, ops,
                                      rerun="tuned")
        if tokens != base_tokens:
            raise AssertionError(f"{path} tuned: greedy tokens differ from "
                                 "the untuned serve's")
        for name in METRICS:
            print(f"  {path} {name}: untuned {base.get(name, 'not measured')}"
                  f", tuned {run.get(name, 'not measured')}")
        print(f"  {path}: launches per decode step "
              f"{sum(run['decode_step_launches'].values())}; greedy tokens "
              "bit-equal to the untuned serve")


def phase_kernels(torch, dev, record, calls, launches):
    """The six RNS kernels bit for bit on the inputs the two serves gave
    them, at every candidate tiling and on boundary cases; flash_attention
    within tolerance on ragged and full-width shapes; times of the
    main-path inputs and of flash at full width.  Fills ``record``."""
    import torch.nn.functional as F

    from repro_torch.core.moduli import PROFILES, get_profile
    from repro_torch.core.rns import encode_exact
    from repro_torch.kernels import autotune
    from repro_torch.kernels.flash_attention import ops as fa_ops

    if not calls:
        raise AssertionError("no main-path calls recorded: the serves did "
                             "not run, so there are no main-path inputs")
    _reset_launches()
    g = torch.Generator(device=dev).manual_seed(0)
    mods = _kernel_mods()
    bad = []

    def case(kernel, label, fn, plain, nbytes=0, ops=0, rate=1, timed=True,
             library=None, calls_in_serve=None, check=None, note=None):
        """``check(got, want) -> (ok, extra)``; by default bit-equal.
        ``note`` says which rate ``rate`` is, for the bound."""
        got, want = fn(), plain()
        err = _max_abs_err(torch, got, want)
        entry = {"case": label, "max_abs_err": err}
        ok = err == 0
        if check is not None:
            ok, extra = check(got, want)
            entry.update(extra)
        if calls_in_serve is not None:
            entry["calls_in_serve"] = calls_in_serve
        if timed:
            b, by = _bound(nbytes, ops, rate)
            entry.update(ms=_time_ms(torch, fn, 20),
                         plain_ms=_time_ms(torch, plain, 5),
                         bound_ms=b, bound_by=by, library_ms=None,
                         eager_ms=_eager_ms(torch, fn, 50))
            if note is not None:
                entry["bound_note"] = note
            if library is not None:
                entry["library_ms"], entry["library_note"] = library()
        record.setdefault(kernel, []).append(entry)
        if not ok:
            bad.append(f"{kernel} {label}: " + " ".join(
                f"{k}={v}" for k, v in entry.items() if k != "case"))
        print(f"  {kernel:26s} {label:52s} " + " ".join(
            f"{k}={v}" for k, v in entry.items() if k != "case"))

    def int_mm(a, b):
        """Per-digit torch._int_mm over [K, M, D] @ [K, D, N] (no mod);
        ``a`` zero-padded to 32 rows where it has 16 or fewer, which
        _int_mm refuses."""
        note = "per-digit torch._int_mm (no mod), one call per digit"
        if a.shape[1] <= 16:
            pad = torch.zeros((a.shape[0], 32, a.shape[2]), dtype=a.dtype,
                              device=a.device)
            pad[:, :a.shape[1]] = a
            a = pad
            note += ", a zero-padded to 32 rows (_int_mm needs > 16)"

        def run():
            return [torch._int_mm(a[s], b[s]) for s in range(a.shape[0])]

        def timed():
            try:
                run()
            except RuntimeError as e:
                return None, f"torch._int_mm refuses this shape: {e}"[:160]
            return _time_ms(torch, run, 5), note
        return timed

    # ---- the main paths' own inputs: every distinct call of both serves
    for entry in sorted(calls.values(),
                        key=lambda e: (e["kernel"], -e["calls"])):
        kernel, prof, args, kw = (entry["kernel"], entry["profile"],
                                  entry["args"], entry["kw"])
        K = get_profile(prof).n_digits
        label, nbytes, ops, rate = _cost(torch, kernel, K, args, kw)
        library = None
        if kernel == "rns_matmul":
            a, b = args
            library = int_mm(a.reshape(K, -1, b.shape[1]), b)
        mod = mods[kernel]
        wrapper, plain = getattr(mod, kernel), getattr(mod, kernel + "_plain")
        case(kernel, label,
             lambda w=wrapper: w(prof, *args, **kw),
             lambda f=plain: f(prof, *args, **kw),
             nbytes, ops, rate, library=library,
             calls_in_serve=entry["calls"])

    # ---- every candidate tiling, on each kernel's most called input
    heads = {}
    for entry in sorted(calls.values(), key=lambda e: -e["calls"]):
        heads.setdefault(entry["kernel"], entry)
    for kernel, entry in sorted(heads.items()):
        prof, args, kw = entry["profile"], entry["args"], entry["kw"]
        label = _cost(torch, kernel, get_profile(prof).n_digits, args, kw)[0]
        mod = mods[kernel]
        wrapper, plain = getattr(mod, kernel), getattr(mod, kernel + "_plain")
        want = plain(prof, *args, **kw)
        for cand in autotune.CANDIDATES[kernel]:
            case(kernel, f"{label} tile {_blk(cand)}",
                 lambda w=wrapper, c=cand: w(prof, *args, **kw, **c),
                 lambda: want, timed=False)

    # ---- flash_attention: ragged shapes (untimed), full width (timed)
    def flash_check(got, want):
        ok, _ = fa_ops.within_tolerance(got, want)
        return ok, {"bar": f"{fa_ops.ATOL}" + (
            "" if got.dtype == torch.float32 else " + one step of bfloat16")}

    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for i, shape in enumerate(FLASH_RAGGED + FLASH_FULL):
                B, Tq, Tk, H, Hk, D = shape
                q, k, v = _flash_inputs(torch, dev, shape, dtype, 100 + i)
                esize = q.element_size()
                nbytes = esize * (2 * B * Tq * H * D + 2 * B * Tk * Hk * D)
                flops = 4 * B * H * Tq * Tk * D / (2 if causal else 1)
                if dtype == torch.float32:
                    # the faster of the CUDA cores and 3xTF32 (three TF32
                    # products per product) on the tensor cores
                    rate = max(F32_OPS_PER_S, TF32_OPS_PER_S / 3)
                    note = ("3 x ops / 495 TFLOP/s (3xTF32)"
                            if rate > F32_OPS_PER_S
                            else "ops / 67 TFLOP/s (float32)")
                else:
                    rate, note = BF16_OPS_PER_S, "ops / 989 TFLOP/s (bf16)"

                def sdpa(q=q, k=k, v=v, causal=causal):
                    return F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), is_causal=causal,
                        enable_gqa=True).transpose(1, 2)

                full = shape in FLASH_FULL
                case("flash_attention",
                     f"{str(dtype)[6:]} causal={causal} q[{B},{Tq},{H},{D}] "
                     f"kv[{B},{Tk},{Hk},{D}]",
                     lambda q=q, k=k, v=v, c=causal: fa_ops.flash_attention(
                         q, k, v, causal=c),
                     lambda q=q, k=k, v=v, c=causal:
                     fa_ops.flash_attention_plain(q, k, v, causal=c),
                     nbytes, flops, rate, timed=full, check=flash_check,
                     note=note,
                     library=(lambda f=sdpa: (
                         _time_ms(torch, f, 5),
                         "torch scaled_dot_product_attention, enable_gqa"))
                     if full else None)
                # every candidate tile the checker allows at this shape
                want = fa_ops.flash_attention_plain(q, k, v, causal=causal)
                legal, _ = autotune.legal_candidates(
                    "flash_attention", str(dtype)[6:], (Tq, Tk, D))
                for cand in legal:
                    case("flash_attention",
                         f"{str(dtype)[6:]} causal={causal} q[{B},{Tq},{H},"
                         f"{D}] tile {_blk(cand)}",
                         lambda q=q, k=k, v=v, c=causal, b=cand:
                         fa_ops.flash_attention(q, k, v, causal=c, **b),
                         lambda w=want: w, timed=False, check=flash_check)

    # ---- boundary cases: every profile, odd shapes, ROADMAP C.1
    c_ops, m_ops, n_ops, f_ops = (mods[k] for k in (
        "rns_convert", "rns_matmul", "rns_normalize", "rns_fused_dot"))
    for name in sorted(PROFILES):
        p = get_profile(name)
        x = 50 * torch.randn((4, 3, 96), generator=g, device=dev)
        x.view(-1)[:4] = torch.tensor([0.25, -0.25, 0.75, -63.75])  # k+0.5
        s = torch.tensor(2.0, device=dev)
        od = torch.int8 if p.int8_safe else torch.int32
        case("rns_convert", f"{name} half-way/clip [4,3,96]",
             lambda: c_ops.rns_convert(p, x, s, bits=8, out_dtype=od),
             lambda: c_ops.rns_convert_plain(p, x, s, bits=8, out_dtype=od),
             timed=False)
    for name in sorted(PROFILES):       # rns8_u8: int32 residues to 255
        p = get_profile(name)
        rd = torch.int8 if p.int8_safe else torch.int32
        # ragged rows and columns; D = 1100 is 9 K steps, shared among
        # blocks (splits_for) since K x 2 column tiles leave SMs idle
        a = _residues(torch, p, (37, 1100), g, dev).to(rd)
        b = _residues(torch, p, (1100, 70), g, dev).to(rd)
        want = m_ops.rns_matmul_plain(p, a, b)
        for cand in autotune.CANDIDATES["rns_matmul"]:
            case("rns_matmul", f"{name} [K,37,1100]{rd}@[K,1100,70] tile "
                 f"{_blk(cand)}",
                 lambda c=cand: m_ops.rns_matmul(p, a, b, **c),
                 lambda: want, timed=False)
    c1 = torch.as_tensor(encode_exact("rns5", [4_503_599_542_737_792,
                                               -4_503_599_542_737_792]),
                         device=dev)
    c1_want = torch.tensor([13505986560.0, -13505986560.0], device=dev)
    case("rns_normalize", "rns5 ROADMAP C.1",
         lambda: n_ops.rns_normalize("rns5", c1), lambda: c1_want,
         timed=False)
    one = torch.as_tensor(encode_exact("rns5", [[1]]).astype("int8"),
                          device=dev)
    case("rns_fused_matmul_normalize", "rns5 ROADMAP C.1",
         lambda: f_ops.rns_fused_matmul_normalize(
             "rns5", c1.reshape(-1, 2, 1), one).reshape(-1),
         lambda: c1_want, timed=False)
    for name in sorted(PROFILES):
        p = get_profile(name)
        r = _residues(torch, p, (4096,), g, dev)
        case("rns_normalize", f"{name} uniform [K,4096]",
             lambda: n_ops.rns_normalize(p, r),
             lambda: n_ops.rns_normalize_plain(p, r), timed=False)
        # the fused kernels at ragged M, D, N, row scales, both a dtypes
        x = torch.randn((13, 130), generator=g, device=dev)
        s = 127.0 / x.abs().amax(dim=1, keepdim=True)
        bd = torch.int8 if p.int8_safe else torch.int32
        b = _residues(torch, p, (130, 37), g, dev).to(bd)
        for kernel in ("rns_fused_dot", "rns_fused_encode_matmul"):
            case(kernel, f"{name} x[13,130] rows @[K,130,37]",
                 lambda k=kernel: getattr(f_ops, k)(p, x, s, b, bits=8),
                 lambda k=kernel: getattr(f_ops, k + "_plain")(p, x, s, b,
                                                               bits=8),
                 timed=False)
        for ad in ((torch.int8, torch.int32) if p.int8_safe
                   else (torch.int32,)):
            a = _residues(torch, p, (13, 37), g, dev).to(ad)
            b2 = _residues(torch, p, (37, 21), g, dev).to(bd)
            case("rns_fused_matmul_normalize",
                 f"{name} [K,13,37]{ad}@[K,37,21]",
                 lambda: f_ops.rns_fused_matmul_normalize(p, a, b2),
                 lambda: f_ops.rns_fused_matmul_normalize_plain(p, a, b2),
                 timed=False)
    torch.cuda.synchronize()
    launches["kernels"] = _launches()
    if bad:
        raise AssertionError("kernels disagree with their plain versions:\n"
                             + "\n".join(bad))
    print("[kernels] ok: every RNS kernel bit-equal to its plain version, "
          "flash_attention within its tolerance")


@contextlib.contextmanager
def _recording(torch, calls: dict, off_table: list | None = None):
    """Keep, for each distinct call the six RNS wrappers see (kernel,
    profile, input shapes and dtypes, options), its number of calls and
    a copy of its first call's inputs: what [kernels] checks and times.
    With ``off_table``, also hold every launch's blocks to the block
    table in force -- its row for the launch's bucket, or the defaults
    when the table is empty -- appending each launch that is not.  The
    wrappers themselves, and their launch counts, are untouched."""
    from repro_torch.kernels import autotune

    mods = _kernel_mods()
    saved = {name: getattr(mods[name], name) for name in RNS_KERNELS}
    table = autotune._load() if off_table is not None else None

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
            before = _launches()[name]
            out = fn(profile, *tensors, **kw)
            if table is not None and _launches()[name] > before:
                bucket, blocks = autotune.last_launch[name]
                row = table.get(bucket)
                want = dict(autotune.DEFAULTS[name],
                            **(row["blocks"] if row else {}))
                if blocks != want or (table and row is None):
                    off_table.append((bucket, blocks))
            return out
        return call

    for name in RNS_KERNELS:
        setattr(mods[name], name, recorder(name, saved[name]))
    try:
        yield calls
    finally:
        for name in RNS_KERNELS:
            setattr(mods[name], name, saved[name])


@contextlib.contextmanager
def _step_launches(log: list):
    """Append (step stats, kernel launches made inside that step) for
    every ContinuousEngine.step run in the block."""
    from repro_torch.serve.engine import ContinuousEngine

    step = ContinuousEngine.step

    def counted(self):
        before = _launches()
        out = step(self)
        after = _launches()
        log.append((out, {k: after[k] - before[k] for k in after}))
        return out

    ContinuousEngine.step = counted
    try:
        yield log
    finally:
        ContinuousEngine.step = step


def phase_serve(torch, path: str, launches: dict, calls: dict,
                serve_kw: dict, per_layer_ops: dict, *, rerun: str = ""):
    """Serve the SERVE traffic at full width on one path (``serve_kw``
    for :func:`serve`), with counts from 0 and every distinct wrapper call
    recorded and merged into ``calls``; ``launches[run label]`` gets the
    run's launches; then re-serve it under torch.profiler.  ``rerun``: a
    run of [serve_tuned], labelled ``<path>_<rerun>``, with every launch
    held to the block table in force and no merge into ``calls``.
    Returns (numbers, greedy tokens)."""
    from repro_torch.launch.serve import serve

    label = f"{path}_{rerun}" if rerun else path
    off_table: list | None = [] if rerun else None

    # one short request first, so that first-use costs (kernel libraries
    # loaded, cuBLAS handles, the caching allocator) stay out of the
    # measured run: without it one call's TTFT p50 was 2.1 s, not 0.9 s
    serve("smollm-135m", full=True, rns="rns9", device="cuda", requests=1,
          prompt_lens=(7,), new=2, max_seqs=SERVE["max_seqs"], **serve_kw)
    torch.cuda.synchronize()
    _reset_launches()
    steps_log: list = []
    path_calls: dict = {}
    t0 = time.perf_counter()
    with _recording(torch, path_calls, off_table), \
            _step_launches(steps_log):
        engine, results, stats = serve("smollm-135m", full=True, rns="rns9",
                                       device="cuda", **SERVE, **serve_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches[label] = run = _launches()
    cfg = engine.cfg
    assert cfg.n_layers == FULL_LAYERS and cfg.d_model == 576
    steps = stats["steps"]
    decode_only = [s for s in steps if not s["admitted"] and s["decoded"]]
    per_step = {k: v * FULL_LAYERS for k, v in per_layer_ops.items()}
    for s in steps:
        phases = len(s["admitted"]) + int(s["decoded"])
        want = {k: v * phases for k, v in per_step.items()}
        assert s["rns_ops"].as_dict() == want, (s["step"], s["rns_ops"])
    assert all(s["rns_ops"].fallbacks == 0 for s in steps)
    want_launch = DECODE_LAUNCHES[path]
    decode_launches = [lc for st, lc in steps_log
                       if not st["admitted"] and st["decoded"]]
    assert decode_launches, "no decode-only step"
    for lc in decode_launches:
        assert lc == want_launch, (path, lc)
    for k, n in run.items():
        assert (n > 0) == (want_launch[k] > 0), (path, k, n)
    calls_by_kernel = {k: sum(e["calls"] for e in path_calls.values()
                              if e["kernel"] == k) for k in run}
    assert calls_by_kernel == run, (calls_by_kernel, run)
    if rerun:
        n_launched = sum(run.values())
        assert not off_table, (f"{len(off_table)} of {n_launched} launches "
                               f"off the block table, e.g. {off_table[:3]}")
    else:
        for key, entry in path_calls.items():
            if key in calls:
                calls[key]["calls"] += entry["calls"]
            else:
                calls[key] = entry
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
        "decode_step_launches": decode_launches[0],
        "launches": dict(run),
        "distinct_calls": len(path_calls),
    }
    if rerun:
        out["launches_on_the_block_table"] = sum(run.values())
    out.update(_profile_serve(torch, engine, results, stats["wall_s"]))
    print(json.dumps({label: out}))
    print(f"[{label}] ok")
    return out, _tokens(results)


def _profile_serve(torch, engine, results, unprofiled_wall_s) -> dict:
    """Device busy share over the serve traffic (prefills and decode
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
            for k in ("rns_convert", "rns_matmul", "rns_normalize",
                      "rns_fused"):
                if k in ev.key:
                    by_name[k] = by_name.get(k, 0.0) + dt / 1e3
    out = {"profiled_run": "the serve traffic re-served under "
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


def _first_logits(torch, M, model, cfg, prompts, device):
    out = []
    for pr in prompts:
        tok = torch.as_tensor(pr[None].astype("int64"), device=device)
        n = torch.tensor([len(pr)], device=device)
        out.append(M.prefill_ragged(model, cfg, tok, n)[0].cpu())
    return out


def _tokens(results) -> list:
    return [results[r].tolist() for r in sorted(results)]


def phase_identity(torch):
    from repro_torch.configs.base import get_config
    from repro_torch.core.rns_matmul import RnsDotConfig
    from repro_torch.models import model as M
    from repro_torch.models.resident import encode_resident
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
    float_cfg = dataclasses.replace(cfg, rns=None)
    lc = _first_logits(torch, M, cpu_model, cfg, prompts, "cpu")
    lg = _first_logits(torch, M, gpu_model, cfg, prompts, "cuda")
    lf = _first_logits(torch, M, cpu_model, float_cfg, prompts, "cpu")
    ln = _first_logits(torch, M, nudged, cfg, prompts, "cpu")

    def gap(xs, ys):
        return max(float((a - b).abs().max()) for a, b in zip(xs, ys))

    worst, quant, ulp = gap(lg, lc), gap(lf, lc), gap(ln, lc)
    kw = dict(max_cache=80, max_new_tokens=8, page_size=16, max_seqs=4)
    res_g, _ = ContinuousEngine(gpu_model, ServeConfig(**kw),
                                device="cuda").run(prompts)
    res_c, _ = ContinuousEngine(cpu_model, ServeConfig(**kw),
                                device="cpu").run(prompts)
    match = sum(int(a == b) for ta, tb in zip(_tokens(res_c), _tokens(res_g))
                for a, b in zip(ta, tb))
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

    # on the card: fused kernels on resident weights == the per-op cuda
    # path re-encoding its weights, bit for bit (JAX promises resident ==
    # re-encode and fused == unfused)
    fused_cfg = dataclasses.replace(cfg, rns=dataclasses.replace(
        cfg.rns, backend="cuda_fused"))
    res_model = encode_resident(copy.deepcopy(gpu_model), fused_cfg)
    lr = _first_logits(torch, M, res_model, fused_cfg, prompts, "cuda")
    l_equal = all(torch.equal(a, b) for a, b in zip(lr, lg))
    res_f, _ = ContinuousEngine(copy.deepcopy(gpu_model), ServeConfig(
        rns_backend="cuda_fused", resident_weights=True, **kw),
        device="cuda").run(prompts)
    t_equal = _tokens(res_f) == _tokens(res_g)
    print(f"  card, fused resident per-op vs re-encode per-op: logits "
          f"bit-equal {l_equal}, greedy tokens equal {t_equal}")
    if not (l_equal and t_equal):
        raise AssertionError("fused resident per-op path differs from the "
                             "re-encode per-op path on the card")

    # the deferred fused path, card vs CPU
    def_cfg = dataclasses.replace(cfg, rns=dataclasses.replace(
        cfg.rns, backend="cuda_fused", defer=True))
    def_cpu = encode_resident(copy.deepcopy(cpu_model), def_cfg)
    def_gpu = encode_resident(copy.deepcopy(gpu_model), def_cfg)
    ldc = _first_logits(torch, M, def_cpu, def_cfg, prompts, "cpu")
    ldg = _first_logits(torch, M, def_gpu, def_cfg, prompts, "cuda")
    d_worst, d_quant = gap(ldg, ldc), gap(lf, ldc)
    dkw = dict(rns_backend="cuda_fused", rns_defer=True,
               resident_weights=True, **kw)
    res_dg, _ = ContinuousEngine(copy.deepcopy(gpu_model), ServeConfig(
        **dkw), device="cuda").run(prompts)
    res_dc, _ = ContinuousEngine(copy.deepcopy(cpu_model), ServeConfig(
        **dkw), device="cpu").run(prompts)
    d_match = sum(int(a == b) for ta, tb in zip(_tokens(res_dc),
                                                _tokens(res_dg))
                  for a, b in zip(ta, tb))
    d_total = sum(len(v) for v in res_dc.values())
    print(f"  deferred fused path: first-step logits max |card - cpu| = "
          f"{d_worst} (tolerance {LOGIT_TOL}); its 8-bit datapath vs float "
          f"on the cpu: {d_quant}; matching greedy tokens: "
          f"{d_match}/{d_total}")
    if not LOGIT_TOL < d_quant:
        raise AssertionError(f"tolerance {LOGIT_TOL} would not tell the "
                             f"deferred datapath ({d_quant}) from float")
    if not d_worst <= LOGIT_TOL:
        raise AssertionError(f"deferred first-step logits differ by "
                             f"{d_worst}")
    if d_match != d_total:
        raise AssertionError(f"deferred greedy tokens differ: "
                             f"{d_match}/{d_total}")
    print("[identity] ok")


def _kernel_line(record: dict, launches: dict, tuned: dict) -> dict:
    fused_src = "src/repro_torch/kernels/rns_fused/csrc/rns_fused.cu"
    meta = {
        "rns_convert": ("src/repro_torch/kernels/rns_convert/csrc/"
                        "rns_convert.cu",
                        "src/repro/kernels/rns_convert/kernel.py:38"),
        "rns_matmul": ("src/repro_torch/kernels/rns_matmul/csrc/rns_matmul.cu",
                       "src/repro/kernels/rns_matmul/kernel.py:51"),
        "rns_normalize": ("src/repro_torch/kernels/rns_normalize/csrc/"
                          "rns_normalize.cu",
                          "src/repro/kernels/rns_normalize/kernel.py:93"),
        "rns_fused_encode_matmul": (
            fused_src, "src/repro/kernels/rns_fused/kernel.py:82"),
        "rns_fused_matmul_normalize": (
            fused_src, "src/repro/kernels/rns_fused/kernel.py:141"),
        "rns_fused_dot": (fused_src,
                          "src/repro/kernels/rns_fused/kernel.py:194"),
        "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/"
                            "flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:72"),
    }
    out = []
    for name, (src, replaces) in meta.items():
        cases = record.get(name, [])
        timed = [c for c in cases if "ms" in c]
        if name == "flash_attention":
            # its path is the tuner; [kernels]' launches are comparisons
            head = next((c for c in timed if c["case"].startswith(
                "float32 causal=True q[1,2048,")), {})
            by_path = {path: launches.get(path, {}).get(name, 0)
                       for path in ("tune", "kernels")}
            n = by_path["tune"]
        else:
            # the head of the line: the main-path input called most
            head = max(timed, key=lambda c: c.get("calls_in_serve", 0),
                       default={})
            by_path = {path: run.get(name, 0) for path, run in
                       launches.items() if path != "kernels"}
            n = sum(by_path.values())
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": n,
            "launches_by_path": by_path,
            "max_abs_err": max((c["max_abs_err"] for c in cases),
                               default=None),
            "ms": head.get("ms"), "plain_ms": head.get("plain_ms"),
            "bound_ms": head.get("bound_ms"),
            "bound_by": head.get("bound_by"),
            "library_ms": head.get("library_ms"),
            "case": head.get("case"),
            "blocks_by_bucket": {
                b: {k: t[k] for k in ("default", "tuned", "default_us",
                                      "tuned_us")}
                for b, t in tuned.items() if t["kind"] == name},
            "cases": timed})
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
    # a fresh block table: [serve] and [serve_fused] run on the defaults,
    # [tune] fills it, [serve_tuned] and [kernels] resolve through it
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(TUNE_CACHE)
    TUNE_CACHE.unlink(missing_ok=True)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} on {torch.cuda.get_device_name(0)}")
    record, launches, calls, failed = {}, {}, {}, []
    untuned, tuned = {}, {}
    for name, fn in [
            ("build", phase_build),
            ("serve", lambda: untuned.__setitem__("serve", phase_serve(
                torch, "serve", launches, calls, {}, JAX_DECODE_RNS_OPS))),
            ("serve_fused", lambda: untuned.__setitem__(
                "serve_fused", phase_serve(
                    torch, "serve_fused", launches, calls, FUSED_SERVE,
                    JAX_FUSED_DECODE_RNS_OPS))),
            ("tune", lambda: phase_tune(torch, dev, calls, launches, tuned)),
            ("serve_tuned", lambda: phase_serve_tuned(torch, launches, calls,
                                                      untuned)),
            ("kernels", lambda: phase_kernels(torch, dev, record, calls,
                                              launches)),
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
    print(json.dumps(_kernel_line(record, launches, tuned)))
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
