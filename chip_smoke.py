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
                rns_matmul and rns_fused_mma (the fused dot, matmul +
                normalize and, counted on its own too, encode + matmul),
                HMMA in flash_attention, none may be 0; and MUFU.RCP
                (a division's reciprocal) in rns_normalize, which must
                be 0;
  [serve]       full-width smollm-135m with the rns9 MLP datapath through
                ContinuousEngine.run on mixed-length requests (after one
                short warm-up request): the per-op path, weights
                re-encoded every step, three kernels.  Each path is
                served twice.  First eager (``graphs=False``): every
                kernel's launch count is set to 0 just before and read
                after, a copy is kept of each distinct call the wrappers
                see, and each decode step's launches are held to the
                path's; then captured (the engine's prefill and decode
                replayed from CUDA graphs): the same greedy tokens and
                rns_ops as the eager serve, each phase captured once,
                and torch.profiler's count of the kernels in one
                replayed decode step equal to the eager launches.  Each
                serve is re-served under torch.profiler for the device's
                idle share, and the two are printed side by side;
  [serve_fused] the same on the fused path: resident weights (encoded
                once at engine build), the deferred MLP and the fused
                kernels (``rns_backend="cuda_fused"``), with the
                launches of every decode step held to 30 each of the
                three fused kernels and rns_convert, and none of
                rns_matmul or rns_normalize;
  [serve_per_layer] the same on the fused path with per-layer profiles
                (``per_layer_profiles=True``): every layer on the
                profile its weights select (rns7 for these weights), 120
                launches a decode step, tokens equal to [serve_fused]'s;
  [tune]        with the block table pointed at a fresh file under
                build/, tune every kernel kind at every shape bucket the
                three serves gave the wrappers (on the recorded inputs),
                and flash_attention at smollm-135m's attention geometry
                (Tq = Tk = 120 and 2048, causal): every legal candidate
                is held against the plain version and timed, and every
                candidate the checker drops is printed with its reason;
  [serve_tuned] the three serves again, eager and captured, with engines
                built after the tuned table is in force (a captured step
                keeps the tiles it was captured with; each also
                re-served under torch.profiler): greedy tokens bit-equal
                to the untuned serves, the same launches per decode
                step, every launch on its bucket's row, and its numbers
                beside the untuned run's;
  [kernels]     hold all seven kernels against their plain PyTorch
                versions on the card -- the six RNS kernels bit for bit
                on the inputs the serves gave them (every distinct
                shape), at every candidate tiling on one main-path input
                each, and on boundary cases of every profile (rns8_u8's
                int32 residues included; rns_normalize on the edge
                values 0, 1, M/2 - 1, M/2, M/2 + 1, M - 1, T % 4 != 0
                (planes off a 16-byte boundary) and a view one int32
                off one; rns_matmul, the fused dot and
                the fused matmul + normalize (int8 and int32 a) at every
                candidate tile with their K steps split among blocks;
                the fused encode + matmul also on both main-path inputs
                at every compiled tile with its split forced 1, 2 and 4
                ways);
                flash_attention within 2e-5 (float32; plus one step of
                the type in bfloat16) on ragged and full-width shapes,
                at every candidate tile --
                and time kernel, plain
                version and the library yardstick (torch._int_mm,
                scaled_dot_product_attention), and, beside each fused
                kernel's main-path input, the port's unfused chain on
                the same inputs (rns_convert -> rns_matmul ->
                rns_normalize, or its first or last two) in one graph;
  [identity]    the same seeded weights and prompts at a reduced depth:
                per-op path on the card (kernels) vs the CPU (plain path)
                -- one RNS projection bit-equal, first-step logits within
                LOGIT_TOL, every greedy token equal; on the card, the
                fused resident per-op path vs the re-encode per-op path
                -- logits and tokens bit-equal; the deferred fused path on
                the card vs the CPU -- logits within LOGIT_TOL, every
                greedy token equal; and the same with per-layer profiles
                -- the same profiles selected on both devices.  The card's
                engines here are captured;
  [fractional]  Olsen fractional RNS (core/fractional.py) and fractional
                residue tensors (frac_exp != 0).  With every launch count
                set to 0: rns9 fractional weights at smollm-135m's MLP
                widths through rt_dot (B.4), rt_matmul_decode (B.6) and
                rt_decode of rt_matmul (B.2, B.3) on the decode and
                prefill rows, each of B.3, B.4 and B.6 launched at least
                once with M_f**-frac_exp in its weight table, the floats
                bit-equal to the same calls on the CPU; then the
                Mandelbrot demo (launch/mandelbrot.py) at 1920 x 1080, 256
                iterations on rns12, captured and eager (equal escape
                counts, one capture, pixel-iterations per second,
                agreement with float64); a 256 x 256 crop of that view
                captured, eager and on the CPU (equal escape counts, and
                equal to the full render's window); the rns24_deep proof
                (two c values one float64 apart, orbits that differ, as
                on the CPU); and B.3, B.4 and B.6 with a scaled table
                (rns9 at M_f**-1, M_f**-2 and M_f**-10, the last outside
                float32) bit for bit against their plain versions at the
                main path's decode and prefill inputs, one timed row of
                each beside the same inputs unscaled.

Then it prints the card's name and power limit, one ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
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
# each serve path: its ServeConfig overrides and the JAX engine's decode
# rns_ops for one layer (the per-layer path's layers run the fused
# path's ops on their own profile)
SERVE_PATHS = {
    "serve": ({}, JAX_DECODE_RNS_OPS),
    "serve_fused": (FUSED_SERVE, JAX_FUSED_DECODE_RNS_OPS),
    "serve_per_layer": (dict(FUSED_SERVE, per_layer_profiles=True),
                        JAX_FUSED_DECODE_RNS_OPS),
}
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
DECODE_LAUNCHES["serve_per_layer"] = DECODE_LAUNCHES["serve_fused"]
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
SASS_MMA = {"rns_matmul": "IMMA", "rns_fused_mma": "IMMA",
            "flash_attention": "HMMA"}

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

    if (m := re.search(r"rns_convert_kernelILi(\d+)E(.)E", entry)):
        return ka.registers_per_thread("rns_convert", int(m[1]),
                                       res_bytes=1 if m[2] == "a" else 4)
    if (m := re.search(r"rns_normalize_kernelILi(\d+)E", entry)):
        return ka.registers_per_thread("rns_normalize", int(m[1]))
    if (m := re.search(r"rns_fused_mma_kernelI(.).Li(\d+)ELi\d+ELi(\d+)E",
                       entry)):
        kind = "rns_fused_dot" if m[1] == "f" else \
            "rns_fused_matmul_normalize"
        return ka.registers_per_thread(kind, int(m[2]),
                                       blocks={"bn": int(m[3])})
    if (m := re.search(r"rns_encode_residues_kernelI.Li(\d+)ELi\d+ELi(\d+)E",
                       entry)):
        return ka.registers_per_thread("rns_fused_encode_matmul", int(m[1]),
                                       blocks={"bn": int(m[2])})
    if "rns_matmul_kernel" in entry:
        return ka.registers_per_thread("rns_matmul")
    if "flash_attention_kernel" in entry:
        return ka.registers_per_thread("flash_attention")
    return None


def _sass_counts(lib: Path, op: str):
    """({compiled function: count of ``op`` lines}, cuobjdump's process)
    from ``cuobjdump -sass`` of one library; every function is a key."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300)
    by_fn, fn = {}, ""
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            by_fn.setdefault(fn, 0)
        elif op in line:
            by_fn[fn] = by_fn.get(fn, 0) + 1
    return by_fn, sass


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    from repro_torch.kernels.rns_normalize import ops as n_ops

    sources = {m.SOURCE.stem: m.SOURCE for m in _kernel_mods().values()}

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
    for name, op in SASS_MMA.items():
        lib = build.library_path(name, sources[name])
        by_fn, sass = _sass_counts(lib, op)
        counts = {name: sum(by_fn.values())}
        if name == "rns_fused_mma":     # B.5's instantiations on their own
            counts["rns_encode_residues_kernel"] = sum(
                n for f, n in by_fn.items()
                if "rns_encode_residues_kernel" in f)
        for what, n in counts.items():
            print(f"  {what}: {n} {op} instructions in the SASS "
                  f"(cuobjdump -sass {lib.name})")
            if not n:
                raise AssertionError(
                    f"{what}: no {op} instruction in its SASS (cuobjdump rc "
                    f"{sass.returncode}: {sass.stderr.strip()[:200]})")
    # B.3's MRC reduces by multiply-high mods: no division, whose
    # reciprocal (MUFU.RCP) would show in the SASS
    lib = build.library_path("rns_normalize", sources["rns_normalize"])
    by_fn, sass = _sass_counts(lib, "MUFU.RCP")
    n = sum(by_fn.values())
    print(f"  rns_normalize: {n} MUFU.RCP instructions in the SASS of "
          f"{len(by_fn)} functions (cuobjdump -sass {lib.name})")
    if sass.returncode or len(by_fn) < len(n_ops.SUPPORTED_K) or n:
        raise AssertionError(
            f"rns_normalize: {n} MUFU.RCP in {len(by_fn)} functions, want 0 "
            f"in at least {len(n_ops.SUPPORTED_K)} (cuobjdump rc "
            f"{sass.returncode}: {sass.stderr.strip()[:200]})")


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
    """Each serve path once more, eager and captured, with engines built
    under the table [tune] wrote: tokens bit-equal to the untuned
    serves, every launch on its bucket's row, the numbers beside the
    untuned run's."""
    for path in SERVE_PATHS:
        if path not in untuned:
            raise AssertionError(f"[{path}] did not run: nothing to "
                                 "compare with")
        base, base_tokens = untuned[path]
        with _table(TUNE_CACHE):
            run, tokens = phase_serve(torch, path, launches, calls,
                                      rerun="tuned")
        if tokens != base_tokens:
            raise AssertionError(f"{path} tuned: greedy tokens differ from "
                                 "the untuned serve's")
        for mode in ("eager", "captured"):
            for name in METRICS:
                print(f"  {path} {mode} {name}: untuned "
                      f"{base[mode].get(name, 'not measured')}, tuned "
                      f"{run[mode].get(name, 'not measured')}")
        print(f"  {path}: launches per decode step "
              f"{run['eager']['rns_kernels_per_decode_step']} eager, "
              f"{run['captured']['rns_kernels_per_decode_step']} replayed; "
              "greedy tokens bit-equal to the untuned serve")


def phase_serve_per_layer(torch, launches, calls, untuned):
    """The fused path with per-layer profiles, eager and captured: one
    profile for the layers' one period slot, narrower than rns9, and
    greedy tokens equal to [serve_fused]'s (a resident chain on a
    narrower profile computes the same integers)."""
    untuned["serve_per_layer"] = run, tokens = phase_serve(
        torch, "serve_per_layer", launches, calls)
    profiles = run["profiles"]
    if len(profiles) != 1 or "rns9" in profiles:
        raise AssertionError(f"per-layer profiles {profiles}: want one "
                             "profile narrower than rns9")
    if "serve_fused" not in untuned:
        raise AssertionError("[serve_fused] did not run: nothing to "
                             "compare with")
    if tokens != untuned["serve_fused"][1]:
        raise AssertionError("per-layer greedy tokens differ from "
                             "[serve_fused]'s")
    print(f"  serve_per_layer: profiles {profiles}; greedy tokens equal to "
          "[serve_fused]'s")


def phase_kernels(torch, dev, record, calls, launches):
    """The six RNS kernels bit for bit on the inputs the serves gave
    them, at every candidate tiling and on boundary cases; flash_attention
    within tolerance on ragged and full-width shapes; times of the
    main-path inputs and of flash at full width.  Fills ``record``."""
    import torch.nn.functional as F

    from repro_torch.analysis.kernel_audit import fused_ring
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bad = []

    def case(kernel, label, fn, plain, nbytes=0, ops=0, rate=1, timed=True,
             library=None, calls_in_serve=None, check=None, note=None,
             unfused=None):
        """``check(got, want) -> (ok, extra)``; by default bit-equal.
        ``note`` says which rate ``rate`` is, for the bound; ``unfused =
        (fn, note)`` is the port's unfused chain on the same inputs, held
        to the plain version too and timed as ``unfused_ms``."""
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
            if unfused is not None:
                chain, entry["unfused_note"] = unfused
                chain_err = _max_abs_err(torch, chain(), want)
                entry["unfused_max_abs_err"] = chain_err
                ok = ok and chain_err == 0
                entry["unfused_ms"] = _time_ms(torch, chain, 20)
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

    def unfused_chain(kernel, prof, args, kw):
        """The port's unfused kernels on a fused kernel's inputs, in the
        order the per-op path runs them."""
        p = get_profile(prof)
        c_ops, m_ops, n_ops = (mods[k] for k in (
            "rns_convert", "rns_matmul", "rns_normalize"))
        rd = torch.int8 if p.int8_safe else torch.int32
        if kernel == "rns_fused_matmul_normalize":
            a, b = args
            a8 = a.to(rd)           # the per-op path's residues are int8

            def chain():
                return n_ops.rns_normalize(p, m_ops.rns_matmul(p, a8, b))
            return chain, ("rns_matmul -> rns_normalize in one graph, "
                           f"a_res cast to {rd} outside it")
        x, sc, b = args

        def chain():
            res = m_ops.rns_matmul(p, c_ops.rns_convert(
                p, x, sc, bits=kw.get("bits", 16), out_dtype=rd), b)
            return res if kernel == "rns_fused_encode_matmul" else \
                n_ops.rns_normalize(p, res)
        return chain, "rns_convert -> rns_matmul" + (
            "" if kernel == "rns_fused_encode_matmul"
            else " -> rns_normalize") + " in one graph"

    # ---- the main paths' own inputs: every distinct call of the serves
    for entry in sorted(calls.values(),
                        key=lambda e: (e["kernel"], -e["calls"])):
        kernel, prof, args, kw = (entry["kernel"], entry["profile"],
                                  entry["args"], entry["kw"])
        K = get_profile(prof).n_digits
        label, nbytes, ops, rate = _cost(torch, kernel, K, args, kw)
        label = f"{get_profile(prof).name} {label}"
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
             calls_in_serve=entry["calls"],
             unfused=(unfused_chain(kernel, prof, args, kw)
                      if kernel.startswith("rns_fused") else None))

    # ---- every candidate tiling, on each kernel's most called input
    heads = {}
    for entry in sorted(calls.values(), key=lambda e: -e["calls"]):
        heads.setdefault(entry["kernel"], entry)
    for kernel, entry in sorted(heads.items()):
        prof, args, kw = entry["profile"], entry["args"], entry["kw"]
        label = get_profile(prof).name + " " + _cost(
            torch, kernel, get_profile(prof).n_digits, args, kw)[0]
        mod = mods[kernel]
        wrapper, plain = getattr(mod, kernel), getattr(mod, kernel + "_plain")
        want = plain(prof, *args, **kw)
        for cand in autotune.CANDIDATES[kernel]:
            case(kernel, f"{label} tile {_blk(cand)}",
                 lambda w=wrapper, c=cand: w(prof, *args, **kw, **c),
                 lambda: want, timed=False)

    # ---- the fused encode + matmul on every main-path input, at every
    # compiled tile with its split over D forced
    f_ops = mods["rns_fused_encode_matmul"]
    rule = f_ops.splits_for
    try:
        for entry in calls.values():
            if entry["kernel"] != "rns_fused_encode_matmul":
                continue
            prof, args, kw = entry["profile"], entry["args"], entry["kw"]
            label = _cost(torch, entry["kernel"],
                          get_profile(prof).n_digits, args, kw)[0]
            want = f_ops.rns_fused_encode_matmul_plain(prof, *args, **kw)
            for cand in autotune.CANDIDATES["rns_fused_encode_matmul"]:
                for n in (1, 2, 4):
                    f_ops.splits_for = lambda *_, n=n: n
                    case("rns_fused_encode_matmul",
                         f"{label} tile {_blk(cand)} split {n} (forced)",
                         lambda c=cand: f_ops.rns_fused_encode_matmul(
                             prof, *args, **kw, **c),
                         lambda: want, timed=False)
    finally:
        f_ops.splits_for = rule

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
        # B.3's edge values (0, 1, M/2 - 1, M/2, M/2 + 1, M - 1) at both
        # ends, T % 4 == 1, 2, 3 (a partial last block; planes off a
        # 16-byte boundary) and a contiguous view one int32 past one;
        # every candidate bt on the ragged, misaligned one
        edge = torch.as_tensor(encode_exact(name, [
            0, 1, p.M // 2 - 1, p.M // 2, p.M // 2 + 1, p.M - 1]),
            device=dev)
        for T in (4096, 4097, 4098, 4099):
            for off in (0, 1):
                buf = torch.zeros(p.n_digits * T + 1, dtype=torch.int32,
                                  device=dev)
                rr = buf[off:off + p.n_digits * T].view(p.n_digits, T)
                rr.copy_(_residues(torch, p, (T,), g, dev))
                rr[:, :6], rr[:, T - 6:] = edge, edge
                tiles = autotune.legal_candidates(
                    "rns_normalize", p, (T,))[0] if (T, off) == (4099, 1) \
                    else [{}]
                for cand in tiles:
                    case("rns_normalize",
                         f"{name} edges [K,{T}] +{off} int32"
                         + (f" tile {_blk(cand)}" if cand else ""),
                         lambda rr=rr, c=cand: n_ops.rns_normalize(p, rr,
                                                                   **c),
                         lambda rr=rr: n_ops.rns_normalize_plain(p, rr),
                         timed=False)
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
        a_dtypes = (torch.int8, torch.int32) if p.int8_safe \
            else (torch.int32,)
        for ad in a_dtypes:
            a = _residues(torch, p, (13, 37), g, dev).to(ad)
            b2 = _residues(torch, p, (37, 21), g, dev).to(bd)
            case("rns_fused_matmul_normalize",
                 f"{name} [K,13,37]{ad}@[K,37,21]",
                 lambda: f_ops.rns_fused_matmul_normalize(p, a, b2),
                 lambda: f_ops.rns_fused_matmul_normalize_plain(p, a, b2),
                 timed=False)
        # D = 1100 over one row tile and 2-3 column tiles: the tensor-core
        # fused kernels share each tile's K steps among blocks, at every
        # candidate tile the checker allows
        x = torch.randn((13, 1100), generator=g, device=dev)
        s = 127.0 / x.abs().amax(dim=1, keepdim=True)
        b = _residues(torch, p, (1100, 70), g, dev).to(bd)
        split_in = [(k, "x[13,1100] rows @[K,1100,70]", (x, s, b),
                     {"bits": 8}) for k in ("rns_fused_dot",
                                            "rns_fused_encode_matmul")]
        split_in += [("rns_fused_matmul_normalize",
                      f"[K,13,1100]{ad}@[K,1100,70]",
                      (_residues(torch, p, (13, 1100), g, dev).to(ad), b),
                      {}) for ad in a_dtypes]
        for kernel, label, args, kw in split_in:
            want = getattr(f_ops, kernel + "_plain")(p, *args, **kw)
            legal, _ = autotune.legal_candidates(kernel, name, (13, 1100, 70))
            for cand in legal:
                bk = fused_ring(kernel, p.n_digits, cand["bm"], cand["bn"])[0]
                sp = f_ops.splits_for(13, 1100, 70, cand["bm"], cand["bn"],
                                      bk, sms, f_ops.MIN_STEPS[kernel])
                if sp < 2:
                    bad.append(f"{kernel} {name} {label} {cand}: no split")
                case(kernel, f"{name} {label} tile {_blk(cand)} split {sp}",
                     lambda k=kernel, c=cand, a=args, w=kw: getattr(
                         f_ops, k)(p, *a, **w, **c),
                     lambda w=want: w, timed=False)
    torch.cuda.synchronize()
    launches["kernels"] = _launches()
    if bad:
        raise AssertionError("kernels disagree with their plain versions:\n"
                             + "\n".join(bad))
    print("[kernels] ok: every RNS kernel bit-equal to its plain version, "
          "flash_attention within its tolerance")


@contextlib.contextmanager
def _recording(torch, calls: dict, off_table: list | None = None,
               in_step: dict | None = None):
    """Keep, for each distinct call the six RNS wrappers see (kernel,
    profile, input shapes and dtypes, options), its number of calls and
    a copy of the inputs of its first call inside an engine step (of
    its first call at all until then: the engine's build warms its
    programs up on zero inputs): what [kernels] checks and times.
    ``in_step["on"]`` says whether a step is running (``_step_launches``
    sets it).  With ``off_table``, also hold every launch's blocks to
    the block table in force -- its row for the launch's bucket, or the
    defaults when the table is empty -- appending each launch that is
    not.  The wrappers themselves, and their launch counts, are
    untouched."""
    from repro_torch.kernels import autotune

    mods = _kernel_mods()
    saved = {name: getattr(mods[name], name) for name in RNS_KERNELS}
    table = autotune._load() if off_table is not None else None
    in_step = in_step if in_step is not None else {}

    def copies(tensors):
        return tuple(t.detach().clone() if torch.is_tensor(t) else t
                     for t in tensors)

    def recorder(name, fn):
        def call(profile, *tensors, **kw):
            key = (name, getattr(profile, "name", profile),
                   tuple((tuple(t.shape), str(t.dtype)) if torch.is_tensor(t)
                         else repr(t) for t in tensors),
                   tuple(sorted((k, repr(v)) for k, v in kw.items())))
            entry = calls.get(key)
            stepping = in_step.get("on", False)
            if entry is None:
                calls[key] = entry = {
                    "kernel": name, "profile": profile, "calls": 0,
                    "args": copies(tensors), "kw": dict(kw),
                    "from_step": stepping}
            elif stepping and not entry["from_step"]:
                entry["args"], entry["from_step"] = copies(tensors), True
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
def _step_launches(log: list, in_step: dict):
    """Append (step stats, kernel launches made inside that step) for
    every ContinuousEngine.step run in the block; ``in_step["on"]`` is
    True while one runs."""
    from repro_torch.serve.engine import ContinuousEngine

    step = ContinuousEngine.step

    def counted(self):
        before = _launches()
        in_step["on"] = True
        try:
            out = step(self)
        finally:
            in_step["on"] = False
        after = _launches()
        log.append((out, {k: after[k] - before[k] for k in after}))
        return out

    ContinuousEngine.step = counted
    try:
        yield log
    finally:
        ContinuousEngine.step = step


def _kernel_kind(name: str) -> str | None:
    """The wrapper whose kernel a profiler event names (its demangled or
    mangled name), or None for a kernel of PyTorch's."""
    if "rns_encode_residues_kernel" in name:
        return "rns_fused_encode_matmul"
    if "rns_fused_mma_kernel" in name:     # AT: float x (the dot) or residues
        dot = "rns_fused_mma_kernel<float" in name or \
            "rns_fused_mma_kernelIf" in name
        return "rns_fused_dot" if dot else "rns_fused_matmul_normalize"
    for kind in ("rns_convert", "rns_matmul", "rns_normalize",
                 "flash_attention"):
        if f"{kind}_kernel" in name:
            return kind
    return None


def _replay_kernels(torch, engine) -> dict:
    """Kernels torch.profiler sees in one replay of the engine's captured
    decode step, by wrapper (and by kernel name), on the trash page: the
    tables are zeroed first and no row is active."""
    from torch.profiler import ProfilerActivity, profile

    prog = engine.programs["decode"]
    if prog.graph is None:
        raise AssertionError("the decode step was not captured")
    engine.cache.block_table.zero_()
    engine.cache.lengths.zero_()
    R = engine.pcfg.max_seqs
    token = torch.zeros((R, 1), dtype=torch.int64)
    active = torch.zeros((R,), dtype=torch.bool)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prog.run(token=token, active=active)
        torch.cuda.synchronize()
    by_kind, by_name, total = {}, {}, 0
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        if "memcpy" in ev.key.lower() or "memset" in ev.key.lower():
            continue
        total += ev.count
        kind = _kernel_kind(ev.key)
        if kind is not None:
            by_kind[kind] = by_kind.get(kind, 0) + ev.count
            by_name[ev.key[:120]] = by_name.get(ev.key[:120], 0) + ev.count
    return {"by_kernel": by_kind, "rns_kernels": sum(by_kind.values()),
            "all_kernels": total, "names": by_name}


def _serve_numbers(engine, stats, wall, decode_launches) -> dict:
    steps = stats["steps"]
    decode_only = [s for s in steps if not s["admitted"] and s["decoded"]]
    return {
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
        "decode_step_launches": decode_launches,
        "captures": stats["captures"],
    }


SIDE_BY_SIDE = ("tokens_per_s", "ttft_p50_s", "decode_step_ms_median",
                "device_idle_share_vs_unprofiled_wall", "device_idle_share",
                "device_busy_ms", "captures", "rns_kernels_per_decode_step")


def phase_serve(torch, path: str, launches: dict, calls: dict, *,
                rerun: str = ""):
    """Serve the SERVE traffic at full width on one path of SERVE_PATHS,
    eager then captured.  The eager serve runs with counts from 0 and
    every distinct wrapper call recorded and merged into ``calls``;
    ``launches[run label]`` gets its launches.  The captured serve must
    give its tokens and rns_ops, capture each phase once, and replay
    the eager decode step's kernels.  The captured serve, and the eager
    serves of [serve] and [serve_fused], are re-served under
    torch.profiler (the profiler's own processing of an eager serve
    takes tens of seconds).  ``rerun``: a run of [serve_tuned],
    labelled ``<path>_<rerun>``, with every launch held to the block
    table in force and no merge into ``calls``.  Returns ({"eager":
    numbers, "captured": numbers}, greedy tokens)."""
    from collections import Counter

    from repro_torch.launch.serve import serve
    from repro_torch.models.resident import resident_profiles

    serve_kw, per_layer_ops = SERVE_PATHS[path]
    label = f"{path}_{rerun}" if rerun else path
    off_table: list | None = [] if rerun else None
    profile_eager = not rerun and path in ("serve", "serve_fused")
    clock = {"start": time.perf_counter()}

    # one short request first, so that first-use costs (kernel libraries
    # loaded, cuBLAS handles, the caching allocator) stay out of the
    # measured run: without it one call's TTFT p50 was 2.1 s, not 0.9 s
    serve("smollm-135m", full=True, rns="rns9", device="cuda", requests=1,
          prompt_lens=(7,), new=2, max_seqs=SERVE["max_seqs"],
          graphs=False, **serve_kw)
    torch.cuda.synchronize()
    _reset_launches()
    steps_log: list = []
    path_calls: dict = {}
    in_step: dict = {}
    t0 = time.perf_counter()
    with _recording(torch, path_calls, off_table, in_step), \
            _step_launches(steps_log, in_step):
        engine, results, stats = serve("smollm-135m", full=True, rns="rns9",
                                       device="cuda", graphs=False, **SERVE,
                                       **serve_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches[label] = run = _launches()
    cfg = engine.cfg
    assert cfg.n_layers == FULL_LAYERS and cfg.d_model == 576
    steps = stats["steps"]
    per_step = {k: v * FULL_LAYERS for k, v in per_layer_ops.items()}
    for s in steps:                 # the JAX engine's rule: decode + prefills
        want = {k: v * (1 + len(s["admitted"])) for k, v in per_step.items()}
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
    eager = _serve_numbers(engine, stats, wall, decode_launches[0])
    eager.update(launches=dict(run), distinct_calls=len(path_calls),
                 rns_kernels_per_decode_step=sum(decode_launches[0].values()))
    if rerun:
        eager["launches_on_the_block_table"] = sum(run.values())
    clock["eager_served"] = time.perf_counter()
    if profile_eager:
        eager.update(_profile_serve(torch, engine, results, stats["wall_s"]))
    clock["eager_profiled"] = time.perf_counter()
    profiles = Counter(resident_profiles(engine.model).values())
    del engine

    # the same traffic through the captured steps
    t0 = time.perf_counter()
    cengine, cresults, cstats = serve("smollm-135m", full=True, rns="rns9",
                                      device="cuda", graphs=True, **SERVE,
                                      **serve_kw)
    torch.cuda.synchronize()
    cwall = time.perf_counter() - t0
    if _tokens(cresults) != _tokens(results):
        raise AssertionError(f"{label}: captured greedy tokens differ from "
                             "the eager serve's")
    if [s["rns_ops"].as_dict() for s in cstats["steps"]] != [
            s["rns_ops"].as_dict() for s in steps]:
        raise AssertionError(f"{label}: captured rns_ops differ from the "
                             "eager serve's")
    if cstats["captures"] != {"decode": 1, "prefill": 1}:
        raise AssertionError(f"{label}: captures {cstats['captures']}")
    cprofiles = Counter(resident_profiles(cengine.model).values())
    if cprofiles != profiles:
        raise AssertionError(f"{label}: profiles {cprofiles} vs {profiles}")
    captured = _serve_numbers(cengine, cstats, cwall, None)
    clock["captured_served"] = time.perf_counter()
    captured.update(_profile_serve(torch, cengine, cresults,
                                   cstats["wall_s"]))
    clock["captured_profiled"] = time.perf_counter()
    replay = _replay_kernels(torch, cengine)
    captured["replayed_decode_step"] = replay
    captured["rns_kernels_per_decode_step"] = replay["rns_kernels"]
    if replay["all_kernels"] == 0:
        raise AssertionError("torch.profiler sees no kernel in a replayed "
                             "decode step")
    want_rns = {k: n for k, n in want_launch.items() if n}
    if replay["by_kernel"] != want_rns:
        raise AssertionError(f"{label}: a replayed decode step ran "
                             f"{replay['by_kernel']}, the eager step "
                             f"launched {want_rns}")
    del cengine
    marks = list(clock.items())
    out = {"eager": eager, "captured": captured,
           "profiles": dict(profiles),
           "phase_s": {k: t - t_prev for (_, t_prev), (k, t)
                       in zip(marks, marks[1:] + [("replayed",
                                                   time.perf_counter())])}}
    print(json.dumps({label: out}))
    print(f"  {label} profiles: {dict(profiles) or 'none (re-encoded)'}")
    for name in SIDE_BY_SIDE:
        print(f"  {label} {name}: eager {eager.get(name, 'not measured')}, "
              f"captured {captured.get(name, 'not measured')}")
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
                      "rns_fused_mma", "rns_encode_residues"):
                if k in ev.key:     # B.4 + B.6; B.5 on its own
                    by_name[k] = by_name.get(k, 0.0) + dt / 1e3
                    break
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
    from repro_torch.models.resident import encode_resident, resident_profiles
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

    # the deferred fused path with per-layer profiles, card vs CPU: the
    # same profiles selected from the same weights on both devices
    pl_cpu = encode_resident(copy.deepcopy(cpu_model), def_cfg,
                             per_layer_profiles=True)
    pl_gpu = encode_resident(copy.deepcopy(gpu_model), def_cfg,
                             per_layer_profiles=True)
    prof_c, prof_g = resident_profiles(pl_cpu), resident_profiles(pl_gpu)
    lpc = _first_logits(torch, M, pl_cpu, def_cfg, prompts, "cpu")
    lpg = _first_logits(torch, M, pl_gpu, def_cfg, prompts, "cuda")
    p_worst = gap(lpg, lpc)
    pkw = dict(dkw, per_layer_profiles=True)
    res_pg, _ = ContinuousEngine(copy.deepcopy(gpu_model), ServeConfig(
        **pkw), device="cuda").run(prompts)
    res_pc, _ = ContinuousEngine(copy.deepcopy(cpu_model), ServeConfig(
        **pkw), device="cpu").run(prompts)
    p_match = sum(int(a == b) for ta, tb in zip(_tokens(res_pc),
                                                _tokens(res_pg))
                  for a, b in zip(ta, tb))
    p_total = sum(len(v) for v in res_pc.values())
    print(f"  per-layer profiles {sorted(set(prof_g.values()))} (card) "
          f"{sorted(set(prof_c.values()))} (cpu); first-step logits max "
          f"|card - cpu| = {p_worst} (tolerance {LOGIT_TOL}); matching "
          f"greedy tokens: {p_match}/{p_total}")
    if prof_c != prof_g:
        raise AssertionError(f"per-layer profiles differ: card {prof_g}, "
                             f"cpu {prof_c}")
    if not p_worst <= LOGIT_TOL:
        raise AssertionError(f"per-layer first-step logits differ by "
                             f"{p_worst}")
    if p_match != p_total:
        raise AssertionError(f"per-layer greedy tokens differ: "
                             f"{p_match}/{p_total}")
    print("[identity] ok")


def _bit_equal(torch, got, want) -> bool:
    """float32 results equal bit for bit (-0.0 is not 0.0; NaN == NaN)."""
    return (got.shape == want.shape and got.dtype == want.dtype and
            torch.equal(got.contiguous().view(torch.int32),
                        want.contiguous().view(torch.int32)))


def _traffic(torch, fn) -> tuple[int, int]:
    """(ops, bytes) of one call of ``fn``, op by op at the aten level:
    each tensor an op reads counted once, each tensor it writes once
    (an in-place op's first argument as written only); views move
    nothing.  The least traffic of running the same ops one kernel each."""
    from torch.utils._python_dispatch import TorchDispatchMode

    tally = [0, 0]

    def nbytes(t):
        return t.numel() * t.element_size() if torch.is_tensor(t) else 0

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            outs = out if isinstance(out, (tuple, list)) else [out]
            if any(torch.is_tensor(o) and o._is_view() for o in outs):
                return out
            ins = [a for a in list(args) + list(kwargs.values())
                   if torch.is_tensor(a)]
            inplace = func._schema.name.endswith("_")
            tally[0] += 1
            tally[1] += sum(nbytes(t) for t in ins[int(inplace):]) + sum(
                nbytes(o) for o in outs)
            return out

    with Count():
        fn()
    return tally[0], tally[1]


def phase_fractional(torch, dev, record, launches):
    """Fractional residue tensors through B.3/B.4/B.6 (counted), the
    Mandelbrot demo full size and cropped (card captured / eager / CPU),
    the deep proof, and the scaled kernels against their plain versions.
    Adds its timed rows to ``record`` and its launches to ``launches``."""
    import numpy as np

    from repro_torch.core import fractional as fr
    from repro_torch.core import tensor as rt
    from repro_torch.core.moduli import get_profile
    from repro_torch.launch import mandelbrot as mb

    bad = []
    p = get_profile("rns9")
    D, N = 576, 1536                # smollm-135m's MLP widths
    g = torch.Generator().manual_seed(5)

    def frac(v, device, dtype):
        """A fractional residue tensor (frac_exp 1) of the float ``v``."""
        return rt.RnsTensor(fr.fr_encode(p, v.to(device)).to(dtype),
                            torch.ones((), device=device), p.name,
                            math.log2(float(v.abs().max()) * p.M_f + 1), 1)

    w_i = torch.randn((D, N), generator=g) * 0.05      # wi / wg: D -> N
    w_o = torch.randn((N, D), generator=g) * 0.05      # wo: N -> D
    rows = {"decode": torch.randn((8, 1, D), generator=g),
            "prefill": torch.randn((1, 144, D), generator=g)}
    hs = {k: torch.randn(v.shape[:-1] + (N,), generator=g) * 0.5
          for k, v in rows.items()}

    def chain(device):
        """rt_dot (B.4, frac_exp 1), rt_matmul_decode (B.6, frac_exp 2),
        rt_decode(rt_matmul) (B.2 then B.3, frac_exp 2) on each row."""
        Wi = frac(w_i, device, torch.int8)
        Wo = frac(w_o, device, torch.int8)
        out = {}
        for k, x in rows.items():
            A = frac(hs[k], device, torch.int32)
            out[k + " dot"] = rt.rt_dot(x.to(device), Wi, bits=8,
                                        backend="cuda_fused")
            out[k + " matmul_decode"] = rt.rt_matmul_decode(
                A, Wo, backend="cuda_fused")
            out[k + " decode"] = rt.rt_decode(rt.rt_matmul(
                A.astype_digits(torch.int8), Wo, backend="cuda"),
                backend="cuda")
        return out

    _reset_launches()
    got = chain(dev)
    torch.cuda.synchronize()
    launches["fractional"] = run = _launches()
    want = chain("cpu")
    for k, y in got.items():
        x = rows[k.split()[0]].double()
        ref = (x @ w_i.double() if k.endswith("dot")
               else hs[k.split()[0]].double() @ w_o.double())
        err = float((y.cpu().double() - ref).abs().max())
        same = _bit_equal(torch, y.cpu(), want[k])
        print(f"  frac_exp {1 if k.endswith('dot') else 2} {k}: "
              f"{list(y.shape)} card == cpu bit for bit {same}, max |y - "
              f"float64| = {err:.3g} (|ref| max "
              f"{float(ref.abs().max()):.3g})")
        if not same or not err <= 0.02 * float(ref.abs().max()):
            bad.append(f"fractional chain {k}")
    print(f"  launches on the fractional path: {run}")
    for name in ("rns_normalize", "rns_fused_dot",
                 "rns_fused_matmul_normalize"):
        if not run[name]:
            bad.append(f"{name} not launched on the fractional path")

    # ---- the Mandelbrot demo, full size: captured, then eager
    iters, (W, H) = 256, (1920, 1080)
    cr, ci = mb.view(W, H)
    probe = mb.MandelbrotRender("rns12", cr, ci, iters, device=dev,
                                graphs=False)
    n_ops, step_bytes = _traffic(torch, lambda: mb.mandelbrot_step(
        probe.profile, iters, **probe.inputs))
    del probe
    bound_s = step_bytes * iters / HBM_BYTES_PER_S
    print(f"  mandelbrot step: {n_ops} aten ops moving {step_bytes} bytes "
          f"({step_bytes / (W * H):.1f} a pixel); bound of the render "
          f"{bound_s:.4f} s (bytes)")
    full, st = mb.render("rns12", cr, ci, iters, device=dev)
    torch.cuda.empty_cache()
    eager, st_e = mb.render("rns12", cr, ci, iters, device=dev,
                            graphs=False)
    torch.cuda.empty_cache()
    agree = float(np.mean(mb.escape_f64(cr, ci, iters, device=dev) == full))
    print(f"  mandelbrot rns12 {W}x{H} x {iters} iterations: captured "
          f"{st['seconds']:.4f} s ({st['pixel_iters_per_s']:.6g} "
          f"pixel-iterations/s, build {st['build_s']:.3f} s, captures "
          f"{st['captures']}), eager {st_e['seconds']:.4f} s "
          f"({st_e['pixel_iters_per_s']:.6g}/s); escape counts equal "
          f"{np.array_equal(full, eager)}; agreement with float64 "
          f"{agree:.6f}; captured / bound {st['seconds'] / bound_s:.3f}")
    if not (np.array_equal(full, eager) and st["captures"] == 1
            and st_e["captures"] == 0 and agree > 0.9):
        bad.append("mandelbrot full render")

    # ---- a 256 x 256 crop: captured, eager, on the CPU
    r0, c0 = (H - 256) // 2, (W - 256) // 2
    crop = (slice(r0, r0 + 256), slice(c0, c0 + 256))
    runs = {"captured": mb.render("rns12", cr[crop], ci[crop], iters,
                                  device=dev),
            "eager": mb.render("rns12", cr[crop], ci[crop], iters,
                               device=dev, graphs=False),
            "cpu": mb.render("rns12", cr[crop], ci[crop], iters,
                             device="cpu")}
    same = all(np.array_equal(e, full[crop]) for e, _ in runs.values())
    print("  mandelbrot crop 256x256 x 256: " + ", ".join(
        f"{k} {v[1]['seconds']:.4f} s ({v[1]['pixel_iters_per_s']:.6g}/s)"
        for k, v in runs.items())
        + f"; escape counts equal (and equal to the full render's "
        f"window) {same}")
    if not same:
        bad.append("mandelbrot crop: card captured / eager / cpu differ")

    # ---- the deep proof
    deep = mb.deep_precision_proof(dev)
    deep_cpu = mb.deep_precision_proof("cpu")
    print(f"  rns24_deep ({deep['frac_bits']:.1f} fractional bits): "
          f"float64(c1) == float64(c0) {deep['f64_equal']}; orbits differ "
          f"by {float(deep['diff']):.6e} after 30 iterations; card == cpu "
          f"{deep['diff'] == deep_cpu['diff']}")
    if not (deep["f64_equal"] and deep["diff"] != 0
            and deep["diff"] == deep_cpu["diff"]):
        bad.append("deep proof")

    # ---- B.3, B.4, B.6 with a scaled table vs their plain versions
    mods = _kernel_mods()
    gd = torch.Generator(device=dev).manual_seed(6)
    b_i = _residues(torch, p, (D, N), gd, dev).to(torch.int8)
    b_o = _residues(torch, p, (N, D), gd, dev).to(torch.int8)
    inputs = {}
    for k, shape in (("decode", (8, 1)), ("prefill", (1, 144))):
        x = torch.randn(shape + (D,), generator=gd, device=dev)
        s = 127.0 / x.abs().amax(dim=-1, keepdim=True)
        a = _residues(torch, p, shape + (N,), gd, dev)
        inputs[k] = {"rns_normalize": (a,),
                     "rns_fused_dot": (x, s, b_i),
                     "rns_fused_matmul_normalize": (a, b_o)}
    scales = {"M_f^-1": 1.0 / p.M_f, "M_f^-2": 1.0 / float(p.M_f) ** 2,
              "M_f^-10": 1.0 / float(p.M_f) ** 10}
    for kernel in ("rns_normalize", "rns_fused_dot",
                   "rns_fused_matmul_normalize"):
        wrapper = getattr(mods[kernel], kernel)
        plain = getattr(mods[kernel], kernel + "_plain")
        kw = {"bits": 8} if kernel == "rns_fused_dot" else {}
        for row, ins in inputs.items():
            args = ins[kernel]
            label, nbytes, ops, rate = _cost(torch, kernel, p.n_digits, args,
                                             kw)
            for sname, inv in scales.items():
                def fn(a=args, i=inv):
                    return wrapper(p, *a, inv_scale=i, **kw)

                def pl(a=args, i=inv):
                    return plain(p, *a, inv_scale=i, **kw)

                y, yp = fn(), pl()
                ok = _bit_equal(torch, y, yp)
                entry = {"case": f"rns9 {row} {label} inv_scale {sname}",
                         "max_abs_err": _max_abs_err(torch, y, yp),
                         "bit_equal": ok, "subnormal_weights": bool(
                             inv * 1.0 < 2.0 ** -126)}
                if row == "decode" and sname == "M_f^-2":
                    b, by = _bound(nbytes, ops, rate)
                    entry.update(
                        ms=_time_ms(torch, fn, 20),
                        unscaled_ms=_time_ms(
                            torch, lambda a=args: wrapper(p, *a, **kw), 20),
                        plain_ms=_time_ms(torch, pl, 5), bound_ms=b,
                        bound_by=by, library_ms=None)
                record.setdefault(kernel, []).append(entry)
                print(f"  {kernel:26s} {entry['case']:60s} " + " ".join(
                    f"{k}={v}" for k, v in entry.items() if k != "case"))
                if not ok:
                    bad.append(f"{kernel} {entry['case']}")
    if bad:
        raise AssertionError(f"[fractional] failed: {bad}")
    print("[fractional] ok")


def _kernel_line(record: dict, launches: dict, tuned: dict) -> dict:
    matmul_src = "src/repro_torch/kernels/rns_matmul/csrc/rns_matmul.cu"
    mma_src = "src/repro_torch/kernels/rns_fused/csrc/rns_fused_mma.cu"
    meta = {
        "rns_convert": ("src/repro_torch/kernels/rns_convert/csrc/"
                        "rns_convert.cu",
                        "src/repro/kernels/rns_convert/kernel.py:38"),
        "rns_matmul": (matmul_src,
                       "src/repro/kernels/rns_matmul/kernel.py:51"),
        "rns_normalize": ("src/repro_torch/kernels/rns_normalize/csrc/"
                          "rns_normalize.cu",
                          "src/repro/kernels/rns_normalize/kernel.py:93"),
        "rns_fused_encode_matmul": (
            mma_src, "src/repro/kernels/rns_fused/kernel.py:82"),
        "rns_fused_matmul_normalize": (
            mma_src, "src/repro/kernels/rns_fused/kernel.py:141"),
        "rns_fused_dot": (mma_src,
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
                       launches.items()
                       if path.startswith("serve") or path == "fractional"}
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
            "unfused_ms": head.get("unfused_ms"),
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
                torch, "serve", launches, calls))),
            ("serve_fused", lambda: untuned.__setitem__(
                "serve_fused", phase_serve(torch, "serve_fused", launches,
                                           calls))),
            ("serve_per_layer", lambda: phase_serve_per_layer(
                torch, launches, calls, untuned)),
            ("tune", lambda: phase_tune(torch, dev, calls, launches, tuned)),
            ("serve_tuned", lambda: phase_serve_tuned(torch, launches, calls,
                                                      untuned)),
            ("kernels", lambda: phase_kernels(torch, dev, record, calls,
                                              launches)),
            ("identity", lambda: phase_identity(torch)),
            ("fractional", lambda: phase_fractional(torch, dev, record,
                                                    launches))]:
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
