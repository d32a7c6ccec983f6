#!/usr/bin/env python3
"""Design sweeps of the two tensor-core kernels, on one card.

    python3 scripts/kernel_variants.py [--out FILE] STUDY...

Each STUDY (see ``STUDIES``) names variants of one kernel source: copies
of ``rns_matmul.cu`` or ``flash_attention.cu`` edited by regular-
expression substitutions, built with the port's nvcc flags into
``build/variants/`` (all in parallel).  Each variant's library is bound
in place of the kernel's own, and the real wrapper is timed through it
(device time per call from CUDA-graph replays, ``autotune.
device_seconds``) on the main path's shapes: smollm-135m rns9's four
RNS matmuls (decode 8 rows, prefill 144 rows; d_model 576, d_ff 1536)
and its attention at 2048 tokens (9 query heads, 3 KV heads of 64),
inputs made from seed 0, every output checked against the plain
version.  Variants that drop work are timing probes only: their
outputs are marked wrong.  One JSON object per study and variant is
printed (and appended to FILE), each with the card's name and power
limit.

Studies:

* ``rns_matmul_splits``: the kernel as it is, with the split over D
  forced to 1, 2, 4 and 8 blocks per tile at every compiled tile (what
  ``rns_matmul.splits_for`` chooses from);
* ``rns_matmul_ring``: the K step and ring depth (128 x 3 as built,
  128 x 4, 64 x 4) at every tile, splits as ``splits_for`` chooses;
* ``flash_parts``: flash_attention as built, and with the exponentials,
  the P.V products, the Q.K products or all of a tile's arithmetic, or
  the K/V loads, left out: where the time of a tile goes.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_NOPV = [(r"mma_16<T>\(acc\[j\], pl, vb\[0\], vb\[1\]\);", ""),
         (r"mma_16<T>\(acc\[j\], ph, vb\[0\], vb\[1\]\);", ""),
         (r"mma_16<T>\(acc\[j \+ 1\], pl, vb\[2\], vb\[3\]\);", ""),
         (r"mma_16<T>\(acc\[j \+ 1\], ph, vb\[2\], vb\[3\]\);",
          "acc[j][0] += __uint_as_float(vb[0] ^ vb[1] ^ vb[2] ^ vb[3] ^ "
          "ph[0] ^ pl[1]);")]
STUDIES = {
    "rns_matmul_splits": ("rns_matmul", {"as built": []}, [1, 2, 4, 8]),
    "rns_matmul_ring": ("rns_matmul", {
        "BK 128, 3 stages (as built)": [],
        "BK 128, 4 stages": [(r"constexpr int STAGES = 3;",
                              "constexpr int STAGES = 4;")],
        "BK 64, 4 stages": [(r"constexpr int BK = 128;",
                             "constexpr int BK = 64;"),
                            (r"constexpr int STAGES = 3;",
                             "constexpr int STAGES = 4;")]}, [None]),
    "flash_parts": ("flash_attention", {
        "as built": [],
        "no exp": [(r"const float p = expf\(s\[j\]\[e\] - m\[e / 2\]\);",
                    "const float p = s[j][e];"),
                   (r"corr\[i\] = expf\(m\[i\] - m_new\);",
                    "corr[i] = 1.f;")],
        "no P.V MMAs (16-bit)": _NOPV,
        "no Q.K MMAs (16-bit)": [
            (r"mma_16<T>\(s\[j\], qa\[kk\], \*\(const uint32_t\*\)kr,\n"
             r"\s*\*\(const uint32_t\*\)\(kr \+ 8\)\);",
             "s[j][0] += __uint_as_float(*(const uint32_t*)kr ^ "
             "qa[kk][0]);")],
        "no arithmetic (loads only)": [
            (r"if \(wlive && !\(causal && k0 > wlast\)\) \{",
             "if (wlive && !(causal && k0 > wlast) && Tq < 0) {")],
        "no K/V loads (arithmetic only)": [
            (r"if \(it \+ 1 < ntiles\) \{", "if (it + 1 < ntiles && Tq < 0) {")],
    }, [None]),
}
MATMUL_SHAPES = [(8, 576, 1536), (8, 1536, 576), (144, 576, 1536),
                 (144, 1536, 576)]
FLASH_CASES = [("bfloat16", True), ("bfloat16", False), ("float32", True),
               ("float32", False)]
FLASH_TILES = [(64, 64), (128, 64), (128, 128), (64, 32)]


def _build(name, source, subs, nvcc, flags, include):
    text = source.read_text()
    for pat, rep in subs:
        new = re.sub(pat, rep, text)
        if new == text:
            raise ValueError(f"{name}: pattern {pat!r} matches nothing")
        text = new
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    stem = re.sub(r"\W+", "_", name)
    cu, so = out / f"{stem}.cu", out / f"{stem}.so"
    cu.write_text(text)
    r = subprocess.run([nvcc, *flags, f"-I{include}", "-o", str(so),
                        str(cu)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    log = r.stdout + r.stderr
    return so, {"registers": sorted({int(x) for x in re.findall(
        r"Used (\d+) registers", log)}), "spill_bytes": sorted({int(x) for x in
        re.findall(r"(\d+) bytes spill stores", log)})}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("studies", nargs="+", choices=sorted(STUDIES))
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants.py: no CUDA device", file=sys.stderr)
        return 2
    import os

    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(
        ROOT / "build" / "variants" / "autotune.json")
    from repro_torch.core.moduli import get_profile
    from repro_torch.kernels import autotune, build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rns_matmul import ops as mm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    mods = {"rns_matmul": mm, "flash_attention": fa}
    jobs = [(study, name, mods[STUDIES[study][0]], subs)
            for study in args.studies
            for name, subs in STUDIES[study][1].items()]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: _build(
            f"{j[0]} {j[1]}", j[2].SOURCE, j[3], build._nvcc(),
            build.NVCC_FLAGS, build.INCLUDE_DIR), jobs))
    print(f"built {len(jobs)} variants in {time.perf_counter() - t0:.1f}s")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    p = get_profile("rns9")

    def us(fn):
        return autotune.device_seconds(fn, iters=20) * 1e6

    def res(shape):
        return torch.stack([torch.randint(0, m, shape, generator=g,
                                          device=dev)
                            for m in p.moduli]).to(torch.int8)

    mm_in = {s: (res(s[:2]), res(s[1:])) for s in MATMUL_SHAPES}
    fa_in = {dt: tuple(torch.randn(s, generator=g, device=dev).to(
        getattr(torch, dt)) for s in ((1, 2048, 9, 64), (1, 2048, 3, 64),
                                      (1, 2048, 3, 64)))
        for dt in ("bfloat16", "float32")}
    splits_rule = mm.splits_for
    for (study, name, mod, _), (so, regs) in zip(jobs, built):
        lib = ctypes.CDLL(str(so))
        mod._bind(lib)
        build._LIBS[mod.SOURCE.stem] = lib
        rows = {}
        if mod is mm:
            for shape, (a, b) in mm_in.items():
                want = mm.rns_matmul_plain(p, a, b)
                for tile in autotune.CANDIDATES["rns_matmul"]:
                    for n in STUDIES[study][2]:
                        mm.splits_for = splits_rule if n is None else (
                            lambda *_, n=n: n)
                        run = (lambda a=a, b=b, t=tile:
                               mm.rns_matmul(p, a, b, **t))
                        ok = torch.equal(run(), want)
                        label = (f"{shape} {tile['bm']}x{tile['bn']}"
                                 + ("" if n is None else f" splits {n}"))
                        rows[label] = [us(run), ok]
            mm.splits_for = splits_rule
        else:
            for dt, causal in FLASH_CASES:
                q, k, v = fa_in[dt]
                want = fa.flash_attention_plain(q, k, v, causal=causal)
                for bq, bk in FLASH_TILES:
                    def run(q=q, k=k, v=v, c=causal, t=dict(bq=bq, bk=bk)):
                        return fa.flash_attention(q, k, v, causal=c, **t)
                    ok = fa.within_tolerance(run(), want)[0]
                    rows[f"{dt} causal={causal} {bq}x{bk}"] = [us(run), ok]
        line = {"study": study, "variant": name, "card": card, **regs,
                "us_and_correct": rows}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del build._LIBS[mod.SOURCE.stem]
    return 0


if __name__ == "__main__":
    sys.exit(main())
