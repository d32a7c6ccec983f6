#!/usr/bin/env python3
"""Design sweeps of the port's kernels, on one card.

    python3 scripts/kernel_variants.py [--out FILE] STUDY...

Each STUDY (see ``STUDIES``) names variants of one kernel source: copies
of ``rns_matmul.cu``, ``rns_fused_mma.cu``, ``rns_convert.cu``,
``flash_attention.cu``, ``rns_normalize.cu`` or the design candidates
``variants/rns_encode_one_digit.cu``,
``variants/rns_normalize_two_pass.cu`` and
``variants/rns_normalize_elems.cu`` edited by regular-expression
substitutions (a variant may name its own source), built with the
port's nvcc flags into ``build/variants/`` (all in parallel).  Each
variant's library is bound in place of the
kernel's own, and the real wrapper is timed through it (the candidate,
which has no wrapper, through :func:`_one_digit_encode`; device time
per call from CUDA-graph replays, ``autotune.device_seconds``) on the
main path's shapes: smollm-135m rns9's four RNS matmuls (decode 8 rows,
prefill 144 rows; d_model 576, d_ff 1536), its fused dot (wg: x [rows,
576] with row scales), fused encode + matmul (wi, the same inputs) and
fused matmul + normalize (wo: int32 residues [9, rows, 1536]), its
convert rows, its normalize rows (the per-op path's int32 residues
[9, 8, 1, 1536], [9, 8, 1, 576], [9, 1, 144, 1536], [9, 1, 144, 576]),
and its attention at 2048 tokens (9 query heads, 3 KV heads of 64),
inputs made from seed 0, every output checked against the plain
version.  Variants that drop work are timing probes only: their outputs
are marked wrong.
One JSON object per study and variant is printed (and appended to
FILE), each with the card's name and power limit.

Studies:

* ``rns_matmul_splits``: the kernel as it is, with the split over D
  forced to 1, 2, 4 and 8 blocks per tile at every compiled tile (what
  ``rns_matmul.splits_for`` chooses from);
* ``rns_matmul_ring``: the K step and ring depth (128 x 3 as built,
  128 x 4, 64 x 4) at every tile, splits as ``splits_for`` chooses;
* ``flash_parts``: flash_attention as built, and with the exponentials,
  the P.V products, the Q.K products or all of a tile's arithmetic, or
  the K/V loads, left out: where the time of a tile goes;
* ``fused_splits``: the fused dot, matmul + normalize and encode +
  matmul as built (all K digits of a tile in one block), with the split
  over D forced to 1, 2, 4, 6 and 8 blocks a tile at every compiled tile
  (what ``rns_fused.splits_for`` chooses from);
* ``fused_ring``: their ring's K step and depth forced to 128 x 3, 128 x
  2, 64 x 3, 64 x 4, 64 x 2, 32 x 4, 32 x 3 and 32 x 2 at every tile
  (shallower rings fit two blocks an SM; the built rule takes the
  deepest that fits; a ring that does not fit is refused at launch),
  splits as ``splits_for`` chooses;
* ``fused_parts``: where a fused tile's time goes -- as built, without
  the MRC epilogue, without the MMAs, without the dot's quantize step;
* ``fused_loads``: the same with b's or a's copies left out (timing
  probes), and with int32 a's rows past M (decode: 8 of 16) not copied
  instead of zero-filled;
* ``fused_layout``: the two layouts of the digits -- all K digits of a
  tile in one block (the fused kernel as built, every tile), against one
  digit a block: rns_matmul's blocks (its default tile and splits) with
  the MRC in a second kernel (rns_normalize), preceded by rns_convert
  for the dot, in one CUDA graph on the same inputs (int32 a_res cast to
  int8 outside the graph).  The last-block-MRC form of the digit-a-block
  layout is not built;
* ``encode_layout``: the fused encode + matmul (B.5, x [rows, 576] with
  row scales @ wi [9, 576, 1536] at bits 8) in its two layouts: all K
  digits of a tile in one block (``rns_fused_mma.cu``'s
  ``rns_encode_residues_kernel``, the kernel the port runs, through its
  wrapper at every tile, splits by ``rns_fused.splits_for``) against one
  digit a block (``variants/rns_encode_one_digit.cu``, built only here:
  rns_matmul's tiles and splits, the block's x rows quantized once into
  shared memory, several column tiles a block by
  :func:`col_tiles_for`);
* ``encode_parts``: where a one-digit B.5 block's time goes -- as built,
  without the quantize step, without b's copies, without the MMAs
  (timing probes); rns_matmul on the same shapes (int8 residues) beside
  them;
* ``encode_coltiles``: the one-digit B.5 with the column tiles a block
  walks forced to 1, 2 and 4 at every tile;
* ``convert_quads``: rns_convert with 1, 2 or 4 runs of 4 elements a
  thread, at every candidate block size, on the per-op path's weight
  rows and activation rows;
* ``normalize_design``: rns_normalize (B.3) at bt 128, 256 and 512 on
  the per-op path's four rows -- the two-pass kernel with floor-mods
  (``variants/rns_normalize_two_pass.cu``, the design before the one
  pass), with offset multiply-high mods (``mulhi_mod``), and in one pass
  with those; the shipped one-pass kernel (direct-remainder terms,
  ``mrc_term``, one element a thread), the same at 2 and 4 elements a
  thread with vector loads (``variants/rns_normalize_elems.cu``), and
  with 32-bit in place of 64-bit indices; and a timing probe that only loads the
  residues and stores a float (their XOR): the memory floor.

The fused studies build rns9's digit count only (K = 9), which keeps
their builds short.
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
_K9 = [(r"RNS_FUSED_MMA_CASE\((?:5|6|7|8|12|16|18|21)\)", "")]
# the one-digit fused encode + matmul, a design candidate
ONE_DIGIT_SOURCE = ROOT / "scripts" / "variants" / "rns_encode_one_digit.cu"
# the two-pass MRC normalize, the design the one-pass kernel replaced
TWO_PASS_SOURCE = ROOT / "scripts" / "variants" / "rns_normalize_two_pass.cu"
ELEMS_SOURCE = ROOT / "scripts" / "variants" / "rns_normalize_elems.cu"
_ONE: list = []
# probes: a copy left out (the ring keeps what was there before)
_NOLOAD_B = (r"(      if \(b_vec\)\n)        stage_async<BT, BK, BN, NT, K>"
             r"\(st, BK \* BST, BST, b, bmat, N, D, N,\n\s*k0, col0\);",
             r"\1        {}")
_NOLOAD_A = [(r"(      if \(a_vec\)\n)        stage_async<(?:AT|float), BM, BK, "
              r"NT[^;]*;", r"\1        {}")]
# int32 a: the rows past M (decode: 8 of 16) not copied at all
_SKIP_A_ROWS = (
    r"stage_async<AT, BM, BK, NT, K>\(sa, ADIG, IST \* 4, a, amat, D, M, D,"
    r"\n\s*row0, k0\);",
    "for (int c = threadIdx.x; c < K * BM * (BK / 4); c += NT) {\n"
    "  const int j = c / (BM * (BK / 4)), r = c % (BM * (BK / 4)) / (BK / 4);\n"
    "  const int gk = k0 + 4 * (c % (BK / 4));\n"
    "  if (row0 + r >= M) continue;\n"
    "  cp_async16(sa + j * ADIG + r * IST * 4 + 4 * (gk - k0) * 1,\n"
    "             gk < D ? (const void*)(a + ((long long)j * M + row0 + r) * D"
    " + gk) : (const void*)a, gk < D ? 16 : 0);\n}")


_MULHI = (r"constexpr bool MULHI = false;", "constexpr bool MULHI = true;")


def _ring(bk, stages):
    return _K9 + [
        (r"static constexpr int BK = R == 0 \? 128 : R <= 2 \? 64 : 32;",
         f"static constexpr int BK = {bk};"),
        (r"static constexpr int STAGES = R == 2 \|\| R == 4 \? 2 : 3;",
         f"static constexpr int STAGES = {stages};")]


STUDIES.update({
    "fused_splits": ("rns_fused_mma", {"as built": _K9}, [1, 2, 4, 6, 8]),
    "fused_ring": ("rns_fused_mma", {
        f"BK {bk}, {st} stages": _ring(bk, st)
        for bk, st in ((128, 3), (128, 2), (64, 3), (64, 4), (64, 2),
                       (32, 4), (32, 3), (32, 2))},
        [None]),
    "fused_layout": ("rns_fused_mma", {"as built": _K9}, [None]),
    "encode_layout": ("one_digit", {"one digit a block": _ONE}, [None]),
    "encode_parts": ("one_digit", {
        "as built": _ONE,
        "no quantize": _ONE + [
            (r"quantize\(\(kb \+ i\) \* BK, min\(cst, n - i\)\);", "")],
        "no b copies": _ONE + [
            (r"stage_async<BT, BK, BN, L::THREADS>\(sb, 0, L::BST, B, 0, N, "
             r"D, N, k0,\n\s*col0\);", "{}")],
        "no MMAs": _ONE + [
            (r"mma_(?:s8)?u8\(acc\[mi\]\[j\], a0, a1, a2, a3, "
             r"b0\[j\], b1\[j\]\);",
             "acc[mi][j][0] += (int)(a0 ^ a1 ^ a2 ^ a3 ^ b0[j] ^ b1[j]);")],
    }, [None]),
    "encode_coltiles": ("one_digit", {"one digit a block": _ONE},
                        [1, 2, 4]),
    "convert_quads": ("rns_convert", {
        "1 quad a thread (as built)": [],
        **{f"{q} quads a thread": [(r"constexpr int QUADS = 1;",
                                    f"constexpr int QUADS = {q};")]
           for q in (2, 4)}}, [None]),
    "fused_loads": ("rns_fused_mma", {
        "as built": _K9,
        "no b loads": _K9 + [_NOLOAD_B],
        "no a loads": _K9 + _NOLOAD_A,
        "no loads": _K9 + [_NOLOAD_B] + _NOLOAD_A,
        "a rows past M not copied": _K9 + [_SKIP_A_ROWS]}, [None]),
    "normalize_design": ("rns_normalize", {
        "two passes, floor-mod": ("normalize_two_pass", []),
        "two passes, multiply-high": ("normalize_two_pass", [_MULHI]),
        "one pass, offset multiply-high": ("normalize_two_pass", [
            _MULHI,
            (r"constexpr int PASSES = 2;", "constexpr int PASSES = 1;")]),
        "one pass, 1 element a thread": [],
        **{f"one pass, {e} elements a thread": ("normalize_elems", [
            (r"constexpr int ELEMS = \d;", f"constexpr int ELEMS = {e};")])
           for e in (2, 4)},
        "one pass, 32-bit indices": [
            (r"const int32_t\* __restrict__ res,\n(\s*)long long T,",
             r"const int32_t* __restrict__ res,\n\1int T,"),
            (r"const long long i = \(long long\)blockIdx",
             "const int i = (int)blockIdx"),
            (r"res\[\(long long\)j \* T \+ i\]", "res[j * T + i]")],
        "loads and stores only (timing probe)": [
            (r"mrc_decode_float<K>\(r, t\)",
             "[&] { int x = 0; for (int j = 0; j < K; ++j) x ^= r[j]; "
             "return (float)x; }()")]}, [None]),
    "fused_parts": ("rns_fused_mma", {
        "as built": _K9,
        "no MRC epilogue": _K9 + [
            (r"\(\(float\*\)out\)\[\(long long\)gm \* N \+ gc\] = "
             r"mrc_decode_float<K>\(res, t\);",
             "((float*)out)[(long long)gm * N + gc] = (float)res[0] + "
             "res[K - 1];")],
        "no MMAs": _K9 + [
            (r"mma_(?:s8)?u8\(acc\[mi\]\[j\], a0, a1, a2, a3, b0\[j\], "
             r"b1\[j\]\);",
             "acc[mi][j][0] += (int)(a0 ^ a1 ^ a2 ^ a3 ^ b0[j] ^ b1[j]);")],
        "no quantize (dot)": _K9 + [(r"quantize\(st\);", "")],
    }, [None]),
})
#: (rows, D, N) of the fused wrappers' main-path calls: wg (the dot) and
#: wo (matmul + normalize), decode and prefill
FUSED_SHAPES = {"rns_fused_dot": [(8, 576, 1536), (144, 576, 1536)],
                "rns_fused_matmul_normalize": [(8, 1536, 576),
                                               (144, 1536, 576)],
                "rns_fused_encode_matmul": [(8, 576, 1536),
                                            (144, 576, 1536)]}
MATMUL_SHAPES = [(8, 576, 1536), (8, 1536, 576), (144, 576, 1536),
                 (144, 1536, 576)]
#: (rows, D, N) of the fused encode + matmul's main-path calls (wi)
ENCODE_SHAPES = [(8, 576, 1536), (144, 576, 1536)]
#: rns_normalize's main-path calls (the per-op path's int32 residues)
NORMALIZE_SHAPES = [(9, 8, 1, 1536), (9, 8, 1, 576), (9, 1, 144, 1536),
                    (9, 1, 144, 576)]
#: rns_convert's main-path calls: the per-op weight rows (a scalar
#: scale) and activation rows (one scale a row)
CONVERT_SHAPES = [((576, 1536), False), ((1536, 576), False),
                  ((8, 1536), True), ((144, 1536), True)]
FLASH_CASES = [("bfloat16", True), ("bfloat16", False), ("float32", True),
               ("float32", False)]
FLASH_TILES = [(64, 64), (128, 64), (128, 128), (64, 32)]


def variant_source(study, subs):
    """(source key, substitutions) of one variant of ``study``: its own
    when it names one as a (key, subs) pair, else the study's."""
    return subs if isinstance(subs, tuple) else (STUDIES[study][0], subs)


def _build(name, source, subs, nvcc, flags, include):
    text = source.read_text()
    for pat, rep in subs:
        text, n = re.subn(pat, rep, text)
        if not n:
            raise ValueError(f"{name}: pattern {pat!r} matches nothing")
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


def _digit_a_block(kind, p, call, kw, want, us):
    """[us, correct] of the digit-a-block layout of one fused call: the
    port's rns_matmul (one digit's tile a block), then rns_normalize (and
    rns_convert first for the dot), in one graph."""
    import torch

    from repro_torch.kernels.rns_convert.ops import rns_convert
    from repro_torch.kernels.rns_matmul.ops import rns_matmul
    from repro_torch.kernels.rns_normalize.ops import rns_normalize

    if kind == "rns_fused_dot":
        x, s, b = call

        def run():
            return rns_normalize(p, rns_matmul(p, rns_convert(
                p, x, s, bits=kw["bits"], out_dtype=torch.int8), b))
    else:
        a8, b = call[0].to(torch.int8), call[1]

        def run():
            return rns_normalize(p, rns_matmul(p, a8, b))
    return [us(run), torch.equal(run(), want)]


def col_tiles_for(S: int, M: int, N: int, bm: int, bn: int,
                  sms: int) -> int:
    """Column tiles each block of the one-digit encode + matmul walks on
    its once-quantized x rows when its tile is not split: as many as
    leave about two blocks an SM, at most 4 (prefill; decode's tiles are
    too few to share)."""
    tiles = S * -(-M // bm) * -(-N // bn)
    return max(1, min(4, tiles // (2 * sms)))


def _one_digit_encode(lib, mm, fo, p, call, tile):
    """A runner of the one-digit encode + matmul
    (``variants/rns_encode_one_digit.cu``) on one call: rns_matmul's
    splits (``mm.splits_for``) and workspace, and :func:`col_tiles_for`
    column tiles a block when unsplit."""
    import torch

    from repro_torch.kernels import build

    x, s, b = call
    M, D = x.shape
    N = b.shape[-1]
    bm, bn = tile["bm"], tile["bn"]
    splits, ws, cnt = mm.split_args(p.n_digits, M, D, N, bm, bn, x.device)
    ntile = 1 if splits > 1 else col_tiles_for(
        p.n_digits, M, N, bm, bn,
        torch.cuda.get_device_properties(x.device).multi_processor_count)
    sc, group = fo._row_scales("encode_matmul", x, s)
    out = torch.empty((p.n_digits, M, N), dtype=torch.int32, device=x.device)

    def run():
        err = lib.rns_fused_encode_matmul(
            x.data_ptr(), sc.data_ptr(), group, 127.0, b.data_ptr(), 1, M, N,
            D, p.lazy_chunk - 1, ctypes.byref(build.rns_tables_c(p)),
            out.data_ptr(), bm, bn, splits, ws, cnt, ntile,
            torch.cuda.current_stream().cuda_stream)
        build.check(err, "rns_fused_encode_matmul (one digit a block)")
        return out
    return run


def main() -> int:
    global col_tiles_for            # forced by the encode_coltiles study
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
    from repro_torch.kernels.rns_convert import ops as co
    from repro_torch.kernels.rns_fused import ops as fo
    from repro_torch.kernels.rns_matmul import ops as mm
    from repro_torch.kernels.rns_normalize import ops as no

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    # source -> (module, its source file, library name, binder)
    mods = {"rns_matmul": (mm, mm.SOURCE, "rns_matmul", mm._bind),
            "rns_fused_mma": (fo, fo.SOURCE, "rns_fused_mma", fo._bind),
            "flash_attention": (fa, fa.SOURCE, "flash_attention", fa._bind),
            "rns_convert": (co, co.SOURCE, "rns_convert", co._bind),
            "rns_normalize": (no, no.SOURCE, "rns_normalize", no._bind),
            "normalize_two_pass": (no, TWO_PASS_SOURCE, "rns_normalize",
                                   no._bind),
            "normalize_elems": (no, ELEMS_SOURCE, "rns_normalize", no._bind),
            "one_digit": (mm, ONE_DIGIT_SOURCE, "one_digit",
                          lambda lib: None)}
    jobs = [(study, name, mods[key], subs)
            for study in args.studies
            for name, v in STUDIES[study][1].items()
            for key, subs in [variant_source(study, v)]]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: _build(
            f"{j[0]} {j[1]}", j[2][1], j[3], build._nvcc(),
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
    no_in = {s: res(s[1:]).to(torch.int32) for s in NORMALIZE_SHAPES}
    fa_in = {dt: tuple(torch.randn(s, generator=g, device=dev).to(
        getattr(torch, dt)) for s in ((1, 2048, 9, 64), (1, 2048, 3, 64),
                                      (1, 2048, 3, 64)))
        for dt in ("bfloat16", "float32")}
    splits_rule, fused_splits, fused_ring = (mm.splits_for, fo.splits_for,
                                             fo.fused_ring)
    ct_rule = col_tiles_for
    fu_in = {}
    for kind, shapes in FUSED_SHAPES.items():
        for M, D, N in shapes:
            b = res((D, N))
            if kind != "rns_fused_matmul_normalize":
                x = torch.randn((M, D), generator=g, device=dev)
                call = (x, 127.0 / x.abs().amax(dim=1, keepdim=True), b)
                kw = {"bits": 8}
            else:
                call, kw = (res((M, D)).to(torch.int32), b), {}
            fu_in[(kind, M, D, N)] = (call, kw)
    enc_in = {}
    for M, D, N in ENCODE_SHAPES:
        x = torch.randn((M, D), generator=g, device=dev)
        enc_in[(M, D, N)] = (x, 127.0 / x.abs().amax(dim=1, keepdim=True),
                             res((D, N)))
    for (study, name, (mod, _, libname, bind), subs), (so, regs) in zip(
            jobs, built):
        lib = ctypes.CDLL(str(so))
        bind(lib)
        build._LIBS[libname] = lib
        rows = {}
        ring = re.search(r"BK (\d+), (\d+) stages", name)
        if ring:                    # the wrapper sizes its splits on it
            fo.fused_ring = lambda *_, r=ring: (int(r[1]), int(r[2]))
        if study.startswith("encode_"):
            # the one-digit candidate; in encode_layout, the port's
            # all-digit kernel through its wrapper beside it
            p_i, p_f, p_l = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.rns_fused_encode_matmul.argtypes = [
                p_i, p_i, p_l, ctypes.c_float, p_i, p_f, p_f, p_f, p_f, p_f,
                ctypes.POINTER(build.RnsTablesC), p_i, p_f, p_f, p_f, p_i,
                p_i, p_f, p_i]
            lib.rns_fused_encode_matmul.restype = ctypes.c_int
            for shape, call in enc_in.items():
                want = fo.rns_fused_encode_matmul_plain(p, *call, bits=8)
                if study == "encode_parts" and name == "as built":
                    a8 = co.rns_convert(p, call[0], call[1], bits=8)

                    def run(a8=a8, b=call[2]):
                        return mm.rns_matmul(p, a8, b)
                    rows[f"{shape} rns_matmul on int8 residues"] = [
                        us(run), torch.equal(run(), want)]
                if study == "encode_layout":
                    for tile in autotune.CANDIDATES[
                            "rns_fused_encode_matmul"]:
                        def run(c=call, t=tile):
                            return fo.rns_fused_encode_matmul(p, *c, bits=8,
                                                              **t)
                        rows[f"{shape} {tile['bm']}x{tile['bn']} all "
                             "digits"] = [us(run), torch.equal(run(), want)]
                for tile in autotune.CANDIDATES["rns_matmul"]:
                    for n in STUDIES[study][2]:
                        col_tiles_for = ct_rule if n is None else (
                            lambda *_, n=n: n)
                        run = _one_digit_encode(lib, mm, fo, p, call, tile)
                        label = (f"{shape} {tile['bm']}x{tile['bn']} one "
                                 "digit" + ("" if n is None
                                            else f" column tiles {n}"))
                        rows[label] = [us(run), torch.equal(run(), want)]
            col_tiles_for = ct_rule
        elif study == "convert_quads":
            for shape, rows_scale in CONVERT_SHAPES:
                x = torch.randn(shape, generator=g, device=dev)
                sc = (127.0 / x.abs().amax(dim=-1, keepdim=True)
                      if rows_scale else 127.0 / x.abs().amax())
                want = co.rns_convert_plain(p, x, sc, bits=8)
                for bt in (128, 256, 512):
                    def run(x=x, sc=sc, bt=bt):
                        return co.rns_convert(p, x, sc, bits=8, bt=bt)
                    rows[f"{shape} bt{bt}"] = [us(run),
                                               torch.equal(run(), want)]
        elif mod is no:             # a probe's outputs are wrong
            for shape, r in no_in.items():
                want = no.rns_normalize_plain(p, r)
                for bt in (128, 256, 512):
                    def run(r=r, bt=bt):
                        return no.rns_normalize(p, r, bt=bt)
                    rows[f"{list(shape)} bt{bt}"] = [
                        us(run), torch.equal(run(), want)]
        elif mod is fo:
            for (kind, M, D, N), (call, kw) in fu_in.items():
                wrapper = getattr(fo, kind)
                want = getattr(fo, kind + "_plain")(p, *call, **kw)
                for tile in autotune.CANDIDATES[kind]:
                    for n in STUDIES[study][2]:
                        fo.splits_for = fused_splits if n is None else (
                            lambda *_, n=n: n)
                        run = (lambda w=wrapper, c=call, k=kw, t=tile:
                               w(p, *c, **k, **t))
                        try:
                            ok = torch.equal(run(), want)
                            t_us = us(run)
                        except RuntimeError as e:   # a ring that won't fit
                            ok, t_us = f"refused: {e}"[:120], None
                        label = (f"{kind} {(M, D, N)} {tile['bm']}x"
                                 f"{tile['bn']}" + ("" if n is None
                                                   else f" splits {n}"))
                        rows[label] = [t_us, ok]
                if study == "fused_layout" and \
                        kind != "rns_fused_encode_matmul":  # encode_layout
                    rows[f"{kind} {(M, D, N)} digit a block"] = \
                        _digit_a_block(kind, p, call, kw, want, us)
            fo.splits_for, fo.fused_ring = fused_splits, fused_ring
        elif mod is mm:
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
        del build._LIBS[libname]
    return 0


if __name__ == "__main__":
    sys.exit(main())
