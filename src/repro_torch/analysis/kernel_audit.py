"""Tile legality of the port's CUDA kernels on Hopper (H100).

The counterpart of ``repro.analysis.kernel_audit``'s closed-form layer
(``validate_blocks`` / ``vmem_bytes`` / ``check_wrapper_blocks``), with
Hopper's rules in place of Mosaic's (8, 128) tiling and 16 MiB VMEM:

* shared memory per block: what the ``.cu`` launch code allocates
  (:func:`smem_bytes`), at most 227 KiB (the kernels that need more
  than 48 KiB opt in with ``cudaFuncSetAttribute``);
* threads per block at most 1024;
* registers: the block's threads times each thread's registers, both in
  the units the card allocates (warps of 32, registers in eights), at
  most 65 536 per SM.  Registers per thread come from the instantiation's
  ``__launch_bounds__`` cap, or, for the two kernels built without one
  (rns_convert, rns_normalize), from :data:`REGISTERS`, which
  ``chip_smoke.py [build]`` holds against ``ptxas -v``;
* each kernel's own constraints: the matmul kernels reduce at least
  every ``lazy_chunk - 1`` terms, so their K step (128 deep in
  rns_matmul.cu, the ring's in rns_fused_mma.cu) must not exceed that;
  and every tile must be one that is compiled.

rns_matmul (B.2) runs ``rns_matmul.cu``: one digit's bm x bn tile a
block, bn threads, a 3-stage ring of 128-deep K steps.  The fused dot
(B.4), matmul + normalize (B.6) and encode + matmul (B.5) run on
``rns_fused_mma.cu``: K x bn threads (bn / 32 warps a digit), and a ring
whose K step and depth are the deepest of :data:`FUSED_MMA_RINGS` that
fits in 227 KiB (:func:`fused_ring`, the kernel's ``Ring``; B.5 stages
and quantizes x as the dot does).

``kernels/autotune.py`` gates the tiles of every wrapper call through
:func:`check_wrapper_blocks` (once per call shape, and whenever a caller
passes tiles), and drops illegal candidates and cache rows through
:func:`validate_blocks`.
"""

from __future__ import annotations

import functools

from repro_torch.core.moduli import get_profile

__all__ = ["BlockConfigError", "MATMUL_TILES", "FUSED_MMA_TILES",
           "FUSED_MMA_RINGS", "FLASH_TILES", "REGISTERS", "SMEM_OPT_IN",
           "register_cap", "registers_per_thread", "threads", "smem_bytes",
           "fused_ring", "validate_blocks", "check_wrapper_blocks"]

SMEM_OPT_IN = 232_448           # 227 KiB, after cudaFuncSetAttribute
MAX_THREADS = 1024
REGS_PER_SM = 65_536

_RNS_MATMUL_BK = 128            # csrc/rns_matmul.cu: K step (4 k32 MMAs)
_RNS_MATMUL_STAGES = 3          # csrc/rns_matmul.cu: cp.async ring
_RNS_MATMUL_PAD = 16            # csrc/rns_matmul.cu: bytes after a row

#: compiled (bm, bn) tiles: template instantiations, dispatched at launch,
#: the first being the kernel's default: rns_matmul.cu (B.2),
#: rns_fused_mma.cu (B.4, B.5, B.6)
MATMUL_TILES = ((32, 64), (64, 64), (32, 128), (64, 128))
FUSED_MMA_TILES = ((16, 32), (16, 64), (32, 32), (32, 64))
#: rns_fused_mma.cu's rings (K step, stages), deepest first
FUSED_MMA_RINGS = ((128, 3), (64, 3), (64, 2), (32, 3), (32, 2))
_MMA_PAD, _MMA_XPAD, _MMA_IPAD, _MMA_FLAG = 16, 4, 16, 16
#: flash_attention: bq (16 rows a warp) a launch parameter, bk a template
#: parameter (with the head width padded to 16, 32, 64 or 128)
FLASH_TILES = ((32, 64, 128), (32, 64, 128))
FLASH_DMAX = 128                # csrc/flash_attention.cu DMAX

#: registers per thread of the instantiations built without
#: ``__launch_bounds__``, from ``ptxas -v`` (sm_90a, CUDA 12.8):
#: rns_convert by output type and digit count K, rns_normalize by K (one
#: MRC pass in place, so every bt up to 1024 fits)
REGISTERS = {
    "rns_convert": {"int8": {5: 32, 6: 32, 7: 32, 8: 32, 9: 32, 12: 32,
                             16: 32, 18: 32, 21: 32},
                    "int32": {5: 32, 6: 32, 7: 38, 8: 32, 9: 32, 12: 32,
                              16: 32, 18: 32, 21: 32}},
    "rns_normalize": {5: 21, 6: 23, 7: 25, 8: 29, 9: 28, 12: 32, 16: 32,
                      18: 32, 21: 32},
}

_MATMUL_KINDS = ("rns_matmul", "rns_fused_encode_matmul",
                 "rns_fused_matmul_normalize", "rns_fused_dot")
_MMA_KINDS = ("rns_fused_matmul_normalize", "rns_fused_dot",
              "rns_fused_encode_matmul")          # rns_fused_mma.cu
_QUANT_KINDS = ("rns_fused_dot", "rns_fused_encode_matmul")  # x in

#: block names each kind requires (the autotune DEFAULTS schema)
_REQUIRED: dict[str, tuple[str, ...]] = {
    **{k: ("bm", "bn") for k in _MATMUL_KINDS},
    "rns_convert": ("bt",),
    "rns_normalize": ("bt",),
    "flash_attention": ("bq", "bk"),
}


class BlockConfigError(ValueError):
    """An illegal block config, raised by the wrapper-side gate."""


def _profile_meta(kind, profile):
    """(n_digits, residue element bytes, lazy_chunk) of a (kind, profile)
    pair; flash_attention has no RNS profile (its key holds a dtype tag,
    and the element bytes are that type's)."""
    if kind == "flash_attention":
        return 1, (4 if str(profile) == "float32" else 2), None
    p = get_profile(profile)
    return p.n_digits, (1 if p.int8_safe else 4), p.lazy_chunk


def register_cap(bound_threads: int) -> int:
    """Registers per thread ptxas may use under
    ``__launch_bounds__(bound_threads)``: the SM's 65 536 shared by the
    block's warps, in eights, at most 255."""
    warps = -(-bound_threads // 32)
    return min(255, 8 * (REGS_PER_SM // (8 * 32 * warps)))


def registers_per_thread(kind, n_digits=1, res_bytes=1, blocks=None):
    """The register model of one instantiation (None: not compiled);
    ``blocks`` gives the tensor-core fused kernels' bn."""
    if kind == "rns_convert":
        return REGISTERS[kind]["int8" if res_bytes == 1 else "int32"].get(
            int(n_digits))
    if kind == "rns_normalize":
        return REGISTERS[kind].get(int(n_digits))
    if kind == "rns_matmul":          # __launch_bounds__(bn), bn >= 64
        return register_cap(64)
    if kind == "flash_attention":       # __launch_bounds__(256)
        return register_cap(256)
    return register_cap(int(n_digits) * blocks["bn"])  # K x bn threads


def threads(kind, blocks, n_digits=1) -> int:
    """Threads per block of a launch."""
    if kind in ("rns_convert", "rns_normalize"):
        return blocks["bt"]
    if kind in _MMA_KINDS:
        return int(n_digits) * blocks["bn"]  # bn / 32 warps a digit
    if kind == "rns_matmul":
        return blocks["bn"]                 # one warp per 32 columns
    return 2 * blocks["bq"]                 # flash: one warp per 16 rows


def _mma_smem(quant, K, bm, bn, bk, stages) -> int:
    """rns_fused_mma.cu's ``smem_bytes``: ``stages`` of b's K u8 tiles
    [bk][bn + 16] and a's K tiles sized for int32 residues [bm][bk + 16]
    or (the dot) the float32 x tile [bm][bk + 4]; the dot adds the
    digits' u8 tiles, the quantized int32 tile [bm][bk + 16] and the row
    scales; the parked residues [K][bm][bn] int32 alias it all; 16 bytes
    of flag."""
    stage = K * bk * (bn + _MMA_PAD) + (
        4 * bm * (bk + _MMA_XPAD) if quant
        else 4 * K * bm * (bk + _MMA_IPAD))
    body = stages * stage + (K * bm * (bk + _MMA_PAD)
                             + 4 * bm * (bk + _MMA_IPAD) + 4 * bm
                             if quant else 0)
    return max(body, 4 * K * bm * bn) + _MMA_FLAG


def fused_ring(kind, n_digits, bm, bn):
    """The (K step, stages) of rns_fused_mma.cu's ring for a B.4, B.5 or
    B.6 tile: the first of :data:`FUSED_MMA_RINGS` that fits in 227 KiB,
    or None when none does."""
    quant = kind in _QUANT_KINDS
    for bk, stages in FUSED_MMA_RINGS:
        if _mma_smem(quant, int(n_digits), bm, bn, bk, stages) <= \
                SMEM_OPT_IN:
            return bk, stages
    return None


def smem_bytes(kind, blocks, n_digits=1, res_bytes=4, dims=None) -> int:
    """Shared memory bytes one block of the launch allocates, as the
    ``.cu`` launch code computes them.  ``dims`` gives flash's ``D`` and
    ``Dv`` (128 each when unknown: the widest the kernel takes);
    ``res_bytes`` is flash's element size (4 float32, 2 bf16 / fp16)."""
    K = int(n_digits)
    if kind in ("rns_convert", "rns_normalize"):
        return 0
    if kind == "rns_matmul":    # STAGES x (A [bm][BK + 16], B [BK][bn + 16])
        bk, pad = _RNS_MATMUL_BK, _RNS_MATMUL_PAD
        return _RNS_MATMUL_STAGES * (blocks["bm"] * (bk + pad)
                                     + bk * (blocks["bn"] + pad))
    if kind in _MMA_KINDS:                  # rns_fused_mma.cu
        bm, bn = blocks["bm"], blocks["bn"]
        bk, stages = fused_ring(kind, K, bm, bn) or FUSED_MMA_RINGS[-1]
        return _mma_smem(kind in _QUANT_KINDS, K, bm, bn, bk, stages)
    if kind == "flash_attention":           # 2 stages x (K, V) [bk][DP + pad]
        d = dict(dims or {})
        D, Dv = d.get("D", 128), d.get("Dv", d.get("D", 128))
        dp = 16
        while dp < max(D, Dv):
            dp *= 2
        pad = 4 if res_bytes == 4 else 8
        return res_bytes * 2 * 2 * blocks["bk"] * (dp + pad)
    raise KeyError(f"unknown kernel kind {kind!r}")


def _compiled(kind, blocks) -> list[str]:
    if kind in ("rns_convert", "rns_normalize"):
        bt = blocks["bt"]
        if bt % 32 or bt > MAX_THREADS:
            return [f"{kind}: bt={bt} is not a multiple of 32 up to "
                    f"{MAX_THREADS}"]
        return []
    if kind == "flash_attention":
        bqs, bks = FLASH_TILES
        if blocks["bq"] not in bqs or blocks["bk"] not in bks:
            return [f"{kind}: tile {blocks['bq']}x{blocks['bk']} is not "
                    f"compiled (bq in {bqs}, bk in {bks})"]
        return []
    tiles = MATMUL_TILES if kind == "rns_matmul" else FUSED_MMA_TILES
    if (blocks["bm"], blocks["bn"]) not in tiles:
        return [f"{kind}: tile {blocks['bm']}x{blocks['bn']} is not "
                f"compiled (bm x bn in {tiles})"]
    return []


def validate_blocks(kind, blocks, *, n_digits=1, res_bytes=4, dims=None,
                    lazy_chunk=None) -> list[str]:
    """Every legality violation of a block dict for one kernel kind on an
    H100; empty means legal.  Tolerates junk (missing keys, non-int
    sizes) by naming it: this is the autotune cache's gate."""
    if kind not in _REQUIRED:
        return [f"unknown kernel kind {kind!r}"]
    if not isinstance(blocks, dict):
        return [f"{kind}: blocks is {type(blocks).__name__}, not a dict"]
    bad = []
    for name in _REQUIRED[kind]:
        v = blocks.get(name)
        if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
            bad.append(f"{kind}: block {name!r} is {v!r} "
                       "(need a positive int)")
    bad += [f"{kind}: unknown block {name!r}" for name in blocks
            if name not in _REQUIRED[kind]]
    if bad:
        return bad
    out = _compiled(kind, blocks)
    K = int(n_digits)
    nt = threads(kind, blocks, K)
    if nt > MAX_THREADS:
        out.append(f"{kind}: {nt} threads per block > {MAX_THREADS}")
    regs = registers_per_thread(kind, K, res_bytes, blocks)
    if regs is None:
        out.append(f"{kind}: no instantiation for K={K}")
    else:
        used = (-(-nt // 32) * 32) * (-(-regs // 8) * 8)
        if used > REGS_PER_SM:
            out.append(f"{kind}: {nt} threads x {regs} registers = {used} "
                       f"> {REGS_PER_SM} per SM")
    sm = smem_bytes(kind, blocks, K, res_bytes, dims)
    if sm > SMEM_OPT_IN:
        out.append(f"{kind}: {sm} bytes of shared memory per block > "
                   f"{SMEM_OPT_IN}")
    if kind == "flash_attention":
        d = dict(dims or {})
        for name in ("D", "Dv"):
            if d.get(name, 0) > FLASH_DMAX:
                out.append(f"{kind}: {name}={d[name]} > {FLASH_DMAX}, the "
                           "widest head the kernel's accumulators hold")
    step = _RNS_MATMUL_BK if kind == "rns_matmul" else None
    if kind in _MMA_KINDS:
        ring = fused_ring(kind, K, blocks["bm"], blocks["bn"])
        if ring is None:
            out.append(f"{kind}: no ring of {FUSED_MMA_RINGS} fits in "
                       f"{SMEM_OPT_IN} bytes of shared memory (K={K})")
        step = (ring or FUSED_MMA_RINGS[-1])[0]
    if kind in _MATMUL_KINDS and lazy_chunk is not None and \
            step > lazy_chunk - 1:
        out.append(f"{kind}: K tile {step} > lazy_chunk - 1 = "
                   f"{lazy_chunk - 1} (int32 accumulators could overflow)")
    return out


@functools.lru_cache(maxsize=4096)
def _check_cached(kind, block_items, dim_items, n_digits, res_bytes,
                  lazy_chunk):
    blocks, dims = dict(block_items), dict(dim_items)
    bad = validate_blocks(kind, blocks, n_digits=n_digits,
                          res_bytes=res_bytes, dims=dims,
                          lazy_chunk=lazy_chunk)
    if bad:
        try:
            sm = str(smem_bytes(kind, blocks, n_digits, res_bytes, dims))
        except (KeyError, TypeError):
            sm = "n/a"
        raise BlockConfigError(
            f"{kind}: illegal block config {blocks} ({sm} bytes of shared "
            f"memory per block): " + "; ".join(bad))
    return True


def check_wrapper_blocks(kind, blocks, *, dims=None, n_digits=1,
                         res_bytes=4, lazy_chunk=None) -> None:
    """Wrapper-side gate: raise :class:`BlockConfigError` (a
    ``ValueError``) naming the kernel, the blocks and the shared-memory
    bytes if the resolved config is illegal.  Memoized: a legal config
    costs one dict lookup per launch."""
    _check_cached(kind, tuple(sorted(blocks.items())),
                  tuple(sorted((dims or {}).items())), int(n_digits),
                  int(res_bytes), lazy_chunk)
