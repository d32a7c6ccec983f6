"""Tile legality of the port's CUDA kernels on Hopper (H100).

The counterpart of ``repro.analysis.kernel_audit``'s closed-form layer
(``validate_blocks`` / ``vmem_bytes`` / ``check_wrapper_blocks``), with
Hopper's rules in place of Mosaic's (8, 128) tiling and 16 MiB VMEM:

* shared memory per block: what the ``.cu`` launch code allocates
  (:func:`smem_bytes`), at most 48 KiB, or 227 KiB for a kernel that
  opts in with ``cudaFuncSetAttribute`` (rns_matmul, flash_attention);
* threads per block at most 1024;
* registers: the block's threads times each thread's registers, both in
  the units the card allocates (warps of 32, registers in eights), at
  most 65 536 per SM.  Registers per thread come from the instantiation's
  ``__launch_bounds__`` cap, or, for the two kernels built without one
  (rns_convert, rns_normalize), from :data:`REGISTERS`, which
  ``chip_smoke.py [build]`` holds against ``ptxas -v``;
* each kernel's own constraints: the matmul kernels reduce at least
  every ``lazy_chunk - 1`` terms, so their fixed K step (128 deep in
  rns_matmul, 32 in rns_fused) must not exceed that; a fused block of
  32 K threads quantizes its ``bm x 32`` activation tile in
  ``_FUSED_NX`` passes; and every tile must be one that is compiled.

``kernels/autotune.py`` gates the tiles of every wrapper call through
:func:`check_wrapper_blocks` (once per call shape, and whenever a caller
passes tiles), and drops illegal candidates and cache rows through
:func:`validate_blocks`.
"""

from __future__ import annotations

import functools

from repro_torch.core.moduli import get_profile

__all__ = ["BlockConfigError", "MATMUL_TILES", "FUSED_TILES", "FLASH_TILES",
           "REGISTERS", "SMEM_STATIC", "SMEM_OPT_IN", "register_cap",
           "registers_per_thread", "threads", "smem_bytes",
           "validate_blocks", "check_wrapper_blocks"]

SMEM_STATIC = 48 * 1024         # a block's shared memory without opting in
SMEM_OPT_IN = 232_448           # 227 KiB, after cudaFuncSetAttribute
MAX_THREADS = 1024
REGS_PER_SM = 65_536

_MATMUL_BK = 32                 # csrc/rns_fused.cu: K step
_RNS_MATMUL_BK = 128            # csrc/rns_matmul.cu: K step (4 k32 MMAs)
_RNS_MATMUL_STAGES = 3          # csrc/rns_matmul.cu: cp.async ring
_RNS_MATMUL_PAD = 16            # csrc/rns_matmul.cu: bytes after a row
_FUSED_NX = 2                   # x elements per thread per tile (rns_fused.cu)

#: compiled (bm, bn) tiles: template instantiations, dispatched at launch
#: (rns_matmul.cu, rns_fused.cu), the first being the kernel's default
MATMUL_TILES = ((32, 64), (64, 64), (32, 128), (64, 128))
FUSED_TILES = ((8, 16), (8, 32), (16, 16))
#: flash_attention: bq (16 rows a warp) a launch parameter, bk a template
#: parameter (with the head width padded to 16, 32, 64 or 128)
FLASH_TILES = ((32, 64, 128), (32, 64, 128))
FLASH_DMAX = 128                # csrc/flash_attention.cu DMAX

#: registers per thread of the instantiations built without
#: ``__launch_bounds__``, from ``ptxas -v`` (sm_90a, CUDA 12.8):
#: rns_convert by output type, rns_normalize by digit count K
REGISTERS = {
    "rns_convert": {"int8": 31, "int32": 30},
    "rns_normalize": {5: 30, 6: 30, 7: 30, 8: 39, 9: 48, 12: 95, 16: 180,
                      18: 215, 21: 255},
}

_MATMUL_KINDS = ("rns_matmul", "rns_fused_encode_matmul",
                 "rns_fused_matmul_normalize", "rns_fused_dot")
_FUSED_KINDS = _MATMUL_KINDS[1:]

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


def registers_per_thread(kind, n_digits=1, res_bytes=1):
    """The register model of one instantiation (None: not compiled)."""
    if kind == "rns_convert":
        return REGISTERS[kind]["int8" if res_bytes == 1 else "int32"]
    if kind == "rns_normalize":
        return REGISTERS[kind].get(int(n_digits))
    if kind == "rns_matmul":          # __launch_bounds__(bn), bn >= 64
        return register_cap(64)
    if kind == "flash_attention":       # __launch_bounds__(256)
        return register_cap(256)
    if kind == "rns_fused_encode_matmul":     # KT = 0: bounds for rns21
        return register_cap(32 * 21)
    return register_cap(32 * int(n_digits))


def threads(kind, blocks, n_digits=1) -> int:
    """Threads per block of a launch."""
    if kind in ("rns_convert", "rns_normalize"):
        return blocks["bt"]
    if kind in _FUSED_KINDS:
        return 32 * int(n_digits)           # one warp per digit
    if kind == "rns_matmul":
        return blocks["bn"]                 # one warp per 32 columns
    return 2 * blocks["bq"]                 # flash: one warp per 16 rows


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
    if kind in _FUSED_KINDS:                # [Vs] + As + Bs (rns_fused.cu)
        bm, bn, bk = blocks["bm"], blocks["bn"], _MATMUL_BK
        quant = kind != "rns_fused_matmul_normalize"
        return ((4 * bk * bm if quant else 0) + 4 * K * bk * bm
                + res_bytes * K * bk * bn)
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
    tiles = MATMUL_TILES if kind == "rns_matmul" else FUSED_TILES
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
    regs = registers_per_thread(kind, K, res_bytes)
    if regs is None:
        out.append(f"{kind}: no instantiation for K={K}")
    else:
        used = (-(-nt // 32) * 32) * (-(-regs // 8) * 8)
        if used > REGS_PER_SM:
            out.append(f"{kind}: {nt} threads x {regs} registers = {used} "
                       f"> {REGS_PER_SM} per SM")
    limit = SMEM_OPT_IN if kind in ("rns_matmul", "flash_attention") \
        else SMEM_STATIC
    sm = smem_bytes(kind, blocks, K, res_bytes, dims)
    if sm > limit:
        out.append(f"{kind}: {sm} bytes of shared memory per block > "
                   f"{limit}")
    if kind == "flash_attention":
        d = dict(dims or {})
        for name in ("D", "Dv"):
            if d.get(name, 0) > FLASH_DMAX:
                out.append(f"{kind}: {name}={d[name]} > {FLASH_DMAX}, the "
                           "widest head the kernel's accumulators hold")
    step = _RNS_MATMUL_BK if kind == "rns_matmul" else _MATMUL_BK
    if kind in _MATMUL_KINDS and lazy_chunk is not None and \
            step > lazy_chunk - 1:
        out.append(f"{kind}: K tile {step} > lazy_chunk - 1 = "
                   f"{lazy_chunk - 1} (int32 accumulators could overflow)")
    if kind in _FUSED_KINDS and 32 * K * _FUSED_NX < blocks["bm"] * \
            _MATMUL_BK:
        out.append(f"{kind}: 32*K*NX = {32 * K * _FUSED_NX} threads-passes "
                   f"< bm*{_MATMUL_BK} = {blocks['bm'] * _MATMUL_BK} "
                   f"activations per tile (K={K})")
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
