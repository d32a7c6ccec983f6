"""Hand-written CUDA kernels of the port, one package per kernel package
of ``repro.kernels``: ``ops.py`` holds the wrappers, their plain PyTorch
versions and launch counters; ``csrc/`` the CUDA source.  The shared
headers (profile tables, the quantize rule, the MRC) are in ``csrc/``.
``autotune.py`` is the block table every wrapper resolves its tiles
through."""


def wrappers() -> dict:
    """``{kind: (wrapper, plain)}`` of every kernel, both called as
    ``fn(profile, *inputs, **options)``; flash_attention's ``profile`` is
    its dtype tag and is not passed on."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rns_convert import ops as c
    from repro_torch.kernels.rns_fused import ops as f
    from repro_torch.kernels.rns_matmul import ops as m
    from repro_torch.kernels.rns_normalize import ops as n

    out = {name: (getattr(mod, name), getattr(mod, name + "_plain"))
           for mod, name in ((c, "rns_convert"), (m, "rns_matmul"),
                             (n, "rns_normalize"),
                             (f, "rns_fused_encode_matmul"),
                             (f, "rns_fused_matmul_normalize"),
                             (f, "rns_fused_dot"))}
    out["flash_attention"] = (
        lambda _tag, *a, **kw: fa.flash_attention(*a, **kw),
        lambda _tag, *a, **kw: fa.flash_attention_plain(*a, **kw))
    return out
