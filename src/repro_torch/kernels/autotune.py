"""Block-size table for the port's CUDA kernel wrappers.

The port's counterpart of ``repro.kernels.autotune``.  Every wrapper
resolves tiles it was not given through :func:`get_blocks`:

* lookups are keyed on ``(kind, profile, shape bucket, card)``: shapes
  are bucketed to powers of two, so ragged batch sizes share one row,
  and the tag is the card's name (``"cpu"`` on the CPU), because a tile
  is tuned for one card;
* tuned rows persist to a JSON file of the port's own
  (``REPRO_TORCH_AUTOTUNE_CACHE``, else
  ``~/.cache/repro_torch/autotune.json``), so a row tuned for the JAX
  package's TPU kernels is never read;
* :func:`get_blocks` never measures, and is memoized.  A wrapper calls
  :func:`resolve` on every launch (120-330 per decode step); its answer
  is memoized per exact call shape, so a repeated call is one dict
  lookup, and the tile checker runs only when a shape is first resolved
  or a caller passes tiles.  Measurement is the explicit :func:`tune`,
  which times every legal candidate on the card with CUDA events and
  keeps the fastest.

An empty table gives :data:`DEFAULTS`: ``rns_matmul.cu``'s 32 x 64 (the
tile it had before the table, kept by its tensor-core redesign), 16 x 32
for the three fused kernels on ``rns_fused_mma.cu`` (the smallest tile
of its m16 MMA rows and 32-column warps, legal at every profile), 256
threads for rns_convert and rns_normalize, flash_attention's 64 x 64.
A cached row naming a tile that is no longer compiled (the fused encode
+ matmul's retired CUDA-core tiles, 8 x 16 ...) is dropped with a
warning when the table loads.

Cache file format (versioned)::

    {"version": 1,
     "entries": {"rns_matmul|rns9|8x1024x2048|NVIDIA H100 80GB HBM3":
                 {"blocks": {"bm": 64, "bn": 64}, "us": 51.2}}}
"""

from __future__ import annotations

import functools
import json
import logging
import os
import threading

import torch

_log = logging.getLogger(__name__)

__all__ = ["get_blocks", "resolve", "tune", "legal_candidates",
           "default_bench", "device_seconds", "shape_bucket",
           "pow2_at_least", "cache_path", "clear_cache", "last_launch",
           "DEFAULTS", "CANDIDATES"]

_MMA_DEFAULTS = {"bm": 16, "bn": 32}

#: per-kind tiles of an empty table (the matmul kinds' K step is the
#: kernels' own, not a choice)
DEFAULTS: dict[str, dict[str, int]] = {
    "rns_matmul": {"bm": 32, "bn": 64},
    "rns_fused_encode_matmul": _MMA_DEFAULTS,
    "rns_fused_matmul_normalize": _MMA_DEFAULTS,
    "rns_fused_dot": _MMA_DEFAULTS,
    "rns_convert": {"bt": 256},
    "rns_normalize": {"bt": 256},
    "flash_attention": {"bq": 64, "bk": 64},
}

#: what :func:`tune` sweeps: every compiled tile (analysis/kernel_audit.py)
CANDIDATES: dict[str, list[dict[str, int]]] = {
    "rns_matmul": [{"bm": bm, "bn": bn}
                   for bm, bn in ((32, 64), (64, 64), (32, 128),
                                  (64, 128))],
    "rns_convert": [{"bt": t} for t in (128, 256, 512, 1024)],
    "rns_normalize": [{"bt": t} for t in (128, 256, 512)],
    "flash_attention": [{"bq": q, "bk": k} for q in (32, 64, 128)
                        for k in (32, 64, 128)],
}
for _kind in ("rns_fused_matmul_normalize", "rns_fused_dot",
              "rns_fused_encode_matmul"):
    CANDIDATES[_kind] = [{"bm": bm, "bn": bn}
                         for bm, bn in ((16, 32), (16, 64), (32, 32),
                                        (32, 64))]

#: ``kind -> (cache key, blocks)`` of each kernel's latest launch, set by
#: the wrappers next to their launch counters
last_launch: dict[str, tuple[str, dict[str, int]]] = {}

_lock = threading.Lock()
_cache: dict[str, dict] | None = None       # loaded lazily, saved on tune
_memo: dict[tuple, dict[str, int]] = {}     # get_blocks' answers
_resolved: dict[tuple, tuple] = {}          # resolve's (key, blocks)


def cache_path() -> str:
    return os.environ.get(
        "REPRO_TORCH_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "autotune.json"))


def pow2_at_least(n: int, lo: int = 8) -> int:
    """Smallest power of two >= max(n, lo): the bucketing rule."""
    p = lo
    while p < n:
        p <<= 1
    return p


def shape_bucket(shape) -> tuple[int, ...]:
    """Power-of-two bucket per dim: one tuned row covers the bucket."""
    return tuple(pow2_at_least(int(d), 8) for d in shape)


@functools.lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def _backend_tag(backend) -> str:
    """"cpu", or the card's name for a CUDA device (a ``torch.device``
    or its string); any other string is taken as the tag itself."""
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    if isinstance(backend, str) and not backend.startswith("cuda"):
        return backend
    dev = torch.device(backend)
    if dev.type == "cpu":
        return "cpu"
    return _card_name(dev.index if dev.index is not None
                      else torch.cuda.current_device())


def _key(kind: str, profile, shape, backend) -> str:
    name = getattr(profile, "name", profile)
    dims = "x".join(str(d) for d in shape_bucket(shape))
    return f"{kind}|{name}|{dims}|{_backend_tag(backend)}"


def _valid_entry(entry) -> bool:
    """A row the wrappers can consume: ``blocks`` maps known tile names
    to positive ints.  Anything else is dropped at load time, so a
    poisoned file never pushes a junk tile size into a launch."""
    if not isinstance(entry, dict) or not isinstance(entry.get("blocks"),
                                                     dict):
        return False
    names = {n for d in DEFAULTS.values() for n in d}
    return all(
        isinstance(k, str) and k in names
        and isinstance(v, int) and not isinstance(v, bool) and v > 0
        for k, v in entry["blocks"].items())


def _meta(kind, profile, shape):
    """(n_digits, res_bytes, lazy_chunk, dims) for the checker; flash's
    head width D is the shape's last dim."""
    from repro_torch.analysis.kernel_audit import _profile_meta

    n_digits, res_bytes, lazy = _profile_meta(kind, profile)
    dims = {"D": int(shape[-1])} if kind == "flash_attention" else None
    return n_digits, res_bytes, lazy, dims


def _violations(kind, profile, shape, blocks) -> list[str]:
    from repro_torch.analysis.kernel_audit import validate_blocks

    n_digits, res_bytes, lazy, dims = _meta(kind, profile, shape)
    return validate_blocks(kind, dict(DEFAULTS[kind], **blocks),
                           n_digits=n_digits, res_bytes=res_bytes, dims=dims,
                           lazy_chunk=lazy)


def _row_violations(key: str, entry: dict) -> list[str]:
    """Hopper legality of a structurally valid row, with the kind,
    profile and bucket parsed back out of its key."""
    parts = key.split("|")
    if parts[0] not in DEFAULTS:
        return [f"unknown kernel kind {parts[0]!r}"]
    try:
        shape = tuple(int(d) for d in parts[2].split("x"))
        return _violations(parts[0], parts[1], shape, entry["blocks"])
    except (IndexError, KeyError, ValueError) as e:
        return [f"unreadable key {key!r}: {e!r}"]


def _load() -> dict[str, dict]:
    global _cache
    with _lock:
        if _cache is None:
            _cache = {}
            # a missing or unreadable file, invalid JSON, a wrong top
            # level, another version or junk rows all degrade to "no
            # tuned rows" (DEFAULTS); the next tune() rewrites the file
            try:
                with open(cache_path()) as f:
                    data = json.load(f)
                if isinstance(data, dict) and data.get("version") == 1:
                    entries = data.get("entries")
                    if isinstance(entries, dict):
                        _cache = {k: v for k, v in entries.items()
                                  if isinstance(k, str) and _valid_entry(v)}
            except (OSError, ValueError, TypeError):
                pass
            for k in list(_cache):
                bad = _row_violations(k, _cache[k])
                if bad:
                    _log.warning("autotune: dropping illegal cache row %s "
                                 "(blocks %s): %s", k,
                                 _cache[k].get("blocks"), bad[0])
                    del _cache[k]
        return _cache


def _save() -> None:
    path = cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with _lock:
        data = {"version": 1, "entries": dict(_cache or {})}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def clear_cache() -> None:
    """Drop the in-memory table and the lookup memos (the file stays)."""
    global _cache
    with _lock:
        _cache = None
        _memo.clear()
        _resolved.clear()


def get_blocks(kind: str, profile, shape, backend=None) -> dict[str, int]:
    """Tuned blocks for (kind, profile, shape bucket, card), else the
    defaults.  A pure lookup, memoized; never measures."""
    name = getattr(profile, "name", profile)
    memo_key = (kind, name, shape_bucket(shape), _backend_tag(backend))
    got = _memo.get(memo_key)
    if got is None:
        got = dict(DEFAULTS[kind])
        entry = _load().get(_key(kind, name, shape, backend))
        if entry:
            got.update(entry["blocks"])
        _memo[memo_key] = got
    return dict(got)


def _gate(kind, profile, shape, dims, blocks) -> None:
    from repro_torch.analysis.kernel_audit import check_wrapper_blocks

    n_digits, res_bytes, lazy, base = _meta(kind, profile, shape)
    check_wrapper_blocks(kind, blocks, dims=dict(base or {}, **dict(dims)),
                         n_digits=n_digits, res_bytes=res_bytes,
                         lazy_chunk=lazy)


def resolve(kind: str, profile, shape, device, *, dims=(), gate=True,
            **given):
    """A wrapper's ``(cache key, blocks)``: the tiles it was given (not
    None), the rest from :func:`get_blocks`, gated (``gate``) by
    ``check_wrapper_blocks`` -- an illegal tile raises ``ValueError``.
    ``shape`` is a tuple of ints; ``dims`` extra ``(name, size)`` pairs
    for the checker (flash's ``Dv``).

    Memoized per (kind, profile, shape, device, dims) until
    :func:`clear_cache` or :func:`tune`: without explicit tiles a
    repeated call is one dict lookup and returns the same blocks dict,
    which callers read and never change."""
    name = getattr(profile, "name", profile)
    memo_key = (kind, name, shape, device, dims)
    hit = _resolved.get(memo_key)
    if hit is None:
        hit = (_key(kind, name, shape, device),
               get_blocks(kind, name, shape, device))
        if gate:
            _gate(kind, profile, shape, dims, hit[1])
        _resolved[memo_key] = hit
    for v in given.values():
        if v is not None:
            break
    else:
        return hit
    blocks = dict(hit[1])
    blocks.update({k: v for k, v in given.items() if v is not None})
    if gate:
        _gate(kind, profile, shape, dims, blocks)
    return hit[0], blocks


def legal_candidates(kind: str, profile, shape):
    """``(legal, dropped)``: the CANDIDATES the checker allows at this
    profile and shape, and ``(candidate, reason)`` for the others."""
    legal, dropped = [], []
    for cand in CANDIDATES[kind]:
        bad = _violations(kind, profile, shape, cand)
        if bad:
            dropped.append((dict(cand), bad[0]))
        else:
            legal.append(dict(cand))
    return legal, dropped


def tune(kind: str, profile, shape, backend=None, *, bench_fn=None,
         repeats: int = 3) -> dict[str, int]:
    """Time every legal candidate tiling, persist the fastest and return
    its blocks.  ``bench_fn(blocks) -> seconds`` replaces the built-in
    bench (:func:`default_bench`, CUDA events on the card); without a
    card and without ``bench_fn`` this raises: the plain version's time
    says nothing of a tile."""
    legal, dropped = legal_candidates(kind, profile, shape)
    for cand, why in dropped:
        _log.warning("autotune: skipping illegal candidate %s for %s: %s",
                     cand, kind, why)
    if not legal:
        _log.warning("autotune: no legal candidate for %s, keeping "
                     "DEFAULTS", kind)
        return dict(DEFAULTS[kind])
    if bench_fn is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"autotune.tune({kind!r}): no CUDA device "
                               "to time the kernel on, and no bench_fn")
        backend = backend if backend is not None else "cuda"
        bench_fn = default_bench(kind, profile, shape, backend)
    best, best_t = None, None
    for cand in legal:
        t = min(bench_fn(dict(cand)) for _ in range(repeats))
        if best_t is None or t < best_t:
            best, best_t = cand, t
    entries = _load()
    with _lock:
        entries[_key(kind, profile, shape, backend)] = {
            "blocks": best, "us": float(best_t * 1e6)}
        _memo.clear()
        _resolved.clear()
    _save()
    return dict(DEFAULTS[kind], **best)


def device_seconds(run, iters: int = 10, reps: int = 3) -> float:
    """Device time of one ``run()``: ``iters`` calls captured in a CUDA
    graph, replayed between CUDA events (the host's launch cost stays
    out).  The first call, which builds and loads the kernel, is off
    the clock."""
    run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            run()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / (reps * iters)


def _check_close(kind, got, want, blocks):
    """A candidate must equal the plain version before it is timed: bit
    for bit for the RNS kernels, within flash_attention's tolerance
    (2e-5 in float32, one step of a 16-bit type) for flash."""
    if kind == "flash_attention":
        from repro_torch.kernels.flash_attention.ops import within_tolerance

        ok, err = within_tolerance(got, want)
        err = f"max |kernel - plain| = {err}"
    else:
        ok = torch.equal(got.isnan(), want.isnan()) and torch.equal(
            got.nan_to_num(), want.nan_to_num()) if \
            got.dtype.is_floating_point else torch.equal(got, want)
        err = "not bit-equal"
    if not ok:
        raise AssertionError(f"{kind} {blocks}: differs from its plain "
                             f"version ({err})")


def default_bench(kind: str, profile, shape, backend="cuda", *, call=None):
    """``bench(blocks) -> seconds`` of the real wrapper on the card.
    ``call = (args, kwargs)`` are the wrapper's inputs after the profile
    (a main-path call); by default random operands of ``shape`` made
    from seed 0.  Each candidate's output is held against the plain
    version once, before it is timed."""
    import numpy as np

    from repro_torch.kernels import wrappers

    dev = torch.device(backend)
    wrapper, plain = wrappers()[kind]
    if call is None:
        call = _random_call(kind, profile, shape, dev, np.random.default_rng(0))
    args, kw = call
    checked = set()

    def bench(blocks) -> float:
        def run():
            return wrapper(profile, *args, **kw, **blocks)

        key = tuple(sorted(blocks.items()))
        if key not in checked:
            _check_close(kind, run(), plain(profile, *args, **kw), blocks)
            checked.add(key)
        return device_seconds(run)

    return bench


def _random_call(kind, profile, shape, dev, rng):
    import numpy as np

    from repro_torch.core.moduli import get_profile

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if kind == "flash_attention":
        Tq, Tk, D = shape
        dt = getattr(torch, profile)
        q = t(rng.standard_normal((1, Tq, 4, D)).astype(np.float32)).to(dt)
        kv = t(rng.standard_normal((1, Tk, 4, D)).astype(np.float32)).to(dt)
        return (q, kv, kv), {}
    p = get_profile(profile)
    rdt = np.int8 if p.int8_safe else np.int32

    def res(sh):
        return t(np.stack([rng.integers(0, m, sh) for m in p.moduli])
                 .astype(rdt))

    if kind == "rns_convert":
        x = t(rng.standard_normal(shape[0]).astype(np.float32))
        return (x, torch.tensor(37.5, device=dev)), {
            "out_dtype": torch.int8 if p.int8_safe else torch.int32}
    if kind == "rns_normalize":
        return (res((shape[0],)).to(torch.int32),), {}
    M, D, N = shape
    if kind in ("rns_matmul", "rns_fused_matmul_normalize"):
        return (res((M, D)), res((D, N))), {}
    x = t(rng.standard_normal((M, D)).astype(np.float32))
    return (x, torch.tensor(40.0, device=dev), res((D, N))), {"bits": 8}
