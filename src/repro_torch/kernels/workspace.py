"""Split workspaces of the kernels whose blocks share a tile's K steps
(``rns_matmul``, ``rns_fused_dot``, ``rns_fused_matmul_normalize``,
``rns_fused_encode_matmul``).

A split launch needs int32 scratch for the blocks' partial residues and
one int32 counter per output tile; the kernel writes every slice before
it reads it and its last block sets each counter back to zero, so one
launch needs no memset.  A CUDA graph keeps the addresses it was
captured with, so the rules here are:

* a buffer handed to a launch is never freed or replaced while the
  process runs: growing allocates a larger pair and keeps the old one
  alive (every pair stays in :data:`_held`);
* buffers are keyed by device and stream, so launches on two streams
  never share slices or counters (a graph replays with the workspace of
  the stream it was captured on);
* counters are zeroed once, when they are allocated.

The kernels share one pair per (device, stream): launches on one stream
run one after another.
"""

from __future__ import annotations

import torch

__all__ = ["grow", "get", "held"]

#: (device, stream handle) -> every (sums, counters) pair handed out, in
#: the order allocated; the last is the largest and the one in use
_held: dict[tuple, list[tuple[torch.Tensor, torch.Tensor]]] = {}


def grow(have: tuple[int, int] | None, n_sums: int,
         n_tiles: int) -> tuple[int, int] | None:
    """The sizes of the pair to allocate for a launch that needs
    ``n_sums`` partial residues and ``n_tiles`` counters when the pair in
    use holds ``have`` (None: no pair yet); None when it fits.  Each
    size grows to a power of two, at least the old size, so a run of
    growing calls allocates few pairs."""
    if have is not None and have[0] >= n_sums and have[1] >= n_tiles:
        return None
    old = have or (0, 0)

    def up(need, now):
        size = 1
        while size < max(need, now):
            size <<= 1
        return size

    return up(n_sums, old[0]), up(n_tiles, old[1])


def _key(device, stream: int | None) -> tuple:
    """(device with its index, stream handle; by default the device's
    current stream, 0 on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if stream is None:
        stream = (torch.cuda.current_stream(device).cuda_stream
                  if device.type == "cuda" else 0)
    return device, stream


def get(device, n_sums: int, n_tiles: int, stream: int | None = None):
    """``(sums, counters)`` int32 tensors of at least ``n_sums`` and
    ``n_tiles`` elements for a launch on ``device`` and ``stream`` (a
    stream handle; by default the device's current stream).  Never frees
    a pair it handed out."""
    key = _key(device, stream)
    device = key[0]
    pairs = _held.setdefault(key, [])
    have = (pairs[-1][0].numel(), pairs[-1][1].numel()) if pairs else None
    size = grow(have, n_sums, n_tiles)
    if size is not None:
        pairs.append((torch.empty(size[0], dtype=torch.int32, device=device),
                      torch.zeros(size[1], dtype=torch.int32, device=device)))
    return pairs[-1]


def held(device, stream: int | None = None) -> list[tuple[torch.Tensor,
                                                          torch.Tensor]]:
    """Every pair handed out for ``(device, stream)``, oldest first."""
    return list(_held.get(_key(device, stream), []))
