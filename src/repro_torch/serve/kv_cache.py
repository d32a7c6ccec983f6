"""Paged KV cache: fixed-size pages + per-sequence block tables.

One physical pool of ``n_pages`` pages of ``page_size`` tokens per layer,
and per-sequence **block tables** mapping logical block ``t // page_size``
to a physical page, so mixed-length sequences share one decode step and a
finished row's pages return to the pool at once.

Host side (numpy, the phase-barrier subset of ``repro.serve.kv_cache``):
the :class:`PageAllocator` that ``serve/scheduler.py`` drives.  Device
side (PyTorch): the page pool :class:`PagedKV` -- ``k_pages``/``v_pages``
``[n_layers, n_pages, page_size, Hk, D]`` plus one ``block_table``
``[max_seqs, max_blocks]`` and ``lengths`` ``[max_seqs]`` shared by every
layer -- and the gather/scatter helpers, which update the pool IN PLACE (the JAX package
returns new arrays; in place saves a copy of the pool per token).

Physical page 0 is the **trash page**: empty slots and blocks past a
sequence's end point at it, so every gather/scatter stays in bounds;
reads through it are masked by ``lengths``, writes to it are garbage.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "TRASH_PAGE",
    "PagedCacheConfig",
    "PageAllocator",
    "PagedKV",
    "make_paged_cache",
    "set_tables",
    "gather_pages",
    "write_token",
    "write_prompt_pages",
]

#: physical page reserved as the write-target / read-source of inactive
#: rows; never handed out by the allocator, never read unmasked.
TRASH_PAGE = 0


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Static shape of the paged pool.

    ``max_blocks * page_size`` is the per-sequence capacity (the paged
    analogue of the dense cache's ``S_max``); ``n_pages`` bounds the
    *total* tokens resident across all sequences — the knob that trades
    memory for concurrency.  Page 0 is reserved (trash), so the usable
    pool is ``n_pages - 1`` pages.
    """

    page_size: int = 16
    n_pages: int = 129          # 128 usable + trash
    max_seqs: int = 8           # decode slots (R)
    max_blocks: int = 8         # logical blocks per sequence

    def __post_init__(self):
        if self.page_size < 1 or self.n_pages < 2:
            raise ValueError("need page_size >= 1 and n_pages >= 2")
        if self.n_pages - 1 < self.max_blocks:
            raise ValueError(
                f"pool of {self.n_pages - 1} usable pages cannot hold even "
                f"one resident sequence ({self.max_blocks} blocks)")

    @property
    def tokens_per_seq(self) -> int:
        return self.page_size * self.max_blocks


class PageAllocator:
    """Host-side free list over pages 1..n_pages-1 (0 = trash).

    ``free`` is IDEMPOTENT: a page already on the free list is skipped
    rather than raised on.  The scheduler can preempt a sequence in the
    same engine step that it finishes (growth runs before the finished
    check), and the preemption path and the completion path both release
    pages — releasing twice must not corrupt the free list or hand one
    physical page to two sequences.  Out-of-range ids still raise: those
    are real bugs, not benign races.
    """

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        # LIFO reuse keeps the working set of hot pages small
        self._free = list(range(n_pages - 1, TRASH_PAGE, -1))
        self._free_set = set(self._free)    # O(1) idempotence check

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def utilization(self) -> float:
        usable = self.n_pages - 1
        return (usable - len(self._free)) / max(usable, 1)

    def alloc(self, n: int) -> list[int] | None:
        """Pop ``n`` pages, or None (no change) if short."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(pages)
        return pages

    def free(self, pages: list[int]) -> None:
        for pg in pages:
            if not (TRASH_PAGE < pg < self.n_pages):
                raise ValueError(f"bad page id {pg}")
            if pg in self._free_set:
                continue                    # already free: idempotent
            self._free.append(pg)
            self._free_set.add(pg)


# ------------------------------------------------------- device tensors ---
@dataclasses.dataclass
class PagedKV:
    """The device page pool of every layer plus the shared tables."""

    k_pages: torch.Tensor       # [n_layers, n_pages, page_size, Hk, D]
    v_pages: torch.Tensor
    block_table: torch.Tensor   # [max_seqs, max_blocks] int64
    lengths: torch.Tensor       # [max_seqs] int64


def make_paged_cache(cfg, pcfg: PagedCacheConfig, *,
                     device="cuda") -> PagedKV:
    """Zero float32 paged decode cache for every attention layer."""
    shape = (cfg.n_layers, pcfg.n_pages, pcfg.page_size, cfg.n_kv_heads,
             cfg.d_head)
    return PagedKV(
        k_pages=torch.zeros(shape, device=device),
        v_pages=torch.zeros(shape, device=device),
        block_table=torch.zeros((pcfg.max_seqs, pcfg.max_blocks),
                                dtype=torch.int64, device=device),
        lengths=torch.zeros((pcfg.max_seqs,), dtype=torch.int64,
                            device=device))


def set_tables(cache: PagedKV, block_tables, lengths) -> None:
    """Overwrite the block table + lengths from the scheduler's host
    arrays (tiny transfers; the pool itself never leaves the device)."""
    cache.block_table.copy_(torch.as_tensor(np.asarray(block_tables),
                                            dtype=torch.int64))
    cache.lengths.copy_(torch.as_tensor(np.asarray(lengths),
                                        dtype=torch.int64))


def gather_pages(pages: torch.Tensor, block_table: torch.Tensor):
    """[P, bs, ...] pages + [R, nb] table -> dense [R, nb*bs, ...] view:
    logical position t of row r is ``pages[block_table[r, t // bs],
    t % bs]``."""
    R = block_table.shape[0]
    return pages[block_table].reshape((R, -1) + tuple(pages.shape[2:]))


def write_token(pages: torch.Tensor, block_table: torch.Tensor,
                lengths: torch.Tensor, vals: torch.Tensor) -> None:
    """Scatter one new token per row at its current length, in place.

    ``vals`` [R, ...]: row r goes to page ``block_table[r, lengths[r] //
    bs]`` offset ``lengths[r] % bs``; a row past its table's capacity is
    redirected to the trash page rather than clipped onto a real page.
    """
    bs = pages.shape[1]
    nb = block_table.shape[1]
    blk = lengths // bs
    rows = torch.arange(block_table.shape[0], device=block_table.device)
    page = torch.where(blk < nb, block_table[rows, blk.clamp(max=nb - 1)],
                       TRASH_PAGE)
    pages[page, lengths % bs] = vals.to(pages.dtype)


def write_prompt_pages(pages: torch.Tensor, block_row: torch.Tensor,
                       planes: torch.Tensor) -> None:
    """Blit one prefilled prompt into its pages, in place.

    ``pages`` [..., P, bs, Hk, D] (leading layer dim allowed);
    ``block_row`` [nbp] physical page per logical block (trash for blocks
    past the prompt); ``planes`` [..., Tpad, Hk, D] with ``Tpad == nbp *
    bs``.  Whole pages are overwritten; positions past the prompt length
    hold garbage that ``lengths`` masks at read time.
    """
    bs = pages.shape[-3]
    nbp = block_row.shape[0]
    lead = tuple(planes.shape[:-3])
    v = planes.reshape(lead + (nbp, bs) + tuple(planes.shape[-2:]))
    pages[..., block_row, :, :, :] = v.to(pages.dtype)
