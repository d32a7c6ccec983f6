"""Paged KV cache: fixed-size pages + per-sequence block tables.

One physical pool of ``n_pages`` pages of ``page_size`` tokens per layer,
and per-sequence **block tables** mapping logical block ``t // page_size``
to a physical page, so mixed-length sequences share one decode step and a
finished row's pages return to the pool at once.

Host side (numpy, as ``repro.serve.kv_cache``): the refcounted
:class:`PageAllocator` and the content-addressed :class:`PrefixCache`
that ``serve/scheduler.py`` drives.  Device side (PyTorch): the page pools
:class:`PagedKV` -- ``k_pages``/``v_pages`` ``[n_attn, n_pages,
page_size, Hk, D]`` of the GQA layers, the latent ``ckv_pages`` /
``krope_pages`` of the MLA layers, plus one ``block_table`` ``[max_seqs,
max_blocks]`` and ``lengths`` ``[max_seqs]`` shared by every layer -- and the
gather/scatter/copy helpers, which update the pool IN PLACE (the JAX
package returns new arrays; in place saves a copy of the pool per token).

Physical page 0 is the **trash page**: empty slots and blocks past a
sequence's end point at it, so every gather/scatter stays in bounds;
reads through it are masked by ``lengths``, writes to it are garbage.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

__all__ = [
    "TRASH_PAGE",
    "PagedCacheConfig",
    "PageAllocator",
    "PrefixCache",
    "PagedKV",
    "make_paged_cache",
    "set_tables",
    "gather_pages",
    "write_token",
    "write_token_window",
    "write_packed_tokens",
    "write_prompt_pages",
    "copy_pages",
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

    ``resident_blocks`` (optional) caps how many of a sequence's blocks
    are physically resident at once: sliding-window serving evicts pages
    behind the window, so a pool far smaller than ``max_blocks`` can
    still serve arbitrarily long rows.  It only relaxes the feasibility
    check here; block tables keep ``max_blocks`` columns (positions stay
    absolute, evicted entries point at the trash page).
    """

    page_size: int = 16
    n_pages: int = 129          # 128 usable + trash
    max_seqs: int = 8           # decode slots (R)
    max_blocks: int = 8         # logical blocks per sequence
    resident_blocks: int | None = None   # physical bound (None: max_blocks)

    def __post_init__(self):
        if self.page_size < 1 or self.n_pages < 2:
            raise ValueError("need page_size >= 1 and n_pages >= 2")
        need = self.max_blocks if self.resident_blocks is None \
            else min(self.max_blocks, self.resident_blocks)
        if self.n_pages - 1 < need:
            raise ValueError(
                f"pool of {self.n_pages - 1} usable pages cannot hold even "
                f"one resident sequence ({need} blocks)")

    @property
    def tokens_per_seq(self) -> int:
        return self.page_size * self.max_blocks


class PageAllocator:
    """Refcounted host-side free list over pages 1..n_pages-1 (0 = trash).

    Prefix caching maps several sequences' block tables (and the prefix
    index itself) onto one physical page, so every allocated page carries
    a reference count: :meth:`alloc` hands out pages at refcount 1,
    :meth:`incref` registers another holder, and :meth:`free` releases
    ONE holder's reference -- the page returns to the free list only when
    the last holder lets go.

    ``free`` is IDEMPOTENT for fully released pages: a page already on
    the free list is skipped rather than raised on.  The scheduler can
    preempt a sequence in the same engine step that it finishes (growth
    runs before the finished check), and the preemption path and the
    completion path both release pages -- releasing twice must not
    corrupt the free list, hand one physical page to two sequences, or
    drive a shared page's count below its other holders' (the scheduler
    clears a departing row's page list at its first release).
    Out-of-range ids still raise: those are real bugs, not benign races.
    """

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        # LIFO reuse keeps the working set of hot pages small
        self._free = list(range(n_pages - 1, TRASH_PAGE, -1))
        self._free_set = set(self._free)    # O(1) idempotence check
        self._ref: dict[int, int] = {}      # allocated page -> #holders
        self.pages_allocated = 0            # fresh pages handed out
        self.pages_shared = 0               # increfs (block-table reuse)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def utilization(self) -> float:
        usable = self.n_pages - 1
        return (usable - len(self._free)) / max(usable, 1)

    def refcount(self, pg: int) -> int:
        """Current holder count (0 for free pages)."""
        return self._ref.get(pg, 0)

    def alloc(self, n: int) -> list[int] | None:
        """Pop ``n`` pages at refcount 1, or None (no change) if short."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(pages)
        for pg in pages:
            self._ref[pg] = 1
        self.pages_allocated += n
        return pages

    def incref(self, pages: list[int]) -> None:
        """Register another holder of already-allocated pages."""
        for pg in pages:
            if self._ref.get(pg, 0) < 1:
                raise ValueError(f"incref of unallocated page {pg}")
            self._ref[pg] += 1
        self.pages_shared += len(pages)

    def free(self, pages: list[int]) -> None:
        """Release one holder's reference on each page."""
        for pg in pages:
            if not (TRASH_PAGE < pg < self.n_pages):
                raise ValueError(f"bad page id {pg}")
            if pg in self._free_set:
                continue                    # already free: idempotent
            self._ref[pg] -= 1
            if self._ref[pg] > 0:
                continue                    # other holders keep it alive
            del self._ref[pg]
            self._free.append(pg)
            self._free_set.add(pg)


class PrefixCache:
    """Content-addressed prefix -> physical-page index (host side).

    Causal attention makes a page's KV a function of the token prefix
    ending at that page, so a page is keyed by the exact bytes of that
    prefix: ``tokens[:(i+1)*page_size]`` for full block i,
    ``tokens[:T]`` for a prompt's partial last block.  Exact byte keys
    never alias distinct prefixes.

    Each entry holds one allocator reference (the index is a holder like
    any sequence), so a cached page outlives its producer until
    :meth:`evict` (LRU) reclaims it.  A partial entry exposes ``valid``
    tokens; an adopter reads only positions below its length and splits
    the page copy-on-write before its first write into it.

    Every hit is re-checked against the allocator: an entry whose page
    shows refcount 0 is stale (the page went back to the pool while the
    index pointed at it) and is dropped on sight (``stale_drops``
    counts them), never returned.
    """

    def __init__(self, alloc: PageAllocator, page_size: int):
        self.alloc = alloc
        self.bs = page_size
        # key -> (page, valid_tokens); ordered = LRU (oldest first)
        self._entries: collections.OrderedDict[bytes, tuple[int, int]] = (
            collections.OrderedDict())
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.stale_drops = 0
        #: bumped whenever the entry set changes: a peek result holds
        #: only within one generation (the scheduler memoizes on it)
        self.generation = 0

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _bytes(tokens: np.ndarray, n: int) -> bytes:
        return np.ascontiguousarray(tokens[:n], np.int32).tobytes()

    def _ends(self, T: int) -> list[int]:
        """Prefix lengths that key a prompt's blocks: every full block,
        then the partial tail."""
        ends = [(i + 1) * self.bs for i in range(T // self.bs)]
        if T % self.bs:
            ends.append(T)
        return ends

    def _live(self, key: bytes) -> bool:
        e = self._entries.get(key)
        return e is not None and self.alloc.refcount(e[0]) >= 1

    def _get(self, key: bytes):
        e = self._entries.get(key)
        if e is None:
            return None
        if self.alloc.refcount(e[0]) < 1:
            del self._entries[key]          # stale: self-heal
            self.stale_drops += 1
            self.generation += 1
            return None
        self._entries.move_to_end(key)      # LRU touch
        return e

    def lookup(self, tokens: np.ndarray):
        """([page or None per block], n_cached_tokens) for a prompt.

        Blocks are independent: block i's key holds the whole prefix, so
        a later block can hit after an earlier one was evicted.  The
        partial last block hits only on an exact whole-prompt match.
        Pages come back WITHOUT a reference; the adopter increfs."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        shared: list[int | None] = []
        n_cached = 0
        prev = 0
        for end in self._ends(len(tokens)):
            e = self._get(self._bytes(tokens, end))
            shared.append(e[0] if e is not None else None)
            if e is not None:
                n_cached += end - prev
                self.hits += 1
            else:
                self.misses += 1
            prev = end
        return shared, n_cached

    def peek_cached_tokens(self, tokens: np.ndarray) -> int:
        """Cached-token count for a prompt, without touching the LRU
        order or the hit/miss counters (the admission scan probes every
        waiting request)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n, prev = 0, 0
        for end in self._ends(len(tokens)):
            if self._live(self._bytes(tokens, end)):
                n += end - prev
            prev = end
        return n

    def insert(self, tokens: np.ndarray, pages: list[int]) -> int:
        """Register a prefilled prompt's blocks (full blocks and the
        partial tail); returns the number of new entries.  A key already
        present is left alone: its page holds the same KV.  A trash or
        unallocated page is never indexed."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        added = 0
        for i, end in enumerate(self._ends(len(tokens))):
            key = self._bytes(tokens, end)
            if key in self._entries or i >= len(pages):
                continue
            if pages[i] == TRASH_PAGE or self.alloc.refcount(pages[i]) < 1:
                continue
            self.alloc.incref([pages[i]])
            self._entries[key] = (pages[i], end)
            added += 1
        if added:
            self.generation += 1
        return added

    def evict(self, n_pages: int) -> int:
        """Release up to ``n_pages`` LRU entries whose page would return
        to the pool (refcount 1: the index is the only holder); entries
        still shared by running rows stay.  Returns pages freed."""
        freed = dropped = 0
        for key in list(self._entries):
            if freed >= n_pages:
                break
            page, _ = self._entries[key]
            rc = self.alloc.refcount(page)
            if rc == 0:                     # stale: self-heal
                del self._entries[key]
                self.stale_drops += 1
                dropped += 1
                continue
            if rc != 1:
                continue
            del self._entries[key]
            self.alloc.free([page])
            self.evictions += 1
            freed += 1
        if freed or dropped:
            self.generation += 1
        return freed


# ------------------------------------------------------- device tensors ---
#: the page pool of each cache plane (``models/model.py::PLANES``)
POOLS = {"k": "k_pages", "v": "v_pages", "c_kv": "ckv_pages",
         "k_rope": "krope_pages"}


@dataclasses.dataclass
class PagedKV:
    """The device page pools of every layer plus the shared tables: the
    GQA layers' ``k_pages``/``v_pages`` [n_attn, n_pages, page_size, Hk,
    D], the MLA layers' latent ``ckv_pages`` [n_mla, n_pages, page_size,
    r] and ``krope_pages`` [n_mla, n_pages, page_size, dr] (None where the
    model has no such layer)."""

    k_pages: torch.Tensor | None
    v_pages: torch.Tensor | None
    block_table: torch.Tensor   # [max_seqs, max_blocks] int64
    lengths: torch.Tensor       # [max_seqs] int64
    ckv_pages: torch.Tensor | None = None
    krope_pages: torch.Tensor | None = None

    def pools(self) -> dict[str, torch.Tensor]:
        """{plane name: its page pool} of the pools this cache has."""
        return {name: getattr(self, pool) for name, pool in POOLS.items()
                if getattr(self, pool) is not None}


def make_paged_cache(cfg, pcfg: PagedCacheConfig, *, device="cuda",
                     dtype=torch.float32) -> PagedKV:
    """Zero paged decode cache: the pools of every layer type the model
    has (JAX's ``_layer_pages``), its pages in ``dtype``
    (``ServeConfig.cache_dtype``; writes round to it, reads upcast
    exactly to float32)."""
    from repro_torch.models.model import STATE_PLANES, plane_shapes

    pools = {POOLS[name]: torch.zeros(
                 (n, pcfg.n_pages, pcfg.page_size) + feat, dtype=dtype,
                 device=device)
             for name, (n, feat) in plane_shapes(cfg).items()
             if name not in STATE_PLANES}
    return PagedKV(
        k_pages=pools.pop("k_pages", None),
        v_pages=pools.pop("v_pages", None),
        block_table=torch.zeros((pcfg.max_seqs, pcfg.max_blocks),
                                dtype=torch.int64, device=device),
        lengths=torch.zeros((pcfg.max_seqs,), dtype=torch.int64,
                            device=device), **pools)


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


def write_token_window(pages: torch.Tensor, block_table: torch.Tensor,
                       lengths: torch.Tensor, vals: torch.Tensor) -> None:
    """Scatter W consecutive tokens per row from its length, in place.

    ``vals`` [R, W, ...] (a speculative-verify window): token i of row r
    goes to logical position ``lengths[r] + i``.  As in
    :func:`write_token`, positions past the row's table (block >= nb)
    go to the trash page, so draft tokens past a row's pages lose their
    KV harmlessly (the engine caps acceptance to what landed on real
    pages).
    """
    bs = pages.shape[1]
    R, nb = block_table.shape
    W = vals.shape[1]
    pos = lengths[:, None] + torch.arange(W, device=lengths.device)[None]
    blk = pos // bs
    rows = torch.arange(R, device=block_table.device)[:, None]
    page = torch.where(blk < nb, block_table[rows, blk.clamp(max=nb - 1)],
                       TRASH_PAGE)
    pages[page, pos % bs] = vals.to(pages.dtype)


def write_packed_tokens(pages: torch.Tensor, block_table: torch.Tensor,
                        seg: torch.Tensor, pos: torch.Tensor,
                        vals: torch.Tensor) -> None:
    """Scatter N packed tokens at explicit (segment, position) coords,
    in place (a mixed chunked-prefill/decode step).

    ``vals`` [N, ...]: token i goes to logical position ``pos[i]`` of
    row ``seg[i]``, i.e. page ``block_table[seg[i], pos[i] // bs]``
    offset ``pos[i] % bs``.  Pad lanes carry ``seg = -1`` and go to the
    trash page, as do positions past a row's table (block >= nb).
    """
    bs = pages.shape[1]
    R, nb = block_table.shape
    blk = pos // bs
    page = block_table[seg.clamp(0, R - 1), blk.clamp(max=nb - 1)]
    page = torch.where((seg >= 0) & (blk < nb), page, TRASH_PAGE)
    pages[page, pos % bs] = vals.to(pages.dtype)


def write_prompt_pages(pages: torch.Tensor, block_row: torch.Tensor,
                       planes: torch.Tensor) -> None:
    """Blit one prefilled prompt into its pages, in place.

    ``pages`` [L, P, bs, ...] (a pool of every layer of one type: K/V
    [.., Hk, D] or latents [.., r]); ``block_row`` [nbp] physical page
    per logical block (trash for blocks past the prompt); ``planes`` [L,
    Tpad, ...] with ``Tpad == nbp * bs``.  Whole pages are overwritten;
    positions past the prompt length hold garbage that ``lengths`` masks
    at read time.
    """
    L, bs = pages.shape[0], pages.shape[2]
    nbp = block_row.shape[0]
    v = planes.reshape((L, nbp, bs) + tuple(planes.shape[2:]))
    pages[:, block_row] = v.to(pages.dtype)


def copy_pages(pages: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor) -> None:
    """Copy page contents ``src[i] -> dst[i]`` in every layer, in place.

    ``pages`` [n_layers, P, bs, ...]; ``src``/``dst`` [m].  The
    copy-on-write split: a row about to write into a shared page first
    duplicates it onto a fresh page.  No-op rows pass ``src = dst =
    TRASH_PAGE`` (trash onto trash), which keeps the shapes fixed; the
    engine never repeats a real ``dst`` within one call.
    """
    pages[:, dst] = pages[:, src]
