"""Continuous-batching request scheduler (host-side policy, numpy only).

The phase-barrier subset of ``repro.serve.scheduler``: under its default
policy (no prefix cache, no sliding window, no chunked prefill, no
speculative lookahead) both make the same plans on the same traffic
(asserted in tests/test_torch_serve.py).  Prefix caching with
copy-on-write splits, window eviction and packed mixed steps come with
the slices that serve them.

One :class:`Scheduler` owns the page pool and the slot map and makes the
in-flight-batching decisions each engine step:

  * **growth** — every running sequence gets the page its next token
    lands in.  Running rows always outrank new admissions for pages.
  * **preemption** — when the pool is exhausted, the *youngest* running
    sequence (LIFO, the vLLM recompute policy) is evicted: its pages are
    freed and the request returns to the *front* of the waiting queue.
    Re-admission re-prefills from the original prompt; greedy decoding
    makes the regenerated tokens identical to the uninterrupted run.  A
    sequence preempted ``PREEMPT_SHIELD`` times (the JAX scheduler's
    default) becomes immune: victim selection skips it while any
    unshielded candidate exists, which bounds how often page-growth
    priority can bounce the same request.
  * **admission** — FCFS, while a slot is free and the pool can hold the
    prompt plus one decode token.

The scheduler never touches device memory: it hands the engine numpy
block tables / lengths / active masks (:meth:`tables`) and the list of
sequences to prefill.  All device work lives in ``serve/engine.py``.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.serve.kv_cache import (
    TRASH_PAGE,
    PageAllocator,
    PagedCacheConfig,
)

__all__ = ["Request", "SeqState", "StepPlan", "Scheduler"]

PREEMPT_SHIELD = 2              # preemptions after which a row is immune


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray          # [T] int32 prompt
    max_new: int
    submit_time: float = 0.0
    n_preempts: int = 0         # times evicted (preemption shield)


@dataclasses.dataclass
class SeqState:
    """A running sequence: its slot, pages, and generation progress."""

    req: Request
    slot: int
    pages: list[int]            # physical pages, logical-block order
    length: int                 # tokens resident in cache
    emitted: list[int]          # generated token ids (greedy)
    last_token: int = 0
    admit_seq: int = -1         # admission order (LIFO preemption key)

    @property
    def rid(self) -> int:
        return self.req.rid


@dataclasses.dataclass
class StepPlan:
    """What the engine must do this step."""

    admitted: list[SeqState]    # need a prefill + page blit
    preempted: list[int]        # rids evicted back to the queue
    grew: bool = False          # some running row got a new page


class Scheduler:
    def __init__(self, pcfg: PagedCacheConfig):
        self.pcfg = pcfg
        self.alloc = PageAllocator(pcfg.n_pages)
        self.waiting: collections.deque[Request] = collections.deque()
        self.running: dict[int, SeqState] = {}          # slot -> seq
        self._free_slots = list(range(pcfg.max_seqs - 1, -1, -1))
        self._admit_clock = 0

    # ------------------------------------------------------------ intake --
    def submit(self, req: Request) -> None:
        bs = self.pcfg.page_size
        T = len(req.tokens)
        need = -(-(T + req.max_new) // bs)
        if need > self.pcfg.max_blocks:
            raise ValueError(
                f"request {req.rid}: prompt {T} + max_new {req.max_new} "
                f"needs {need} blocks > per-seq capacity "
                f"{self.pcfg.max_blocks} ({self.pcfg.tokens_per_seq} tokens)")
        if need > self.alloc.n_pages - 1:
            raise ValueError(
                f"request {req.rid} can never fit: needs {need} pages, "
                f"pool has {self.alloc.n_pages - 1}")
        self.waiting.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ------------------------------------------------------------ policy --
    def _release(self, seq: SeqState) -> None:
        """Free a departing row's pages and clear its page list, so a
        stale reference the engine still holds (a row preempted the same
        step it finishes) cannot free them a second time."""
        self.alloc.free(seq.pages)
        seq.pages = []

    def _preempt_youngest(self) -> int | None:
        """Evict the most recently admitted unshielded running seq.

        Rows preempted ``PREEMPT_SHIELD`` times are skipped while any
        other candidate exists — page-growth priority must not bounce the
        same request forever.  Returns the rid.
        """
        if not self.running:
            return None
        cands = [s for s in self.running.values()
                 if s.req.n_preempts < PREEMPT_SHIELD]
        victim = max(cands or self.running.values(),
                     key=lambda s: s.admit_seq)
        victim.req.n_preempts += 1
        self._release(victim)
        self._free_slots.append(victim.slot)
        del self.running[victim.slot]
        # back to the FRONT: it has the oldest arrival among waiting peers
        self.waiting.appendleft(victim.req)
        return victim.rid

    def _grow(self, preempted: list[int]) -> bool:
        """Give every running row the page for the token it writes next
        (position ``length``); preemption backs it, so every surviving
        row emits one token per step."""
        bs = self.pcfg.page_size
        grew = False
        for seq in sorted(self.running.values(), key=lambda s: s.admit_seq):
            if self.running.get(seq.slot) is not seq:   # preempted below us
                continue
            required = seq.length // bs + 1
            while len(seq.pages) < required:
                got = self.alloc.alloc(1)
                if got is not None:
                    seq.pages.extend(got)
                    grew = True
                    continue
                rid = self._preempt_youngest()
                if rid is None or rid == seq.rid:
                    if rid is not None:
                        preempted.append(rid)
                    break                           # seq itself evicted
                preempted.append(rid)
        return grew

    def _admit(self) -> list[SeqState]:
        bs = self.pcfg.page_size
        admitted = []
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            pages = self.alloc.alloc(-(-(len(req.tokens) + 1) // bs))
            if pages is None:
                break                               # head-of-line blocks
            self.waiting.popleft()
            slot = self._free_slots.pop()
            seq = SeqState(req=req, slot=slot, pages=pages,
                           length=len(req.tokens), emitted=[],
                           admit_seq=self._admit_clock)
            self._admit_clock += 1
            self.running[slot] = seq
            admitted.append(seq)
        return admitted

    def schedule(self) -> StepPlan:
        """Growth (with LIFO preemption), then admission."""
        preempted: list[int] = []
        grew = self._grow(preempted)
        admitted = self._admit()
        return StepPlan(admitted=admitted, preempted=preempted, grew=grew)

    def complete(self, seq: SeqState) -> None:
        """Finished row: free its pages and slot immediately.

        Guarded against stale states: if ``seq`` is no longer the
        registered occupant of its slot (it was preempted this same step,
        or completed already), this is a no-op — freeing its slot or
        pages again would hand them to two sequences at once.
        """
        if self.running.get(seq.slot) is not seq:
            return
        self._release(seq)
        self._free_slots.append(seq.slot)
        del self.running[seq.slot]

    # ------------------------------------------------------- device views --
    def tables(self):
        """(block_tables [R, nb], lengths [R], active [R], last_tokens [R])
        as numpy — empty slots point at the trash page with length 0."""
        R, nb = self.pcfg.max_seqs, self.pcfg.max_blocks
        bt = np.full((R, nb), TRASH_PAGE, np.int32)
        lengths = np.zeros((R,), np.int32)
        active = np.zeros((R,), bool)
        last = np.zeros((R,), np.int32)
        for slot, seq in self.running.items():
            bt[slot, : len(seq.pages)] = seq.pages
            lengths[slot] = seq.length
            active[slot] = True
            last[slot] = seq.last_token
        return bt, lengths, active, last

    def block_row(self, seq: SeqState, n_blocks: int) -> np.ndarray:
        """[n_blocks] physical pages for a prompt blit (trash-padded)."""
        row = np.full((n_blocks,), TRASH_PAGE, np.int32)
        k = min(len(seq.pages), n_blocks)
        row[:k] = seq.pages[:k]
        return row
