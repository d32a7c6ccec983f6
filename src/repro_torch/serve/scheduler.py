"""Continuous-batching request scheduler (host-side policy, numpy only).

The port of ``repro.serve.scheduler``: on the same traffic both make the
same plans (asserted in tests/test_torch_serve.py, test_torch_chunked.py,
test_torch_prefix.py and test_torch_window.py).

One :class:`Scheduler` owns the page pool and the slot map and makes the
in-flight-batching decisions each engine step:

  * **growth** -- running sequences get the page(s) the tokens they
    write next land in; with speculative decoding the write window is
    ``lookahead`` tokens wide: the first page is preemption-backed (every
    row emits at least one token a step), the rest best-effort (a draft
    whose KV has no page goes to the trash page and the engine caps
    acceptance).  Running rows always outrank new admissions for pages.
  * **copy-on-write** -- a row about to write into a *shared* page
    (refcount > 1: the prefix index and/or other rows hold it) first
    splits it: a fresh page is allocated, the engine copies the contents
    on the device (``kv_cache.copy_pages``) and the row's block table is
    repointed.  The shared original stays frozen for its other holders.
  * **preemption** -- when the pool is exhausted, the *youngest* running
    sequence (LIFO, the vLLM recompute policy) is evicted: its pages are
    freed and the request returns to the *front* of the waiting queue.
    Re-admission re-prefills from the original prompt; greedy decoding
    makes the regenerated tokens identical to the uninterrupted run.  A
    sequence preempted ``preempt_shield`` times becomes immune: victim
    selection skips it while any unshielded candidate exists.
  * **window eviction** -- with ``window_tokens`` set, every step begins
    by recycling each row's blocks that no future query can attend
    (query ``q`` sees keys ``[q - W + 1, q]``).  Evicted block-table
    entries become the trash page: absolute positions and block indices
    stay, the attention mask weighs the evicted positions exactly 0, and
    the freed pages serve the same step's growth and admissions.
    Windowed rows never register prefix-cache blocks (every one is
    evicted in time; the index holds only live, immutable pages).
  * **admission** -- while a slot is free and the pool can hold the
    prompt plus one decode token.  With the prefix cache on, the waiting
    request with the longest cached prefix goes first; strict FCFS
    resumes whenever the queue head was preempted before or has waited
    ``starvation_limit`` steps.

With ``prefix_cache=True`` the scheduler keeps the content-addressed
:class:`~repro_torch.serve.kv_cache.PrefixCache`: admissions adopt cached
pages block by block (the engine's prefill blit skips them), prefilled
full-prompt blocks are registered at once, and a departing row stashes
its partial last prompt block before releasing its pages.  With
``chunked=True`` admitted rows carry the prompt positions still to run
(``SeqState.todo``) and :meth:`Scheduler.plan_mixed` packs each step's
decode rows and prefill chunks into ``token_budget`` lanes.

The scheduler never touches device memory: it hands the engine numpy
block tables / lengths / active masks (:meth:`tables`), the sequences to
prefill, packed segments and COW (slot, block, src, dst) splits.  All
device work lives in ``serve/engine.py``.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.serve.kv_cache import (
    TRASH_PAGE,
    PageAllocator,
    PagedCacheConfig,
    PrefixCache,
)

__all__ = ["Request", "SeqState", "StepPlan", "PackedSegment", "Scheduler"]


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray          # [T] int32 prompt
    max_new: int
    submit_time: float = 0.0
    wait_steps: int = 0         # scheduler steps spent waiting (starvation)
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
    cached_tokens: int = 0      # prompt tokens served by the prefix cache
    shared_blocks: set[int] = dataclasses.field(default_factory=set)
    # chunked prefill: prompt positions still to run through the mixed
    # step, ascending (None: not chunked, or prefill complete).  Adopted
    # shared blocks' positions are left out -- their KV is resident --
    # but the last prompt position always stays in (its logits are the
    # first generated token).
    todo: collections.deque[int] | None = None

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def prefilling(self) -> bool:
        return bool(self.todo)

    @property
    def resident(self) -> int:
        """Prompt tokens whose KV is resident (a contiguous prefix:
        ``todo`` is consumed in order, and earlier positions are either
        consumed or adopted from the prefix cache)."""
        if self.todo:
            return self.todo[0]
        return len(self.req.tokens)


@dataclasses.dataclass
class StepPlan:
    """What the engine must do this step."""

    admitted: list[SeqState]    # need a prefill + page blit
    preempted: list[int]        # rids evicted back to the queue
    grew: bool = False          # some running row got a new page
    # copy-on-write splits the engine copies on the device BEFORE this
    # step's writes (block tables already repointed)
    cow: list[tuple[int, int, int, int]] = dataclasses.field(
        default_factory=list)           # (slot, block, src, dst)


@dataclasses.dataclass
class PackedSegment:
    """One contiguous run of lanes in a packed mixed step.

    ``kind`` is ``"chunk"`` (prefill-chunk tokens, ``tokens`` taken from
    the prompt) or ``"decode"`` (a decode row's next-token lane and
    ``n - 1`` speculative-draft lanes; the engine fills the tokens).
    ``offset`` is the segment's first lane in the step's fixed
    [token_budget] arrays, set by the engine when it packs.  ``last``
    marks a chunk that completes its prompt: its final lane's logits
    are the row's first generated token.
    """

    seq: SeqState
    kind: str
    positions: np.ndarray       # [n] absolute positions, ascending
    tokens: np.ndarray | None   # [n] token ids (None for decode segments)
    last: bool = False
    offset: int = 0

    @property
    def n(self) -> int:
        return len(self.positions)


class Scheduler:
    def __init__(self, pcfg: PagedCacheConfig, *, prefix_cache: bool = False,
                 lookahead: int = 1, starvation_limit: int = 8,
                 preempt_shield: int = 2, chunked: bool = False,
                 token_budget: int = 0, chunk_size: int | None = None,
                 prefill_reserve: int = 0, window_tokens: int | None = None):
        self.pcfg = pcfg
        self.alloc = PageAllocator(pcfg.n_pages)
        self.prefix = (PrefixCache(self.alloc, pcfg.page_size)
                       if prefix_cache else None)
        self.lookahead = max(1, lookahead)
        self.starvation_limit = starvation_limit
        self.preempt_shield = preempt_shield
        self.chunked = chunked
        self.token_budget = token_budget
        self.chunk_size = chunk_size
        self.prefill_reserve = prefill_reserve
        self._rr = 0                    # decode round-robin rotation
        self.window = window_tokens     # sliding-window width (None: full)
        self.window_evictions = 0       # pages recycled by _evict_window
        self.waiting: collections.deque[Request] = collections.deque()
        self.running: dict[int, SeqState] = {}          # slot -> seq
        self._free_slots = list(range(pcfg.max_seqs - 1, -1, -1))
        self._admit_clock = 0
        self._peek_memo: dict[int, tuple[int, int]] = {}   # rid -> (gen, n)
        self.cow_splits = 0
        self.cache_hit_tokens = 0

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
        # windowed rows recycle their oldest pages as they go, so their
        # physical footprint is bounded by the window (plus the write
        # lookahead and block-alignment slack) however long they run
        need_pool = need
        if self.window is not None:
            need_pool = min(need,
                            -(-(self.window + self.lookahead) // bs) + 1)
        if need_pool > self.alloc.n_pages - 1:
            raise ValueError(
                f"request {req.rid} can never fit: needs {need_pool} pages, "
                f"pool has {self.alloc.n_pages - 1}")
        self.waiting.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ------------------------------------------------------------ policy --
    def _alloc(self, n: int) -> list[int] | None:
        """Allocate, reclaiming LRU prefix-cache pages before giving up."""
        pages = self.alloc.alloc(n)
        if pages is None and self.prefix is not None:
            self.prefix.evict(n - self.alloc.n_free)
            pages = self.alloc.alloc(n)
        return pages

    def _stash_prefix(self, seq: SeqState) -> None:
        """Register a departing row's prompt blocks (with the partial
        tail, frozen from now on: an adopter splits it before writing).

        A row evicted before its prefill ran (admitted and preempted in
        the same :meth:`schedule`) has nothing to stash: its pages were
        never written, and indexing them would serve garbage KV.  A
        windowed row registers nothing: every one of its blocks is
        evicted in time."""
        if (self.prefix is not None and self.window is None
                and seq.pages and seq.emitted):
            self.prefix.insert(seq.req.tokens, seq.pages)

    def _release(self, seq: SeqState) -> None:
        """Free a departing row's real pages (window eviction leaves trash
        placeholders, which the allocator never handed out) and clear its
        state, so a stale reference the engine still holds (a row
        preempted the same step it finishes) can neither free them again
        nor look prefilling."""
        self.alloc.free([pg for pg in seq.pages if pg != TRASH_PAGE])
        seq.pages = []
        seq.shared_blocks = set()
        seq.todo = None

    def _preempt_youngest(self) -> int | None:
        """Evict the most recently admitted unshielded running seq.

        Rows preempted ``preempt_shield`` times are skipped while any
        other candidate exists -- page-growth priority must not bounce
        the same request forever.  Returns the rid.
        """
        if not self.running:
            return None
        cands = [s for s in self.running.values()
                 if s.req.n_preempts < self.preempt_shield]
        victim = max(cands or self.running.values(),
                     key=lambda s: s.admit_seq)
        victim.req.n_preempts += 1
        self._stash_prefix(victim)
        self._release(victim)
        self._free_slots.append(victim.slot)
        del self.running[victim.slot]
        # back to the FRONT: it has the oldest arrival among waiting peers
        self.waiting.appendleft(victim.req)
        return victim.rid

    def _evict_window(self) -> None:
        """Sliding window: recycle every block no future query can attend.

        The earliest query a row runs again sits at ``qmin`` (the front
        of its chunked ``todo`` while prefilling, else its ``length``),
        and it attends keys from ``qmin - window + 1``, so block ``b`` is
        dead once ``(b + 1) * bs <= qmin - window + 1``.  Its page goes
        back to the pool and its entry becomes the trash page (absolute
        block indexing stays; the window mask weighs those positions
        exactly 0).  Runs first in :meth:`schedule`, so the pages serve
        this step's growth and admissions."""
        if self.window is None:
            return
        bs = self.pcfg.page_size
        for seq in self.running.values():
            qmin = seq.todo[0] if seq.todo else seq.length
            keep_from = qmin - self.window + 1
            n_dead = min(max(keep_from, 0) // bs, len(seq.pages))
            for b in range(n_dead):
                pg = seq.pages[b]
                if pg == TRASH_PAGE:
                    continue                        # already recycled
                self.alloc.free([pg])
                seq.pages[b] = TRASH_PAGE
                seq.shared_blocks.discard(b)
                self.window_evictions += 1

    def _grow(self, preempted: list[int]) -> bool:
        """Give every running row page(s) for the tokens it writes next.

        The page of position ``length`` is required: preemption backs
        it, so every surviving row emits at least one token a step.  The
        pages of the rest of the ``lookahead`` window (speculative
        drafts) are best-effort: a missing one sends that draft's KV to
        the trash page and the engine caps acceptance."""
        bs = self.pcfg.page_size
        grew = False
        for seq in sorted(self.running.values(), key=lambda s: s.admit_seq):
            if self.running.get(seq.slot) is not seq:   # preempted below us
                continue
            required = seq.length // bs + 1
            while len(seq.pages) < required:
                got = self._alloc(1)
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
            desired = min((seq.length + self.lookahead - 1) // bs + 1,
                          self.pcfg.max_blocks)
            while (self.running.get(seq.slot) is seq
                   and len(seq.pages) < desired):
                got = self._alloc(1)
                if got is None:
                    break                           # best-effort only
                seq.pages.extend(got)
                grew = True
        return grew

    def _cow_split(self, preempted: list[int]) -> list[tuple[int, int, int, int]]:
        """Split every shared page in a row's write window (positions
        ``length .. length + lookahead - 1``): the row gets a fresh copy
        and drops its reference on the original.  The engine runs the
        device copies first."""
        cow: list[tuple[int, int, int, int]] = []
        bs = self.pcfg.page_size
        for seq in sorted(self.running.values(), key=lambda s: s.admit_seq):
            if self.running.get(seq.slot) is not seq:
                continue
            b0 = seq.length // bs
            b1 = min((seq.length + self.lookahead - 1) // bs,
                     len(seq.pages) - 1)
            for b in range(b0, b1 + 1):
                if self.running.get(seq.slot) is not seq:
                    break                           # evicted mid-split
                src = seq.pages[b]
                if src == TRASH_PAGE or self.alloc.refcount(src) <= 1:
                    continue
                fresh = self._alloc(1)
                while fresh is None:
                    rid = self._preempt_youngest()
                    if rid is None:
                        break
                    preempted.append(rid)
                    if rid == seq.rid:
                        break                       # seq itself evicted
                    fresh = self._alloc(1)
                if fresh is None or self.running.get(seq.slot) is not seq:
                    continue
                dst = fresh[0]
                cow.append((seq.slot, b, src, dst))
                seq.pages[b] = dst
                seq.shared_blocks.discard(b)
                self.alloc.free([src])              # drop OUR ref only
                self.cow_splits += 1
        return cow

    def _pick_next(self) -> int:
        """Index into ``waiting`` of the next admission candidate: the
        request with the longest cached prefix, unless the queue head
        was preempted or has waited ``starvation_limit`` steps (then
        strict FCFS)."""
        if self.prefix is None or len(self.waiting) <= 1:
            return 0
        head = self.waiting[0]
        if head.n_preempts > 0 or head.wait_steps >= self.starvation_limit:
            return 0
        best, best_cached = 0, -1
        gen = self.prefix.generation
        for i, req in enumerate(self.waiting):
            # memoized per (request, index generation): the probe hashes
            # O(T^2 / page_size) prefix bytes
            memo = self._peek_memo.get(req.rid)
            if memo is not None and memo[0] == gen:
                n_cached = memo[1]
            else:
                n_cached = self.prefix.peek_cached_tokens(req.tokens)
                self._peek_memo[req.rid] = (gen, n_cached)
            if n_cached > best_cached:
                best, best_cached = i, n_cached
        return best

    def _admit(self) -> list[SeqState]:
        bs = self.pcfg.page_size
        admitted = []
        while self.waiting and self._free_slots:
            idx = self._pick_next()
            req = self.waiting[idx]
            n_blocks = -(-(len(req.tokens) + 1) // bs)
            shared: list[int | None] = [None] * n_blocks
            n_cached = 0
            # windowed rows never adopt (nothing registers under a
            # window), and blocks already outside the window at admission
            # get the trash page, not a page: a whole-prompt prefill
            # attends from the token stream, not the pages (a chunked
            # one reads the pages, but its todo starts at 0, so nothing
            # is dead yet: _evict_window recycles as chunks drain)
            dead: set[int] = set()
            if self.window is not None:
                if not self.chunked:
                    keep_from = len(req.tokens) - self.window + 1
                    dead = {b for b in range(n_blocks)
                            if (b + 1) * bs <= keep_from}
            elif self.prefix is not None:
                hit, n_cached = self.prefix.lookup(req.tokens)
                shared[: len(hit)] = hit
            share_map = {b: pg for b, pg in enumerate(shared)
                         if pg is not None}
            # incref the adopted pages BEFORE the fresh allocation: _alloc
            # may evict index entries, and an index-only hit page is
            # exactly what eviction frees
            self.alloc.incref(list(share_map.values()))
            fresh = self._alloc(n_blocks - len(share_map) - len(dead))
            if fresh is None:
                self.alloc.free(list(share_map.values()))   # undo adoption
                break                               # head-of-line blocks
            fi = iter(fresh)
            pages = [share_map[b] if b in share_map
                     else TRASH_PAGE if b in dead else next(fi)
                     for b in range(n_blocks)]
            del self.waiting[idx]
            self._peek_memo.pop(req.rid, None)
            req.wait_steps = 0
            slot = self._free_slots.pop()
            seq = SeqState(req=req, slot=slot, pages=pages,
                           length=len(req.tokens), emitted=[],
                           admit_seq=self._admit_clock,
                           cached_tokens=n_cached,
                           shared_blocks=set(share_map))
            if self.chunked:
                T = len(req.tokens)
                todo = [p for p in range(T)
                        if p // bs not in seq.shared_blocks]
                if not todo or todo[-1] != T - 1:
                    todo.append(T - 1)      # first-token logits
                seq.todo = collections.deque(todo)
            self._admit_clock += 1
            self.running[slot] = seq
            admitted.append(seq)
            self.cache_hit_tokens += n_cached
        return admitted

    def schedule(self) -> StepPlan:
        """Window eviction, growth (with LIFO preemption), admission,
        then COW splits."""
        for req in self.waiting:
            req.wait_steps += 1
        preempted: list[int] = []
        self._evict_window()
        grew = self._grow(preempted)
        admitted = self._admit()
        # COW runs last so it also covers rows admitted THIS step (their
        # first write can land in an adopted partial block)
        cow = self._cow_split(preempted)
        admitted = [s for s in admitted
                    if self.running.get(s.slot) is s]   # COW may evict
        return StepPlan(admitted=admitted, preempted=preempted, grew=grew,
                        cow=cow)

    def plan_mixed(self, window: int = 1) -> list[PackedSegment]:
        """Fill one mixed step's ``token_budget`` lanes: decode rows,
        then prefill chunks.  Called after :meth:`schedule`.

          * total lanes never exceed ``token_budget``;
          * every decode-phase row gets ``window`` lanes (its next token
            and ``window - 1`` speculative drafts), round-robin across
            steps when rows outnumber ``token_budget // window``;
          * while any row is prefilling, decode rows are capped so at
            least ``prefill_reserve`` lanes go to chunks, but at least
            one decode row always advances;
          * chunks drain FCFS by admission order, each row consuming at
            most ``chunk_size`` positions a step, ``todo`` front first.
        """
        W = max(1, window)
        budget = self.token_budget
        segs: list[PackedSegment] = []
        decode_rows = sorted((s for s in self.running.values()
                              if not s.prefilling and s.emitted),
                             key=lambda s: s.slot)
        prefill_rows = sorted((s for s in self.running.values()
                               if s.prefilling), key=lambda s: s.admit_seq)
        max_decode = budget // W
        if prefill_rows:
            max_decode = min(max_decode,
                             max(1, (budget - self.prefill_reserve) // W))
        remaining = budget
        if decode_rows:
            rot = self._rr % len(decode_rows)
            take = (decode_rows[rot:] + decode_rows[:rot])[:max_decode]
            self._rr = (rot + len(take)) % len(decode_rows)
            for seq in take:
                segs.append(PackedSegment(
                    seq=seq, kind="decode",
                    positions=seq.length + np.arange(W, dtype=np.int32),
                    tokens=None))
                remaining -= W
        for seq in prefill_rows:
            if remaining <= 0:
                break
            n = min(len(seq.todo), remaining)
            if self.chunk_size:
                n = min(n, self.chunk_size)
            positions = np.array([seq.todo.popleft() for _ in range(n)],
                                 np.int32)
            segs.append(PackedSegment(
                seq=seq, kind="chunk", positions=positions,
                tokens=np.asarray(seq.req.tokens, np.int32)[positions],
                last=not seq.todo))
            remaining -= n
        return segs

    def _register_blocks(self, seq: SeqState, n_tokens: int) -> None:
        """Index the full blocks of the prompt's first ``n_tokens`` (none
        under a window)."""
        n_full = n_tokens // self.pcfg.page_size
        if self.prefix is not None and self.window is None and n_full:
            self.prefix.insert(seq.req.tokens[: n_full * self.pcfg.page_size],
                               seq.pages[:n_full])

    def register_chunks(self, seq: SeqState) -> None:
        """Register a chunked row's now fully resident full prompt blocks
        (a block becomes a hit as soon as its last chunk lands; the
        partial tail waits for :meth:`_stash_prefix`)."""
        self._register_blocks(seq, min(seq.resident, len(seq.req.tokens)))

    def register_prefix(self, seq: SeqState) -> None:
        """Called by the engine right after a prefill blit: the prompt's
        FULL blocks now hold final KV and become discoverable.  The
        partial tail stays private until the row departs (the producer
        keeps writing into it)."""
        self._register_blocks(seq, len(seq.req.tokens))

    def complete(self, seq: SeqState) -> None:
        """Finished row: stash its prompt blocks, free its pages and
        slot.  A no-op if ``seq`` no longer holds its slot (preempted
        this same step, or completed already): freeing its slot or pages
        again would hand them to two sequences at once."""
        if self.running.get(seq.slot) is not seq:
            return
        self._stash_prefix(seq)
        self._release(seq)
        self._free_slots.append(seq.slot)
        del self.running[seq.slot]

    # ------------------------------------------------------- device views --
    def tables(self):
        """(block_tables [R, nb], lengths [R], active [R], last_tokens [R])
        as numpy -- empty slots point at the trash page with length 0."""
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
        """[n_blocks] physical pages for a prompt blit (trash-padded).
        Blocks adopted from the prefix cache map to the trash page too:
        their KV is resident in the shared page, frozen for its holders."""
        row = np.full((n_blocks,), TRASH_PAGE, np.int32)
        k = min(len(seq.pages), n_blocks)
        row[:k] = seq.pages[:k]
        for b in seq.shared_blocks:
            if b < n_blocks:
                row[b] = TRASH_PAGE
        return row
