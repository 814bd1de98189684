"""Prefix-sharing KV cache plane (cross-request prefill reuse).

Agentic pipelines send near-identical system/task prefixes to the same
engines thousands of times; re-prefilling them from scratch is the
dominant wasted work in agent serving.  This module makes the prefix
cache a *programmable plane* in the paper's sense: reuse is the
mechanism, but eviction, pinning and reservation are **knobs**, hit rate
is a **metric** on the bus, and pin/unpin are **intent actions**.

* ``PrefixCache`` — per-engine block-hash radix index over token
  prefixes, layered on the refcount-capable ``PageAllocator``
  (serving/kv_cache.py).  Blocks are page-aligned; a request *acquires*
  every resident block of its prompt prefix at admission (the scheduler
  then charges only uncached tokens against its prefill budget) and new
  blocks are *promoted* out of the sequence's private pages when prefill
  completes.  Pluggable eviction (LRU / LFU over idle blocks; pinned
  blocks are never evicted), a ``reserve_frac`` cap on idle cache pages,
  and a ControlSurface with the paper's Table-1 knobs.
* ``CacheDirectory`` — the controller-visible map prefix digest →
  instances where the blocks are resident (mirror of ``SessionDirectory``
  in kv_transfer.py).  The router's ``cache_aware`` policy and the intent
  language's ``pin``/``unpin`` actions go through it.

Prefix identity is a digest chain.  Real engines hash actual token-id
blocks; the sim (which carries token *counts*, not contents) describes a
prompt as labelled segments — ``(("system-prompt", 512), ("sess:a", 96))``
— and the chain is derived from the labels covering each block, so two
prompts share exactly the blocks whose covering spans agree.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Sequence

from repro_torch.core.knobs import ControlSurface, KnobSpec
from repro_torch.serving.kv_cache import PageAllocator

# A prefix source is either labelled segments ((label, n_tokens), ...)
# or a concrete token-id sequence (real engine path).
PrefixSource = Sequence


def _digest(parent: str, payload: str) -> str:
    return hashlib.sha1((parent + "|" + payload).encode()).hexdigest()[:16]


@dataclass(frozen=True)
class BlockId:
    """One block of the digest chain: identity + the segment labels that
    cover it (labels are what ``pin system-prompt`` matches against)."""

    digest: str
    labels: tuple[str, ...]


def chain_for(source: PrefixSource, block_tokens: int) -> list[BlockId]:
    """Digest chain over full blocks of ``source``.

    Segments path: block ``i`` covers token span [i·B, (i+1)·B); its
    digest hashes the (label, in-segment offset) spans covering it, so
    equality holds exactly when the labelled content agrees position by
    position.  Token path: digest hashes the raw ids in the block.
    """
    if not source:
        return []
    first = source[0]
    if isinstance(first, (tuple, list)) and len(first) == 2 \
            and isinstance(first[0], str):
        return _chain_segments(source, block_tokens)
    return _chain_tokens(source, block_tokens)


def _chain_tokens(tokens: Sequence[int], block_tokens: int) -> list[BlockId]:
    out, parent = [], ""
    for i in range(0, (len(tokens) // block_tokens) * block_tokens,
                   block_tokens):
        blk = ",".join(str(int(t)) for t in tokens[i:i + block_tokens])
        parent = _digest(parent, blk)
        out.append(BlockId(parent, ()))
    return out


def _chain_segments(segments: Iterable, block_tokens: int) -> list[BlockId]:
    # materialize (label, offset_in_segment) span boundaries per block
    spans: list[tuple[str, int, int]] = []     # (label, seg_start, seg_end)
    total = 0
    for label, n in segments:
        n = int(n)
        if n <= 0:
            continue
        spans.append((str(label), total, total + n))
        total += n
    out, parent = [], ""
    for i in range(total // block_tokens):
        lo, hi = i * block_tokens, (i + 1) * block_tokens
        cover = [(lab, max(lo, s) - s, min(hi, e) - s)
                 for lab, s, e in spans if s < hi and e > lo]
        payload = ";".join(f"{lab}:{a}:{b}" for lab, a, b in cover)
        parent = _digest(parent, payload)
        out.append(BlockId(parent, tuple(lab for lab, _, _ in cover)))
    return out


@dataclass
class CacheEntry:
    """Metadata for one resident block (residency itself lives in the
    allocator; this is what eviction policies rank)."""

    block: BlockId
    parent: Optional[str]
    pages: int
    tokens: int
    last_used: float = 0.0
    uses: int = 0
    pinned: bool = False


class PrefixCache(ControlSurface):
    """Per-engine prefix index + eviction policy + control surface."""

    kind = "cache"
    CAPABILITIES = ("pin", "evict")
    METRICS = ("hit_rate", "saved_prefill_tokens", "shared_pages")
    KNOB_SPECS = (
        KnobSpec("enabled", kind="bool",
                 doc="prefix reuse on/off (off: admission never matches)"),
        KnobSpec("evict_policy", kind="str", choices=("lru", "lfu"),
                 doc="ranking for idle-block eviction"),
        KnobSpec("reserve_frac", kind="float", lo=0.0, hi=1.0,
                 on_change="_reserve_changed",
                 doc="max fraction of the page pool idle cache blocks "
                     "may occupy"),
        KnobSpec("min_block_tokens", kind="int", lo=1, attr="block_tokens",
                 doc="requested block size; effective size is the next "
                     "page multiple"),
    )

    def __init__(self, alloc: PageAllocator, name: str = "cache",
                 instance: str = "", block_tokens: int = 64,
                 enabled: bool = True, evict_policy: str = "lru",
                 reserve_frac: float = 0.5,
                 directory: Optional["CacheDirectory"] = None,
                 collector=None, clock: Optional[Callable[[], float]] = None):
        self.alloc = alloc
        self.name = name
        self.instance = instance or name
        self.block_tokens = int(block_tokens)
        self.enabled = bool(enabled)
        self.evict_policy = evict_policy
        self.reserve_frac = float(reserve_frac)
        self.directory = directory
        self.collector = collector
        self._clock = clock or (lambda: 0.0)
        self._entries: dict[str, CacheEntry] = {}
        self._children: dict[str, set[str]] = {}
        self._inflight: dict[str, list[BlockId]] = {}   # seq -> full chain
        self._hit_blocks: dict[str, int] = {}           # seq -> blocks hit
        self._seq_shared: dict[str, int] = {}           # seq -> shared tokens
        self._pinned_labels: set[str] = set()
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.lookups = 0
        self.evictions = 0
        if directory is not None:
            directory.attach(self)

    # -- knob hooks ---------------------------------------------------------
    def _surface_now(self) -> float:
        return self._clock()

    def _reserve_changed(self, old, new) -> None:
        self.enforce_reserve()

    # -- geometry -----------------------------------------------------------
    @property
    def eff_block_tokens(self) -> int:
        """Blocks are page-aligned so shared pages never straddle a
        private page: the requested size rounds up to a page multiple."""
        ps = self.alloc.page_size
        return -(-max(self.block_tokens, 1) // ps) * ps

    @property
    def pages_per_block(self) -> int:
        return self.eff_block_tokens // self.alloc.page_size

    # -- prefix identity -----------------------------------------------------
    @staticmethod
    def request_source(req) -> Optional[PrefixSource]:
        src = (req.meta or {}).get("prefix")
        if src is not None:
            return src
        if req.prompt_tokens is not None:
            return list(req.prompt_tokens)
        return None

    def chain(self, source: PrefixSource) -> list[BlockId]:
        return chain_for(source, self.eff_block_tokens)

    # -- lookups -------------------------------------------------------------
    def probe(self, source: Optional[PrefixSource],
              limit: Optional[int] = None) -> int:
        """Tokens of ``source``'s prefix resident here (no side effects)."""
        if not self.enabled or source is None:
            return 0
        bt, hit = self.eff_block_tokens, 0
        for i, blk in enumerate(self.chain(source)):
            end = (i + 1) * bt
            if limit is not None and end > limit:
                break
            if not self.alloc.block_resident(blk.digest):
                break
            hit = end
        return hit

    def probe_request(self, req, limit: Optional[int] = None) -> int:
        return self.probe(self.request_source(req), limit=limit)

    # -- admission-side ------------------------------------------------------
    def begin(self, req, limit: Optional[int] = None) -> int:
        """Match + acquire at admission.  Returns cached prefix tokens;
        the scheduler starts ``req.prefilled`` there and charges only the
        remainder.  The full chain is remembered for ``commit``."""
        source = self.request_source(req)
        if not self.enabled or source is None:
            return 0
        now = self._clock()
        chain = self.chain(source)
        bt, hit_blocks = self.eff_block_tokens, 0
        for i, blk in enumerate(chain):
            end = (i + 1) * bt
            if limit is not None and end > limit:
                break
            if not self.alloc.block_resident(blk.digest):
                break
            self.alloc.acquire(req.req_id, blk.digest)
            ent = self._entries.get(blk.digest)
            if ent is not None:
                ent.last_used = now
                ent.uses += 1
            hit_blocks = i + 1
        self._inflight[req.req_id] = chain
        self._hit_blocks[req.req_id] = hit_blocks
        hit = hit_blocks * bt
        self._seq_shared[req.req_id] = hit
        self.lookups += 1
        self.hit_tokens += hit
        self.miss_tokens += max(req.prompt_len - hit, 0)
        self._publish()
        return hit

    def commit(self, req) -> int:
        """Prefill finished: promote the freshly-computed full blocks out
        of the sequence's private pages into shared, refcounted blocks.
        Returns the number of blocks newly inserted."""
        chain = self._inflight.get(req.req_id)
        if chain is None or not self.enabled:
            return 0
        now = self._clock()
        bt, ppb = self.eff_block_tokens, self.pages_per_block
        inserted = 0
        parent = None
        start = self._hit_blocks.get(req.req_id, 0)
        for i, blk in enumerate(chain):
            if i < start:
                parent = blk.digest
                continue
            if (i + 1) * bt > req.prefilled:
                break
            if self.alloc.block_resident(blk.digest):
                # raced in via a sibling request: just reference it
                self.alloc.acquire(req.req_id, blk.digest)
            elif self.alloc.promote(req.req_id, blk.digest, ppb):
                self._entries[blk.digest] = CacheEntry(
                    blk, parent, ppb, bt, last_used=now, uses=1,
                    pinned=any(l in self._pinned_labels for l in blk.labels))
                if parent is not None:
                    self._children.setdefault(parent, set()).add(blk.digest)
                if self.directory is not None:
                    self.directory.note_insert(blk.digest, self.instance)
                inserted += 1
            else:
                break                    # private pages exhausted — stop
            self._seq_shared[req.req_id] = (i + 1) * bt
            parent = blk.digest
        self._publish()
        return inserted

    def shared_tokens(self, seq_id: str) -> int:
        """Prompt tokens of ``seq_id`` living in shared blocks — the
        scheduler subtracts these when sizing private page growth."""
        return self._seq_shared.get(seq_id, 0)

    def seq_done(self, seq_id: str) -> None:
        """Sequence released (finish/preempt): drop per-seq state and
        trim idle pages back under the reservation cap."""
        self._inflight.pop(seq_id, None)
        self._hit_blocks.pop(seq_id, None)
        self._seq_shared.pop(seq_id, None)
        self.enforce_reserve()

    # -- eviction ------------------------------------------------------------
    def _evictable(self) -> list[CacheEntry]:
        out = []
        for d, ent in self._entries.items():
            if ent.pinned or self.alloc.block_refs(d) > 0:
                continue
            kids = self._children.get(d)
            if kids and any(k in self._entries for k in kids):
                continue                 # leaf-first: keep chains walkable
            out.append(ent)
        return out

    def evict_one(self) -> bool:
        cands = self._evictable()
        if not cands:
            return False
        if self.evict_policy == "lfu":
            victim = min(cands, key=lambda e: (e.uses, e.last_used))
        else:                            # lru
            victim = min(cands, key=lambda e: (e.last_used, e.uses))
        d = victim.block.digest
        if not self.alloc.drop_block(d):
            return False
        del self._entries[d]
        if victim.parent is not None:
            kids = self._children.get(victim.parent)
            if kids:
                kids.discard(d)
        self._children.pop(d, None)
        if self.directory is not None:
            self.directory.note_evict(d, self.instance)
        self.evictions += 1
        self._publish()
        return True

    def make_room(self, tokens: int) -> bool:
        """Evict idle blocks until ``tokens`` fit; False if impossible."""
        while not self.alloc.can_allocate(tokens):
            if not self.evict_one():
                return False
        return True

    def enforce_reserve(self) -> None:
        cap = int(self.reserve_frac * self.alloc.num_pages)
        while self.alloc.idle_pages > cap:
            if not self.evict_one():
                break

    def clear(self) -> None:
        while self.evict_one():
            pass

    # -- pinning (intent `pin`/`unpin` actions) -----------------------------
    def pin(self, label: str) -> int:
        """Pin every block covered by segment ``label`` (and blocks that
        arrive later carrying it): exempt from eviction."""
        self._pinned_labels.add(label)
        n = 0
        for ent in self._entries.values():
            if label in ent.block.labels and not ent.pinned:
                ent.pinned = True
                n += 1
        return n

    def unpin(self, label: str) -> int:
        self._pinned_labels.discard(label)
        n = 0
        for ent in self._entries.values():
            if label in ent.block.labels and ent.pinned:
                ent.pinned = any(l in self._pinned_labels
                                 for l in ent.block.labels)
                n += not ent.pinned
        return n

    # -- metrics -------------------------------------------------------------
    @property
    def hit_rate(self) -> float:
        seen = self.hit_tokens + self.miss_tokens
        return self.hit_tokens / seen if seen else 0.0

    @property
    def saved_prefill_tokens(self) -> int:
        return self.hit_tokens

    @property
    def blocks_resident(self) -> int:
        return len(self._entries)

    def _publish(self) -> None:
        if self.collector is None:
            return
        t = self._clock()
        self.collector.gauge(f"{self.name}.hit_rate", self.hit_rate, t)
        self.collector.gauge(f"{self.name}.saved_prefill_tokens",
                             self.saved_prefill_tokens, t)
        self.collector.gauge(f"{self.name}.shared_pages",
                             self.alloc.shared_pages, t)


class CacheDirectory:
    """Controller-visible residency map: prefix digest → instances where
    the block is resident (the ``SessionDirectory`` of the cache plane).

    The ``cache_aware`` router policy scores placements through it.
    (The intent actions ``pin PREFIX`` / ``unpin PREFIX`` reach the
    instance caches directly via the registry's ``pin`` capability —
    see ``ControlContext.pin`` in core/controller.py.)"""

    def __init__(self):
        self.caches: dict[str, PrefixCache] = {}
        self._where: dict[str, set[str]] = {}

    # -- membership ----------------------------------------------------------
    def attach(self, cache: PrefixCache) -> None:
        self.caches[cache.instance] = cache
        cache.directory = self

    def detach(self, instance: str) -> None:
        self.caches.pop(instance, None)
        for insts in self._where.values():
            insts.discard(instance)

    # -- residency bookkeeping (called by instance caches) ------------------
    def note_insert(self, digest: str, instance: str) -> None:
        self._where.setdefault(digest, set()).add(instance)

    def note_evict(self, digest: str, instance: str) -> None:
        insts = self._where.get(digest)
        if insts is not None:
            insts.discard(instance)
            if not insts:
                del self._where[digest]

    def where(self, digest: str) -> set[str]:
        return set(self._where.get(digest, ()))

    def resident_blocks(self, instance: str) -> int:
        cache = self.caches.get(instance)
        return cache.blocks_resident if cache is not None else 0

    # -- routing / control queries -------------------------------------------
    def estimate_hit(self, source: Optional[PrefixSource],
                     instance: str) -> int:
        """Prefix tokens of ``source`` already resident at ``instance`` —
        the cache-aware router's placement score."""
        cache = self.caches.get(instance)
        if cache is None:
            return 0
        return cache.probe(source)
