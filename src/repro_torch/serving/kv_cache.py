"""Page-granular KV accounting (vLLM-style allocator, TPU-adapted).

On TPU the physical decode state lives in slot-contiguous ring buffers
inside the jitted step (fixed shapes, no per-page gathers on the hot
path — see DESIGN.md §3); this allocator provides the *scheduling*
semantics of paging: admission control, growth-on-decode, preemption
pressure, and per-sequence accounting that the controller's policies and
the KV-transfer cost model read.

Two page classes:

* **private** pages — owned by exactly one sequence (`allocate`/`grow_to`
  /`free`), the original accounting.
* **shared** blocks — refcounted groups of pages holding a cached token
  prefix (serving/prefix_cache.py).  A sequence *acquires* a resident
  block instead of re-allocating it; freeing the sequence only drops the
  block's refcount, and the pages themselves stay resident (refcount 0
  ⇒ *idle*, i.e. evictable by the prefix cache's policy) until
  ``drop_block`` reclaims them.

* **host** pages — a spill tier for tool-call suspend/resume
  (serving/scheduler.py): ``suspend`` moves a live sequence's private
  pages HBM→host and releases its shared blocks (decref only, so
  sharers keep the prefix hot), ``restore`` reclaims fresh HBM pages
  and re-acquires the remembered blocks, and ``drop_suspended`` is the
  bottom rung of the eviction ladder HBM → host → drop-and-recompute.
  Host pages get physical ids in their own range ``[num_pages,
  num_pages + host_capacity_pages)`` so the two tiers never alias.

Invariant (the hypothesis property tests pin this down):

    free_pages + private_pages + shared_pages == num_pages
    host_free + host_used                     == host_capacity_pages

Beyond the page *counts*, the allocator assigns every page a concrete
**physical id** in ``[0, num_pages)``: each sequence holds an ordered
list of private ids, each shared block an ordered id group, and
``page_table(seq_id)`` lays them out in logical order (acquired shared
blocks first — the prefix — then private pages).  That list is exactly
the block-table row ``kernels/paged_decode_attention.py`` gathers
through, so the scheduling-plane layout and the kernel's memory-access
pattern are one structure: shared prefixes appear as the *same*
physical ids in every sharer's table.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SharedBlock:
    """One refcounted shared page group (a cached prefix block)."""

    block_id: str
    pages: int
    refs: int = 0


@dataclass
class PageAllocator:
    num_pages: int
    page_size: int = 128
    host_capacity_pages: int = 0
    _used: dict[str, int] = field(default_factory=dict)   # seq -> pages
    _blocks: dict[str, SharedBlock] = field(default_factory=dict)
    _seq_blocks: dict[str, list[str]] = field(default_factory=dict)
    # physical page ids (same partition as the counts above)
    _free_ids: list[int] = field(default_factory=list)
    _seq_ids: dict[str, list[int]] = field(default_factory=dict)
    _block_ids: dict[str, list[int]] = field(default_factory=dict)
    # host spill tier: ids live in [num_pages, num_pages + capacity)
    _host_free_ids: list[int] = field(default_factory=list)
    _host_ids: dict[str, list[int]] = field(default_factory=dict)
    _host_blocks: dict[str, list[str]] = field(default_factory=dict)

    def __post_init__(self):
        if not self._free_ids and not self._seq_ids and not self._block_ids:
            self._free_ids = list(range(self.num_pages))
        if not self._host_free_ids and not self._host_ids:
            self._host_free_ids = list(
                range(self.num_pages,
                      self.num_pages + self.host_capacity_pages))
        self._host_next = self.num_pages + self.host_capacity_pages

    # -- queries --------------------------------------------------------------
    @property
    def private_pages(self) -> int:
        return sum(self._used.values())

    @property
    def shared_pages(self) -> int:
        return sum(b.pages for b in self._blocks.values())

    @property
    def free_pages(self) -> int:
        return self.num_pages - self.private_pages - self.shared_pages

    @property
    def idle_pages(self) -> int:
        """Shared pages held only by the cache (refcount 0): reclaimable."""
        return sum(b.pages for b in self._blocks.values() if b.refs == 0)

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size) if tokens > 0 else 0

    def holds(self, seq_id: str) -> int:
        return self._used.get(seq_id, 0)

    def can_allocate(self, tokens: int) -> bool:
        return self.pages_for(tokens) <= self.free_pages

    @property
    def utilization(self) -> float:
        return 1.0 - self.free_pages / max(self.num_pages, 1)

    @property
    def host_pages(self) -> int:
        return sum(len(ids) for ids in self._host_ids.values())

    @property
    def host_free_pages(self) -> int:
        return len(self._host_free_ids)

    def is_suspended(self, seq_id: str) -> bool:
        return seq_id in self._host_ids

    def host_room_for(self, seq_id: str) -> bool:
        """Would ``suspend(seq_id)`` land on the host tier (vs drop)?"""
        return self._used.get(seq_id, 0) <= len(self._host_free_ids)

    # -- private-page mutation -------------------------------------------------
    def allocate(self, seq_id: str, tokens: int) -> bool:
        if seq_id in self._host_ids:          # suspended sequences can't grow
            return False
        need = self.pages_for(tokens)
        have = self._used.get(seq_id, 0)
        grow = max(0, need - have)
        if grow > self.free_pages:
            return False
        self._used[seq_id] = max(need, have)
        if grow:
            ids = self._seq_ids.setdefault(seq_id, [])
            ids.extend(self._free_ids[:grow])
            del self._free_ids[:grow]
        return True

    def grow_to(self, seq_id: str, total_tokens: int) -> bool:
        """Ensure capacity for total_tokens; False => caller must preempt."""
        return self.allocate(seq_id, total_tokens)

    def free(self, seq_id: str) -> int:
        """Release a sequence: private pages are returned to the pool;
        shared blocks are only decref'd — their pages stay resident until
        the prefix cache evicts them (``drop_block``)."""
        for bid in self._seq_blocks.pop(seq_id, ()):
            blk = self._blocks.get(bid)
            if blk is not None and blk.refs > 0:
                blk.refs -= 1
        self._free_ids.extend(self._seq_ids.pop(seq_id, ()))
        return self._used.pop(seq_id, 0)

    # -- host spill tier (tool-call suspend/resume) ----------------------------
    def suspend(self, seq_id: str) -> str:
        """Spill a live sequence for an external wait.  Private pages move
        HBM→host (fresh ids from the host range); acquired shared blocks
        are decref'd — sharers keep them hot — but remembered so
        ``restore`` can re-acquire the exact prefix chain.  Returns
        ``"host"`` on a successful spill or ``"drop"`` when the host tier
        has no room (the sequence's state is simply released and resume
        must recompute)."""
        if seq_id in self._host_ids:
            return "host"
        blocks = self._seq_blocks.pop(seq_id, [])
        for bid in blocks:
            blk = self._blocks.get(bid)
            if blk is not None and blk.refs > 0:
                blk.refs -= 1
        ids = self._seq_ids.pop(seq_id, [])
        self._used.pop(seq_id, None)
        self._free_ids.extend(ids)
        n = len(ids)
        if n > len(self._host_free_ids):
            return "drop"
        self._host_ids[seq_id] = self._host_free_ids[:n]
        del self._host_free_ids[:n]
        self._host_blocks[seq_id] = blocks
        return "host"

    def host_holds(self, seq_id: str) -> int:
        return len(self._host_ids.get(seq_id, ()))

    def restore_ready(self, seq_id: str) -> str:
        """Why (or whether) a warm restore can proceed right now:
        ``ok`` | ``no_pages`` (HBM full — transient) | ``no_blocks``
        (prefix chain partially evicted — recompute) | ``gone`` (no host
        copy — recompute)."""
        ids = self._host_ids.get(seq_id)
        if ids is None:
            return "gone"
        if any(b not in self._blocks
               for b in self._host_blocks.get(seq_id, ())):
            return "no_blocks"
        return "ok" if len(ids) <= len(self._free_ids) else "no_pages"

    def can_restore(self, seq_id: str) -> bool:
        """True iff a host-suspended sequence can come back warm: the host
        copy exists, every remembered prefix block is still resident, and
        the HBM pool has room for its private pages."""
        return self.restore_ready(seq_id) == "ok"

    def restore(self, seq_id: str) -> bool:
        """Reclaim HBM pages for a host-suspended sequence and re-acquire
        its prefix blocks (all-or-nothing: a partially evicted chain means
        recompute, not a broken prefix)."""
        if not self.can_restore(seq_id):
            return False
        host = self._host_ids.pop(seq_id)   # un-suspend first: acquire()
        for bid in self._host_blocks.pop(seq_id, ()):   # refuses parked seqs
            self.acquire(seq_id, bid)
        n = len(host)
        if n:
            self._used[seq_id] = n
            self._seq_ids[seq_id] = self._free_ids[:n]
            del self._free_ids[:n]
        self._host_free_ids.extend(host)
        return True

    def drop_suspended(self, seq_id: str) -> int:
        """Bottom of the eviction ladder: discard the host copy (resume
        will drop-and-recompute).  Returns the host pages reclaimed."""
        self._host_blocks.pop(seq_id, None)
        ids = self._host_ids.pop(seq_id, ())
        self._host_free_ids.extend(ids)
        return len(ids)

    def set_host_capacity(self, pages: int) -> int:
        """Grow/shrink the host tier; shrink is clamped above the pages
        currently holding spilled sequences.  Returns the capacity that
        actually took effect."""
        pages = max(0, int(pages))
        cur = self.host_capacity_pages
        if pages > cur:
            grow = pages - cur
            self._host_free_ids.extend(
                range(self._host_next, self._host_next + grow))
            self._host_next += grow
        elif pages < cur:
            drop = min(cur - pages, len(self._host_free_ids))
            if drop:
                del self._host_free_ids[-drop:]
            pages = cur - drop
        self.host_capacity_pages = pages
        return pages

    # -- shared-block mutation -------------------------------------------------
    def share(self, block_id: str, pages: int) -> bool:
        """Make a block resident with refcount 0 (cache-owned).  No-op if
        already resident; False if the pool has no room."""
        if block_id in self._blocks:
            return True
        if pages > self.free_pages:
            return False
        self._blocks[block_id] = SharedBlock(block_id, pages)
        self._block_ids[block_id] = self._free_ids[:pages]
        del self._free_ids[:pages]
        return True

    def block_resident(self, block_id: str) -> bool:
        return block_id in self._blocks

    def block_refs(self, block_id: str) -> int:
        blk = self._blocks.get(block_id)
        return blk.refs if blk is not None else 0

    def acquire(self, seq_id: str, block_id: str) -> bool:
        """Reference a resident block from a sequence (idempotent per
        seq/block pair)."""
        blk = self._blocks.get(block_id)
        if blk is None or seq_id in self._host_ids:
            return False                  # suspended: no HBM references
        held = self._seq_blocks.setdefault(seq_id, [])
        if block_id in held:
            return True
        held.append(block_id)
        blk.refs += 1
        return True

    def promote(self, seq_id: str, block_id: str, pages: int) -> bool:
        """Convert ``pages`` of a sequence's *private* pages into a new
        shared block referenced by that sequence — how freshly-prefilled
        prefix blocks enter the cache without double-counting."""
        if block_id in self._blocks:
            return self.acquire(seq_id, block_id)
        if seq_id in self._host_ids:
            return False                  # suspended: no HBM references
        have = self._used.get(seq_id, 0)
        if pages > have:
            return False
        self._used[seq_id] = have - pages
        # the promoted pages are the *front* of the private region: a
        # sequence's private pages cover its tokens in order and commit
        # promotes prefix blocks front-to-back, so the physical ids move
        # with the tokens they hold
        ids = self._seq_ids.get(seq_id, [])
        self._block_ids[block_id] = ids[:pages]
        del ids[:pages]
        self._blocks[block_id] = SharedBlock(block_id, pages, refs=0)
        return self.acquire(seq_id, block_id)

    def drop_block(self, block_id: str) -> bool:
        """Evict an idle (refcount-0) block; its pages return to the pool."""
        blk = self._blocks.get(block_id)
        if blk is None or blk.refs > 0:
            return False
        del self._blocks[block_id]
        self._free_ids.extend(self._block_ids.pop(block_id, ()))
        return True

    # -- kernel block tables ---------------------------------------------------
    def block_pages(self, block_id: str) -> list[int]:
        """Physical page ids of a resident shared block, in token order."""
        return list(self._block_ids.get(block_id, ()))

    def page_table(self, seq_id: str) -> list[int]:
        """Physical page ids of ``seq_id`` in logical (token) order:
        acquired shared blocks first — the cached prefix, in acquisition
        order, which is chain order — then private pages.  This row is
        what the paged decode-attention kernel's block table gathers
        through; sequences sharing a prefix block repeat the same
        physical ids."""
        ids: list[int] = []
        for bid in self._seq_blocks.get(seq_id, ()):
            ids.extend(self._block_ids.get(bid, ()))
        ids.extend(self._seq_ids.get(seq_id, ()))
        return ids

    def reset(self) -> None:
        self._used.clear()
        self._blocks.clear()
        self._seq_blocks.clear()
        self._free_ids = list(range(self.num_pages))
        self._seq_ids.clear()
        self._block_ids.clear()
        self._host_ids.clear()
        self._host_blocks.clear()
        self._host_free_ids = list(
            range(self.num_pages, self.num_pages + self.host_capacity_pages))
        self._host_next = self.num_pages + self.host_capacity_pages


def block_tables(alloc: PageAllocator, seq_ids,
                 pad_to: int = 0, width: int | None = None) -> list[list[int]]:
    """Batched kernel block tables: one row per sequence, physical page
    ids in logical order, right-padded with -1 to a rectangle (at least
    ``pad_to`` columns).  Feed directly to
    ``kernels.ops.paged_decode_attention``.

    ``width`` pins the exact column count (the engine's jitted step
    traces a fixed (slots, P_max) table so page churn never recompiles);
    a row longer than ``width`` means the allocator granted a sequence
    more context than the engine compiled for — a real invariant
    violation, so it raises."""
    rows = [alloc.page_table(s) for s in seq_ids]
    if width is not None:
        for s, r in zip(seq_ids, rows):
            if len(r) > width:
                raise ValueError(
                    f"page table for {s!r} has {len(r)} pages > fixed "
                    f"width {width}")
    else:
        width = max([len(r) for r in rows] + [pad_to, 1])
    return [r + [-1] * (width - len(r)) for r in rows]
