"""Radix prefix cache: copy-on-write shared-prefix KV pages.

Every chat turn re-sends the whole conversation, and a thousand sessions
share the same system prompt — yet each one pays full prefill.  Because
``models/llama.ragged_step`` gathers only its own page-table row, two
sessions can point at the SAME physical page for free (the Ragged Paged
Attention argument, PAPERS.md); this module is the control-plane index
that makes that safe:

  * **radix keying** — a trie keyed by page-sized chunks of token ids.
    Each node maps one full page of tokens to one physical arena page;
    the PATH to a node is part of the key, because a page's K/V depends
    on every position before it (attention).  Only FULL pages are ever
    cached — a partial page's slots would be written by the next turn's
    divergent suffix, and full-page-only keying makes shared pages
    structurally read-only (the engine's CoW guard covers the one edge
    case where a hit ends exactly on a page boundary).
  * **refcounts, not reachability** — the cache holds one allocator
    reference per warm node (``PageAllocator.retain``); sessions mapping
    the page hold their own.  A page returns to the free list only at
    refcount zero, so eviction and retirement can interleave freely.
  * **LRU eviction under exhaustion** — the admission path calls
    :meth:`evict` when the free list cannot cover a footprint; eviction
    drops least-recently-used leaves whose page only the cache still
    references (dropping a page a live session shares would free
    nothing).  Cold leaves are dropped only when they block a warm
    ancestor — host-RAM records are cheap to keep.
  * **two tiers per node** — a node is *warm* (``page`` set, device
    resident) or *cold* (``record`` set: the migration-format page
    record in host RAM, docs/PROTOCOL.md §Cold arena).  The tiering
    sweep (serving/tiering.py) demotes idle warm nodes; the engine's
    admission path re-warms cold nodes it hits (alloc + scatter).

The engine (serving/engine.py) drives everything from the worker's event
loop; like the allocator, this class does no internal locking.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from .pager import PageAllocator


@dataclass
class PrefixNode:
    """One cached full page of tokens, keyed by its path from the root."""

    chunk: tuple[int, ...]
    parent: Optional["PrefixNode"] = None
    depth: int = 0  # page ordinal: root=0, first chunk node=1, ...
    page: int = 0  # physical arena page when warm (0 = not warm)
    record: Optional[dict] = None  # migration page record when cold
    children: dict = field(default_factory=dict)
    last_used: float = 0.0
    dropped: bool = False  # evicted while someone awaited on it

    @property
    def warm(self) -> bool:
        return self.page != 0

    @property
    def cold(self) -> bool:
        return self.record is not None and self.page == 0


@dataclass
class PrefixStats:
    hits: int = 0  # lookups matching >= 1 full page
    misses: int = 0
    hit_tokens: int = 0  # prompt tokens whose prefill was skipped
    registered_pages: int = 0
    evicted_pages: int = 0  # warm pages LRU-evicted back to the free list
    dropped_cold: int = 0  # cold records discarded
    hibernated_pages: int = 0  # warm -> cold demotions
    restored_pages: int = 0  # cold -> warm promotions


class PrefixCache:
    """Trie over token-id prefixes → refcounted physical pages."""

    def __init__(
        self,
        allocator: PageAllocator,
        *,
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.allocator = allocator
        self.page_size = allocator.page_size
        self.metrics = metrics
        self.clock = clock
        self._root = PrefixNode(chunk=())
        self._by_page: dict[int, PrefixNode] = {}  # warm nodes by page
        self.stats = PrefixStats()

    # ------------------------------------------------------------------
    @property
    def warm_pages(self) -> int:
        return len(self._by_page)

    @property
    def cold_pages(self) -> int:
        return sum(1 for n in self._walk() if n.cold)

    def _walk(self):
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    def _gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.serving_prefix_pages.set(float(len(self._by_page)))

    # ------------------------------------------------------------------
    def match(self, tokens: list[int], *, touch: bool = True) -> list[PrefixNode]:
        """The longest cached path of full-page chunks prefixing
        ``tokens`` — warm AND cold nodes (the caller re-warms cold ones,
        truncating the match where a restore cannot proceed).  Touches
        every matched node (MRU), so an in-progress admission's path is
        never the eviction victim; observers (tier accounting) pass
        ``touch=False`` so reading residency never resets idleness."""
        now = self.clock()
        ps = self.page_size
        out: list[PrefixNode] = []
        node = self._root
        for i in range(len(tokens) // ps):
            child = node.children.get(tuple(tokens[i * ps:(i + 1) * ps]))
            if child is None:
                break
            if touch:
                child.last_used = now
            out.append(child)
            node = child
        return out

    def register(self, tokens: list[int], pages: list[int]) -> int:
        """Retain a retiring session's full pages under their token path.
        ``tokens`` are the positions actually written (prompt + generated
        output minus the never-fed final sample); ``pages`` the session's
        page table.  Existing warm nodes are kept (their page holds the
        identical K/V — same tokens, same deterministic forward pass);
        existing cold nodes re-warm from the live page for free.  Returns
        how many pages were newly retained."""
        now = self.clock()
        ps = self.page_size
        node = self._root
        fresh = 0
        for i in range(min(len(tokens) // ps, len(pages))):
            key = tuple(tokens[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is None:
                self.allocator.retain([pages[i]])
                child = PrefixNode(
                    chunk=key, parent=node, depth=i + 1,
                    page=pages[i], last_used=now,
                )
                node.children[key] = child
                self._by_page[pages[i]] = child
                fresh += 1
            else:
                child.last_used = now
                if child.cold:
                    # the retiring session carries this page live: adopt
                    # it instead of paying a restore scatter later
                    self.allocator.retain([pages[i]])
                    child.page = pages[i]
                    child.record = None
                    self._by_page[pages[i]] = child
                    self.stats.restored_pages += 1
                    fresh += 1
            node = child
        self.stats.registered_pages += fresh
        self._gauge()
        return fresh

    # ------------------------------------------------------------------
    def _leaves(self) -> list[PrefixNode]:
        return [n for n in self._walk() if not n.children]

    def _drop_leaf(self, node: PrefixNode) -> int:
        """Remove a childless node; returns device pages freed (0/1)."""
        freed = 0
        if node.warm:
            self._by_page.pop(node.page, None)
            freed = self.allocator.release([node.page])
            node.page = 0
            self.stats.evicted_pages += 1
            if self.metrics is not None:
                self.metrics.serving_prefix_evictions.inc(reason="capacity")
        elif node.cold:
            node.record = None
            self.stats.dropped_cold += 1
            if self.metrics is not None:
                self.metrics.serving_hibernate.inc(event="dropped")
        node.dropped = True
        if node.parent is not None:
            node.parent.children.pop(node.chunk, None)
        return freed

    def evict(self, n_pages: int, *, reason: str = "capacity") -> int:
        """LRU-evict cached prefixes until ``n_pages`` device pages are
        back on the free list (the exhaustion/admission-queue hook).
        Only pages the cache alone references are eligible — releasing a
        page a live session still maps frees nothing.  Cold leaves are
        dropped only when no warm leaf is evictable (they may be blocking
        a warm ancestor).  Returns pages actually freed."""
        freed = 0
        while freed < n_pages:
            warm = [
                n for n in self._leaves()
                if n.warm and self.allocator.refcount(n.page) == 1
            ]
            if warm:
                freed += self._drop_leaf(min(warm, key=lambda n: n.last_used))
                continue
            cold = [n for n in self._leaves() if not n.warm]
            if not cold:
                break  # every remaining leaf is shared by a live session
            self._drop_leaf(min(cold, key=lambda n: n.last_used))
        self._gauge()
        return freed

    def drop_subtree(self, page: int) -> int:
        """Drop the node holding ``page`` and everything under it (the
        CoW-under-exhaustion escape hatch: releasing the cache's
        reference may make the writer the sole owner, so no copy — and no
        fresh page — is needed).  Returns device pages freed."""
        node = self._by_page.get(page)
        if node is None:
            return 0
        freed = 0
        stack = [node]
        post: list[PrefixNode] = []
        while stack:
            n = stack.pop()
            post.append(n)
            stack.extend(n.children.values())
        for n in reversed(post):
            n.children.clear()
            freed += self._drop_leaf(n)
        self._gauge()
        return freed

    # ------------------------------------------------------------------
    # tiering hooks (serving/tiering.py drives these)
    def hibernate_candidates(self, cutoff: float) -> list[PrefixNode]:
        """Warm nodes idle since before ``cutoff`` that only the cache
        references — safe to demote without touching any live table."""
        return sorted(
            (
                n for n in self._walk()
                if n.warm and n.last_used < cutoff
                and self.allocator.refcount(n.page) == 1
            ),
            key=lambda n: n.last_used,
        )

    def demote(self, node: PrefixNode, record: dict) -> bool:
        """Finish hibernating ``node``: swap its device page for the
        exported ``record`` and release the page.  Returns False (no
        release) when the node was evicted or gained a live sharer while
        the export was in flight — the caller simply keeps it warm."""
        if node.dropped or not node.warm:
            return False
        if self.allocator.refcount(node.page) > 1:
            return False
        self._by_page.pop(node.page, None)
        self.allocator.release([node.page])
        node.record = record
        node.page = 0
        self.stats.hibernated_pages += 1
        if self.metrics is not None:
            self.metrics.serving_hibernate.inc(event="hibernated")
        self._gauge()
        return True

    def promote(self, node: PrefixNode, page: int) -> None:
        """Finish restoring ``node``: the caller scattered its record
        into freshly allocated ``page`` (carrying a bare reference)."""
        node.page = page
        node.record = None
        node.last_used = self.clock()
        self._by_page[page] = node
        self.stats.restored_pages += 1
        if self.metrics is not None:
            self.metrics.serving_hibernate.inc(event="restored")
        self._gauge()
