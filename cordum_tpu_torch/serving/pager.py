"""Block-granular KV-page allocator (the bookkeeping half of the paged cache).

The arena itself (the ``[L, num_pages, page_size, kvh, hd]`` K/V arrays)
lives in the serving backend; this allocator owns which *page indices*
belong to which session.  Design points:

  * **page 0 is the null page** — never handed out.  Padding rows of the
    ragged decode batch and padded page-table tails point at it, so their
    writes land in slots no live sequence attends to.
  * **exhaustion is an admission signal, not an error path** — the serving
    engine calls :meth:`alloc` at admission time for the session's full
    worst-case footprint (prompt + max_new_tokens), so a session admitted
    once can never die mid-decode from cache pressure;
    :class:`CacheExhausted` parks the session in the admission queue.
  * **isolation by masking, not zeroing** — freed pages return to the free
    list dirty.  A later owner only ever attends to positions it wrote
    (the decode mask cuts every k_pos > position), so stale data is
    unreachable; ``tests/test_serving.py`` proves reuse never leaks across
    sessions.
  * **refcounted sharing** (docs/SERVING.md §Prefix cache and tiering):
    a physical page may back more than one page table at once — prefix
    hits map cached pages into new sessions, and the prefix cache itself
    holds a reference while a prefix is resident.  Every page on loan
    carries an explicit refcount; a page returns to the free list only
    when the count hits zero.  :meth:`retain` / :meth:`release` raise on
    unreferenced pages, so a double free or a share of a freed page fails
    loudly instead of silently aliasing the free list (reachability
    arguments alone cannot survive aliasing).
    ``tests/test_prefix_tiering.py`` property-tests the invariant: no page
    is ever both free and referenced, and no refcount ever goes negative.
  * single-owner, event-loop-confined: no internal locking (the serving
    engine is the only caller and runs on the worker's loop).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


class CacheExhausted(Exception):
    """Not enough free KV pages for the requested allocation."""


class PageAccountingError(RuntimeError):
    """Refcount invariant violated: double free, share of an unreferenced
    page, or a release that would drive a refcount negative.  Always a
    caller bug — the allocator raises instead of corrupting the free list."""


@dataclass
class PagerStats:
    allocs: int = 0
    frees: int = 0
    exhaustions: int = 0
    peak_pages_in_use: int = 0
    shares: int = 0  # retain() calls: pages mapped into a second+ table


class PageAllocator:
    """Free-list allocator over ``num_pages`` arena pages of ``page_size``
    token slots each.  Page 0 is reserved (null page)."""

    NULL_PAGE = 0

    def __init__(self, num_pages: int, page_size: int) -> None:
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is the null page)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: deque[int] = deque(range(1, num_pages))
        self._owned: dict[str, list[int]] = {}
        # page -> live reference count; absence means the page is on the
        # free list (or is the null page).  Counts only reach zero through
        # release(), which moves the page back to the free list atomically
        # with deleting its entry — so "in _refs" and "on _free" partition
        # the arena at every step.
        self._refs: dict[int, int] = {}
        self.stats = PagerStats()

    # ------------------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Usable pages (the null page is not allocatable)."""
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.capacity - len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` sequence positions."""
        return max(1, -(-n_tokens // self.page_size))

    def owner_pages(self, owner: str) -> list[int]:
        return list(self._owned.get(owner, ()))

    def fits(self, n_pages: int) -> bool:
        return n_pages <= len(self._free)

    def refcount(self, page: int) -> int:
        """Live references on ``page`` (0 = free / null)."""
        return self._refs.get(page, 0)

    def referenced_pages(self) -> set[int]:
        """Every page with a live reference (any table or the prefix
        cache) — the complement of the free list over the usable arena."""
        return set(self._refs)

    # ------------------------------------------------------------------
    def alloc(
        self, owner: str, n_pages: int, *, shared: list[int] | None = None
    ) -> list[int]:
        """Allocate ``n_pages`` fresh pages to ``owner`` (cumulative per
        owner), optionally mapping ``shared`` already-referenced pages in
        front of them (a prefix hit: the owner's table starts with the
        cached prefix pages, then its own fresh tail).

        Raises :class:`CacheExhausted` without allocating anything — and
        without touching ``shared`` refcounts — when the free list cannot
        cover the request (all-or-nothing, so a failed admission never
        strands partial pages or dangling references)."""
        shared = list(shared or ())
        if n_pages < 0 or (n_pages == 0 and not shared):
            raise ValueError("n_pages must be >= 1 (or shared pages given)")
        if n_pages > len(self._free):
            self.stats.exhaustions += 1
            raise CacheExhausted(
                f"{n_pages} pages requested, {len(self._free)} free "
                f"(capacity {self.capacity})"
            )
        if shared:
            self.retain(shared)  # raises before any free-list mutation
        pages = [self._free.popleft() for _ in range(n_pages)]
        for p in pages:
            self._refs[p] = 1
        self._owned.setdefault(owner, []).extend(shared + pages)
        self.stats.allocs += 1
        self.stats.peak_pages_in_use = max(
            self.stats.peak_pages_in_use, self.used_pages
        )
        return shared + pages

    def alloc_raw(self, n_pages: int) -> list[int]:
        """Allocate pages carrying a bare reference and no owner record —
        the prefix cache and the CoW path settle these via
        :meth:`retain` / :meth:`release` directly instead of :meth:`free`.
        All-or-nothing like :meth:`alloc`."""
        if n_pages < 1:
            raise ValueError("n_pages must be >= 1")
        if n_pages > len(self._free):
            self.stats.exhaustions += 1
            raise CacheExhausted(
                f"{n_pages} pages requested, {len(self._free)} free "
                f"(capacity {self.capacity})"
            )
        pages = [self._free.popleft() for _ in range(n_pages)]
        for p in pages:
            self._refs[p] = 1
        self.stats.allocs += 1
        self.stats.peak_pages_in_use = max(
            self.stats.peak_pages_in_use, self.used_pages
        )
        return pages

    def retain(self, pages: list[int]) -> None:
        """Add one reference to each page (mapping it into another table).
        Raises :class:`PageAccountingError` on any unreferenced page —
        sharing a freed page would alias the free list."""
        for p in pages:
            if p not in self._refs:
                raise PageAccountingError(
                    f"retain of unreferenced page {p} (free or null)"
                )
        for p in pages:
            self._refs[p] += 1
        if pages:
            self.stats.shares += 1

    def release(self, pages: list[int]) -> int:
        """Drop one reference from each page; pages reaching zero return
        to the free list.  Returns how many pages were actually freed.
        Raises :class:`PageAccountingError` on an unreferenced page (the
        double-free / negative-refcount guard)."""
        freed = 0
        for p in pages:
            rc = self._refs.get(p, 0)
            if rc <= 0:
                raise PageAccountingError(
                    f"release of unreferenced page {p} (double free)"
                )
            if rc == 1:
                del self._refs[p]
                self._free.append(p)
                freed += 1
            else:
                self._refs[p] = rc - 1
        return freed

    def swap_owned(self, owner: str, old: int, new: int) -> None:
        """Replace ``old`` with ``new`` in the owner's page list (the CoW
        page-table swap).  Reference counts are the caller's to settle —
        this only fixes which pages :meth:`free` will release."""
        pages = self._owned.get(owner)
        if pages is None or old not in pages:
            raise PageAccountingError(
                f"swap_owned: owner {owner!r} does not hold page {old}"
            )
        pages[pages.index(old)] = new

    def free(self, owner: str) -> int:
        """Drop the owner's reference on every page it holds (shared pages
        survive under their remaining references); returns the count of
        pages actually freed (0 for an unknown owner — freeing twice is a
        no-op, not an error, because cancel and retirement can race
        benignly)."""
        pages = self._owned.pop(owner, None)
        if not pages:
            return 0
        freed = self.release(pages)
        self.stats.frees += 1
        return freed

    # ------------------------------------------------------------------
    def check_consistency(
        self, live_tables: dict[str, list[int]] | None = None
    ) -> None:
        """Assert the accounting invariants (test/debug hook; the property
        suite calls this after every random interleaving step):

          * free list and refcount table partition the usable arena —
            no page is both free and referenced, none is lost;
          * every refcount is positive;
          * the null page is never free, owned, or referenced;
          * every page in every live table (``live_tables`` — e.g. the
            engine's session page tables) carries a reference.
        """
        free = list(self._free)
        free_set = set(free)
        if len(free) != len(free_set):
            raise PageAccountingError("free list holds duplicate pages")
        overlap = free_set & set(self._refs)
        if overlap:
            raise PageAccountingError(
                f"pages both free and referenced: {sorted(overlap)[:8]}"
            )
        for p, rc in self._refs.items():
            if rc <= 0:
                raise PageAccountingError(f"non-positive refcount {rc} on page {p}")
        usable = set(range(1, self.num_pages))
        if free_set | set(self._refs) != usable:
            lost = usable - free_set - set(self._refs)
            raise PageAccountingError(f"pages lost from accounting: {sorted(lost)[:8]}")
        if self.NULL_PAGE in free_set or self.NULL_PAGE in self._refs:
            raise PageAccountingError("null page entered circulation")
        for owner, pages in (live_tables or {}).items():
            for p in pages:
                if p != self.NULL_PAGE and self._refs.get(p, 0) < 1:
                    raise PageAccountingError(
                        f"table {owner!r} maps unreferenced page {p}"
                    )
