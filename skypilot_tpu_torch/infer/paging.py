"""Host-side page allocator for the paged KV cache.

The port's own copy of skypilot_tpu/infer/paging.py's `PageAllocator`
and `chain_hashes` (without the fault-injection and host-RAM spill
hooks, which this slice does not port).  The device holds a pool of
`n_pages` pages; page 0 is the reserved null page that dead table rows
point at.  This allocator keeps the free stack, per-page refcounts, and
a chain-hash map of registered prompt-prefix pages whose contents stay
matchable (in an LRU of reclaimable pages) until their memory is
needed.

Pure host-side Python, thread-unsafe by design: the engine calls it
only from its single scheduler thread.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence

NULL_PAGE = 0


def chain_hashes(tokens: Sequence[int], page_size: int) -> List[int]:
    """Chain hash of each full page-aligned chunk of ``tokens``:
    ``hashes[i]`` commits to tokens[:(i+1)*page_size].  Stable across
    processes for integer token ids (int and tuple-of-int hashing does
    not depend on PYTHONHASHSEED)."""
    hashes: List[int] = []
    h = 0
    for i in range(len(tokens) // page_size):
        h = hash((h, tuple(tokens[i * page_size:(i + 1) * page_size])))
        hashes.append(h)
    return hashes


class PageAllocator:
    """Free list + refcounts + prefix-chain map over a fixed page pool."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError(
                f'n_pages must be >= 2 (page {NULL_PAGE} is reserved), '
                f'got {n_pages}')
        if page_size < 1:
            raise ValueError(f'page_size must be >= 1, got {page_size}')
        self.n_pages = n_pages
        self.page_size = page_size
        # LIFO so allocation is deterministic, low pages first.
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self._prefix_page: Dict[int, int] = {}    # chain hash -> page
        self._page_hash: Dict[int, int] = {}      # page -> chain hash
        # ref==0 registered pages; insertion order == LRU order.
        self._reclaimable: 'collections.OrderedDict[int, int]' = \
            collections.OrderedDict()
        self.cannibalized_total = 0
        # High-water mark of live_pages (pages with a reference).
        self.peak_live_pages = 0

    @property
    def capacity(self) -> int:
        """Every page a request could ever hold (the null page is not)."""
        return self.n_pages - 1

    @property
    def free_pages(self) -> int:
        """Pages allocatable right now (fresh + reclaimable)."""
        return len(self._free) + len(self._reclaimable)

    @property
    def live_pages(self) -> int:
        return len(self._ref)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take `n` pages with refcount 1 each, or None if they don't all
        fit (all-or-nothing).  Reclaimable prefix pages are cannibalised
        oldest-first once the free stack is empty."""
        if n < 0:
            raise ValueError(f'alloc({n})')
        if n > self.free_pages:
            return None
        out = []
        for _ in range(n):
            if self._free:
                page = self._free.pop()
            else:
                h, page = next(iter(self._reclaimable.items()))
                del self._reclaimable[h]
                del self._prefix_page[h]
                del self._page_hash[page]
                self.cannibalized_total += 1
            self._ref[page] = 1
            out.append(page)
        self.peak_live_pages = max(self.peak_live_pages, len(self._ref))
        return out

    def retain(self, page: int) -> None:
        """Add a reference (prefix hit); resurrects a reclaimable page."""
        ref = self._ref.get(page, 0)
        if ref == 0:
            h = self._page_hash.get(page)
            if h is None or h not in self._reclaimable:
                raise ValueError(f'retain of unallocated page {page}')
            del self._reclaimable[h]
        self._ref[page] = ref + 1
        self.peak_live_pages = max(self.peak_live_pages, len(self._ref))

    def release(self, page: int) -> None:
        """Drop one reference.  At zero, registered prefix pages park in
        the reclaimable LRU; anonymous pages return to the free stack."""
        ref = self._ref.get(page, 0)
        if ref <= 0:
            raise ValueError(f'release of unreferenced page {page}')
        if ref > 1:
            self._ref[page] = ref - 1
            return
        del self._ref[page]
        h = self._page_hash.get(page)
        if h is not None:
            self._reclaimable[h] = page
        else:
            self._free.append(page)

    def leak_report(self) -> Optional[str]:
        """None when every page is accounted for, else a description."""
        problems = []
        if self._ref:
            sample = sorted(self._ref)[:4]
            problems.append(f'{len(self._ref)} page(s) still referenced '
                            f'(e.g. {sample})')
        missing = (self.n_pages - 1) - len(self._ref) \
            - len(self._free) - len(self._reclaimable)
        if missing:
            problems.append(f'{missing} page(s) unaccounted for')
        return '; '.join(problems) or None

    def reset(self) -> None:
        """Forget all references and prefix registrations (the
        reference's, for a pool whose contents are gone or must not be
        matched).  `cannibalized_total` is a lifetime counter and stays."""
        self._free = list(range(self.n_pages - 1, 0, -1))
        self._ref.clear()
        self._prefix_page.clear()
        self._page_hash.clear()
        self._reclaimable.clear()

    def lookup_prefix(self, tokens: Sequence[int],
                      max_pages: Optional[int] = None) -> List[int]:
        """Longest already-cached page-aligned prefix of `tokens`.
        Every returned page is retained (caller must release)."""
        pages = []
        for i, h in enumerate(chain_hashes(tokens, self.page_size)):
            if max_pages is not None and i >= max_pages:
                break
            page = self._prefix_page.get(h)
            if page is None:
                break
            pages.append(page)
        for page in pages:
            self.retain(page)
        return pages

    def register_prefix(self, tokens: Sequence[int],
                        pages: Sequence[int]) -> None:
        """Publish a prefilled prompt's full pages for future sharing;
        `pages[i]` must hold the K/V of tokens[i*ps:(i+1)*ps]."""
        for i, h in enumerate(chain_hashes(tokens, self.page_size)):
            if i >= len(pages):
                break
            if h in self._prefix_page:
                continue
            page = pages[i]
            if page in self._page_hash or page == NULL_PAGE:
                continue
            self._prefix_page[h] = page
            self._page_hash[page] = h
