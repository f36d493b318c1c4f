"""Page-table allocator for the paged KV cache.

The device side is a fixed pool of fixed-size KV pages
(``repro_torch.models.attention.init_paged_cache``: ``[L, n_pages, page_size, KV,
hd]``). This module is the *host* side: which sequence owns which pages.
Allocator state never crosses to the device — each dispatch receives a
freshly built int32 page-table array, the same way the training kernels
receive their host-built visit schedules.

Invariants (pinned by tests/test_serving.py and tests/test_torch_serving.py):

* page 0 is the reserved **null page** — never allocated, the scatter
  target for prompt padding and for slots decoding past their request
  (its contents are garbage by design and always masked);
* a page is owned by at most one sequence at a time (no double
  allocation);
* ``release`` returns every owned page to the free pool (release on
  finish), so a long-running server's pool never leaks;
* allocating beyond the pool raises :class:`OutOfPages` — the scheduler
  uses :meth:`PageAllocator.can_admit` to defer admission instead.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class OutOfPages(RuntimeError):
    """The fixed page pool cannot satisfy an allocation."""


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages required to hold ``n_tokens`` KV entries."""
    return -(-n_tokens // page_size)


@dataclasses.dataclass
class PageAllocator:
    """Fixed pool of ``n_pages`` pages of ``page_size`` KV slots each.

    Page 0 is reserved (the null page), so ``n_pages - 1`` pages are
    usable. Per-sequence page lists are kept in allocation order ==
    position order: page ``i`` of a sequence holds positions
    ``[i*page_size, (i+1)*page_size)``.
    """

    n_pages: int
    page_size: int

    def __post_init__(self) -> None:
        if self.n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self._free: list[int] = list(range(self.n_pages - 1, 0, -1))
        self._owned: dict[object, list[int]] = {}

    # --- queries ---
    @property
    def n_free(self) -> int:
        return len(self._free)

    def pages_for(self, seq_id) -> list[int]:
        return list(self._owned.get(seq_id, ()))

    def capacity(self, seq_id) -> int:
        """Tokens the sequence's current pages can hold."""
        return len(self._owned.get(seq_id, ())) * self.page_size

    def can_admit(self, n_tokens: int) -> bool:
        return pages_needed(n_tokens, self.page_size) <= self.n_free

    # --- mutation ---
    def alloc(self, seq_id, n: int) -> list[int]:
        """Append ``n`` fresh pages to ``seq_id``'s page list."""
        if n > len(self._free):
            raise OutOfPages(
                f"need {n} pages, {len(self._free)} free "
                f"(pool {self.n_pages}, page 0 reserved)")
        pages = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(seq_id, []).extend(pages)
        return pages

    def ensure(self, seq_id, n_tokens: int) -> list[int]:
        """Grow ``seq_id``'s allocation to cover ``n_tokens`` positions
        (allocate-on-demand during decode). Returns any new pages."""
        need = pages_needed(n_tokens, self.page_size) - len(self._owned.get(seq_id, ()))
        return self.alloc(seq_id, need) if need > 0 else []

    def release(self, seq_id) -> int:
        """Return every page owned by ``seq_id`` to the pool."""
        pages = self._owned.pop(seq_id, [])
        self._free.extend(reversed(pages))
        return len(pages)

    # --- device view ---
    def page_table_row(self, seq_id, max_pages: int) -> np.ndarray:
        """int32 [max_pages] page ids, 0-padded past the allocation."""
        pages = self._owned.get(seq_id, ())
        if len(pages) > max_pages:
            raise ValueError(
                f"sequence owns {len(pages)} pages > max_pages={max_pages}")
        row = np.zeros((max_pages,), np.int32)
        row[: len(pages)] = pages
        return row

    def page_table(self, seq_ids, max_pages: int) -> np.ndarray:
        """int32 [len(seq_ids), max_pages] table; ``None`` entries (empty
        slots) become all-null rows."""
        rows = [np.zeros((max_pages,), np.int32) if sid is None
                else self.page_table_row(sid, max_pages) for sid in seq_ids]
        return np.stack(rows) if rows else np.zeros((0, max_pages), np.int32)
