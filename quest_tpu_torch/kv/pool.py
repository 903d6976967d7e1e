"""Host-side page pool (counterpart of ``quest_tpu/kv/pool.py``).

Manages physical page (here: allocation block) ownership for many
sequences sharing one device pool: per-sequence page lists, refcounts
for shared prefixes, and one call per admission that fills the int32
table rows the scheduler copies into the cache's block table.

The JAX package also has a C++ version of the allocator, because its
engine fills every sequence's table row on every step. The port's
scheduler calls the pool only at admission, when a prompt is published
and when a request finishes (every decode step reads the rows already
in the cache), so the pool stays in Python.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class PagePool:
    """Shared physical page pool for many sequences: ``total_pages``
    pages of ``page_size`` tokens, at most ``max_seqs`` live sequences.
    Pages are handed out lowest id first (a LIFO free list) and are
    refcounted: a sequence holds one count on each of its pages,
    :meth:`pages_retain` takes another (a shared prefix), and a page
    returns to the free list when its count reaches zero."""

    def __init__(self, total_pages: int, page_size: int, max_seqs: int):
        self.total_pages = total_pages
        self.page_size = page_size
        self.max_seqs = max_seqs
        self._free = list(range(total_pages - 1, -1, -1))
        self._seqs = {}
        self._next_ids = list(range(max_seqs - 1, -1, -1))
        self._refs = np.zeros((total_pages,), np.int64)

    def free_pages(self) -> int:
        return len(self._free)

    def seq_create(self) -> int:
        """A new sequence id; raises when ``max_seqs`` are live."""
        if not self._next_ids:
            raise RuntimeError("sequence capacity exhausted")
        sid = self._next_ids.pop()
        self._seqs[sid] = {"pages": [], "len": 0}
        return sid

    def seq_release(self, seq_id: int) -> None:
        """Drop the sequence's count on each of its pages."""
        s = self._seqs.pop(seq_id)
        self._drop(s["pages"])
        self._next_ids.append(seq_id)

    def pages_alloc(self, n: int) -> List[int]:
        """``n`` free pages, each with one count held by the caller (no
        sequence owns them; :meth:`pages_release` returns them). Raises
        ``MemoryError`` (allocating nothing) when the pool is short."""
        if n > len(self._free):
            raise MemoryError("page pool exhausted")
        out = [self._free.pop() for _ in range(n)]
        self._refs[out] = 1
        return out

    def pages_retain(self, pages: Sequence[int]) -> None:
        """Take a refcount hold on owned pages — a shared-prefix hold
        that survives the owning sequence's release. Nothing changes if
        any page is not owned."""
        self._check_owned(pages, "retain")
        for pg in pages:
            self._refs[pg] += 1

    def pages_release(self, pages: Sequence[int]) -> None:
        """Drop a :meth:`pages_retain` hold; pages reaching zero become
        free."""
        self._check_owned(pages, "release")
        self._drop(pages)

    def _check_owned(self, pages: Sequence[int], what: str) -> None:
        if any(not 0 <= pg < self.total_pages or self._refs[pg] <= 0
               for pg in pages):
            raise ValueError(f"{what} of unowned page")

    def _drop(self, pages: Sequence[int]) -> None:
        for pg in pages:
            self._refs[pg] -= 1
            if self._refs[pg] == 0:
                self._free.append(pg)

    def seq_extend(self, seq_id: int, n_tokens: int) -> int:
        """Grow the sequence by ``n_tokens``; returns the number of new
        pages. Raises ``MemoryError`` (allocating nothing) when the pool
        is short."""
        s = self._seqs[seq_id]
        new_len = s["len"] + n_tokens
        need = -(-new_len // self.page_size) - len(s["pages"])
        if need > len(self._free):
            raise MemoryError("page pool exhausted")
        for _ in range(need):
            pg = self._free.pop()
            self._refs[pg] = 1
            s["pages"].append(pg)
        s["len"] = new_len
        return need

    def seq_len(self, seq_id: int) -> int:
        return self._seqs[seq_id]["len"]

    def seq_pages(self, seq_id: int) -> List[int]:
        return list(self._seqs[seq_id]["pages"])

    def fill_batch_tables(self, seq_ids: Sequence[int], table_width: int,
                          pad_page: int = 0):
        """(tables [n, table_width] int32, lens [n] int32): each
        sequence's pages padded with ``pad_page``, and its length.
        Raises ``ValueError`` on an unknown id or a row that overflows."""
        n = len(seq_ids)
        tables = np.empty((n, table_width), np.int32)
        lens = np.empty((n,), np.int32)
        for i, sid in enumerate(seq_ids):
            s = self._seqs.get(sid)
            if s is None or len(s["pages"]) > table_width:
                raise ValueError("invalid sequence id or table overflow")
            pg = s["pages"]
            tables[i, :len(pg)] = pg
            tables[i, len(pg):] = pad_page
            lens[i] = s["len"]
        return tables, lens
