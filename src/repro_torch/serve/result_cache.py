"""Exact-repeat result cache: (dataset id, template fingerprint) → rows.

The long-blocked serving win: a repeat of an already-executed template can
be answered without touching the engine at all — not even the warm replay
path — IF the system can prove the stored rows are still the answer.  With
an immutable dataset that proof was trivial but the cache was pointless to
scope; with `Dataset.apply_delta` it becomes possible to keep entries
*across* deltas:

  * entries are keyed by the server's versioned dataset id
    (``Dataset.cache_key`` = ``digest:vN``), so a delta never serves stale
    rows by accident — unmigrated entries simply stop matching;
  * on a delta, `migrate` re-keys the entries that provably survived: a
    connection-free template's matches live entirely inside its candidate
    intervals (every matched node is interval-constrained, and any
    changed edge's endpoints are in the delta's touched set), so the
    result is unchanged iff no touched node falls in any interval
    (`interval_footprint_hit`).  Templates WITH connection edges always
    drop — connectivity paths may run through nodes outside every
    interval, which the footprint can't see.

Results are stored in canonical-template form (cols + row array straight
from the engine); the server remaps per caller at fan-out time, so one
entry serves every isomorphic renumbering.  Bounded LRU by entry count
and (optionally) accounted row bytes, same discipline as ReachCache.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..core.dataset import interval_footprint_hit


class ResultCache:
    """LRU cache of exact query results keyed (dataset id, fingerprint)."""

    def __init__(self, max_entries: int = 256,
                 max_bytes: int | None = None):
        self.max_entries = int(max_entries)
        self.max_bytes = max_bytes
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0      # entries dropped by delta migration
        self.insertions = 0
        self.total_bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------------ #
    def get(self, dataset_id: str, fingerprint: str):
        """(cols, rows) in canonical-template form, or None."""
        key = (dataset_id, fingerprint)
        e = self._entries.get(key)
        if e is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return e["cols"], e["rows"]

    def put(self, dataset_id: str, fingerprint: str, cols, rows,
            has_connections: bool, iv) -> None:
        """Store one canonical result.  `iv` is the prepared query's
        [Q, 2] candidate-interval array — the migration footprint."""
        key = (dataset_id, fingerprint)
        if key in self._entries:
            self.total_bytes -= self._entries.pop(key)["bytes"]
        rows = np.asarray(rows)
        nbytes = int(rows.nbytes)
        e = {"cols": tuple(int(c) for c in cols), "rows": rows,
             "has_connections": bool(has_connections),
             "iv": np.array(iv, copy=True), "bytes": nbytes}
        self._entries[key] = e
        self.insertions += 1
        self.total_bytes += nbytes
        while len(self._entries) > self.max_entries:
            self._evict_lru()
        if self.max_bytes is not None:
            # never evict the just-inserted entry: an oversized result
            # stays as a cache-of-one rather than thrashing
            while self.total_bytes > self.max_bytes \
                    and len(self._entries) > 1:
                self._evict_lru()

    def _evict_lru(self) -> None:
        _, e = self._entries.popitem(last=False)
        self.total_bytes -= e["bytes"]
        self.evictions += 1

    # ------------------------------------------------------------------ #
    def migrate(self, old_id: str, new_id: str,
                touched: np.ndarray | None) -> tuple[int, int]:
        """Delta migration: re-key surviving entries from `old_id` to
        `new_id`, drop the rest.  `touched` is the delta's sorted
        touched-node array (None = full rebuild = drop everything).
        Returns (kept, dropped)."""
        kept = dropped = 0
        for (dsid, fp), e in list(self._entries.items()):
            if dsid != old_id:
                continue
            del self._entries[(dsid, fp)]
            iv_pairs = [(int(lo), int(hi)) for lo, hi in e["iv"]]
            if touched is None or e["has_connections"] \
                    or interval_footprint_hit(iv_pairs, touched):
                self.total_bytes -= e["bytes"]
                self.invalidations += 1
                dropped += 1
                continue
            self._entries[(new_id, fp)] = e
            kept += 1
        return kept, dropped

    # ------------------------------------------------------------------ #
    def snapshot(self) -> dict:
        total = self.hits + self.misses
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
            "insertions": self.insertions,
            "bytes": self.total_bytes,
            "max_bytes": self.max_bytes,
        }
