"""Warm-restart durability: versioned, checksummed serving-state snapshots.

Everything the serving tier *learns* — the Calibrator's τ separators and
cost scales, the Governor's rung memory and breaker states, and the
PlanCache's PreparedQuery entries with their learned join/connection
plans (`join_seq`, `conn_impls`, component/connection orders, candidate
masks) — evaporates on process restart, forcing a full re-learn from
cold.  `save_snapshot`/`restore_snapshot` round-trip that state through
one file, so a restarted server's first execution per cached template
runs the warm path: no prepare, no planning DP, no §4.3 decide, no
signature check.

File format (everything after the header is one pickle payload):

    bytes  0..7   MAGIC  b"RTORCHSN"
    bytes  8..11  format version (little-endian uint32)
    bytes 12..43  sha256 of the payload
    bytes 44..    payload (pickle protocol, stdlib only)

Safety invariants:

  * A corrupt, truncated, version-mismatched, stale (``max_age_s``), or
    wrong-dataset snapshot raises a typed `SnapshotError` — the server
    is left exactly as it was (a clean cold start), never serving a
    wrong or stale answer.  Restore is all-or-nothing: every object is
    rebuilt and validated BEFORE any server state is touched.
  * The dataset is identified by its content digest (`Dataset.digest`,
    over the full edge arrays) PLUS its delta version, so a snapshot can
    never replay another graph's masks or join sizes onto a lookalike
    graph, nor onto a same-origin dataset that has since absorbed
    `apply_delta` updates (reason 'version').
  * Device tensors are never serialized: candidate masks travel in host
    (numpy) form and `Engine._candidate_masks` rebuilds the device side
    lazily on first post-restore use, on the restoring engine's device.
  * The format is this package's own: a snapshot of the JAX package
    (magic ``b"REPROSNP"``) is refused on its magic, before anything is
    unpickled — its payload names the JAX package's classes.
  * Clocks don't compare across processes: breaker cooldowns and rung
    re-probe deadlines are stored as *remaining* durations and rebased
    against the restoring process's monotonic clock (see
    `governor.CircuitBreaker.save_state`).
"""
from __future__ import annotations

import hashlib
import os
import pickle
import struct
import time

from ..core.engine import PreparedQuery
from .governor import ServingError

MAGIC = b"RTORCHSN"
FORMAT_VERSION = 1


class SnapshotError(ServingError):
    """A snapshot could not be written or safely restored.  `reason` is
    one of: 'io', 'truncated', 'magic', 'format_version', 'checksum',
    'undecodable', 'dataset', 'version', 'stale', 'payload'."""

    def __init__(self, reason: str, detail: str):
        self.reason = reason
        super().__init__(f"snapshot {reason}: {detail}")


# ---------------------------------------------------------------------- #
# PreparedQuery <-> host-only blob.
# ---------------------------------------------------------------------- #
_PQ_FIELDS = ("query", "iv", "cand_sizes", "comps", "trees_per_comp",
              "decision", "use_check", "fingerprint", "version",
              "prepare_time", "executions", "comp_orders", "comp_costs",
              "conn_order", "conn_costs", "conn_impls", "join_seq",
              "join_est_seq")

# Fields ADDED to PreparedQuery after snapshot format v1 shipped, with
# the default a pre-addition snapshot restores to.  Listing a field here
# (instead of bumping FORMAT_VERSION) keeps older payloads restorable:
# the learned plan state they carry is still exactly valid, only the new
# observability field is absent.  join_est_seq added in the tracing PR —
# an empty history merely renders EXPLAIN's est column as "-" until the
# next cold run repopulates it.
_PQ_FIELD_DEFAULTS = {"join_est_seq": list}


def _pq_to_blob(pq: PreparedQuery) -> dict:
    """Host-only dict of one PreparedQuery.  Device-resident masks are
    dropped for their numpy form (`masks_host`, read from the device
    here); everything else is plain Python / numpy already."""
    blob = {k: getattr(pq, k) for k in _PQ_FIELDS}
    if pq.masks is not None:
        _, pass_np, after = pq.masks
        blob["masks_host"] = (dict(pass_np), after)
    else:
        blob["masks_host"] = pq.masks_host
    # join_seq caps may be CapEstimate (an int subclass carrying a
    # capacity hint) — normalize to plain tuples of builtins so the blob
    # survives refactors of estimator-internal types
    blob["join_seq"] = [(int(r), int(c), str(i))
                        for r, c, i in pq.join_seq]
    blob["join_est_seq"] = [None if e is None else int(e)
                            for e in pq.join_est_seq]
    return blob


def _pq_from_blob(blob: dict) -> PreparedQuery:
    kwargs = {}
    for k in _PQ_FIELDS:
        if k in blob:
            kwargs[k] = blob[k]
        elif k in _PQ_FIELD_DEFAULTS:
            kwargs[k] = _PQ_FIELD_DEFAULTS[k]()
        else:
            raise KeyError(k)            # caller wraps as payload error
    pq = PreparedQuery(**kwargs)
    pq.masks = None
    pq.masks_host = blob.get("masks_host")
    return pq


# ---------------------------------------------------------------------- #
# Save / restore.
# ---------------------------------------------------------------------- #
def _collect(server) -> dict:
    plans = []
    for (ds, fp), pq in server.plan_cache.entries():   # LRU order
        if ds != server.dataset_id:
            continue
        plans.append((fp, _pq_to_blob(pq)))
    return {
        "dataset_key": server.dataset.digest,
        "dataset_version": server.dataset.version,
        "saved_at": time.time(),
        "calibration_version": server._version(),
        "calibrator": (None if server.calibrator is None
                       else server.calibrator.save_state()),
        "governor": (None if server.governor is None
                     else server.governor.save_state()),
        "plans": plans,
    }


def save_snapshot(server, path) -> dict:
    """Write every piece of learned serving state to `path` (atomic:
    tmp file + rename).  Returns a manifest dict."""
    path = os.fspath(path)
    data = _collect(server)
    payload = pickle.dumps(data, protocol=4)
    digest = hashlib.sha256(payload).digest()
    head = MAGIC + struct.pack("<I", FORMAT_VERSION) + digest
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(head)
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError as e:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise SnapshotError("io", str(e)) from e
    return {"path": path, "format_version": FORMAT_VERSION,
            "dataset_key": server.dataset.digest,
            "dataset_version": server.dataset.version,
            "plans": len(data["plans"]),
            "bytes": len(head) + len(payload)}


def _read_payload(path) -> dict:
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        raise SnapshotError("io", str(e)) from e
    hdr_len = len(MAGIC) + 4 + hashlib.sha256().digest_size
    if len(raw) < hdr_len:
        raise SnapshotError("truncated",
                            f"{len(raw)} bytes < {hdr_len}-byte header")
    if raw[:len(MAGIC)] != MAGIC:
        raise SnapshotError("magic", f"{raw[:len(MAGIC)]!r}")
    (version,) = struct.unpack_from("<I", raw, len(MAGIC))
    if version != FORMAT_VERSION:
        raise SnapshotError(
            "format_version",
            f"snapshot v{version}, this build reads v{FORMAT_VERSION}")
    digest = raw[len(MAGIC) + 4:hdr_len]
    payload = raw[hdr_len:]
    if hashlib.sha256(payload).digest() != digest:
        raise SnapshotError("checksum", "payload sha256 mismatch")
    try:
        data = pickle.loads(payload)
    except Exception as e:               # noqa: BLE001
        raise SnapshotError("undecodable", str(e)) from e
    if not isinstance(data, dict) or "dataset_key" not in data:
        raise SnapshotError("payload", "missing dataset_key")
    return data


def restore_snapshot(server, path, max_age_s: float | None = None) -> dict:
    """Load a snapshot into `server`.  All-or-nothing: every restored
    object is built and validated before any server state is mutated, so
    a failed restore leaves an exact cold start.  Raises SnapshotError
    on any corruption, format/version mismatch, wrong dataset, or
    staleness past `max_age_s`."""
    path = os.fspath(path)
    data = _read_payload(path)
    # The delta version is checked before the content digest: once the
    # server's dataset has absorbed apply_delta round-trips the snapshot
    # never saw, "this snapshot predates your deltas" is the actionable
    # error even though the content digest (which tracks the edge set)
    # has necessarily moved too.  A digest mismatch at the SAME version
    # means a genuinely different dataset.  (Pre-version payloads carry
    # no dataset_version: they could only have been taken at version 0.)
    snap_version = int(data.get("dataset_version", 0))
    if snap_version != server.dataset.version:
        raise SnapshotError(
            "version",
            f"snapshot at dataset version {snap_version}, server is at "
            f"v{server.dataset.version}")
    if data["dataset_key"] != server.dataset.digest:
        raise SnapshotError(
            "dataset",
            f"snapshot for {data['dataset_key']!r}, server is on "
            f"{server.dataset.digest!r}")
    age = time.time() - float(data.get("saved_at", 0.0))
    if max_age_s is not None and age > max_age_s:
        raise SnapshotError("stale",
                            f"snapshot is {age:.1f}s old > {max_age_s}s")
    # ---- build everything before touching the server ----------------- #
    try:
        plans = [(fp, _pq_from_blob(blob)) for fp, blob in data["plans"]]
        cal_state = data.get("calibrator")
        gov_state = data.get("governor")
    except Exception as e:               # noqa: BLE001
        raise SnapshotError("payload", str(e)) from e
    # ---- apply -------------------------------------------------------- #
    if server.calibrator is not None and cal_state is not None:
        server.calibrator.load_state(cal_state)
    if server.governor is not None and gov_state is not None:
        server.governor.load_state(gov_state, server.governor.clock())
    for fp, pq in plans:                 # LRU order preserved
        server.plan_cache.put(server.dataset_id, fp, pq)
    return {"path": path, "format_version": FORMAT_VERSION,
            "dataset_key": data["dataset_key"], "plans": len(plans),
            "age_s": age,
            "calibration_version": int(data.get("calibration_version", 0))}
