"""Micro-batching queue in front of the device.

Every search dispatch pays a fixed cost (host prep, kernel launches, a
device-to-host copy of the results), so N concurrent REST requests that
each carry a handful of queries pay it N times. The reference absorbs
request concurrency with actix worker threads + rayon batch_search
(indexes/mod.rs:260-272); the array-native equivalent is coalescing: the
first thread in becomes the leader, waits a few ms for followers, stacks every pending request into
ONE device call at max(top_k), and slices the results back per request.

Engine calls are serialized through `dispatch_lock` (shared per
collection, also taken by the non-coalesced bypass paths), so concurrent
searches never race inside the index handle.

Port of ``cosdata_tpu/core/microbatch.py`` (a copy; imports name ``cosdata_tpu_torch``).
"""

from __future__ import annotations

import threading
import time

import numpy as np


class MicroBatcher:
    """Leader-follower coalescer for `run(queries (B, d), top_k)` calls.

    `run` must return `(ids (B, K), scores (B, K))` arrays. Requests are
    only coalesced with each other — a lone caller pays just WINDOW_S.
    """

    #: how long the leader waits for followers. Small vs the device round
    #: trip it saves; irrelevant for throughput (the window overlaps the
    #: previous batch's device time under sustained load).
    WINDOW_S = 0.003
    #: cap on one coalesced dispatch: a leader splits larger coalesced
    #: batches into MAX_BATCH-query engine calls (bounds the device
    #: working set)
    MAX_BATCH = 4096
    #: follower patience: if a leader thread dies without distributing
    #: (hard kill / BaseException during its window), followers fall back
    #: to running their own query instead of hanging the serving path.
    #: Must exceed the worst normal dispatch latency (the first search
    #: of a process also builds the kernels); a short timeout would
    #: stampede N followers into N duplicate dispatches exactly when the
    #: device is slowest. Leader death is the rare case; waiting longer
    #: for it is the right trade.
    FOLLOWER_TIMEOUT_S = 600.0

    def __init__(self, run, dispatch_lock: threading.Lock | None = None):
        self._run = run
        self._dispatch_lock = dispatch_lock or threading.RLock()
        self._lock = threading.Lock()
        self._pending: list[tuple] = []
        self._leader_active = False

    def _dispatch(self, queries, top_k: int):
        """One engine call, serialized with every other engine call that
        shares `dispatch_lock` (other batchers of this collection and the
        bypass paths)."""
        with self._dispatch_lock:
            return self._run(queries, top_k)

    @staticmethod
    def _concat(parts):
        if isinstance(parts[0], np.ndarray):
            return np.concatenate(parts)
        out = []
        for p in parts:
            out.extend(p)
        return out

    def search(self, queries, top_k: int):
        """`queries` is a (B, d) array (dense) or a list of per-query
        payloads (sparse term pairs / BM25 texts) — anything `run` takes
        whose results come back as (B, K) arrays."""
        if isinstance(queries, np.ndarray) or not isinstance(queries, (list, tuple)):
            queries = np.atleast_2d(np.asarray(queries, np.float32))
        if len(queries) >= self.MAX_BATCH:
            return self._dispatch(queries, top_k)
        ev = threading.Event()
        slot: dict = {}
        entry = (queries, top_k, ev, slot)
        with self._lock:
            self._pending.append(entry)
            am_leader = not self._leader_active
            if am_leader:
                self._leader_active = True
        if not am_leader:
            if ev.wait(self.FOLLOWER_TIMEOUT_S):
                if "err" in slot:
                    raise slot["err"]
                return slot["ids"], slot["scores"]
            # leader died without distributing: withdraw and self-serve
            # (identity filter — tuple __eq__ would compare the arrays)
            with self._lock:
                self._pending = [e for e in self._pending if e is not entry]
            if "ids" in slot:  # filled between timeout and withdrawal
                return slot["ids"], slot["scores"]
            return self._dispatch(queries, top_k)

        time.sleep(self.WINDOW_S)
        with self._lock:
            batch, self._pending = self._pending, []
            self._leader_active = False
        try:
            if len(batch) == 1:
                q, k, _, _ = batch[0]
                return self._dispatch(q, k)
            k_max = max(b[1] for b in batch)
            # chunk the coalesced batch so one engine call never exceeds
            # MAX_BATCH rows (requests are never split across chunks:
            # each is < MAX_BATCH rows by the bypass above)
            groups: list[list] = [[]]
            rows = 0
            for b in batch:
                if rows + len(b[0]) > self.MAX_BATCH and groups[-1]:
                    groups.append([])
                    rows = 0
                groups[-1].append(b)
                rows += len(b[0])
            mine = None
            for group in groups:
                qs = self._concat([b[0] for b in group])
                ids, scores = self._dispatch(qs, k_max)
                ids = np.asarray(ids)
                scores = np.asarray(scores)
                pos = 0
                for q, k, evt, slot_i in group:
                    part = (ids[pos : pos + len(q), :k],
                            scores[pos : pos + len(q), :k])
                    pos += len(q)
                    if slot_i is slot:
                        mine = part
                    else:
                        slot_i["ids"], slot_i["scores"] = part
                        evt.set()
            return mine
        except BaseException as e:
            for q, k, evt, slot_i in batch:
                if slot_i is slot or "ids" in slot_i:
                    continue
                slot_i["err"] = e
                evt.set()
            raise
