"""The request flight recorder — a bounded ring buffer of span events,
dumped as JSONL when something breaks. The port of
``raft_tpu/obs/flight.py`` (pure Python, the same JSONL).

Metrics (:mod:`raft_tpu_torch.obs.metrics`) answer "how is serving doing";
they cannot answer "what happened to THE batch that failed at 03:12".
The flight recorder is that postmortem story: every request carries an
id from ``submit`` through pack → dispatch → hedge → demux, each hop
appends one small event dict to a fixed-capacity ring (old events fall
off the back — the recorder bounds its own memory, a crashed process
never drowned in its telemetry), and the ring is serialized to
structured JSONL automatically on the chaos paths
(docs/observability.md "Flight recorder"):

* a batch DISPATCH fails — the executor dumps before failing the
  batch's futures, so the file shows what the doomed batch looked like;
* a deadline/timeout trips inside a dispatch (same path: the timeout is
  the dispatch failure);
* ``close()`` finds failed requests outstanding — the shutdown dump.

Event schema (one JSON object per line; the header line carries the
dump reason):

    {"t": 12.345, "event": "submit", "request_id": 17, "rows": 3}
    {"t": 12.347, "event": "pack", "request_id": 17, "batch_id": 4,
     "bucket": 8, "start": 0}
    {"t": 12.347, "event": "dispatch", "batch_id": 4, "bucket": 8,
     "requests": [17, 18]}
    {"t": 12.390, "event": "hedge", "batch_id": 4, "age_ms": 43.1}
    {"t": 12.401, "event": "demux", "batch_id": 4, "winner": "backup",
     "held_ms": 54.0}

``t`` is the recorder's injectable clock (the executor passes its own,
so flight stamps and stage metrics share a timeline). Recording honors
the global ``RAFT_TPU_OBS`` gate — a disabled process pays one
attribute load per hop.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from raft_tpu_torch import errors
from raft_tpu_torch.analysis.threads import runtime as lockcheck
from raft_tpu_torch.obs import metrics as _metrics

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """A bounded, thread-safe ring of per-request span events.

    ``capacity`` bounds memory: the ring keeps the most recent events
    (a dump after a failure shows the failure's neighborhood, which is
    what a postmortem needs — not the whole run). ``dump_dir`` is where
    automatic dumps land (``flight-<name>-<seq>.jsonl``); without one,
    :meth:`dump` with no explicit path is a no-op returning ``None``
    (the events stay readable via :meth:`events`/:meth:`dumps`).
    """

    def __init__(self, capacity: int = 4096, *,
                 dump_dir: Optional[str] = None,
                 name: str = "serving",
                 clock: Callable[[], float] = time.monotonic):
        errors.expects(capacity >= 1,
                       "FlightRecorder: capacity=%d < 1", capacity)
        self.capacity = int(capacity)
        self.dump_dir = dump_dir
        self.name = name
        self._clock = clock
        self._lock = lockcheck.make_lock("FlightRecorder._lock")
        self._ring: deque = deque(maxlen=self.capacity)
        self._dropped = 0
        self._dump_seq = 0
        self.dumps_written: List[str] = []

    # -- recording -----------------------------------------------------------
    def record(self, event: str, *, request_id: Optional[int] = None,
               batch_id: Optional[int] = None, **fields: Any) -> None:
        """Append one span event (cheap; honors the global obs gate).
        ``fields`` must be JSON-serializable — keep them small scalars
        (ids, ms, names), the ring is a black box, not a log."""
        if not _metrics.enabled():
            return
        ev: Dict[str, Any] = {"t": self._clock(), "event": event}
        if request_id is not None:
            ev["request_id"] = request_id
        if batch_id is not None:
            ev["batch_id"] = batch_id
        if fields:
            ev.update(fields)
        with self._lock:
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(ev)

    @property
    def dropped(self) -> int:
        """Events that fell off the back of the ring (capacity
        pressure — size the ring to the in-flight window × hops)."""
        with self._lock:
            return self._dropped

    # -- reading -------------------------------------------------------------
    def events(self, *, request_id: Optional[int] = None,
               batch_id: Optional[int] = None,
               event: Optional[str] = None) -> List[dict]:
        """Snapshot the ring (oldest first), optionally filtered by
        request id / batch id / event name."""
        with self._lock:
            evs = list(self._ring)
        return [
            e for e in evs
            if (request_id is None or e.get("request_id") == request_id)
            and (batch_id is None or e.get("batch_id") == batch_id)
            and (event is None or e.get("event") == event)
        ]

    def dumps(self, reason: str = "manual") -> str:
        """The JSONL serialization: a header line
        ``{"flight": name, "reason": ..., "t": ..., "n_events": ...,
        "dropped": ...}`` followed by one event per line."""
        with self._lock:
            evs = list(self._ring)
            dropped = self._dropped
        head = {
            "flight": self.name, "reason": reason, "t": self._clock(),
            "n_events": len(evs), "dropped": dropped,
        }
        return "\n".join(
            json.dumps(e, sort_keys=True) for e in [head] + evs
        ) + "\n"

    def dump(self, reason: str, path: Optional[str] = None,
             ) -> Optional[str]:
        """Write the ring as JSONL and return the path written.
        ``path`` default: ``dump_dir/flight-<name>-<seq>.jsonl``; with
        neither, no file is written (``None``) — the executor calls
        this unconditionally on its failure paths and an un-sinked
        recorder must not crash the failure handling it documents."""
        if path is None:
            if self.dump_dir is None:
                return None
            with self._lock:
                seq = self._dump_seq
                self._dump_seq += 1
            path = (f"{self.dump_dir}/flight-{self.name}-"
                    f"{seq:03d}.jsonl")
        text = self.dumps(reason)
        with open(path, "w") as f:
            f.write(text)
        with self._lock:
            self.dumps_written.append(path)
        return path

    def __repr__(self) -> str:
        with self._lock:
            n = len(self._ring)
            nd = len(self.dumps_written)
        return (f"FlightRecorder(name={self.name!r}, events={n}/"
                f"{self.capacity}, dumps={nd})")
