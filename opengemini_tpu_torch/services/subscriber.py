"""Subscriptions: forward written points to remote endpoints.

The port of ``opengemini_tpu/services/subscriber.py``, whole: the
subscriptions live in the engine's meta.json (the reference's keys, so
either package reopens them); in a cluster CREATE and DROP SUBSCRIPTION
replicate through the meta service (query/showddl.py ``_replicate_ddl``)
and reach every node's engine.

Reference: coordinator/subscriber.go SubscriberManager — written line
protocol is pushed to subscription destinations. Here a write observer
re-serializes points to line protocol and POSTs them to each
subscription's endpoints from a background queue (writes never block on
subscribers; a full queue drops batches like the reference's buffered
writer).

DDL: CREATE SUBSCRIPTION <name> ON <db> DESTINATIONS ALL|ANY '<url>', ...
     DROP SUBSCRIPTION <name> ON <db>; SHOW SUBSCRIPTIONS
ALL posts to every destination; ANY round-robins.
"""

from __future__ import annotations

import queue
import threading
import urllib.parse
import urllib.request

from opengemini_tpu_torch.record import FieldType
from opengemini_tpu_torch.services.base import logger


class Subscription:
    def __init__(self, name: str, mode: str, destinations: list[str]):
        self.name = name
        self.mode = mode  # ALL | ANY
        self.destinations = destinations
        self._rr = 0

    def to_json(self):
        return {"name": self.name, "mode": self.mode,
                "destinations": self.destinations}

    @classmethod
    def from_json(cls, j):
        return cls(j["name"], j["mode"], j["destinations"])


class SubscriberManager:
    def __init__(self, engine, max_queue: int = 1024, timeout_s: float = 2.0):
        self.engine = engine
        self.timeout_s = timeout_s
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="subscriber")
        engine.add_write_observer(self.on_write)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def on_write(self, db: str, rp: str | None, points: list) -> None:
        d = self.engine.databases.get(db)
        subs = getattr(d, "subscriptions", None) if d else None
        if not subs:
            return
        try:
            self._q.put_nowait((db, rp, points))
        except queue.Full:
            logger.warning("subscription queue full; dropping batch for %s", db)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                db, rp, points = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                d = self.engine.databases.get(db)
                subs = list(getattr(d, "subscriptions", {}).values()) if d else []
                if not subs:
                    continue
                body = points_to_lines(points).encode("utf-8")
                for sub in subs:
                    dests = (
                        sub.destinations
                        if sub.mode == "ALL"
                        else [sub.destinations[sub._rr % len(sub.destinations)]]
                    )
                    sub._rr += 1
                    for dest in dests:
                        self._post(dest, db, rp, body)
            except Exception:  # noqa: BLE001 — the worker must never die
                logger.exception("subscription forwarding failed")

    def _post(self, dest: str, db: str, rp: str | None, body: bytes) -> None:
        try:
            url = dest.rstrip("/") + "/write?db=" + urllib.parse.quote(db)
            if rp:
                url += "&rp=" + urllib.parse.quote(rp)
            req = urllib.request.Request(url, data=body, method="POST")
            urllib.request.urlopen(req, timeout=self.timeout_s).read()
        except (OSError, ValueError):
            logger.warning("subscription post to %s failed", dest)


def points_to_lines(points: list) -> str:
    """Structured points -> line protocol text (escaping-safe)."""
    from opengemini_tpu_torch.ingest.line_protocol import _esc_key

    lines = []
    for mst, tags, t, fields in points:
        tag_str = "".join(
            f",{_esc_key(k)}={_esc_key(v)}" for k, v in tags
        )
        parts = []
        for name, (ftype, v) in fields.items():
            key = _esc_key(name)
            if ftype == FieldType.BOOL:
                parts.append(f"{key}={'true' if v else 'false'}")
            elif ftype == FieldType.INT:
                parts.append(f"{key}={int(v)}i")
            elif ftype == FieldType.FLOAT:
                parts.append(f"{key}={float(v)!r}")
            else:
                s = str(v).replace("\\", "\\\\").replace('"', '\\"')
                parts.append(f'{key}="{s}"')
        if parts:
            lines.append(f"{_esc_key(mst)}{tag_str} {','.join(parts)} {t}")
    return "\n".join(lines)
