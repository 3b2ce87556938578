"""Deterministic network-fault injection for the cluster data plane.

The port of ``opengemini_tpu/parallel/netfault.py``, whole, with a plain
``threading`` lock (a delay action sleeps where it is consulted).

The cluster torture harness (tools/cluster_torture.py) needs partitions,
black holes, and slow links it can create and heal WITHOUT real network
tooling (iptables/tc are unavailable in test containers and nondetermin-
istic anyway).  This module is the failpoint analogue for the transport:
rules keyed by (src, dst, path) glob patterns are consulted by every
outbound peer call the DataRouter makes (``_post_raw``, liveness probes,
health-view fetches, line-protocol forwards) and either drop the request
(an ``OSError`` indistinguishable from an unreachable peer), delay it,
or answer it with an injected HTTP error status.

Pass-through contract: with no rules armed the hook is one truthiness
check of an empty list — bit-identical behavior to an unwrapped
transport (asserted by tests/test_netfault.py).

Rules are matched CLIENT-side, so a rule armed on node A affects only
A's OUTBOUND traffic: a one-way partition is a single rule; a full
partition is the mirrored pair (the torture harness arms both ends via
``POST /debug/ctrl?mod=netfault``).  The meta-raft plane has its own
transport and is deliberately out of scope — this module partitions the
DATA plane (routed writes, hints, migration, anti-entropy, scans).

Rule shape — three glob patterns and an action:

  src    matched against the calling router's node id
  dst    matched against the target node id AND its host:port address
         (call sites pass whichever they have; either may match)
  path   matched against the URL path (e.g. ``/internal/*``)

Actions:

  drop             raise NetFault (an OSError: looks unreachable)
  delay:<seconds>  sleep, then pass the request through
  error[:<status>] raise urllib.error.HTTPError (default 503)

Arming:

  env:      OGT_NETFAULT="src|dst|path=action;..."
  runtime:  POST /debug/ctrl?mod=netfault&src=...&dst=...&path=...&action=...
            (action=off clears one rule; clear=1 clears all)

Hit counts per rule are recorded for test assertions (``hits()``).
"""

from __future__ import annotations

import fnmatch
import os
import threading
import time

from opengemini_tpu_torch.utils import lockdep

_lock = lockdep.Lock()
# armed rules: (src, dst, path, action) — first match wins, in arming order
_rules: list[tuple[str, str, str, str]] = []
_hits: dict[str, int] = {}


class NetFault(OSError):
    """Injected transport fault (presents as an unreachable peer)."""


def validate(action: str) -> None:
    """Reject malformed actions at arming time — a typo must fail the
    ctrl call, not silently pass traffic through (or crash a later
    check() deep inside a write path)."""
    if action == "drop":
        return
    if action.startswith("delay:"):
        secs = float(action.split(":", 1)[1])  # ValueError on garbage
        if not 0 <= secs < float("inf"):  # also rejects nan
            raise ValueError(f"bad netfault delay {secs}")
        return
    if action == "error":
        return
    if action.startswith("error:"):
        status = int(action.split(":", 1)[1])
        if not 100 <= status <= 599:
            raise ValueError(f"bad netfault error status {status}")
        return
    raise ValueError(f"unknown netfault action {action!r}")


def _load_env() -> None:
    spec = os.environ.get("OGT_NETFAULT", "")
    for part in spec.split(";"):
        part = part.strip()
        if not part or "=" not in part:
            continue
        key, _, action = part.partition("=")
        bits = key.split("|")
        if len(bits) != 3:
            continue
        try:
            validate(action.strip())
        except ValueError:
            continue
        _rules.append((bits[0].strip() or "*", bits[1].strip() or "*",
                       bits[2].strip() or "*", action.strip()))


_load_env()


def _key(src: str, dst: str, path: str, action: str) -> str:
    return f"{src}|{dst}|{path}={action}"


def set_rule(src: str, dst: str, path: str, action: str) -> None:
    validate(action)
    with _lock:
        _rules[:] = [r for r in _rules if r[:3] != (src, dst, path)]
        _rules.append((src, dst, path, action))


def clear_rule(src: str, dst: str, path: str) -> bool:
    with _lock:
        before = len(_rules)
        _rules[:] = [r for r in _rules if r[:3] != (src, dst, path)]
        return len(_rules) != before


def clear_all() -> None:
    with _lock:
        _rules.clear()
        _hits.clear()


def rules() -> list[dict]:
    with _lock:
        return [{"src": s, "dst": d, "path": p, "action": a}
                for s, d, p, a in _rules]


def hits() -> dict[str, int]:
    with _lock:
        return dict(_hits)


def check(src: str, path: str, *dsts: str) -> None:
    """The transport hook: no-op unless a rule matches (src, any of
    dsts, path).  Raises NetFault (drop), sleeps (delay), or raises
    urllib.error.HTTPError (error) per the first matching rule."""
    if not _rules:  # fast path: nothing armed
        return
    with _lock:
        action = None
        for rs, rd, rp, act in _rules:
            if not fnmatch.fnmatch(src or "", rs):
                continue
            if not any(fnmatch.fnmatch(d or "", rd) for d in dsts if d):
                continue
            if not fnmatch.fnmatch(path, rp):
                continue
            key = _key(rs, rd, rp, act)
            _hits[key] = _hits.get(key, 0) + 1
            action = act
            break
    if action is None:
        return
    if action == "drop":
        raise NetFault(
            f"netfault: dropped {src or '?'} -> {dsts[0] if dsts else '?'} "
            f"{path}")
    if action.startswith("delay:"):
        # audited blocking: delay: exists to stall RPCs mid-flight,
        # deliberately wherever the consult point sits
        with lockdep.allow_blocking("netfault delay action"):
            time.sleep(float(action.split(":", 1)[1]))
        return
    # error[:status]
    import io
    import urllib.error

    status = int(action.split(":", 1)[1]) if ":" in action else 503
    raise urllib.error.HTTPError(
        path, status, "netfault injected error", hdrs=None,
        fp=io.BytesIO(b""))
