"""Stable error-code taxonomy: the ``errno`` and ``module`` fields and
the ``X-Ogt-Errno`` header of an error response.

The port of ``opengemini_tpu/utils/errno.py``, with the same codes (they
are stable API: log triage greps them; values are never reused or
renumbered). Each exception class of the port (and a few message
patterns) maps to a (code, module) pair; a raise site may pin a code by
setting ``exc.og_errno``.
"""

from __future__ import annotations

from enum import IntEnum


class Module(IntEnum):
    UNKNOWN = 0
    QUERY = 1
    WRITE = 2
    INDEX = 3
    META = 4
    META_RAFT = 5
    NETWORK = 6
    COMPACT = 7
    STORAGE = 8
    HA = 9
    HTTP = 10
    WAL = 11
    DOWNSAMPLE = 12
    CASTOR = 13
    STREAM = 14
    LOGSTORE = 15
    AUTH = 16


# -- code blocks (1000 per module) ----------------------------------------------

# query (1xxx)
QUERY_PARSE = 1001
QUERY_UNSUPPORTED = 1002
QUERY_BAD_ARGUMENT = 1003
QUERY_KILLED = 1004
QUERY_TOO_MANY_BUCKETS = 1005
QUERY_MEASUREMENT_NOT_FOUND = 1006

# write (2xxx)
WRITE_PARSE = 2001
WRITE_FIELD_CONFLICT = 2002
WRITE_DISABLED = 2003
WRITE_DB_NOT_FOUND = 2004
WRITE_RP_NOT_FOUND = 2005

# meta (4xxx)
META_NOT_LEADER = 4001
META_NO_QUORUM = 4002
META_DB_NOT_FOUND = 4003

# network / cluster (6xxx)
NET_NODE_UNREACHABLE = 6001
NET_PARTIALS_RETRY = 6002
NET_PARTIALS_UNAVAILABLE = 6003

# auth (16xxx)
AUTH_DENIED = 16001

# catch-alls (9xxx)
INTERNAL_ERROR = 9001


def classify(exc: BaseException) -> tuple[int, Module]:
    """-> (stable code, module) for any exception. Explicit wins: a raise
    site may set ``exc.og_errno`` (int) and optionally ``exc.og_module``
    (not ``errno``: OSError's own errno attribute would hijack the pin)."""
    explicit = getattr(exc, "og_errno", None)
    if isinstance(explicit, int):
        mod = getattr(exc, "og_module", None)
        return explicit, mod if isinstance(mod, Module) else Module.UNKNOWN

    # imports are local: errno must import from anywhere without pulling
    # the query and storage stacks in
    from opengemini_tpu_torch.ingest.line_protocol import ParseError
    from opengemini_tpu_torch.query.qhelpers import QueryError
    from opengemini_tpu_torch.record import FieldTypeConflict
    from opengemini_tpu_torch.storage.engine import (
        DatabaseNotFound, WriteError,
    )

    if isinstance(exc, ParseError):
        return WRITE_PARSE, Module.WRITE
    if isinstance(exc, FieldTypeConflict):
        return WRITE_FIELD_CONFLICT, Module.WRITE
    if isinstance(exc, DatabaseNotFound):
        return WRITE_DB_NOT_FOUND, Module.WRITE
    if isinstance(exc, WriteError):
        msg = str(exc)
        if "disabled" in msg:
            return WRITE_DISABLED, Module.WRITE
        if "retention policy" in msg:
            return WRITE_RP_NOT_FOUND, Module.WRITE
        return WRITE_PARSE, Module.WRITE
    if isinstance(exc, QueryError):
        msg = str(exc)
        if "not the meta leader" in msg or "leader" in msg and "redirect" in msg:
            return META_NOT_LEADER, Module.META
        if "no quorum" in msg:
            return META_NO_QUORUM, Module.META
        if "measurement not found" in msg:
            return QUERY_MEASUREMENT_NOT_FOUND, Module.QUERY
        if "max-select-buckets" in msg or "too large" in msg:
            return QUERY_TOO_MANY_BUCKETS, Module.QUERY
        if "unsupported" in msg or "not supported" in msg:
            return QUERY_UNSUPPORTED, Module.QUERY
        if "error parsing" in msg or "expected" in msg:
            return QUERY_PARSE, Module.QUERY
        return QUERY_BAD_ARGUMENT, Module.QUERY
    if isinstance(exc, OSError):
        return NET_NODE_UNREACHABLE, Module.NETWORK
    return INTERNAL_ERROR, Module.UNKNOWN


def tag(exc: BaseException) -> str:
    """Log form: 'errno=<code> module=<name>'."""
    code, mod = classify(exc)
    return f"errno={code} module={mod.name.lower()}"
