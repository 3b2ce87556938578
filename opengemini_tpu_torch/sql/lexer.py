"""InfluxQL lexer.

Reference: lib/util/lifted/influx/influxql scanner. Context-sensitive bits
(regex literals after =~ / !~ / FROM) are handled by the parser asking for
`allow_regex` on the next token.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

KEYWORDS = {
    "select", "from", "where", "group", "by", "fill", "limit", "offset",
    "slimit", "soffset", "order", "asc", "desc", "and", "or", "not", "show",
    "databases", "measurements", "tag", "values", "keys", "field", "fields",
    "series", "retention", "policies", "policy", "create", "drop", "alter",
    "database",
    "with", "key", "in", "on", "duration", "replication", "shard", "default",
    "into", "true", "false", "null", "none", "previous", "linear", "tz",
    "measurement", "delete", "as", "name", "continuous", "query", "queries",
    "begin", "end", "resample", "every", "for", "explain", "analyze",
    "user", "users", "password", "privileges", "grant", "grants", "revoke",
    "to", "set", "read", "write", "all", "cardinality", "exact",
    "stream", "streams", "delay", "shards", "stats", "diagnostics",
    "subscription", "subscriptions", "destinations", "any", "kill",
    "downsample", "downsamples", "ttl", "sampleinterval", "timeinterval",
    "cluster", "union", "join", "inner", "outer", "full", "left", "right",
}

_DUR_RE = re.compile(r"(\d+)(ns|u|µ|us|ms|s|m|h|d|w)")
_DUR_NS = {
    "ns": 1,
    "u": 1_000,
    "us": 1_000,
    "µ": 1_000,
    "ms": 1_000_000,
    "s": 1_000_000_000,
    "m": 60 * 1_000_000_000,
    "h": 3_600 * 1_000_000_000,
    "d": 86_400 * 1_000_000_000,
    "w": 7 * 86_400 * 1_000_000_000,
}


def parse_duration_ns(text: str) -> int | None:
    """Whole-string duration ('90s', '1h30m') -> ns, else None. The single
    duration-unit table for every surface (SQL lexer, logstore intervals)."""
    text = text.strip()
    total, j, n = 0, 0, len(text)
    if not n:
        return None
    while j < n:
        m = _DUR_RE.match(text, j)
        if not m or m.start() != j:
            return None
        total += int(m.group(1)) * _DUR_NS[m.group(2)]
        j = m.end()
    return total


@dataclass
class Token:
    kind: str  # IDENT KEYWORD STRING NUMBER INTEGER DURATION REGEX OP EOF
    val: object
    pos: int


class LexError(ValueError):
    pass


class Lexer:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        # optimizer hints seen while skipping /*+ ... */ comments; the
        # parser drains these per statement (reference: influxql hint pass)
        self.hints: list[str] = []
        self._hint_seen: set[int] = set()

    def peek(self, allow_regex: bool = False) -> Token:
        save = self.pos
        tok = self._scan(allow_regex)
        self.pos = save
        return tok

    def next(self, allow_regex: bool = False) -> Token:
        return self._scan(allow_regex)

    def _skip_ws(self) -> None:
        n = len(self.text)
        while self.pos < n:
            c = self.text[self.pos]
            if c in " \t\r\n":
                self.pos += 1
            elif c == "-" and self.text[self.pos : self.pos + 2] == "--":
                nl = self.text.find("\n", self.pos)
                self.pos = n if nl < 0 else nl
            elif c == "/" and self.text[self.pos : self.pos + 2] == "/*":
                # block comment; /*+ ... */ records optimizer hints
                # (peek() re-scans, so dedupe by start offset)
                end = self.text.find("*/", self.pos + 2)
                if (self.text[self.pos + 2 : self.pos + 3] == "+"
                        and self.pos not in self._hint_seen):
                    self._hint_seen.add(self.pos)
                    body = self.text[self.pos + 3 : (n if end < 0 else end)]
                    self.hints.extend(body.split())
                self.pos = n if end < 0 else end + 2
            else:
                break

    def _scan(self, allow_regex: bool) -> Token:
        self._skip_ws()
        text, n = self.text, len(self.text)
        if self.pos >= n:
            return Token("EOF", None, self.pos)
        start = self.pos
        c = text[start]

        if allow_regex and c == "/":
            i = start + 1
            buf = []
            while i < n:
                if text[i] == "\\" and i + 1 < n:
                    if text[i + 1] == "/":
                        buf.append("/")
                    else:
                        buf.append(text[i])
                        buf.append(text[i + 1])
                    i += 2
                    continue
                if text[i] == "/":
                    self.pos = i + 1
                    return Token("REGEX", "".join(buf), start)
                buf.append(text[i])
                i += 1
            raise LexError(f"unterminated regex at {start}")

        if c == "'":
            i = start + 1
            buf = []
            while i < n:
                if text[i] == "\\" and i + 1 < n:
                    buf.append({"n": "\n", "t": "\t", "'": "'", "\\": "\\"}.get(text[i + 1], text[i + 1]))
                    i += 2
                    continue
                if text[i] == "'":
                    self.pos = i + 1
                    return Token("STRING", "".join(buf), start)
                buf.append(text[i])
                i += 1
            raise LexError(f"unterminated string at {start}")

        if c == '"':
            i = start + 1
            buf = []
            while i < n:
                if text[i] == "\\" and i + 1 < n and text[i + 1] in '"\\':
                    buf.append(text[i + 1])
                    i += 2
                    continue
                if text[i] == '"':
                    self.pos = i + 1
                    return Token("IDENT", "".join(buf), start)
                buf.append(text[i])
                i += 1
            raise LexError(f"unterminated quoted identifier at {start}")

        if c.isdigit() or (c == "." and start + 1 < n and text[start + 1].isdigit()):
            return self._scan_number(start)

        if c.isalpha() or c == "_":
            i = start
            while i < n and (text[i].isalnum() or text[i] == "_"):
                i += 1
            word = text[start:i]
            self.pos = i
            lw = word.lower()
            if lw in KEYWORDS:
                return Token("KEYWORD", lw, start)
            return Token("IDENT", word, start)

        for op in ("=~", "!~", "!=", "<>", "<=", ">=", "::"):
            if text.startswith(op, start):
                self.pos = start + len(op)
                return Token("OP", op, start)
        if c in "=<>+-*/%(),;.$":
            self.pos = start + 1
            return Token("OP", c, start)
        raise LexError(f"unexpected character {c!r} at {start}")

    def _scan_number(self, start: int) -> Token:
        text, n = self.text, len(self.text)
        i = start
        while i < n and text[i].isdigit():
            i += 1
        # duration?  e.g. 5m, 1h30m, 90s
        m = _DUR_RE.match(text, start)
        if m and (i >= n or not text[i] in ".eE"):
            total = 0
            j = start
            while True:
                m = _DUR_RE.match(text, j)
                if not m:
                    break
                total += int(m.group(1)) * _DUR_NS[m.group(2)]
                j = m.end()
            # guard: "1m30" without unit is invalid; only accept full matches
            if j > start and (j >= n or not (text[j].isalnum() or text[j] == ".")):
                self.pos = j
                return Token("DURATION", total, start)
        is_float = False
        if i < n and text[i] == ".":
            is_float = True
            i += 1
            while i < n and text[i].isdigit():
                i += 1
        if i < n and text[i] in "eE":
            k = i + 1
            if k < n and text[k] in "+-":
                k += 1
            if k < n and text[k].isdigit():
                is_float = True
                i = k
                while i < n and text[i].isdigit():
                    i += 1
        word = text[start:i]
        self.pos = i
        if is_float:
            return Token("NUMBER", float(word), start)
        return Token("INTEGER", int(word), start)
