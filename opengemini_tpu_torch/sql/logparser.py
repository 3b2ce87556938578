"""Log-search query grammar (PPL-style pipe syntax).

Reference: the yacc grammar at lib/util/lifted/logparser/sql.y — bare
terms are full-text matches on the ``content`` field, ``field: value``
is a phrase match, comparison and ``IN`` range operators apply to
numeric fields, adjacency means AND, ``|`` pipe segments AND-combine,
and at most one ``EXTRACT(field: "pattern") AS(aliases...)`` clause
derives new fields (reference Unnest/match_all, sql.y:246-273).

This parser is a hand-written tokenizer + recursive descent (same style
as sql/parser.py) producing a small AST that ``server/logstore.py``
compiles onto the InfluxQL executor: content terms become ``match()``
(text-index-pruned scans), field terms become equality/comparison
predicates, EXTRACT patterns run as Python regexes over result rows with
alias conditions applied post-extract.

Grammar summary::

    query    := segment ('|' segment)*
    segment  := EXTRACT '(' field ':' STRING ')' AS '(' ident (',' ident)* ')'
              | or_expr
    or_expr  := and_expr ('or' and_expr)*
    and_expr := adj_expr ('and' adj_expr)*
    adj_expr := primary primary*              # adjacency = AND
    primary  := '(' or_expr ')' | term
    term     := value                          # full-text on content
              | field ':' value                # phrase match
              | field op value                 # op: < <= > >= !=
              | field IN ('('|'[') value value (')'|']')
    value    := ident | 'string' | "string" | '*'

The port of ``opengemini_tpu/sql/logparser.py``, whole, with its imports
rewritten.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field as dc_field

DEFAULT_FIELD = "content"  # reference logparser DefaultFieldForFullText


class LogParseError(ValueError):
    pass


@dataclass
class Term:
    """One predicate. op: 'match' (phrase/full-text), 'eq', 'neq', 'lt',
    'lte', 'gt', 'gte'. field None = bare full-text term."""

    field: str | None
    op: str
    value: str | float


@dataclass
class Rng:
    field: str
    lo: float
    hi: float
    lo_incl: bool
    hi_incl: bool


@dataclass
class And:
    children: list


@dataclass
class Or:
    children: list


@dataclass
class Extract:
    source: str
    pattern: str
    aliases: list[str]


@dataclass
class MatchAll:
    """`*` — matches every log line."""


@dataclass
class LogQuery:
    cond: object | None = None
    extract: Extract | None = None
    aliases: list[str] = dc_field(default_factory=list)


# -- tokenizer ---------------------------------------------------------------

_TOK_RE = re.compile(
    r"""
    \s*(
        "(?:[^"\\]|\\.)*"         # double-quoted string
      | '(?:[^'\\]|\\.)*'         # single-quoted string
      | <= | >= | != | [:<>(),|\[\]]
      | [^\s:<>()\[\],|]+         # bare word
    )
    """,
    re.VERBOSE,
)

_KEYWORDS = {"and", "or", "in", "as", "extract"}


def _tokenize(text: str) -> list[str]:
    toks, pos = [], 0
    while pos < len(text):
        m = _TOK_RE.match(text, pos)
        if not m:
            if text[pos:].strip():
                raise LogParseError(f"bad token at {text[pos:pos + 20]!r}")
            break
        toks.append(m.group(1))
        pos = m.end()
    return toks


def _unquote(tok: str) -> str:
    if len(tok) >= 2 and tok[0] in "\"'" and tok[-1] == tok[0]:
        body = tok[1:-1]
        # unescape ONLY the quote char and backslash — other escapes
        # (\d, \s, ...) must survive for EXTRACT regex patterns
        return body.replace("\\" + tok[0], tok[0]).replace("\\\\", "\\")
    return tok


def _is_value(tok: str | None) -> bool:
    return tok is not None and tok not in (
        ":", "<", "<=", ">", ">=", "!=", "(", ")", "[", "]", ",", "|",
    ) and tok.lower() not in ("and", "or", "in", "as", "extract")


class _Parser:
    def __init__(self, toks: list[str]):
        self.toks = toks
        self.i = 0

    def peek(self) -> str | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        tok = self.peek()
        if tok is None:
            raise LogParseError("unexpected end of query")
        self.i += 1
        return tok

    def expect(self, want: str) -> str:
        tok = self.next()
        if tok.lower() != want.lower():
            raise LogParseError(f"expected {want!r}, got {tok!r}")
        return tok

    # -- segments ------------------------------------------------------------

    def parse_query(self) -> LogQuery:
        q = LogQuery()
        conds = []
        while True:
            tok = self.peek()
            if tok is None:
                break
            if tok.lower() == "extract":
                ex = self.parse_extract()
                if q.extract is not None:
                    raise LogParseError("only one EXTRACT clause is supported")
                q.extract = ex
            else:
                conds.append(self.parse_or())
            tok = self.peek()
            if tok == "|":
                self.next()
                continue
            if tok is not None:
                raise LogParseError(f"unexpected {tok!r}")
            break
        conds = [c for c in conds if not isinstance(c, MatchAll)]
        if conds:
            q.cond = conds[0] if len(conds) == 1 else And(conds)
        if q.extract:
            q.aliases = list(q.extract.aliases)
        return q

    def parse_extract(self) -> Extract:
        self.expect("extract")
        self.expect("(")
        src = _unquote(self.next())
        self.expect(":")
        pattern = _unquote(self.next())
        self.expect(")")
        self.expect("as")
        self.expect("(")
        aliases = [_unquote(self.next())]
        while self.peek() == ",":
            self.next()
            aliases.append(_unquote(self.next()))
        self.expect(")")
        try:
            ngroups = re.compile(pattern).groups
        except re.error as e:
            raise LogParseError(f"bad EXTRACT pattern: {e}") from None
        if ngroups != len(aliases):
            raise LogParseError(
                f"EXTRACT pattern has {ngroups} capture group(s) "
                f"but {len(aliases)} alias(es)"
            )
        return Extract(src, pattern, aliases)

    # -- conditions ----------------------------------------------------------

    def parse_or(self):
        left = self.parse_and()
        items = [left]
        while self.peek() is not None and self.peek().lower() == "or":
            self.next()
            items.append(self.parse_and())
        return items[0] if len(items) == 1 else Or(items)

    def parse_and(self):
        items = [self.parse_adj()]
        while self.peek() is not None and self.peek().lower() == "and":
            self.next()
            items.append(self.parse_adj())
        return items[0] if len(items) == 1 else And(items)

    def parse_adj(self):
        items = [self.parse_primary()]
        # adjacency = AND (reference BAND rule)
        while True:
            tok = self.peek()
            if tok == "(" or _is_value(tok):
                items.append(self.parse_primary())
            else:
                break
        items = [c for c in items if not isinstance(c, MatchAll)] or items[:1]
        return items[0] if len(items) == 1 else And(items)

    def parse_primary(self):
        tok = self.peek()
        if tok == "(":
            self.next()
            inner = self.parse_or()
            self.expect(")")
            return inner
        return self.parse_term()

    def parse_term(self):
        raw = self.next()
        first = _unquote(raw)
        nxt = self.peek()
        if nxt == ":":
            self.next()
            val = self.next()
            if val == "*" :
                # field:* — "field present / non-empty" (reference maps to
                # field != '')
                return Term(first, "neq", "")
            return Term(first, "match", _unquote(val))
        if nxt in ("<", "<=", ">", ">=", "!="):
            op = {"<": "lt", "<=": "lte", ">": "gt", ">=": "gte", "!=": "neq"}[
                self.next()
            ]
            return Term(first, op, _number_or_str(_unquote(self.next())))
        if nxt is not None and nxt.lower() == "in":
            self.next()
            open_tok = self.next()
            if open_tok not in ("(", "["):
                raise LogParseError(f"expected ( or [ after IN, got {open_tok!r}")
            lo = _number(_unquote(self.next()))
            hi = _number(_unquote(self.next()))
            close_tok = self.next()
            if close_tok not in (")", "]"):
                raise LogParseError(f"expected ) or ] closing IN, got {close_tok!r}")
            return Rng(first, lo, hi, open_tok == "[", close_tok == "]")
        if raw == "*":
            return MatchAll()
        return Term(None, "match", first)


def _number(s: str) -> float:
    try:
        return float(s)
    except ValueError:
        raise LogParseError(f"expected a number, got {s!r}") from None


def _number_or_str(s: str) -> float | str:
    try:
        return float(s)
    except ValueError:
        return s


def parse_log_query(text: str) -> LogQuery:
    """Parse a pipe-syntax log query. Empty/blank/'*' = match everything."""
    text = text.strip()
    if not text:
        return LogQuery()
    return _Parser(_tokenize(text)).parse_query()


# -- compilation to InfluxQL WHERE -------------------------------------------


def _quote_str(v: str) -> str:
    return "'" + v.replace("\\", "\\\\").replace("'", "\\'") + "'"


def _quote_ident(name: str) -> str:
    return '"' + name.replace('"', '\\"') + '"'


def to_influxql_where(node, aliases: set[str] | None = None) -> str | None:
    """Compile the condition tree to an InfluxQL WHERE fragment for the
    engine scan. Terms that reference EXTRACT aliases cannot run in the
    engine (the field does not exist in storage) — they are skipped here
    and enforced post-extract by ``alias_row_filter``. Returns None when
    nothing remains (scan everything)."""
    aliases = aliases or set()

    def emit(n) -> str | None:
        if isinstance(n, MatchAll):
            return None
        if isinstance(n, Term):
            if n.field in aliases:
                return None
            fld = n.field or DEFAULT_FIELD
            qf = _quote_ident(fld)
            if n.op == "match":
                # match values are always strings (parse_term builds them
                # via _unquote only)
                if not _has_tokens(n.value):
                    # no indexable tokens (punctuation-only): exact compare
                    return f"{qf} = {_quote_str(str(n.value))}"
                if fld == DEFAULT_FIELD:
                    return f"match({qf}, {_quote_str(n.value)})"
                # non-content fields: phrase match degenerates to equality
                # for tags/enum-ish fields, which is the common log shape
                # (level: error, host: web-1); content gets the text index
                return f"{qf} = {_quote_str(n.value)}"
            op = {"eq": "=", "neq": "!=", "lt": "<", "lte": "<=",
                  "gt": ">", "gte": ">="}[n.op]
            if isinstance(n.value, float):
                return f"{qf} {op} {n.value!r}"
            return f"{qf} {op} {_quote_str(n.value)}"
        if isinstance(n, Rng):
            if n.field in aliases:
                return None
            qf = _quote_ident(n.field)
            lo_op = ">=" if n.lo_incl else ">"
            hi_op = "<=" if n.hi_incl else "<"
            return f"({qf} {lo_op} {n.lo!r} AND {qf} {hi_op} {n.hi!r})"
        if isinstance(n, And):
            parts = [p for p in (emit(c) for c in n.children) if p]
            if not parts:
                return None
            return "(" + " AND ".join(parts) + ")"
        if isinstance(n, Or):
            parts = [emit(c) for c in n.children]
            if any(p is None for p in parts):
                # an un-pushable OR arm makes the whole OR un-pushable
                # (the engine would wrongly exclude rows the arm accepts)
                return None
            return "(" + " OR ".join(parts) + ")"
        raise LogParseError(f"unsupported node {n!r}")

    return emit(node) if node is not None else None


_TOKEN_RE = re.compile(r"[A-Za-z0-9_]+")


def _has_tokens(s: str) -> bool:
    return bool(_TOKEN_RE.search(s))


def alias_row_filter(node, aliases: set[str]):
    """Build a row-level predicate fn(rowdict) -> bool enforcing every
    part of the condition tree that references EXTRACT aliases (those are
    skipped by to_influxql_where). Non-alias terms evaluate True here —
    the engine already enforced them — EXCEPT inside OR nodes containing
    alias arms, where the whole OR is evaluated row-level (it was not
    pushed down)."""

    def _term_pred(n, row) -> bool:
        if isinstance(n, MatchAll):
            return True
        if isinstance(n, Term):
            v = row.get(n.field or DEFAULT_FIELD)
            if v is None:
                return False
            if n.op == "match":
                toks = _TOKEN_RE.findall(str(n.value).lower())
                if not toks:
                    return str(v) == str(n.value)
                hay = set(_TOKEN_RE.findall(str(v).lower()))
                return all(t.lower() in hay for t in toks)
            try:
                a = float(v)
                b = float(n.value)
            except (TypeError, ValueError):
                a, b = str(v), str(n.value)
            return {
                "eq": a == b, "neq": a != b, "lt": a < b,
                "lte": a <= b, "gt": a > b, "gte": a >= b,
            }[n.op]
        if isinstance(n, Rng):
            v = row.get(n.field)
            try:
                x = float(v)
            except (TypeError, ValueError):
                return False
            lo_ok = x >= n.lo if n.lo_incl else x > n.lo
            hi_ok = x <= n.hi if n.hi_incl else x < n.hi
            return lo_ok and hi_ok
        if isinstance(n, And):
            return all(_term_pred(c, row) for c in n.children)
        if isinstance(n, Or):
            return any(_term_pred(c, row) for c in n.children)
        return True

    def _needs_row_eval(n) -> bool:
        if isinstance(n, (Term, Rng)):
            f = n.field if isinstance(n, Rng) else (n.field or DEFAULT_FIELD)
            return f in aliases
        if isinstance(n, And):
            return any(_needs_row_eval(c) for c in n.children)
        if isinstance(n, Or):
            return any(_needs_row_eval(c) for c in n.children)
        return False

    def pred(row: dict) -> bool:
        def walk(n) -> bool:
            if isinstance(n, And):
                return all(walk(c) for c in n.children)
            if isinstance(n, Or):
                # ORs with any alias arm were not pushed down: evaluate fully
                if _needs_row_eval(n):
                    return _term_pred(n, row)
                return True
            if isinstance(n, (Term, Rng)):
                if _needs_row_eval(n):
                    return _term_pred(n, row)
                return True
            return True

        return walk(node) if node is not None else True

    return pred


def apply_extract(extract: Extract | None, rows: list[dict]) -> None:
    """Run the EXTRACT regex over each row's source field, attaching alias
    fields in place (reference Unnest/match_all). Non-matching rows keep
    the aliases absent."""
    if extract is None:
        return
    rx = re.compile(extract.pattern)
    for row in rows:
        src = row.get(extract.source)
        if src is None:
            continue
        m = rx.search(str(src))
        if m is None:
            continue
        for alias, val in zip(extract.aliases, m.groups()):
            if val is not None:
                row[alias] = val
