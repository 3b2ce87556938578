"""PromQL parser (executed subset).

Grammar covered: vector selectors with label matchers, range selectors,
offset, number literals, function calls, aggregation operators with
by/without clauses, scalar<->vector binary arithmetic and vector/vector
arithmetic on matching label sets, parentheses.

Reference grammar: promql2influxql (transpiler.go:45) drives Prometheus'
own parser; this is a standalone hand-written equivalent for the engine's
surface.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


class PromParseError(ValueError):
    pass


@dataclass(frozen=True)
class LabelMatcher:
    name: str
    op: str  # = != =~ !~
    value: str


@dataclass
class VectorSelector:
    metric: str = ""
    matchers: list[LabelMatcher] = field(default_factory=list)
    offset_s: float = 0.0


@dataclass
class MatrixSelector:
    vector: VectorSelector = None
    range_s: float = 0.0


@dataclass
class Subquery:
    """expr[range:step] — the inner expression evaluated on an
    absolutely-aligned step grid, consumed like a range vector."""

    expr: object = None
    range_s: float = 0.0
    step_s: float | None = None  # None: engine default resolution
    offset_s: float = 0.0


@dataclass
class NumberLit:
    val: float = 0.0


@dataclass
class StringLit:
    val: str = ""


@dataclass
class FunctionCall:
    name: str = ""
    args: list = field(default_factory=list)


@dataclass
class Aggregation:
    op: str = ""
    expr: object = None
    grouping: list[str] = field(default_factory=list)
    without: bool = False
    param: object = None  # topk/quantile first arg


@dataclass
class VectorMatching:
    """on()/ignoring() + group_left/group_right modifiers.
    Reference: promql2influxql/binary_expr.go:308 (On/MatchKeys/
    MatchCard/IncludeKeys) driving Prometheus' VectorMatching."""

    on: bool = False  # True: on(labels); False: ignoring(labels)
    labels: list[str] = field(default_factory=list)
    card: str = "one-to-one"  # |many-to-one|one-to-many|many-to-many
    include: list[str] = field(default_factory=list)


@dataclass
class BinaryOp:
    op: str = ""
    lhs: object = None
    rhs: object = None
    bool_mod: bool = False
    matching: VectorMatching | None = None


AGG_OPS = {"sum", "avg", "min", "max", "count", "topk", "bottomk", "quantile",
           "stddev", "stdvar", "group", "count_values"}
FUNCTIONS = {
    "rate", "irate", "increase", "delta", "idelta", "changes", "resets",
    "avg_over_time", "min_over_time", "max_over_time", "sum_over_time",
    "count_over_time", "last_over_time", "stddev_over_time",
    "stdvar_over_time", "quantile_over_time", "mad_over_time",
    "present_over_time", "absent_over_time",
    "deriv", "predict_linear", "holt_winters", "double_exponential_smoothing",
    "abs", "ceil", "floor", "round", "exp", "ln", "log2", "log10", "sqrt",
    "sgn", "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
    "tanh", "asinh", "acosh", "atanh", "deg", "rad", "pi",
    "clamp", "clamp_min", "clamp_max", "scalar", "vector", "timestamp",
    "histogram_quantile", "absent", "time", "minute", "hour",
    "day_of_month", "day_of_week", "day_of_year", "days_in_month",
    "month", "year", "label_replace", "label_join",
    "sort", "sort_desc", "sort_by_label", "sort_by_label_desc",
}

_DUR = re.compile(r"(\d+(?:\.\d+)?)(ms|s|m|h|d|w|y)")
_DUR_S = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0,
          "w": 604800.0, "y": 31536000.0}


def parse_duration_s(s: str) -> float:
    total = 0.0
    pos = 0
    while pos < len(s):
        m = _DUR.match(s, pos)
        if not m:
            raise PromParseError(f"bad duration {s!r}")
        total += float(m.group(1)) * _DUR_S[m.group(2)]
        pos = m.end()
    return total


class _Lexer:
    _TOKEN = re.compile(
        r"\s*(?:"
        r"(?P<dur>\d+(?:\.\d+)?(?:ms|s|m|h|d|w|y)(?:\d+(?:\.\d+)?(?:ms|s|m|h|d|w|y))*)"
        r"|(?P<num>\d+\.?\d*(?:[eE][+-]?\d+)?)"
        r"|(?P<id>[a-zA-Z_:][a-zA-Z0-9_:]*)"
        r"|(?P<str>\"(?:[^\"\\]|\\.)*\"|'(?:[^'\\]|\\.)*')"
        r"|(?P<op>=~|!~|!=|==|>=|<=|[-+*/%^(){}\[\],=<>])"
        r")"
    )

    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.toks: list[tuple[str, str]] = []
        self._tokenize()
        self.i = 0

    def _tokenize(self):
        n = len(self.text)
        pos = 0
        while pos < n:
            if self.text[pos].isspace():
                pos += 1
                continue
            m = self._TOKEN.match(self.text, pos)
            if not m:
                raise PromParseError(f"bad token at {pos}: {self.text[pos:pos+10]!r}")
            if m.group("dur"):
                self.toks.append(("DUR", m.group("dur")))
            elif m.group("num"):
                self.toks.append(("NUM", m.group("num")))
            elif m.group("id"):
                self.toks.append(("ID", m.group("id")))
            elif m.group("str"):
                raw = m.group("str")
                self.toks.append(("STR", _unquote(raw)))
            else:
                self.toks.append(("OP", m.group("op")))
            pos = m.end()

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else ("EOF", "")

    def next(self):
        t = self.peek()
        self.i += 1
        return t


def _unquote(raw: str) -> str:
    body = raw[1:-1]
    return body.replace('\\"', '"').replace("\\'", "'").replace("\\\\", "\\")


_PREC = {"or": 1, "and": 2, "unless": 2, "==": 3, "!=": 3, "<": 3, ">": 3,
         "<=": 3, ">=": 3, "+": 4, "-": 4, "*": 5, "/": 5, "%": 5,
         "atan2": 5, "^": 6}
COMPARISONS = {"==", "!=", "<", ">", "<=", ">="}
SET_OPS = {"and", "or", "unless"}


def parse(text: str):
    lx = _Lexer(text)
    expr = _parse_expr(lx, 1)
    if lx.peek()[0] != "EOF":
        raise PromParseError(f"unexpected trailing token {lx.peek()[1]!r}")
    return expr


def _parse_expr(lx: _Lexer, min_prec: int):
    lhs = _parse_primary(lx)
    while True:
        kind, val = lx.peek()
        op = None
        if kind == "OP" and val in _PREC:
            op = val
        elif kind == "ID" and val in ("and", "or", "unless", "atan2"):
            op = val
        if op is None or _PREC[op] < min_prec:
            return lhs
        lx.next()
        bool_mod, matching = _parse_binop_modifiers(lx, op)
        # ^ is right-associative in PromQL; all others left-associative
        next_min = _PREC[op] if op == "^" else _PREC[op] + 1
        rhs = _parse_expr(lx, next_min)
        lhs = BinaryOp(op, lhs, rhs, bool_mod, matching)


def _parse_binop_modifiers(lx: _Lexer, op: str):
    """[bool] [on(...)|ignoring(...)] [group_left|group_right [(...)]]
    after a binary operator, with Prometheus' validity rules."""
    bool_mod = False
    if lx.peek() == ("ID", "bool"):
        if op not in COMPARISONS:
            raise PromParseError(
                "bool modifier can only be used on comparison operators")
        lx.next()
        bool_mod = True
    matching = None
    if lx.peek() in (("ID", "on"), ("ID", "ignoring")):
        on = lx.next()[1] == "on"
        matching = VectorMatching(
            on, _parse_grouping(lx),
            "many-to-many" if op in SET_OPS else "one-to-one",
        )
        if lx.peek() in (("ID", "group_left"), ("ID", "group_right")):
            which = lx.next()[1]
            if op in SET_OPS:
                raise PromParseError(
                    f"no grouping allowed for {op!r} operation")
            matching.card = ("many-to-one" if which == "group_left"
                             else "one-to-many")
            if lx.peek() == ("OP", "("):
                matching.include = _parse_grouping(lx)
            if on:
                for ln in matching.include:
                    if ln in matching.labels:
                        raise PromParseError(
                            f"label {ln!r} must not occur in ON and "
                            "GROUP clauses at once")
    elif op in SET_OPS:
        matching = VectorMatching(False, [], "many-to-many")
    if lx.peek() in (("ID", "group_left"), ("ID", "group_right")):
        raise PromParseError(
            f"unexpected {lx.peek()[1]!r}: grouping modifiers require "
            "on(...) or ignoring(...) first")
    return bool_mod, matching


def _parse_primary(lx: _Lexer):
    kind, val = lx.peek()
    if kind == "NUM":
        lx.next()
        return NumberLit(float(val))
    if kind == "STR":
        lx.next()
        return StringLit(val)
    if kind == "OP" and val == "-":
        lx.next()
        # unary minus binds looser than ^ in PromQL: -2^2 == -(2^2)
        inner = _parse_expr(lx, _PREC["^"])
        return BinaryOp("*", NumberLit(-1.0), inner)
    if kind == "OP" and val == "(":
        lx.next()
        e = _parse_expr(lx, 1)
        _expect(lx, ")")
        return _maybe_range(lx, e)
    if kind == "OP" and val == "{":
        vs = _parse_selector(lx, "")
        return _maybe_range(lx, vs)
    if kind == "ID":
        lx.next()
        if val in AGG_OPS:
            return _maybe_range(lx, _parse_aggregation(lx, val))
        if lx.peek() == ("OP", "(") and val in FUNCTIONS:
            lx.next()
            args = []
            if lx.peek() != ("OP", ")"):
                args.append(_parse_expr(lx, 1))
                while lx.peek() == ("OP", ","):
                    lx.next()
                    args.append(_parse_expr(lx, 1))
            _expect(lx, ")")
            return _maybe_range(lx, FunctionCall(val, args))
        return _maybe_range(lx, _parse_selector(lx, val))
    raise PromParseError(f"unexpected token {val!r}")


def _parse_selector(lx: _Lexer, metric: str) -> VectorSelector:
    matchers: list[LabelMatcher] = []
    if lx.peek() == ("OP", "{"):
        lx.next()
        while lx.peek() != ("OP", "}"):
            kind, name = lx.next()
            if kind != "ID":
                raise PromParseError(f"expected label name, got {name!r}")
            okind, op = lx.next()
            if okind != "OP" or op not in ("=", "!=", "=~", "!~"):
                raise PromParseError(f"bad matcher op {op!r}")
            skind, sval = lx.next()
            if skind != "STR":
                raise PromParseError("matcher value must be a string")
            matchers.append(LabelMatcher(name, op, sval))
            if lx.peek() == ("OP", ","):
                lx.next()
        _expect(lx, "}")
    vs = VectorSelector(metric, matchers)
    if lx.peek() == ("ID", "offset"):
        lx.next()
        kind, d = lx.next()
        if kind != "DUR":
            raise PromParseError("offset expects a duration")
        vs.offset_s = parse_duration_s(d)
    return vs


def _maybe_range(lx: _Lexer, expr):
    if lx.peek() == ("OP", "["):
        lx.next()
        kind, d = lx.next()
        if kind != "DUR":
            raise PromParseError("range selector expects a duration")
        nk, nv = lx.peek()
        if nk == "ID" and nv.startswith(":"):
            # subquery: expr[range:step] (the lexer folds ':1m' into one
            # ID token because recording-rule names may contain colons)
            lx.next()
            step_txt = nv[1:]
            if not step_txt and lx.peek()[0] == "DUR":  # '[5m : 1m]'
                step_txt = lx.next()[1]
            step_s = parse_duration_s(step_txt) if step_txt else None
            _expect(lx, "]")
            sq = Subquery(expr, parse_duration_s(d), step_s)
            sq.offset_s = _maybe_offset(lx)
            return _maybe_range(lx, sq)  # nested subqueries: sq[r:s]
        _expect(lx, "]")
        if not isinstance(expr, VectorSelector):
            raise PromParseError(
                "range selector requires a vector selector "
                "(use expr[range:step] for subqueries)"
            )
        ms = MatrixSelector(expr, parse_duration_s(d))
        expr.offset_s = _maybe_offset(lx) or expr.offset_s
        return ms
    return expr


def _maybe_offset(lx: _Lexer) -> float:
    if lx.peek() == ("ID", "offset"):
        lx.next()
        k2, d2 = lx.next()
        if k2 != "DUR":
            raise PromParseError("offset expects a duration")
        return parse_duration_s(d2)
    return 0.0


def _parse_aggregation(lx: _Lexer, op: str) -> Aggregation:
    agg = Aggregation(op)
    # by/without before parens
    if lx.peek() in (("ID", "by"), ("ID", "without")):
        agg.without = lx.next()[1] == "without"
        agg.grouping = _parse_grouping(lx)
    _expect(lx, "(")
    first = _parse_expr(lx, 1)
    if lx.peek() == ("OP", ","):
        lx.next()
        agg.param = first
        agg.expr = _parse_expr(lx, 1)
    else:
        agg.expr = first
    _expect(lx, ")")
    if lx.peek() in (("ID", "by"), ("ID", "without")):
        agg.without = lx.next()[1] == "without"
        agg.grouping = _parse_grouping(lx)
    return agg


def _parse_grouping(lx: _Lexer) -> list[str]:
    _expect(lx, "(")
    names = []
    while lx.peek() != ("OP", ")"):
        kind, v = lx.next()
        if kind != "ID":
            raise PromParseError(f"expected label, got {v!r}")
        names.append(v)
        if lx.peek() == ("OP", ","):
            lx.next()
    _expect(lx, ")")
    return names


def _expect(lx: _Lexer, op: str):
    kind, val = lx.next()
    if kind != "OP" or val != op:
        raise PromParseError(f"expected {op!r}, got {val!r}")
