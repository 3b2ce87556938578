"""InfluxQL recursive-descent parser.

Covers the surface the engine executes: SELECT (aggregates, selectors,
math expressions, WHERE with time/tag/field conditions, GROUP BY
time(...)/tags/*, FILL, ORDER BY time, LIMIT/OFFSET/SLIMIT/SOFFSET, INTO,
subqueries), SHOW {DATABASES, MEASUREMENTS, TAG KEYS/VALUES, FIELD KEYS,
SERIES, RETENTION POLICIES}, CREATE/DROP DATABASE, CREATE/DROP RETENTION
POLICY, DROP MEASUREMENT.

Reference grammar: lib/util/lifted/influx/influxql (yacc sql.y).
"""

from __future__ import annotations

import re

from opengemini_tpu_torch.sql import ast
from opengemini_tpu_torch.sql.lexer import Lexer, Token


class ParseError(ValueError):
    pass


# operator precedence, low to high (influxql)
_PRECEDENCE = {
    "or": 1,
    "and": 2,
    "=": 3, "!=": 3, "<>": 3, "<": 3, "<=": 3, ">": 3, ">=": 3, "=~": 3, "!~": 3,
    "+": 4, "-": 4,
    "*": 5, "/": 5, "%": 5,
}


def _attach_ctes(stmt, ctes: dict) -> None:
    """Make WITH bindings visible to the statement and every nested select
    (subqueries, join sides, IN-subqueries, and the CTE bodies themselves,
    so CTEs can reference other CTEs)."""
    seen: set[int] = set()

    def walk(s):
        if s is None or id(s) in seen:
            return
        seen.add(id(s))
        if isinstance(s, ast.UnionStatement):
            s.ctes = ctes
            for sel in s.selects:
                walk(sel)
            return
        if not isinstance(s, ast.SelectStatement):
            return
        s.ctes = ctes
        for src in s.sources:
            walk_source(src)
        walk_cond(s.condition)

    def walk_source(src):
        if isinstance(src, ast.SubQuery):
            walk(src.stmt)
        elif isinstance(src, ast.JoinSource):
            walk_source(src.left)
            walk_source(src.right)

    def walk_cond(e):
        if e is None:
            return
        if isinstance(e, ast.InSubquery):
            walk(e.stmt)
        elif isinstance(e, ast.BinaryExpr):
            walk_cond(e.lhs)
            walk_cond(e.rhs)
        elif isinstance(e, (ast.ParenExpr,)):
            walk_cond(e.expr)
        elif isinstance(e, ast.UnaryExpr):
            walk_cond(e.expr)

    walk(stmt)
    for body in ctes.values():
        walk(body)


def parse(text: str):
    """Parse one or more ;-separated statements; returns a list."""
    p = Parser(text)
    stmts = []
    while True:
        tok = p.lex.peek()
        if tok.kind == "EOF":
            break
        if tok.kind == "OP" and tok.val == ";":
            p.lex.next()
            continue
        stmts.append(p.parse_statement())
    return stmts


def parse_one(text: str):
    stmts = parse(text)
    if len(stmts) != 1:
        raise ParseError(f"expected exactly one statement, got {len(stmts)}")
    return stmts[0]


class Parser:
    def __init__(self, text: str):
        self.lex = Lexer(text)

    # -- helpers ------------------------------------------------------------

    def _expect_kw(self, *words: str) -> str:
        tok = self.lex.next()
        if tok.kind != "KEYWORD" or tok.val not in words:
            raise ParseError(f"expected {'/'.join(words).upper()}, got {tok.val!r}")
        return tok.val

    def _accept_kw(self, *words: str) -> str | None:
        tok = self.lex.peek()
        if tok.kind == "KEYWORD" and tok.val in words:
            self.lex.next()
            return tok.val
        return None

    def _duration_tok(self, clause: str) -> int:
        t = self.lex.next()
        if t.kind != "DURATION":
            raise ParseError(f"{clause} expects a duration")
        return t.val

    def _duration_list(self, clause: str) -> list[int]:
        out = [self._duration_tok(clause)]
        while self._accept_op(","):
            out.append(self._duration_tok(clause))
        return out

    def _expect_op(self, op: str) -> None:
        tok = self.lex.next()
        if tok.kind != "OP" or tok.val != op:
            raise ParseError(f"expected {op!r}, got {tok.val!r}")

    def _accept_op(self, op: str) -> bool:
        tok = self.lex.peek()
        if tok.kind == "OP" and tok.val == op:
            self.lex.next()
            return True
        return False

    def _accept_word(self, word: str) -> bool:
        """Contextual (non-reserved) keyword: matches an IDENT or KEYWORD
        token case-insensitively. MODEL/ALGORITHM/THRESHOLD stay usable as
        field/tag names this way."""
        tok = self.lex.peek()
        if tok.kind in ("IDENT", "KEYWORD") and tok.val.lower() == word:
            self.lex.next()
            return True
        return False

    def _expect_word(self, word: str) -> None:
        if not self._accept_word(word):
            raise ParseError(f"expected {word.upper()}")

    def _ident(self, allow_string: bool = False) -> str:
        tok = self.lex.next()
        if tok.kind == "IDENT":
            return tok.val
        # unreserved keywords usable as identifiers
        if tok.kind == "KEYWORD":
            return tok.val
        if allow_string and tok.kind == "STRING":
            # openGemini allows single-quoted aliases: AS 'name'
            # (TestServer_Query_Constant_Column)
            return tok.val
        raise ParseError(f"expected identifier, got {tok.val!r}")

    # -- statements ---------------------------------------------------------

    def parse_statement(self):
        # hints recorded before this statement's SELECT belong to nobody
        self.lex.hints.clear()
        tok = self.lex.peek()
        if tok.kind != "KEYWORD":
            raise ParseError(f"expected statement, got {tok.val!r}")
        if tok.val == "select":
            return self.parse_select_or_union()
        if tok.val == "with":
            return self.parse_with()
        if tok.val == "explain":
            self.lex.next()
            analyze = self._accept_kw("analyze") is not None
            return ast.ExplainStatement(self.parse_select(), analyze)
        if tok.val == "show":
            return self.parse_show()
        if tok.val == "create":
            return self.parse_create()
        if tok.val == "drop":
            return self.parse_drop()
        if tok.val == "alter":
            return self.parse_alter()
        if tok.val == "grant":
            return self.parse_grant()
        if tok.val == "revoke":
            return self.parse_revoke()
        if tok.val == "set":
            return self.parse_set_password()
        if tok.val == "delete":
            return self.parse_delete()
        if tok.val == "kill":
            self.lex.next()
            self._expect_kw("query")
            t = self.lex.next()
            if t.kind != "INTEGER":
                raise ParseError("KILL QUERY expects a query id")
            return ast.KillQuery(t.val)
        raise ParseError(f"unsupported statement start: {tok.val!r}")

    def parse_grant(self):
        self._expect_kw("grant")
        priv = self._expect_kw("read", "write", "all")
        self._accept_kw("privileges")
        if self._accept_kw("on"):
            db = self._ident()
            self._expect_kw("to")
            return ast.GrantStatement(priv.upper(), db, self._ident())
        self._expect_kw("to")  # GRANT ALL PRIVILEGES TO u -> admin
        return ast.GrantStatement(priv.upper(), "", self._ident())

    def parse_revoke(self):
        self._expect_kw("revoke")
        priv = self._expect_kw("read", "write", "all")
        self._accept_kw("privileges")
        if self._accept_kw("on"):
            db = self._ident()
            self._expect_kw("from")
            return ast.RevokeStatement(priv.upper(), db, self._ident())
        self._expect_kw("from")
        return ast.RevokeStatement(priv.upper(), "", self._ident())

    def parse_set_password(self):
        self._expect_kw("set")
        self._expect_kw("password")
        self._expect_kw("for")
        name = self._ident()
        self._expect_op("=")
        tok = self.lex.next()
        if tok.kind != "STRING":
            raise ParseError("SET PASSWORD expects a quoted string")
        return ast.SetPassword(name, tok.val)

    def parse_delete(self):
        self._expect_kw("delete")
        stmt = ast.DeleteSeries()
        if self._accept_kw("from"):
            stmt.measurement = self._ident()
        if self._accept_kw("where"):
            stmt.condition = self._parse_expr()
        return stmt

    def parse_with(self):
        """WITH name AS (SELECT ...), ... SELECT ... — common table
        expressions (reference: LogicalCTE, logic_plan.go:3769)."""
        self._expect_kw("with")
        ctes: dict = {}
        while True:
            name = self._ident()
            self._expect_kw("as")
            self._expect_op("(")
            ctes[name] = self.parse_select_or_union()
            self._expect_op(")")
            if not self._accept_op(","):
                break
        tok = self.lex.peek()
        if not (tok.kind == "KEYWORD" and tok.val == "select"):
            raise ParseError("WITH must be followed by SELECT")
        stmt = self.parse_select_or_union()
        _attach_ctes(stmt, ctes)
        return stmt

    def parse_select_or_union(self):
        first = self._parse_union_unit()
        tok = self.lex.peek()
        if not (tok.kind == "KEYWORD" and tok.val == "union"):
            return first
        selects, combines = [first], []
        while self._accept_kw("union"):
            all_ = bool(self._accept_kw("all"))
            by_name = False
            if self._accept_kw("by"):
                self._expect_kw("name")
                by_name = True
            selects.append(self._parse_union_unit())
            combines.append((all_, by_name))
        return ast.UnionStatement(selects, combines)

    def _parse_union_unit(self):
        tok = self.lex.peek()
        if tok.kind == "OP" and tok.val == "(":
            self.lex.next()
            inner = self.parse_select_or_union()
            self._expect_op(")")
            return inner
        return self.parse_select()

    def parse_select(self) -> ast.SelectStatement:
        self._expect_kw("select")
        stmt = ast.SelectStatement()
        stmt.fields = self._parse_fields()
        # hints appear between SELECT and the field list (/*+ ... */);
        # the lexer records them while skipping comments — drain them to
        # THIS statement so multi-statement inputs don't leak hints
        if self.lex.hints:
            stmt.hints = tuple(self.lex.hints)
            self.lex.hints.clear()
        if self._accept_kw("into"):
            stmt.into = self._parse_measurement()
        self._expect_kw("from")
        stmt.sources = self._parse_sources()
        if self._accept_kw("where"):
            stmt.condition = self._parse_expr()
        if self._accept_kw("group"):
            self._expect_kw("by")
            self._parse_group_by(stmt)
        if self._accept_kw("fill"):
            self._parse_fill(stmt)
        if self._accept_kw("order"):
            self._expect_kw("by")
            name = self._ident()
            if name.lower() != "time":
                raise ParseError("only ORDER BY time is supported")
            if self._accept_kw("desc"):
                stmt.ascending = False
            else:
                self._accept_kw("asc")
        stmt.limit = self._parse_int_clause("limit")
        stmt.offset = self._parse_int_clause("offset")
        stmt.slimit = self._parse_int_clause("slimit")
        stmt.soffset = self._parse_int_clause("soffset")
        if self._accept_kw("tz"):
            self._expect_op("(")
            tok = self.lex.next()
            if tok.kind != "STRING":
                raise ParseError("TZ expects a string")
            stmt.tz = tok.val
            self._expect_op(")")
        # hints only count between SELECT and the field list; any recorded
        # later in the statement are discarded so they can't leak into the
        # NEXT statement of a multi-statement input
        self.lex.hints.clear()
        return stmt

    def _parse_int_clause(self, kw: str) -> int:
        if self._accept_kw(kw):
            tok = self.lex.next()
            if tok.kind != "INTEGER":
                raise ParseError(f"{kw.upper()} expects an integer")
            return tok.val
        return 0

    def _parse_fields(self) -> list[ast.Field]:
        fields = []
        while True:
            expr = self._parse_expr()
            alias = ""
            if self._accept_kw("as"):
                alias = self._ident(allow_string=True)
            fields.append(ast.Field(expr, alias))
            if not self._accept_op(","):
                break
        return fields

    def _parse_sources(self) -> list:
        sources = [self._parse_source_join()]
        while self._accept_op(","):
            sources.append(self._parse_source_join())
        return sources

    def _parse_single_source(self):
        import dataclasses

        tok = self.lex.peek(allow_regex=True)
        if tok.kind == "REGEX":
            self.lex.next(allow_regex=True)
            src = ast.Measurement(regex=tok.val)
        elif tok.kind == "OP" and tok.val == "(":
            self.lex.next()
            sub = self.parse_select()
            self._expect_op(")")
            src = ast.SubQuery(sub)
        else:
            src = self._parse_measurement()
        if self._accept_kw("as"):
            src = dataclasses.replace(src, alias=self._ident())
        return src

    def _parse_source_join(self):
        src = self._parse_single_source()
        while True:
            kind = self._accept_join_kind()
            if kind is None:
                return src
            right = self._parse_single_source()
            self._expect_kw("on")
            on = self._parse_expr()
            src = ast.JoinSource(src, right, kind, on)

    def _accept_join_kind(self) -> str | None:
        """JOIN | INNER JOIN | LEFT [OUTER] JOIN | RIGHT [OUTER] JOIN |
        FULL [OUTER] JOIN | OUTER JOIN (reference: influxql.y join rules;
        `outer join` keeps nulls, `full join` zero-fills — observed
        server_test.go join tables)."""
        if self._accept_kw("join"):
            return "inner"
        if self._accept_kw("inner"):
            self._expect_kw("join")
            return "inner"
        for k in ("left", "right"):
            if self._accept_kw(k):
                self._accept_kw("outer")
                self._expect_kw("join")
                return k
        if self._accept_kw("full"):
            self._accept_kw("outer")
            self._expect_kw("join")
            return "full"
        if self._accept_kw("outer"):
            self._expect_kw("join")
            return "outer"
        return None

    def _parse_measurement(self) -> ast.Measurement:
        # [db [.rp]] . name   with each part optionally quoted; or name only
        parts = [self._ident()]
        while self._accept_op("."):
            tok = self.lex.peek(allow_regex=True)
            if tok.kind == "OP" and tok.val == ".":
                parts.append("")  # empty rp: db..measurement
                continue
            if tok.kind == "REGEX":
                self.lex.next(allow_regex=True)
                if len(parts) == 1:
                    return ast.Measurement(database=parts[0], regex=tok.val)
                return ast.Measurement(database=parts[0], rp=parts[1], regex=tok.val)
            parts.append(self._ident())
        if len(parts) == 1:
            return ast.Measurement(name=parts[0])
        if len(parts) == 2:
            return ast.Measurement(database=parts[0], name=parts[1])
        if len(parts) == 3:
            return ast.Measurement(database=parts[0], rp=parts[1], name=parts[2])
        raise ParseError("too many dots in measurement")

    def _parse_group_by(self, stmt: ast.SelectStatement) -> None:
        while True:
            tok = self.lex.peek(allow_regex=True)
            if tok.kind == "OP" and tok.val == "*":
                self.lex.next()
                stmt.group_by_all_tags = True
            elif tok.kind == "IDENT" and tok.val.lower() == "time":
                self.lex.next()
                self._expect_op("(")
                t = self.lex.next()
                if t.kind != "DURATION":
                    raise ParseError("time() expects a duration")
                offset = 0
                if self._accept_op(","):
                    t2 = self.lex.next()
                    sign = 1
                    if t2.kind == "OP" and t2.val == "-":
                        sign = -1
                        t2 = self.lex.next()
                    if t2.kind != "DURATION":
                        raise ParseError("time() offset expects a duration")
                    offset = sign * t2.val
                self._expect_op(")")
                stmt.group_by_time = ast.TimeDimension(t.val, offset)
            elif tok.kind in ("IDENT", "KEYWORD"):
                name = self._ident()
                stmt.group_by_tags.append(name)
            else:
                raise ParseError(f"bad GROUP BY element: {tok.val!r}")
            if not self._accept_op(","):
                break

    def _parse_fill(self, stmt: ast.SelectStatement) -> None:
        self._expect_op("(")
        tok = self.lex.next()
        if tok.kind == "KEYWORD" and tok.val in ("null", "none", "previous", "linear"):
            stmt.fill_option = tok.val
        elif tok.kind in ("NUMBER", "INTEGER"):
            stmt.fill_option = "number"
            stmt.fill_value = float(tok.val)
        elif tok.kind == "OP" and tok.val == "-":
            t2 = self.lex.next()
            if t2.kind not in ("NUMBER", "INTEGER"):
                raise ParseError("bad fill value")
            stmt.fill_option = "number"
            stmt.fill_value = -float(t2.val)
        else:
            raise ParseError(f"bad FILL option: {tok.val!r}")
        self._expect_op(")")

    # -- expressions --------------------------------------------------------

    def _parse_expr(self, min_prec: int = 1):
        lhs = self._parse_unary()
        while True:
            tok = self.lex.peek()
            op = None
            if tok.kind == "OP" and tok.val in _PRECEDENCE:
                op = tok.val
            elif tok.kind == "KEYWORD" and tok.val in ("and", "or"):
                op = tok.val
            if op is None:
                if tok.kind == "KEYWORD" and tok.val == "in" and min_prec <= 3:
                    self.lex.next()
                    lhs = self._parse_in(lhs)
                    continue
                return lhs
            prec = _PRECEDENCE[op]
            if prec < min_prec:
                return lhs
            self.lex.next()
            if op in ("=~", "!~"):
                rtok = self.lex.next(allow_regex=True)
                if rtok.kind != "REGEX":
                    raise ParseError(f"{op} expects a regex")
                rhs = ast.RegexLiteral(rtok.val)
            else:
                rhs = self._parse_expr(prec + 1)
            lhs = ast.BinaryExpr("AND" if op == "and" else ("OR" if op == "or" else op), lhs, rhs)

    def _parse_in(self, lhs):
        """<ref> IN (SELECT ...) or <ref> IN (lit, lit, ...) — the literal
        form desugars to an OR chain of equalities."""
        self._expect_op("(")
        tok = self.lex.peek()
        if tok.kind == "KEYWORD" and tok.val == "select":
            sub = self.parse_select()
            self._expect_op(")")
            return ast.InSubquery(lhs, sub)
        out = None
        while True:
            lit = self._parse_expr()
            eq = ast.BinaryExpr("=", lhs, lit)
            out = eq if out is None else ast.BinaryExpr("OR", out, eq)
            if not self._accept_op(","):
                break
        self._expect_op(")")
        return out

    def _parse_unary(self):
        tok = self.lex.peek()
        if tok.kind == "OP" and tok.val == "-":
            self.lex.next()
            return ast.UnaryExpr("-", self._parse_unary())
        if tok.kind == "OP" and tok.val == "+":
            self.lex.next()
            return self._parse_unary()
        return self._parse_primary()

    def _parse_primary(self):
        tok = self.lex.next()
        if tok.kind == "OP" and tok.val == "(":
            e = self._parse_expr()
            self._expect_op(")")
            return ast.ParenExpr(e)
        if tok.kind == "NUMBER":
            return ast.NumberLiteral(tok.val)
        if tok.kind == "INTEGER":
            return ast.IntegerLiteral(tok.val)
        if tok.kind == "DURATION":
            return ast.DurationLiteral(tok.val)
        if tok.kind == "STRING":
            return ast.StringLiteral(tok.val)
        if tok.kind == "OP" and tok.val == "*":
            return ast.Wildcard()
        if tok.kind == "KEYWORD" and tok.val == "true":
            return ast.BooleanLiteral(True)
        if tok.kind == "KEYWORD" and tok.val == "false":
            return ast.BooleanLiteral(False)
        if tok.kind == "OP" and tok.val == "$":
            # bind parameter — treated as identifier reference
            name = self._ident()
            return ast.VarRef("$" + name)
        if tok.kind in ("IDENT", "KEYWORD"):
            name = tok.val
            # influx alternate DISTINCT syntax (parser.go parseDistinct):
            # `SELECT DISTINCT value`, `COUNT(DISTINCT value)` — a bare
            # identifier right after `distinct` is its argument
            if name.lower() == "distinct":
                nxt = self.lex.peek()
                if nxt.kind == "IDENT":
                    self.lex.next()
                    return ast.Call("distinct", (ast.VarRef(nxt.val),))
            if self._accept_op("("):
                args = []
                if not self._accept_op(")"):
                    while True:
                        targ = self.lex.peek()
                        if targ.kind == "OP" and targ.val == "*":
                            self.lex.next()
                            args.append(ast.Wildcard())
                        else:
                            args.append(self._parse_expr())
                        if not self._accept_op(","):
                            break
                    self._expect_op(")")
                return ast.Call(name.lower(), tuple(args))
            # qualified references: alias.field / alias.* (join sources)
            while self.lex.peek().kind == "OP" and self.lex.peek().val == ".":
                self.lex.next()
                nxt = self.lex.peek()
                if nxt.kind == "OP" and nxt.val == "*":
                    self.lex.next()
                    name += ".*"
                    break
                name += "." + self._ident()
            # double-colon type cast: field::float — parsed, cast ignored
            if self._accept_op("::"):
                self._ident()
            return ast.VarRef(name)
        raise ParseError(f"unexpected token {tok.val!r} in expression")

    # -- SHOW ---------------------------------------------------------------

    def _name_or_regex(self) -> tuple[str, str]:
        """FROM target of a SHOW statement: identifier or /regex/."""
        tok = self.lex.peek(allow_regex=True)
        if tok.kind == "REGEX":
            self.lex.next(allow_regex=True)
            return "", tok.val
        return self._ident(), ""

    def _accept_show_order(self, s) -> None:
        """Trailing `ORDER BY value [ASC|DESC]` on SHOW TAG VALUES
        (reference: influxql.y showTagValuesStatement sort fields)."""
        if not self._accept_kw("order"):
            return
        self._expect_kw("by")
        col = self._ident()
        if col.lower() != "value":
            raise ParseError("SHOW ... ORDER BY supports only `value`")
        if self._accept_kw("desc"):
            s.order_desc = True
        else:
            self._accept_kw("asc")

    def parse_show(self):
        self._expect_kw("show")
        if self._accept_word("models"):
            return ast.ShowModels()
        kw = self.lex.next()
        if kw.kind != "KEYWORD":
            raise ParseError(f"bad SHOW: {kw.val!r}")
        if kw.val == "databases":
            return ast.ShowDatabases()
        if kw.val == "measurements":
            s = ast.ShowMeasurements()
            if self._accept_kw("on"):
                s.database = self._ident()
            if self._accept_kw("with"):
                self._expect_kw("measurement")
                tok = self.lex.next(allow_regex=True)
                if tok.kind == "OP" and tok.val == "=~":
                    rtok = self.lex.next(allow_regex=True)
                    s.regex = rtok.val
                elif tok.kind == "OP" and tok.val == "=":
                    name = self._ident()
                    s.regex = "^" + re.escape(name) + "$"  # exact match
                else:
                    raise ParseError("bad WITH MEASUREMENT")
            return s
        if kw.val == "tag":
            sub = self._expect_kw("keys", "values")
            if sub == "keys":
                s = ast.ShowTagKeys()
                if self._accept_kw("on"):
                    s.database = self._ident()
                if self._accept_kw("from"):
                    s.measurement, s.measurement_regex = self._name_or_regex()
                if self._accept_kw("where"):
                    s.condition = self._parse_expr()
                return s
            s = ast.ShowTagValues()
            if self._accept_kw("on"):
                s.database = self._ident()
            if self._accept_kw("from"):
                s.measurement, s.measurement_regex = self._name_or_regex()
            self._expect_kw("with")
            self._expect_kw("key")
            tok = self.lex.next(allow_regex=True)
            if tok.kind == "OP" and tok.val == "=":
                s.keys = [self._ident()]
            elif tok.kind == "OP" and tok.val == "=~":
                rtok = self.lex.next(allow_regex=True)
                if rtok.kind != "REGEX":
                    raise ParseError("bad WITH KEY regex")
                s.key_regex = rtok.val
            elif tok.kind == "KEYWORD" and tok.val == "in":
                self._expect_op("(")
                s.keys = [self._ident()]
                while self._accept_op(","):
                    s.keys.append(self._ident())
                self._expect_op(")")
            else:
                raise ParseError("bad WITH KEY")
            if self._accept_kw("where"):
                s.condition = self._parse_expr()
            self._accept_show_order(s)
            s.limit = self._parse_int_clause("limit")
            s.offset = self._parse_int_clause("offset")
            return s
        if kw.val == "field":
            self._expect_kw("keys")
            s = ast.ShowFieldKeys()
            if self._accept_kw("on"):
                s.database = self._ident()
            if self._accept_kw("from"):
                s.measurement, s.measurement_regex = self._name_or_regex()
            return s
        if kw.val == "measurement":
            self._expect_kw("cardinality")
            s = ast.ShowMeasurementCardinality()
            if self._accept_kw("on"):
                s.database = self._ident()
            return s
        if kw.val == "series":
            if self._accept_kw("exact"):
                self._expect_kw("cardinality")
                s = ast.ShowSeriesExactCardinality()
                if self._accept_kw("on"):
                    s.database = self._ident()
                if self._accept_kw("from"):
                    s.measurement, s.measurement_regex = self._name_or_regex()
                if self._accept_kw("where"):
                    s.condition = self._parse_expr()
                return s
            if self._accept_kw("cardinality"):
                s = ast.ShowSeriesCardinality()
                if self._accept_kw("on"):
                    s.database = self._ident()
                return s
            s = ast.ShowSeries()
            if self._accept_kw("on"):
                s.database = self._ident()
            if self._accept_kw("from"):
                s.measurement, s.measurement_regex = self._name_or_regex()
            if self._accept_kw("where"):
                s.condition = self._parse_expr()
            return s
        if kw.val == "retention":
            self._expect_kw("policies")
            s = ast.ShowRetentionPolicies()
            if self._accept_kw("on"):
                s.database = self._ident()
            return s
        if kw.val == "continuous":
            self._expect_kw("queries")
            return ast.ShowContinuousQueries()
        if kw.val == "users":
            return ast.ShowUsers()
        if kw.val == "streams":
            return ast.ShowStreams()
        if kw.val == "shards":
            return ast.ShowShards()
        if kw.val == "subscriptions":
            return ast.ShowSubscriptions()
        if kw.val == "queries":
            return ast.ShowQueries()
        if kw.val == "cluster":
            return ast.ShowCluster()
        if kw.val == "downsamples":
            stmt = ast.ShowDownsamples()
            if self._accept_kw("on"):
                stmt.database = self._ident()
            return stmt
        if kw.val == "stats":
            return ast.ShowStats()
        if kw.val == "diagnostics":
            return ast.ShowDiagnostics()
        if kw.val == "grants":
            self._expect_kw("for")
            return ast.ShowGrants(self._ident())
        raise ParseError(f"unsupported SHOW {kw.val!r}")

    # -- CREATE / DROP ------------------------------------------------------

    def parse_create(self):
        self._expect_kw("create")
        if self._accept_word("model"):
            kw = "model"
        else:
            kw = self._expect_kw(
                "database", "retention", "continuous", "user", "stream",
                "subscription", "downsample", "measurement",
            )
        if kw == "model":
            # CREATE MODEL name WITH ALGORITHM 'alg' [THRESHOLD x]
            #   FROM (SELECT field FROM ...): fit + persist (castor)
            stmt = ast.CreateModel(name=self._ident())
            self._expect_kw("with")
            self._expect_word("algorithm")
            tok = self.lex.next()
            if tok.kind != "STRING":
                raise ParseError("ALGORITHM expects a quoted name")
            stmt.algorithm = tok.val
            if self._accept_word("threshold"):
                ntok = self.lex.next()
                if ntok.kind not in ("NUMBER", "INTEGER"):
                    raise ParseError("THRESHOLD expects a number")
                stmt.threshold = float(ntok.val)
            self._expect_kw("from")
            self._expect_op("(")
            start_pos = self.lex.peek().pos
            stmt.select = self.parse_select()
            end_tok = self.lex.peek()
            stmt.select_text = self.lex.text[start_pos:end_tok.pos].strip()
            self._expect_op(")")
            return stmt
        if kw == "measurement":
            # CREATE MEASUREMENT name [WITH ...]: schema pre-declaration.
            # Our engine is schema-on-write, so the statement validates and
            # records nothing; shard-key/index clauses are accepted and
            # ignored (reference: influxql CreateMeasurementStatement).
            stmt = ast.CreateMeasurement(self._ident())
            while self.lex.peek().kind != "EOF" and not (
                self.lex.peek().kind == "OP" and self.lex.peek().val == ";"
            ):
                self.lex.next()
            return stmt
        if kw == "downsample":
            # CREATE DOWNSAMPLE ON [db.]rp (float(mean),integer(sum))
            #   WITH TTL 7d SAMPLEINTERVAL 1h,25h TIMEINTERVAL 5m,30m
            # (reference: influxql CreateDownSampleStatement, ast.go:11262)
            stmt = ast.CreateDownsample()
            if self._accept_kw("on"):
                first = self._ident()
                if self._accept_op("."):
                    stmt.database, stmt.rp = first, self._ident()
                else:
                    stmt.rp = first
            if self._accept_op("("):
                while True:
                    tname = self._ident().lower()
                    self._expect_op("(")
                    stmt.type_aggs[tname] = self._ident().lower()
                    self._expect_op(")")
                    if not self._accept_op(","):
                        break
                self._expect_op(")")
            self._expect_kw("with")
            self._expect_kw("ttl")
            stmt.ttl_ns = self._duration_tok("TTL")
            self._expect_kw("sampleinterval")
            stmt.sample_intervals = self._duration_list("SAMPLEINTERVAL")
            self._expect_kw("timeinterval")
            stmt.time_intervals = self._duration_list("TIMEINTERVAL")
            return stmt
        if kw == "subscription":
            # CREATE SUBSCRIPTION name ON db DESTINATIONS ALL|ANY 'url', ...
            name = self._ident()
            self._expect_kw("on")
            db = self._ident()
            self._expect_kw("destinations")
            mode = self._expect_kw("all", "any").upper()
            dests = []
            while True:
                tok = self.lex.next()
                if tok.kind != "STRING":
                    raise ParseError("destination must be a quoted URL")
                dests.append(tok.val)
                if not self._accept_op(","):
                    break
            return ast.CreateSubscription(name, db, mode, dests)
        if kw == "stream":
            # CREATE STREAM name INTO db..dest ON SELECT ... [DELAY 5s]
            # (reference: openGemini stream DDL, services/stream)
            name = self._ident()
            stmt = ast.CreateStream(name=name)
            self._expect_kw("on")
            start_pos = self.lex.peek().pos
            stmt.select = self.parse_select()
            stmt.select_text = self.lex.text[start_pos : self.lex.pos].strip()
            if self._accept_kw("delay"):
                t = self.lex.next()
                if t.kind != "DURATION":
                    raise ParseError("DELAY expects a duration")
                stmt.delay_ns = t.val
            if stmt.select.into is None:
                raise ParseError("stream requires an INTO clause")
            if stmt.select.group_by_time is None:
                raise ParseError("stream requires GROUP BY time(...)")
            return stmt
        if kw == "database":
            stmt = ast.CreateDatabase(self._ident())
            if self._accept_kw("with"):
                # WITH [DURATION d] [REPLICATION n] [SHARD DURATION d]
                #      [INDEX DURATION d] [NAME rp]  (influxql.y)
                stmt.has_rp_clause = True
                while True:
                    if self._accept_kw("duration"):
                        stmt.duration_ns = self._duration_tok("DURATION")
                    elif self._accept_kw("replication"):
                        t = self.lex.next()
                        if t.kind != "INTEGER":
                            raise ParseError("REPLICATION expects an integer")
                        stmt.replication = t.val
                    elif self._accept_kw("shard"):
                        self._expect_kw("duration")
                        stmt.shard_duration_ns = self._duration_tok("SHARD DURATION")
                    elif self._accept_kw("name"):
                        stmt.rp_name = self._ident()
                    else:
                        tok = self.lex.peek()
                        if tok.kind == "IDENT" and tok.val.lower() == "index":
                            self.lex.next()
                            self._expect_kw("duration")
                            self._duration_tok("INDEX DURATION")  # accepted, n/a
                        else:
                            break
            return stmt
        if kw == "user":
            name = self._ident()
            self._expect_kw("with")
            self._expect_kw("password")
            tok = self.lex.next()
            if tok.kind != "STRING":
                raise ParseError("CREATE USER expects a quoted password")
            stmt = ast.CreateUser(name, tok.val)
            if self._accept_kw("with"):
                self._expect_kw("all")
                self._expect_kw("privileges")
                stmt.admin = True
            return stmt
        if kw == "continuous":
            self._expect_kw("query")
            name = self._ident()
            self._expect_kw("on")
            db = self._ident()
            stmt = ast.CreateContinuousQuery(name=name, database=db)
            if self._accept_kw("resample"):
                while True:
                    if self._accept_kw("every"):
                        t = self.lex.next()
                        if t.kind != "DURATION":
                            raise ParseError("RESAMPLE EVERY expects a duration")
                        stmt.resample_every_ns = t.val
                    elif self._accept_kw("for"):
                        t = self.lex.next()
                        if t.kind != "DURATION":
                            raise ParseError("RESAMPLE FOR expects a duration")
                        stmt.resample_for_ns = t.val
                    else:
                        break
            self._expect_kw("begin")
            start_pos = self.lex.peek().pos
            stmt.select = self.parse_select()
            end_tok = self.lex.peek()
            stmt.select_text = self.lex.text[start_pos : end_tok.pos].strip()
            self._expect_kw("end")
            if stmt.select.into is None:
                raise ParseError("continuous query requires an INTO clause")
            if stmt.select.group_by_time is None:
                raise ParseError("continuous query requires GROUP BY time(...)")
            return stmt
        self._expect_kw("policy")
        name = self._ident()
        self._expect_kw("on")
        db = self._ident()
        self._expect_kw("duration")
        tok = self.lex.next()
        if tok.kind != "DURATION" and not (tok.kind == "INTEGER" and tok.val == 0):
            raise ParseError("DURATION expects a duration")
        duration = tok.val if tok.kind == "DURATION" else 0
        self._expect_kw("replication")
        rtok = self.lex.next()
        if rtok.kind != "INTEGER":
            raise ParseError("REPLICATION expects an integer")
        stmt = ast.CreateRetentionPolicy(
            database=db, name=name, duration_ns=duration, replication=rtok.val
        )
        while True:
            if self._accept_kw("shard"):
                self._expect_kw("duration")
                t = self.lex.next()
                if t.kind != "DURATION":
                    raise ParseError("SHARD DURATION expects a duration")
                stmt.shard_duration_ns = t.val
            elif self._accept_kw("default"):
                stmt.default = True
            else:
                break
        return stmt

    def parse_alter(self):
        """ALTER RETENTION POLICY name ON db with any subset of DURATION /
        REPLICATION / SHARD DURATION / DEFAULT, in any order (influxql
        allows that; reference parser.go:393)."""
        self._expect_kw("alter")
        self._expect_kw("retention")
        self._expect_kw("policy")
        name = self._ident()
        self._expect_kw("on")
        stmt = ast.AlterRetentionPolicy(database=self._ident(), name=name)
        saw = False
        while True:
            if self._accept_kw("duration"):
                tok = self.lex.next()
                if tok.kind == "DURATION":
                    stmt.duration_ns = tok.val
                elif tok.kind == "INTEGER" and tok.val == 0:
                    stmt.duration_ns = 0
                else:
                    raise ParseError("DURATION expects a duration")
            elif self._accept_kw("replication"):
                rtok = self.lex.next()
                if rtok.kind != "INTEGER":
                    raise ParseError("REPLICATION expects an integer")
                stmt.replication = rtok.val
            elif self._accept_kw("shard"):
                self._expect_kw("duration")
                t = self.lex.next()
                if t.kind != "DURATION":
                    raise ParseError("SHARD DURATION expects a duration")
                stmt.shard_duration_ns = t.val
            elif self._accept_kw("default"):
                stmt.default = True
            else:
                break
            saw = True
        if not saw:
            raise ParseError(
                "ALTER RETENTION POLICY requires at least one of "
                "DURATION/REPLICATION/SHARD DURATION/DEFAULT")
        return stmt

    def parse_drop(self):
        self._expect_kw("drop")
        if self._accept_word("model"):
            return ast.DropModel(self._ident())
        kw = self._expect_kw(
            "database", "retention", "measurement", "continuous", "user", "series",
            "stream", "subscription", "downsample", "downsamples",
        )
        if kw in ("downsample", "downsamples"):
            stmt = ast.DropDownsample()
            if self._accept_kw("on"):
                first = self._ident()
                if self._accept_op("."):
                    stmt.database, stmt.rp = first, self._ident()
                elif kw == "downsample":
                    stmt.rp = first
                else:  # DROP DOWNSAMPLES ON db: every rp of the database
                    stmt.database = first
            elif kw == "downsample":
                raise ParseError("DROP DOWNSAMPLE requires ON [db.]rp")
            return stmt
        if kw == "stream":
            return ast.DropStream(self._ident())
        if kw == "subscription":
            name = self._ident()
            self._expect_kw("on")
            return ast.DropSubscription(name, self._ident())
        if kw == "database":
            return ast.DropDatabase(self._ident())
        if kw == "measurement":
            return ast.DropMeasurement(self._ident())
        if kw == "user":
            return ast.DropUser(self._ident())
        if kw == "series":
            stmt = ast.DropSeries()
            if self._accept_kw("from"):
                stmt.measurement = self._ident()
            if self._accept_kw("where"):
                stmt.condition = self._parse_expr()
            return stmt
        if kw == "continuous":
            self._expect_kw("query")
            name = self._ident()
            self._expect_kw("on")
            return ast.DropContinuousQuery(name=name, database=self._ident())
        self._expect_kw("policy")
        name = self._ident()
        self._expect_kw("on")
        return ast.DropRetentionPolicy(database=self._ident(), name=name)
