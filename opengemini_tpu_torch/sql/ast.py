"""InfluxQL AST nodes (naming mirrors the reference's influxql package)."""

from __future__ import annotations

from dataclasses import dataclass, field


# -- expressions -------------------------------------------------------------


@dataclass(frozen=True)
class VarRef:
    name: str

    def __str__(self):
        return f'"{self.name}"'


@dataclass(frozen=True)
class NumberLiteral:
    val: float

    def __str__(self):
        return repr(self.val)


@dataclass(frozen=True)
class IntegerLiteral:
    val: int

    def __str__(self):
        return str(self.val)


@dataclass(frozen=True)
class StringLiteral:
    val: str

    def __str__(self):
        return f"'{self.val}'"


@dataclass(frozen=True)
class BooleanLiteral:
    val: bool

    def __str__(self):
        return "true" if self.val else "false"


@dataclass(frozen=True)
class DurationLiteral:
    val_ns: int

    def __str__(self):
        return f"{self.val_ns}ns"


@dataclass(frozen=True)
class RegexLiteral:
    pattern: str

    def __str__(self):
        return f"/{self.pattern}/"


@dataclass(frozen=True)
class Wildcard:
    kind: str = ""  # "", "field", "tag"

    def __str__(self):
        return "*"


@dataclass(frozen=True)
class Call:
    name: str
    args: tuple

    def __str__(self):
        return f"{self.name}({', '.join(map(str, self.args))})"


@dataclass(frozen=True)
class BinaryExpr:
    op: str
    lhs: object
    rhs: object

    def __str__(self):
        return f"({self.lhs} {self.op} {self.rhs})"


@dataclass(frozen=True)
class ParenExpr:
    expr: object

    def __str__(self):
        return f"({self.expr})"


@dataclass(frozen=True)
class UnaryExpr:
    op: str
    expr: object

    def __str__(self):
        return f"{self.op}{self.expr}"


# -- statement pieces --------------------------------------------------------


@dataclass(frozen=True)
class Field:
    expr: object
    alias: str = ""


@dataclass(frozen=True)
class Measurement:
    name: str = ""
    regex: str = ""
    database: str = ""
    rp: str = ""
    alias: str = ""


@dataclass(frozen=True)
class SubQuery:
    stmt: "SelectStatement"
    alias: str = ""


@dataclass(frozen=True)
class JoinSource:
    """A JOIN B ON <cond>. kind: inner|left|right|outer|full
    (reference: influxql.Join, LogicalJoin at logic_plan.go:3679)."""

    left: object  # Measurement | SubQuery | JoinSource
    right: object
    kind: str
    on: object  # condition expr


@dataclass(frozen=True)
class InSubquery:
    """<ref> IN (SELECT ...) in a WHERE clause."""

    ref: object  # VarRef
    stmt: "SelectStatement"


@dataclass(frozen=True)
class TimeDimension:
    every_ns: int
    offset_ns: int = 0


@dataclass
class SelectStatement:
    fields: list[Field] = field(default_factory=list)
    sources: list = field(default_factory=list)  # Measurement | SubQuery
    condition: object | None = None
    group_by_tags: list[str] = field(default_factory=list)
    group_by_time: TimeDimension | None = None
    group_by_all_tags: bool = False  # GROUP BY *
    fill_option: str = "null"  # null | none | previous | linear | <number>
    fill_value: float = 0.0
    limit: int = 0
    offset: int = 0
    slimit: int = 0
    soffset: int = 0
    ascending: bool = True
    tz: str = ""
    into: Measurement | None = None
    ctes: dict | None = None  # WITH name AS (...) bindings, shared by ref
    hints: tuple = ()  # optimizer hints: /*+ full_series */ etc.


@dataclass
class UnionStatement:
    """A UNION [ALL] [BY NAME] B [...]; selects with combine flags.
    combines[i] describes how selects[i+1] merges into the running result.
    (reference: influxql union statement, TestServer_Union_Table)."""

    selects: list = field(default_factory=list)
    combines: list = field(default_factory=list)  # (all: bool, by_name: bool)
    ctes: dict | None = None


# -- other statements --------------------------------------------------------


@dataclass
class ShowDatabases:
    pass


@dataclass
class ShowMeasurements:
    database: str = ""
    regex: str = ""


@dataclass
class ShowTagKeys:
    database: str = ""
    measurement: str = ""
    measurement_regex: str = ""
    condition: object | None = None


@dataclass
class ShowTagValues:
    database: str = ""
    measurement: str = ""
    measurement_regex: str = ""
    keys: list[str] = field(default_factory=list)
    key_regex: str = ""
    condition: object | None = None
    order_desc: bool = False
    limit: int = 0
    offset: int = 0


@dataclass
class ShowFieldKeys:
    database: str = ""
    measurement: str = ""
    measurement_regex: str = ""


@dataclass
class ShowSeries:
    database: str = ""
    measurement: str = ""
    measurement_regex: str = ""
    condition: object | None = None


@dataclass
class ShowSeriesExactCardinality:
    database: str = ""
    measurement: str = ""
    measurement_regex: str = ""
    condition: object | None = None


@dataclass
class CreateMeasurement:
    name: str = ""


@dataclass
class ShowRetentionPolicies:
    database: str = ""


@dataclass
class CreateDatabase:
    name: str = ""
    # optional WITH clause: creates/overrides the default retention policy
    rp_name: str = ""
    duration_ns: int = 0
    shard_duration_ns: int | None = None
    replication: int = 1
    has_rp_clause: bool = False


@dataclass
class DropDatabase:
    name: str = ""


@dataclass
class CreateRetentionPolicy:
    database: str = ""
    name: str = ""
    duration_ns: int = 0
    shard_duration_ns: int | None = None
    replication: int = 1
    default: bool = False


@dataclass
class AlterRetentionPolicy:
    """ALTER RETENTION POLICY name ON db [DURATION d] [REPLICATION n]
    [SHARD DURATION d] [DEFAULT] — None fields stay unchanged.
    Reference: lib/util/lifted/influx/influxql/parser.go:393
    (parseAlterRetentionPolicyStatement)."""

    database: str = ""
    name: str = ""
    duration_ns: int | None = None
    shard_duration_ns: int | None = None
    replication: int | None = None
    default: bool = False


@dataclass
class DropRetentionPolicy:
    database: str = ""
    name: str = ""


@dataclass
class DropMeasurement:
    name: str = ""


@dataclass
class CreateModel:
    """CREATE MODEL name WITH ALGORITHM 'mad' [THRESHOLD x] FROM (SELECT ...)
    — the castor fit pipeline (reference services/castor fit flow)."""

    name: str = ""
    algorithm: str = ""
    threshold: object = None
    select: object = None
    select_text: str = ""  # raw training-query text (provenance)


@dataclass
class ShowModels:
    pass


@dataclass
class DropModel:
    name: str = ""


@dataclass
class CreateContinuousQuery:
    name: str = ""
    database: str = ""
    select: "SelectStatement | None" = None
    select_text: str = ""  # raw SELECT source, persisted in meta
    resample_every_ns: int = 0
    resample_for_ns: int = 0


@dataclass
class DropContinuousQuery:
    name: str = ""
    database: str = ""


@dataclass
class ShowContinuousQueries:
    pass


@dataclass
class ExplainStatement:
    select: "SelectStatement | None" = None
    analyze: bool = False


@dataclass
class CreateUser:
    name: str = ""
    password: str = ""
    admin: bool = False


@dataclass
class DropUser:
    name: str = ""


@dataclass
class SetPassword:
    name: str = ""
    password: str = ""


@dataclass
class GrantStatement:
    privilege: str = ""  # READ | WRITE | ALL
    database: str = ""  # empty + ALL -> admin
    user: str = ""


@dataclass
class RevokeStatement:
    privilege: str = ""
    database: str = ""
    user: str = ""


@dataclass
class ShowUsers:
    pass


@dataclass
class ShowGrants:
    user: str = ""


@dataclass
class DeleteSeries:
    measurement: str = ""
    condition: object | None = None


@dataclass
class DropSeries:
    measurement: str = ""
    condition: object | None = None


@dataclass
class ShowMeasurementCardinality:
    database: str = ""


@dataclass
class ShowSeriesCardinality:
    database: str = ""


@dataclass
class CreateStream:
    name: str = ""
    select: "SelectStatement | None" = None
    select_text: str = ""
    delay_ns: int = 0


@dataclass
class DropStream:
    name: str = ""


@dataclass
class ShowStreams:
    pass


@dataclass
class CreateSubscription:
    name: str = ""
    database: str = ""
    mode: str = "ALL"
    destinations: list[str] = field(default_factory=list)


@dataclass
class DropSubscription:
    name: str = ""
    database: str = ""


@dataclass
class ShowSubscriptions:
    pass


@dataclass
class CreateDownsample:
    """Reference: influxql CreateDownSampleStatement (ast.go:11262) —
    SAMPLEINTERVAL[i] is the data-age threshold of level i, TIMEINTERVAL[i]
    the rewritten resolution, Ops the per-type aggregates."""

    database: str = ""
    rp: str = ""
    ttl_ns: int = 0
    sample_intervals: list[int] = field(default_factory=list)
    time_intervals: list[int] = field(default_factory=list)
    type_aggs: dict = field(default_factory=dict)  # "float"/"integer" -> agg


@dataclass
class DropDownsample:
    database: str = ""
    rp: str = ""  # empty: drop on every rp of the database


@dataclass
class ShowDownsamples:
    database: str = ""


@dataclass
class ShowCluster:
    pass


@dataclass
class ShowQueries:
    pass


@dataclass
class KillQuery:
    qid: int = 0


@dataclass
class ShowShards:
    pass


@dataclass
class ShowStats:
    pass


@dataclass
class ShowDiagnostics:
    pass
