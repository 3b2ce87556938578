"""InfluxQL front-end: lexer, AST, recursive-descent parser.

Reference: the lifted influxql yacc parser
(lib/util/lifted/influx/influxql, ~24k LoC). This is a from-scratch
hand-written parser for the InfluxQL surface the TPU engine executes;
the AST mirrors influxql node naming (SelectStatement, BinaryExpr, Call,
VarRef...) so the planner reads like the reference's.
"""
