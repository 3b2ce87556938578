"""PromQL front end: the parser, the evaluation engine and the rule
manager.

The port of ``opengemini_tpu/promql``. PromQL evaluates directly against
the storage engine, with the range-vector math in ops/prom.py on the
engine's device; the rule manager (rules.py) keeps recording and
alerting rules incrementally over host tile partials."""
