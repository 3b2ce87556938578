"""PromQL front end: the parser and the evaluation engine.

The port of ``opengemini_tpu/promql`` (less the rule manager, ROADMAP
A7.2). PromQL evaluates directly against the storage engine, with the
range-vector math in ops/prom.py on the engine's device."""
