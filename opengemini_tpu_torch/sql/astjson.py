"""JSON codec for sql.ast expression trees.

The port of ``opengemini_tpu/sql/astjson.py``, whole: the documents are
the JAX package's (the pushdown's wire carries them).

The distributed partial-aggregation protocol ships the coordinator's
already-split WHERE subtrees (tag filter, field filter) to peer data
nodes so they can run the same scan locally (reference: the serialized
plan fragments carried by engine/executor/rpc_transform.go — here the
nodes are plain dataclasses, so a name-tagged dict is the whole codec).

Only types defined in sql.ast are codable: the registry is built from
that module's namespace, so an unexpected object fails loudly instead of
round-tripping as something else.
"""

from __future__ import annotations

import dataclasses

from opengemini_tpu_torch.sql import ast

_REGISTRY = {
    name: obj
    for name, obj in vars(ast).items()
    if dataclasses.is_dataclass(obj) and isinstance(obj, type)
}


def to_json(node):
    """AST node (or list/primitive) -> JSON-able doc."""
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    if isinstance(node, (list, tuple)):
        return [to_json(v) for v in node]
    cls = type(node)
    if cls.__name__ not in _REGISTRY or _REGISTRY[cls.__name__] is not cls:
        raise TypeError(f"not a sql.ast node: {cls.__name__}")
    doc = {"_n": cls.__name__}
    for f in dataclasses.fields(node):
        doc[f.name] = to_json(getattr(node, f.name))
    return doc


def from_json(doc):
    """Inverse of to_json."""
    if doc is None or isinstance(doc, (bool, int, float, str)):
        return doc
    if isinstance(doc, list):
        return [from_json(v) for v in doc]
    name = doc.get("_n")
    cls = _REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"unknown ast node {name!r}")
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in doc:
            continue
        v = from_json(doc[f.name])
        # JSON flattens tuples to lists; restore tuple-typed fields so
        # reconstructed nodes compare equal to parser output
        if isinstance(v, list) and "tuple" in str(f.type):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kwargs[f.name] = v
    return cls(**kwargs)
