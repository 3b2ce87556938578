"""Table functions, the port of ``opengemini_tpu/query/tablefunc.py``,
whole (reference: engine/executor/table_function_factory.go
RegistryTableFunctionOp — the registry ships one production operator,
``rca``, engine/executor/rca.go FaultDemarcation).

``rca`` is root-cause fault demarcation: given anomaly/alarm/event rows
(fields ``id``/``name``/``entity_id``/``type``/``annotations``) and an
entity topology graph, BFS outward from a core entity, expanding only
through entities whose events are time-correlated with the core
entity's anomaly timestamps, and return the implicated subgraph.

Exposed through InfluxQL as ``SELECT rca('<params json>') FROM events
WHERE time >= ... AND time < ...`` — the statement-level equivalent of
the reference's table-function plan node (logic_plan.go:3863
LogicalTableFunction). The params JSON carries what the reference
splits between AlgoParam and the graph input::

    {
      "hop_count": 2,            # BFS radius per anomalous entity
      "bfs_narrow": false,       # shrink radius to 1 after first hit
      "task": {"metadata": {"core_entity_id": "...",
                             "anomaly_entity_id": [...optional...]}},
      "topology": {"nodes": [{"uid": ..., ...}],
                    "edges": [{"source": ..., "target": ..., ...}]}
    }
"""

from __future__ import annotations

import bisect
import json

HALF_HOUR_MS = 30 * 60 * 1000
TWO_HOUR_MS = 120 * 60 * 1000


class TableFunctionError(ValueError):
    pass


def _within(target_ts: int, sorted_ts: list[int], close_ms: int) -> bool:
    """Nearest-timestamp proximity check (reference rca.go:66
    isWithinTSRange)."""
    pos = bisect.bisect_left(sorted_ts, target_ts)
    for i in (pos, pos - 1):
        if 0 <= i < len(sorted_ts) and abs(target_ts - sorted_ts[i]) <= close_ms:
            return True
    return False


def _annotations(row: dict) -> dict:
    raw = row.get("annotations", "")
    if isinstance(raw, dict):
        return raw
    try:
        got = json.loads(raw or "{}")
    except ValueError as e:
        raise TableFunctionError(f"rca: bad annotations JSON: {e}") from None
    if not isinstance(got, dict):
        raise TableFunctionError("rca: annotations must be a JSON object")
    return got


def _index_rows(rows: list[dict]) -> dict[str, list[tuple[str, dict]]]:
    """entity_id -> [(type, parsed annotations)] — one pass so the BFS's
    per-entity correlation checks are O(rows of that entity) instead of
    rescanning (and re-parsing JSON for) the whole event set."""
    idx: dict[str, list[tuple[str, dict]]] = {}
    for row in rows:
        ent = row.get("entity_id")
        if ent is None:
            continue
        idx.setdefault(str(ent), []).append((row.get("type"), _annotations(row)))
    return idx


def _is_anomaly(anomaly_ts: list[int], entity_id: str,
                row_idx: dict[str, list[tuple[str, dict]]]) -> bool:
    """Event-type-specific time correlation (reference rca.go:83
    isAnomaly): anomalies match any of their timestamps within 30min;
    alarms use start_time (30min with an end_time, 2h open-ended);
    events use end_time/start_time/create_time at 30min/2h/2h."""
    for etype, ann in row_idx.get(entity_id, []):
        if etype == "anomaly":
            ts_list = ann.get("timestamps")
            if ts_list is None:
                raise TableFunctionError("rca: timestamps not found in annotations")
            for ts in ts_list:
                if _within(int(ts), anomaly_ts, HALF_HOUR_MS):
                    return True
        elif etype == "alarm":
            start = ann.get("start_time")
            if start is None:
                raise TableFunctionError("rca: fired timestamp not found in annotations")
            close = HALF_HOUR_MS if "end_time" in ann else TWO_HOUR_MS
            if _within(int(start), anomaly_ts, close):
                return True
        elif etype == "event":
            if "end_time" in ann:
                if _within(int(ann["end_time"]), anomaly_ts, HALF_HOUR_MS):
                    return True
            elif "start_time" in ann:
                if _within(int(ann["start_time"]), anomaly_ts, TWO_HOUR_MS):
                    return True
            else:
                created = ann.get("create_time")
                if created is None:
                    raise TableFunctionError(
                        "rca: created timestamp not found in annotations"
                    )
                if _within(int(created), anomaly_ts, TWO_HOUR_MS):
                    return True
    return False


def _core_anomaly_ts(row_idx: dict[str, list[tuple[str, dict]]],
                     core_id: str, meta: dict) -> list[int]:
    """Anomaly timestamps of the core entity (reference rca.go:302
    extractCoreAnomalyTimestamps): every 'anomaly' row of the core
    entity — or of the task's anomaly_entity_id list when present.
    STRICT like _is_anomaly: an anomaly row without timestamps is an
    error here too, not silently skipped (the same row would abort the
    BFS later anyway)."""
    ids = {core_id}
    extra = meta.get("anomaly_entity_id")
    if isinstance(extra, list):
        ids.update(str(x) for x in extra)
    out: set[int] = set()
    for ent in ids:
        for etype, ann in row_idx.get(ent, []):
            if etype != "anomaly":
                continue
            ts_list = ann.get("timestamps")
            if ts_list is None:
                raise TableFunctionError("rca: timestamps not found in annotations")
            for ts in ts_list:
                out.add(int(ts))
    if not out:
        raise TableFunctionError(
            f"rca: no anomaly timestamps found for core entity {core_id!r}"
        )
    return sorted(out)


def _edge_uid(edge: dict) -> str:
    return (f"{edge.get('source')}_{edge.get('source_topo', '')}"
            f"::::{edge.get('target')}_{edge.get('target_topo', '')}")


def fault_demarcation(rows: list[dict], params: dict) -> dict:
    """The BFS core (reference rca.go:160 FaultDemarcation): walk the
    topology outward from the core entity; every time-correlated entity
    spawns a bounded sub-BFS (hop_count, default 2) whose frontier joins
    the main queue; edges into the visited set are collected once;
    bfs_narrow shrinks the radius to 1 after the first expansion."""
    task = params.get("task") or {}
    meta = task.get("metadata")
    if not isinstance(meta, dict):
        raise TableFunctionError("rca: meta not found in algoParams")
    core_id = meta.get("core_entity_id")
    if not isinstance(core_id, str):
        raise TableFunctionError("rca: core entity not found in task meta")
    topo = params.get("topology") or {}
    nodes = topo.get("nodes") or []
    edges = topo.get("edges") or []
    # hop_count 0 means "use the default radius of 2" — the reference's
    # exact rule (rca.go: `if BFSHopCount == 0 { BFSHopCount = 2 }`)
    hop_count = int(params.get("hop_count") or 0) or 2
    narrow = bool(params.get("bfs_narrow"))

    row_idx = _index_rows(rows)
    anomaly_ts = _core_anomaly_ts(row_idx, core_id, meta)
    node_idx: dict[str, list[dict]] = {}
    for n in nodes:
        node_idx.setdefault(str(n.get("uid")), []).append(n)
    by_source: dict[str, list[dict]] = {}
    by_target: dict[str, list[dict]] = {}
    for e in edges:
        by_source.setdefault(str(e.get("source")), []).append(e)
        by_target.setdefault(str(e.get("target")), []).append(e)

    edge_list: list[dict] = []
    seen_edges: set[str] = set()
    visited = {core_id}
    queue = [core_id]
    node_list = list(node_idx.get(core_id, []))
    idx = 0
    while idx < len(queue):
        cur = queue[idx]
        if not _is_anomaly(anomaly_ts, cur, row_idx):
            idx += 1
            continue
        tmp_visited = {cur}
        tmp_nodes = [cur]
        tmp_hops = [0]
        t = 0
        while t < len(tmp_nodes):
            ent = tmp_nodes[t]
            for e in by_source.get(ent, []):
                other = str(e.get("target"))
                uid = _edge_uid(e)
                if uid not in seen_edges and (other in visited or other in tmp_visited):
                    seen_edges.add(uid)
                    edge_list.append(e)
                if tmp_hops[t] < hop_count and other not in tmp_visited:
                    tmp_visited.add(other)
                    tmp_nodes.append(other)
                    tmp_hops.append(tmp_hops[t] + 1)
            for e in by_target.get(ent, []):
                other = str(e.get("source"))
                uid = _edge_uid(e)
                if uid not in seen_edges and (other in visited or other in tmp_visited):
                    seen_edges.add(uid)
                    edge_list.append(e)
                if tmp_hops[t] < hop_count and other not in tmp_visited:
                    tmp_visited.add(other)
                    tmp_nodes.append(other)
                    tmp_hops.append(tmp_hops[t] + 1)
            t += 1
        for ent in sorted(tmp_visited):
            if ent not in visited:
                node_list.extend(node_idx.get(ent, []))
                visited.add(ent)
                queue.append(ent)
        if narrow:
            hop_count = 1
        idx += 1
    return {"nodes": node_list, "edges": edge_list}


def run_rca(rows: list[dict], params_json: str) -> dict:
    try:
        params = json.loads(params_json)
    except ValueError as e:
        raise TableFunctionError(f"rca: bad params JSON: {e}") from None
    if not isinstance(params, dict):
        raise TableFunctionError("rca: params must be a JSON object")
    return fault_demarcation(rows, params)


TABLE_FUNCTIONS = {"rca": run_rca}
