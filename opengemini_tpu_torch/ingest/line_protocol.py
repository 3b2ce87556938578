"""InfluxDB line-protocol parser.

Format:  measurement[,tag=v...] field=value[,field=value...] [timestamp]

Behavior mirrors the reference's ingest parser (lifted VM protoparser,
lib/util/lifted/vm/protoparser/influx) and InfluxDB 1.x semantics:
  - escapes: '\\,' '\\ ' '\\=' in identifiers/tags; '\\"' inside string values
  - field types: float (default), i-suffix int, u-suffix uint (stored int),
    t/T/true/True | f/F/false/False bools, double-quoted strings
  - timestamps in the request precision (default ns), missing -> now
  - '#' comment lines and blank lines skipped
  - a malformed line raises ParseError with the line number (the reference
    returns per-line partial-write errors; the HTTP layer maps this to 400)

A point parses to the tuple:
    (measurement, tags, time_ns, fields)
    tags:   tuple of (key, value) pairs sorted by key
    fields: dict name -> (FieldType, python value)
"""

from __future__ import annotations

import time as _time

from opengemini_tpu_torch.record import FieldType

PRECISIONS = {
    "ns": 1,
    "n": 1,
    "us": 1_000,
    "u": 1_000,
    "µ": 1_000,
    "ms": 1_000_000,
    "s": 1_000_000_000,
    "m": 60_000_000_000,
    "h": 3_600_000_000_000,
}


_I64_MIN = -(2**63)
_I64_MAX = 2**63 - 1


class ParseError(ValueError):
    def __init__(self, lineno: int, msg: str):
        super().__init__(f"line {lineno}: {msg}")
        self.lineno = lineno
        self.msg = msg


Point = tuple  # (measurement, tags, time_ns, fields)


def parse_lines(
    data: str | bytes,
    precision: str = "ns",
    now_ns: int | None = None,
    expand_tag_arrays: bool = False,
) -> list[Point]:
    if isinstance(data, bytes):
        data = data.decode("utf-8", errors="replace")
    mult = PRECISIONS.get(precision)
    if mult is None:
        raise ValueError(f"invalid precision {precision!r}")
    if now_ns is None:
        now_ns = _time.time_ns()
    points: list[Point] = []
    for lineno, line in enumerate(data.split("\n"), 1):
        line = line.strip("\r ")
        if not line or line.startswith("#"):
            continue
        p = _parse_line(line, lineno, mult, now_ns,
                        bracket_tags=expand_tag_arrays)
        if expand_tag_arrays and any(
                v.startswith("[") and v.endswith("]") for _k, v in p[1]):
            points.extend(_expand_tag_arrays(p, lineno))
        else:
            points.append(p)
    return points


def _expand_tag_arrays(p: Point, lineno: int) -> list[Point]:
    """openGemini tag arrays (engine/index/tsi/tag_array.go
    AnalyzeTagSets): a tag value `[a,b]` expands the point into one
    series per POSITION — every array tag on the line must carry the
    same element count, scalar tags replicate. `cpu,host=[a,b],az=[1,2]`
    -> (host=a, az=1) and (host=b, az=2)."""
    mst, tags, t_ns, fields = p
    arr_len = 0
    split: dict[str, list[str]] = {}
    for k, v in tags:
        if v.startswith("[") and v.endswith("]"):
            vals = v[1:-1].split(",")
            if arr_len == 0:
                arr_len = len(vals)
            elif len(vals) != arr_len:
                raise ParseError(
                    lineno, "tag arrays on one line must have equal "
                    f"lengths ({len(vals)} vs {arr_len})")
            split[k] = vals
    out = []
    for i in range(arr_len):
        # empty array elements drop like empty scalar tag values (the
        # parser's 'influx drops empty tag values' rule)
        row_tags = tuple(
            (k, split[k][i] if k in split else v) for k, v in tags
            if (split[k][i] if k in split else v))
        out.append((mst, row_tags, t_ns, fields))
    return out


def _split_bracket_aware(s: str) -> list[str]:
    """Split on ',' outside [...] — tag-array values carry commas
    (`host=[a,b]`). Only used with tag-array expansion on; escapes inside
    array brackets are not supported (matches the reference's
    unmarshalTags array path)."""
    parts: list[str] = []
    cur: list[str] = []
    depth = 0
    esc = False
    for ch in s:
        if esc:  # escaped char: literal, never a separator
            cur.append(ch)
            esc = False
            continue
        if ch == "\\":
            cur.append(ch)
            esc = True
            continue
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth = max(depth - 1, 0)
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _parse_line(line: str, lineno: int, mult: int, now_ns: int,
                bracket_tags: bool = False) -> Point:
    key_part, fields_part, ts_part = _split_sections(line, lineno)

    # measurement + tags
    if bracket_tags and "[" in key_part:
        segs = _split_bracket_aware(key_part)
        measurement = _unescape(segs[0]) if "\\" in segs[0] else segs[0]
        raw_tags = segs[1:]
    elif "\\" in key_part:
        segs = _split_escaped(key_part, ",")
        measurement = _unescape(segs[0])
        raw_tags = segs[1:]
    else:
        segs = key_part.split(",")
        measurement = segs[0]
        raw_tags = segs[1:]
    if not measurement:
        raise ParseError(lineno, "missing measurement")
    tags = []
    for rt in raw_tags:
        if "\\" in rt:
            kv = _split_escaped(rt, "=")
            if len(kv) != 2:
                raise ParseError(lineno, f"bad tag {rt!r}")
            k, v = _unescape(kv[0]), _unescape(kv[1])
        else:
            eq = rt.find("=")
            if eq <= 0:
                raise ParseError(lineno, f"bad tag {rt!r}")
            k, v = rt[:eq], rt[eq + 1 :]
        if v:  # influx drops empty tag values
            tags.append((k, v))
    tags.sort()

    fields = _parse_fields(fields_part, lineno)
    if not fields:
        raise ParseError(lineno, "no fields")

    if ts_part:
        try:
            t = int(ts_part) * mult
        except ValueError:
            raise ParseError(lineno, f"bad timestamp {ts_part!r}") from None
        if not (_I64_MIN <= t <= _I64_MAX):
            raise ParseError(lineno, f"timestamp out of int64 range: {ts_part}")
    else:
        t = now_ns
    return (measurement, tuple(tags), t, fields)


def _split_sections(line: str, lineno: int) -> tuple[str, str, str]:
    """Split into (measurement+tags, fields, timestamp) on unescaped,
    unquoted spaces."""
    parts: list[str] = []
    buf: list[str] = []
    in_quotes = False
    i, n = 0, len(line)
    if "\\" not in line and '"' not in line:
        raw = line.split(" ")
        raw = [p for p in raw if p != ""]
        if len(raw) < 2 or len(raw) > 3:
            raise ParseError(lineno, "expected: key fields [timestamp]")
        return raw[0], raw[1], raw[2] if len(raw) == 3 else ""
    while i < n:
        c = line[i]
        if c == "\\" and i + 1 < n:
            buf.append(c)
            buf.append(line[i + 1])
            i += 2
            continue
        if c == '"':
            in_quotes = not in_quotes
            buf.append(c)
        elif c == " " and not in_quotes and len(parts) < 2:
            if buf:
                parts.append("".join(buf))
                buf = []
        else:
            buf.append(c)
        i += 1
    if buf:
        parts.append("".join(buf))
    if in_quotes:
        raise ParseError(lineno, "unterminated string value")
    if len(parts) < 2 or len(parts) > 3:
        raise ParseError(lineno, "expected: key fields [timestamp]")
    return parts[0], parts[1], parts[2] if len(parts) == 3 else ""


def _parse_fields(part: str, lineno: int) -> dict:
    fields: dict[str, tuple[FieldType, object]] = {}
    for seg in _split_escaped_quoted(part, ","):
        eq = _find_unquoted(seg, "=")
        if eq <= 0:
            raise ParseError(lineno, f"bad field {seg!r}")
        name = _unescape(seg[:eq])
        raw = seg[eq + 1 :]
        if not raw:
            raise ParseError(lineno, f"missing value for field {name!r}")
        fields[name] = _parse_value(raw, lineno)
    return fields


def _parse_value(raw: str, lineno: int) -> tuple[FieldType, object]:
    c0 = raw[0]
    if c0 == '"':
        if len(raw) < 2 or raw[-1] != '"':
            raise ParseError(lineno, f"bad string value {raw!r}")
        return (FieldType.STRING, raw[1:-1].replace('\\"', '"').replace("\\\\", "\\"))
    last = raw[-1]
    if last == "i" or last == "u":
        try:
            v = int(raw[:-1])
        except ValueError:
            raise ParseError(lineno, f"bad integer value {raw!r}") from None
        if not (_I64_MIN <= v <= _I64_MAX):
            raise ParseError(lineno, f"integer out of int64 range: {raw!r}")
        return (FieldType.INT, v)
    if raw in ("t", "T", "true", "True", "TRUE"):
        return (FieldType.BOOL, True)
    if raw in ("f", "F", "false", "False", "FALSE"):
        return (FieldType.BOOL, False)
    try:
        return (FieldType.FLOAT, float(raw))
    except ValueError:
        raise ParseError(lineno, f"bad value {raw!r}") from None


def _split_escaped(s: str, sep: str) -> list[str]:
    """Split on sep, honoring backslash escapes."""
    out: list[str] = []
    buf: list[str] = []
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c == "\\" and i + 1 < n:
            buf.append(c)
            buf.append(s[i + 1])
            i += 2
            continue
        if c == sep:
            out.append("".join(buf))
            buf = []
        else:
            buf.append(c)
        i += 1
    out.append("".join(buf))
    return out


def _split_escaped_quoted(s: str, sep: str) -> list[str]:
    """Split on sep, honoring escapes and double-quoted spans."""
    if "\\" not in s and '"' not in s:
        return s.split(sep)
    out: list[str] = []
    buf: list[str] = []
    in_quotes = False
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c == "\\" and i + 1 < n:
            buf.append(c)
            buf.append(s[i + 1])
            i += 2
            continue
        if c == '"':
            in_quotes = not in_quotes
            buf.append(c)
        elif c == sep and not in_quotes:
            out.append("".join(buf))
            buf = []
        else:
            buf.append(c)
        i += 1
    out.append("".join(buf))
    return out


def _find_unquoted(s: str, ch: str) -> int:
    in_quotes = False
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c == "\\":
            i += 2
            continue
        if c == '"':
            in_quotes = not in_quotes
        elif c == ch and not in_quotes:
            return i
        i += 1
    return -1


def _unescape(s: str) -> str:
    if "\\" not in s:
        return s
    out: list[str] = []
    i, n = 0, len(s)
    while i < n:
        if s[i] == "\\" and i + 1 < n and s[i + 1] in ',= "\\':
            out.append(s[i + 1])
            i += 2
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


def _esc_key(s: str) -> str:
    return (
        s.replace("\\", "\\\\")
        .replace(",", "\\,")
        .replace("=", "\\=")
        .replace(" ", "\\ ")
    )


def series_key(measurement: str, tags: tuple) -> str:
    """Canonical series key: escaped measurement,k=v,... sorted by tag key
    (reference: influx series key canonicalization). Components are escaped
    so distinct series can never alias to the same key."""
    if not tags:
        return _esc_key(measurement)
    return (
        _esc_key(measurement)
        + ","
        + ",".join(f"{_esc_key(k)}={_esc_key(v)}" for k, v in tags)
    )
