"""JSON schema → regex compiler (copy of
semi_pd_tpu/constrained/json_schema.py, which imports no JAX).

Reference: the xgrammar/outlines json-schema front ends
(srt/constrained/*_backend.py). Covers the practical schema subset used by
OpenAI response_format: object with properties/required, string (with
enum/pattern), integer, number, boolean, null, arrays (bounded items), and
nested objects. Free-form values (no schema / json_object mode) compile to a
depth-bounded JSON value regex.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

# Bounded whitespace (outlines does the same): unbounded WS lets a model
# stall emitting spaces forever inside the grammar.
WS = r"[ \n\t]{0,4}"
STRING_CHAR = r'[^"\\\x00-\x1f]'
STRING = f'"(?:{STRING_CHAR}|\\\\.)*"'
INTEGER = r"-?(?:0|[1-9]\d*)"
NUMBER = INTEGER + r"(?:\.\d+)?(?:[eE][+-]?\d+)?"
BOOLEAN = r"(?:true|false)"
NULL = r"null"


def _free_value(depth: int) -> str:
    """Any JSON value with nesting bounded to `depth` levels."""
    if depth <= 0:
        return f"(?:{STRING}|{NUMBER}|{BOOLEAN}|{NULL})"
    inner = _free_value(depth - 1)
    arr = rf"\[{WS}(?:{inner}(?:{WS},{WS}{inner})*)?{WS}\]"
    obj = rf"\{{{WS}(?:{STRING}{WS}:{WS}{inner}(?:{WS},{WS}{STRING}{WS}:{WS}{inner})*)?{WS}\}}"
    return f"(?:{STRING}|{NUMBER}|{BOOLEAN}|{NULL}|{arr}|{obj})"


def schema_to_regex(schema: Any, depth: int = 3,
                    whitespace_pattern: Optional[str] = None) -> str:
    """whitespace_pattern overrides the bounded-WS default for this
    compilation (reference constrained_json_whitespace_pattern; outlines'
    flag of the same name). The module constant is restored on exit;
    recursive calls pass None and inherit the override."""
    if whitespace_pattern is not None:
        global WS
        old = WS
        WS = whitespace_pattern
        try:
            return schema_to_regex(schema, depth)
        finally:
            WS = old
    if schema is None or schema is True or schema == {}:
        return _free_value(depth)
    t = schema.get("type")
    if "enum" in schema:
        import json as _json

        opts = "|".join(re.escape(_json.dumps(v)) for v in schema["enum"])
        return f"(?:{opts})"
    if t == "string":
        if "pattern" in schema:
            return f'"{schema["pattern"]}"'
        return STRING
    if t == "integer":
        return INTEGER
    if t == "number":
        return NUMBER
    if t == "boolean":
        return BOOLEAN
    if t == "null":
        return NULL
    if t == "array":
        item = schema_to_regex(schema.get("items"), depth - 1)
        lo = schema.get("minItems", 0)
        hi = schema.get("maxItems")
        if hi is not None:
            if lo == 0:
                body = f"(?:{item}(?:{WS},{WS}{item}){{0,{max(hi - 1, 0)}}})?"
            else:
                body = f"{item}(?:{WS},{WS}{item}){{{lo - 1},{hi - 1}}}"
        elif lo > 0:
            body = f"{item}(?:{WS},{WS}{item}){{{lo - 1},}}"
        else:
            body = f"(?:{item}(?:{WS},{WS}{item})*)?"
        return rf"\[{WS}{body}{WS}\]"
    if t == "object" or "properties" in schema:
        props: Dict[str, Any] = schema.get("properties", {})
        required = schema.get("required", list(props.keys()))
        if not props:
            return _free_value(depth)
        # Emit properties in declaration order; optional ones appear or not.
        # (Same simplification as outlines: fixed ordering.)
        parts = []
        first_emitted = False
        for name, sub in props.items():
            key = re.escape('"%s"' % name)
            val = schema_to_regex(sub, depth - 1)
            piece = f"{key}{WS}:{WS}{val}"
            if name in required:
                sep = f"{WS},{WS}" if first_emitted else ""
                parts.append(f"{sep}{piece}")
                first_emitted = True
            else:
                sep = f"{WS},{WS}" if first_emitted else ""
                parts.append(f"(?:{sep}{piece})?")
        body = "".join(parts)
        return rf"\{{{WS}{body}{WS}\}}"
    if "anyOf" in schema or "oneOf" in schema:
        subs = schema.get("anyOf") or schema.get("oneOf")
        return "(?:" + "|".join(schema_to_regex(s, depth - 1) for s in subs) + ")"
    if "const" in schema:
        import json as _json

        return re.escape(_json.dumps(schema["const"]))
    return _free_value(depth)
