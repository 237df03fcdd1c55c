"""JSON-Schema → GBNF converter.

Copy of ``blazr_tpu/engine/grammar_json.py``: converts a JSON Schema (the
OpenAI ``response_format: json_schema`` payload) into a GBNF grammar
compilable by ``grammar.py``, and holds the generic JSON-mode grammar.
"""

from __future__ import annotations

import json
from typing import Any, Optional

# Generic JSON grammar (json_mode=True). Nesting is bounded by the DFA
# compiler's recursion limit.
JSON_GRAMMAR = r'''
root ::= ws value ws
value ::= object | array | string | number | boolean | null
object ::= "{" ws ( member ( ws "," ws member )* )? ws "}"
member ::= string ws ":" ws value
array ::= "[" ws ( value ( ws "," ws value )* )? ws "]"
string ::= "\"" char* "\""
char ::= [^"\\] | "\\" (["\\/bfnrt] | "u" [0-9a-fA-F]{4})
number ::= "-"? ("0" | [1-9] [0-9]*) ("." [0-9]+)? ([eE] [-+]? [0-9]+)?
boolean ::= "true" | "false"
null ::= "null"
ws ::= [ \t\n\r]*
'''


def _escape_literal(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


class _SchemaConverter:
    def __init__(self) -> None:
        self.rules: dict[str, str] = {}
        self.counter = 0

    def _fresh(self, hint: str) -> str:
        self.counter += 1
        safe = "".join(c if c.isalnum() else "-" for c in hint) or "r"
        return f"{safe}-{self.counter}"

    def _add(self, name: str, body: str) -> str:
        self.rules[name] = body
        return name

    def convert(self, schema: dict[str, Any], name: str = "root") -> str:
        body = self._node(schema, name)
        if name == "root":
            self._add("root", body)
        return body

    def _node(self, schema: dict[str, Any], hint: str) -> str:
        if not isinstance(schema, dict):
            return "value"
        if "$ref" in schema:
            return "value"  # refs degrade to generic value
        if "enum" in schema:
            opts = " | ".join(
                f'"{_escape_literal(json.dumps(v))}"' for v in schema["enum"]
            )
            return opts or "value"
        if "const" in schema:
            return f'"{_escape_literal(json.dumps(schema["const"]))}"'

        t = schema.get("type")
        if isinstance(t, list):
            return " | ".join(self._node({**schema, "type": x}, hint) for x in t)

        if t == "object" or (t is None and "properties" in schema):
            return self._object(schema, hint)
        if t == "array":
            item = schema.get("items", {})
            item_rule = self._subrule(item, hint + "-item")
            return f'"[" ws ( {item_rule} ( ws "," ws {item_rule} )* )? ws "]"'
        if t == "string":
            return "string"
        if t in ("number",):
            return "number"
        if t == "integer":
            return '"-"? ("0" | [1-9] [0-9]*)'
        if t == "boolean":
            return "boolean"
        if t == "null":
            return "null"
        return "value"

    def _subrule(self, schema: dict[str, Any], hint: str) -> str:
        body = self._node(schema, hint)
        if body in ("string", "number", "boolean", "null", "value"):
            return body
        return self._add(self._fresh(hint), body)

    def _object(self, schema: dict[str, Any], hint: str) -> str:
        props = schema.get("properties", {})
        required = set(schema.get("required", []))
        if not props:
            return "object"
        parts = []
        first = True
        # Fixed property order (all properties emitted; optional ones made
        # optional only at the tail to keep the grammar regular).
        for key, sub in props.items():
            rule = self._subrule(sub, f"{hint}-{key}")
            lit = f'"\\"{_escape_literal(key)}\\"" ws ":" ws {rule}'
            sep = "" if first else ' ws "," ws '
            if key in required or True:
                parts.append(f"{sep}{lit}")
            first = False
        inner = " ".join(parts)
        return f'"{{" ws {inner} ws "}}"'


def json_schema_to_gbnf(schema: dict[str, Any]) -> str:
    """Convert a JSON schema into GBNF (reference grammar_json.rs)."""
    conv = _SchemaConverter()
    conv.convert(schema, "root")
    lines = [f"{name} ::= {body}" for name, body in conv.rules.items()]
    # Shared primitive rules from the generic grammar.
    primitives = [
        l for l in JSON_GRAMMAR.strip().splitlines()
        if l.split(" ::=")[0] not in conv.rules and not l.startswith("root")
    ]
    return "\n".join(lines + primitives)


def request_grammar_source(cfg) -> Optional[str]:
    """The GBNF a request asks for: its ``grammar``, else its JSON schema's,
    else JSON mode's; None for a free request (the JAX engines'
    ``_grammar_for``)."""
    if cfg.grammar:
        return cfg.grammar
    if cfg.json_schema:
        return json_schema_to_gbnf(cfg.json_schema)
    return JSON_GRAMMAR if cfg.json_mode else None
