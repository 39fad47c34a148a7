"""Tiny expression language for workflow conditions and ``for_each``
(reference ``core/workflow/eval.go:17-216``): literals, dot-paths over the
scope, ``length()`` / ``first()`` helpers, comparisons, ``!`` negation.

Scope = ``{"input": …, "ctx": …, "steps": …, "item": …}``.

Also implements ``${...}`` template expansion for step inputs (reference
``core/workflow/engine.go:873-964``): a string that is exactly one template
is replaced by the resolved *value* (preserving type); templates embedded in
larger strings are stringified.
"""
from __future__ import annotations

import json
import re
from typing import Any

_COMPARATORS = ("==", "!=", ">=", "<=", ">", "<")
_NUM_RE = re.compile(r"^-?\d+(\.\d+)?$")


class EvalError(Exception):
    pass


def resolve_path(scope: Any, path: str) -> Any:
    """Dot-path lookup over dicts/lists; missing → None."""
    cur = scope
    for part in path.split("."):
        if cur is None:
            return None
        if isinstance(cur, dict):
            cur = cur.get(part)
        elif isinstance(cur, list):
            try:
                cur = cur[int(part)]
            except (ValueError, IndexError):
                return None
        else:
            return None
    return cur


def _parse_operand(scope: dict[str, Any], text: str) -> Any:
    text = text.strip()
    if not text:
        return None
    if text.startswith("length(") and text.endswith(")"):
        v = _parse_operand(scope, text[len("length("):-1])
        try:
            return len(v)  # type: ignore[arg-type]
        except TypeError:
            return 0
    if text.startswith("first(") and text.endswith(")"):
        v = _parse_operand(scope, text[len("first("):-1])
        if isinstance(v, (list, tuple)) and v:
            return v[0]
        return None
    if (text.startswith('"') and text.endswith('"')) or (
        text.startswith("'") and text.endswith("'")
    ):
        return text[1:-1]
    if text in ("true", "True"):
        return True
    if text in ("false", "False"):
        return False
    if text in ("null", "None"):
        return None
    if _NUM_RE.match(text):
        return float(text) if "." in text else int(text)
    return resolve_path(scope, text)


def truthy(v: Any) -> bool:
    if v is None:
        return False
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return v != 0
    if isinstance(v, str):
        return v != "" and v.lower() != "false"
    if isinstance(v, (list, dict)):
        return len(v) > 0
    return True


def evaluate(expr: str, scope: dict[str, Any]) -> Any:
    """Evaluate an expression against the scope."""
    expr = (expr or "").strip()
    if not expr:
        return True
    if expr.startswith("!"):
        return not truthy(evaluate(expr[1:], scope))
    for op in _COMPARATORS:
        # split on the first comparator occurrence outside quotes
        idx = _find_op(expr, op)
        if idx >= 0:
            left = _parse_operand(scope, expr[:idx])
            right = _parse_operand(scope, expr[idx + len(op):])
            return _compare(left, right, op)
    return _parse_operand(scope, expr)


def _find_op(expr: str, op: str) -> int:
    in_quote = ""
    i = 0
    while i < len(expr) - len(op) + 1:
        c = expr[i]
        if in_quote:
            if c == in_quote:
                in_quote = ""
        elif c in "\"'":
            in_quote = c
        elif expr[i : i + len(op)] == op:
            # avoid matching ">" inside ">=" etc.
            if op in (">", "<") and i + 1 < len(expr) and expr[i + 1] == "=":
                i += 1
                continue
            if op == "!" :
                pass
            return i
        i += 1
    return -1


def _compare(a: Any, b: Any, op: str) -> bool:
    if op == "==":
        return _coerced(a) == _coerced(b)
    if op == "!=":
        return _coerced(a) != _coerced(b)
    try:
        af, bf = float(a), float(b)  # type: ignore[arg-type]
    except (TypeError, ValueError):
        af, bf = str(a), str(b)  # lexicographic fallback
    if op == ">":
        return af > bf
    if op == "<":
        return af < bf
    if op == ">=":
        return af >= bf
    if op == "<=":
        return af <= bf
    raise EvalError(f"unknown comparator {op}")


def _coerced(v: Any) -> Any:
    # numbers compare numerically whether int or float
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return float(v)
    return v


# ---------------------------------------------------------------------------
# ${...} templates
# ---------------------------------------------------------------------------

_TEMPLATE_RE = re.compile(r"\$\{([^}]*)\}")


def expand_templates(value: Any, scope: dict[str, Any]) -> Any:
    """Recursively expand ``${expr}`` in strings/dicts/lists."""
    if isinstance(value, str):
        m = _TEMPLATE_RE.fullmatch(value.strip())
        if m:
            return evaluate(m.group(1), scope)

        def sub(match: re.Match) -> str:
            v = evaluate(match.group(1), scope)
            if isinstance(v, (dict, list)):
                return json.dumps(v)
            return "" if v is None else str(v)

        return _TEMPLATE_RE.sub(sub, value)
    if isinstance(value, dict):
        return {k: expand_templates(v, scope) for k, v in value.items()}
    if isinstance(value, list):
        return [expand_templates(v, scope) for v in value]
    return value


def set_path(target: dict, path: str, value: Any) -> None:
    """Graft ``value`` at dot-path in ``target`` (creating dicts)."""
    parts = path.split(".")
    cur = target
    for p in parts[:-1]:
        nxt = cur.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            cur[p] = nxt
        cur = nxt
    cur[parts[-1]] = value
