"""``secret://`` reference detection + recursive redaction
(reference ``core/infra/secrets/secrets.go:8-36``; feeds the
``secrets_present`` label consumed by the safety kernel)."""
from __future__ import annotations

from typing import Any

SECRET_PREFIX = "secret://"
REDACTED = "[redacted:secret-ref]"


def contains_secret_refs(value: Any) -> bool:
    if isinstance(value, str):
        return SECRET_PREFIX in value
    if isinstance(value, dict):
        return any(contains_secret_refs(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return any(contains_secret_refs(v) for v in value)
    return False


def redact_secret_refs(value: Any) -> Any:
    if isinstance(value, str):
        return REDACTED if SECRET_PREFIX in value else value
    if isinstance(value, dict):
        return {k: redact_secret_refs(v) for k, v in value.items()}
    if isinstance(value, list):
        return [redact_secret_refs(v) for v in value]
    return value
