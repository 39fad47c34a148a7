"""JSON Schema registry (reference ``core/infra/schema/registry.go`` —
schemas in the KV under ``schema:<id>`` with a capped index; validation via
jsonschema)."""
from __future__ import annotations

import json
from typing import Any, Optional

import jsonschema

from .kv import KV

MAX_SCHEMAS = 500
INDEX_KEY = "schema:index"


class SchemaError(Exception):
    pass


class SchemaRegistry:
    def __init__(self, kv: KV) -> None:
        self.kv = kv

    async def put(self, schema_id: str, schema: dict[str, Any]) -> None:
        jsonschema.Draft202012Validator.check_schema(schema)
        existing = await self.kv.zcard(INDEX_KEY)
        known = await self.kv.get(f"schema:{schema_id}")
        if known is None and existing >= MAX_SCHEMAS:
            raise SchemaError(f"schema registry full ({MAX_SCHEMAS})")
        await self.kv.set(f"schema:{schema_id}", json.dumps(schema).encode())
        from ..utils.ids import now_us

        await self.kv.zadd(INDEX_KEY, schema_id, float(now_us()))

    async def get(self, schema_id: str) -> Optional[dict[str, Any]]:
        b = await self.kv.get(f"schema:{schema_id}")
        return json.loads(b) if b else None

    async def delete(self, schema_id: str) -> bool:
        n = await self.kv.delete(f"schema:{schema_id}")
        await self.kv.zrem(INDEX_KEY, schema_id)
        return n > 0

    async def list(self) -> list[str]:
        return await self.kv.zrange(INDEX_KEY)

    async def validate_id(self, schema_id: str, value: Any) -> list[str]:
        """Validate value against a registered schema; [] = valid."""
        schema = await self.get(schema_id)
        if schema is None:
            raise SchemaError(f"unknown schema {schema_id!r}")
        return self.validate_map(schema, value)

    @staticmethod
    def validate_map(schema: dict[str, Any], value: Any) -> list[str]:
        v = jsonschema.Draft202012Validator(schema)
        return [e.message for e in v.iter_errors(value)]
