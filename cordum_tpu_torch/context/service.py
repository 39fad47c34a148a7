"""Context engine: memory-backed window building with embedding recall.

Recreates the reference context engine's API (``core/context/engine/
service.go:55-176``): ``build_window(memory_id, mode, payload, budgets)`` →
list of model messages; ``update_memory`` appends chat events/summaries.
Memory lives under ``mem:<memory_id>:*`` keys.

RAG recall is *semantic*: chunks are embedded on the worker pool (as
``embed`` jobs the port's workers run on the card, or by a local embedder)
and ranked
by cosine similarity against the query, instead of the reference's
substring ``file_path`` matching.  Embeddings are cached per chunk in the
KV store so re-indexing is incremental.

Token budget trimming keeps the reference's 4-chars≈1-token estimate.
"""
from __future__ import annotations

import asyncio
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np

from ..infra.kv import KV
from ..protocol import subjects as subj
from ..protocol.types import (
    BusPacket,
    JobRequest,
    JobState,
    LABEL_BATCH_KEY,
    LABEL_OP,
    TERMINAL_STATES,
)
from ..utils.ids import new_id

HISTORY_WINDOW = 20  # last-N chat events (reference service.go:55-132)
HISTORY_CAP = 500
DEFAULT_MAX_INPUT_TOKENS = 4000

MODE_RAW = "RAW"
MODE_CHAT = "CHAT"
MODE_RAG = "RAG"


@dataclass
class ModelMessage:
    role: str = "user"
    content: str = ""
    source: str = ""

    def to_dict(self) -> dict:
        return dict(self.__dict__)


def estimate_tokens(text: str) -> int:
    """Reference estimate: 4 chars ≈ 1 token (service.go:271)."""
    return max(1, len(text) // 4)


def _events_key(memory_id: str) -> str:
    return f"mem:{memory_id}:events"


def _summary_key(memory_id: str) -> str:
    return f"mem:{memory_id}:summary"


def _chunks_key(memory_id: str) -> str:
    return f"mem:{memory_id}:chunks"


def _embed_key(memory_id: str, chunk_hash: str) -> str:
    return f"mem:{memory_id}:embed:{chunk_hash}"


class EmbedFn:
    """Anything with embed(texts) -> array[N, D]; the Embedder model or a
    worker-pool-dispatching client."""

    def embed(self, texts: Sequence[str]) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


class PoolEmbedder(EmbedFn):
    """EmbedFn that runs on the worker pool instead of in-process.

    Texts are split into per-job slices and submitted through the gateway's
    bulk endpoint (``POST /api/v1/jobs:batch``) in ONE HTTP round trip; the
    scheduler's batch affinity routes the slices to one worker, whose
    micro-batcher fuses them into a single padded device call
    (docs/BATCHING.md).  Synchronous (httpx.Client) — meant for re-indexing
    tools and benches, not for calling inside an event loop."""

    def __init__(
        self,
        base_url: str,
        *,
        api_key: str = "",
        topic: str = "job.tpu.embed",
        texts_per_job: int = 16,
        timeout_s: float = 120.0,
        poll_s: float = 0.05,
    ) -> None:
        import httpx

        headers = {"X-Api-Key": api_key} if api_key else {}
        self._c = httpx.Client(base_url=base_url, headers=headers, timeout=timeout_s)
        self.topic = topic
        self.texts_per_job = max(1, texts_per_job)
        self.timeout_s = timeout_s
        self.poll_s = poll_s

    def close(self) -> None:
        self._c.close()

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        import time

        jobs = [
            {"topic": self.topic,
             "payload": {"op": "embed", "texts": list(texts[i:i + self.texts_per_job])}}
            for i in range(0, len(texts), self.texts_per_job)
        ]
        r = self._c.post("/api/v1/jobs:batch", json={"jobs": jobs})
        r.raise_for_status()
        docs = r.json()["jobs"]
        parts: list[np.ndarray] = []
        deadline = time.monotonic() + self.timeout_s
        for doc in docs:
            jid = doc.get("job_id")
            if not jid:
                raise RuntimeError(f"bulk submit rejected a slice: {doc}")
            while True:
                s = self._c.get(f"/api/v1/jobs/{jid}?result=true").json()
                state = s.get("state")
                if state == "SUCCEEDED":
                    parts.append(np.asarray(s["result"]["embeddings"], np.float32))
                    break
                if state in ("FAILED", "DENIED", "CANCELLED", "TIMEOUT"):
                    raise RuntimeError(f"embed job {jid} reached {state}: "
                                       f"{s.get('error_message', '')}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"embed job {jid} not terminal "
                                       f"after {self.timeout_s}s")
                time.sleep(self.poll_s)
        return np.concatenate(parts, axis=0)


class BusEmbedder(EmbedFn):
    """Async EmbedFn that runs embeds on the worker pool over the bus.

    The engine-side counterpart of :class:`PoolEmbedder`: same per-job
    slicing, but bus-native and non-blocking, so it is safe to await from
    inside the control plane's event loop (``context.*`` workflow steps —
    PoolEmbedder's synchronous polling would deadlock there, since the
    results it waits for are produced by the same loop).  Each slice is a
    normal JobRequest on ``sys.job.submit`` stamped with the batch-affinity
    labels, so the scheduler coalesces concurrent slices onto one worker's
    micro-batcher exactly like gateway-submitted embeds
    (docs/BATCHING.md)."""

    def __init__(
        self,
        bus: Any,
        mem: Any,
        *,
        topic: str = "job.tpu.embed",
        texts_per_job: int = 16,
        timeout_s: float = 60.0,
        tenant_id: str = "",
    ) -> None:
        self.bus = bus
        self.mem = mem  # MemoryStore: pointers in, pointers out
        self.topic = topic
        self.texts_per_job = max(1, texts_per_job)
        self.timeout_s = timeout_s
        self.tenant_id = tenant_id
        self.embeds_total = 0  # texts embedded (bench: context_embeds_per_sec)
        self.jobs_total = 0
        self._pending: dict[str, asyncio.Future] = {}
        self._subs: list = []

    async def start(self) -> None:
        """Plain (non-queue-group) result subscriptions: see every result
        broadcast alongside the scheduler/engine queue groups, filter by
        our own job ids.  Both the plain subject and the partition-stamped
        ``sys.job.result.<p>`` variants are covered — under a sharded
        scheduler the worker echoes the owning shard's partition, so the
        embed results never ride the plain subject.  Lazy — first
        ``aembed`` call attaches them."""
        if not self._subs:
            self._subs.append(await self.bus.subscribe(subj.RESULT, self._on_result))
            self._subs.append(
                await self.bus.subscribe(f"{subj.RESULT}.>", self._on_result)
            )

    async def stop(self) -> None:
        for s in self._subs:
            s.unsubscribe()
        self._subs = []
        for fut in self._pending.values():
            if not fut.done():
                fut.cancel()
        self._pending.clear()

    async def _on_result(self, subject: str, pkt: BusPacket) -> None:
        res = pkt.job_result
        if res is None or res.job_id not in self._pending:
            return
        if res.status not in (s.value for s in TERMINAL_STATES):
            return  # RUNNING hint; keep waiting for the terminal state
        fut = self._pending.pop(res.job_id)
        if not fut.done():
            fut.set_result(res)

    def embed(self, texts: Sequence[str]) -> np.ndarray:  # pragma: no cover
        raise RuntimeError("BusEmbedder is async-only; await aembed(texts)")

    async def aembed(self, texts: Sequence[str]) -> np.ndarray:
        await self.start()
        loop = asyncio.get_running_loop()
        job_ids: list[str] = []
        futs: list[asyncio.Future] = []
        for i in range(0, len(texts), self.texts_per_job):
            job_id = f"ctxembed-{new_id()}"
            ptr = await self.mem.put_context(
                job_id, {"op": "embed", "texts": list(texts[i:i + self.texts_per_job])}
            )
            fut = loop.create_future()
            self._pending[job_id] = fut
            req = JobRequest(
                job_id=job_id,
                topic=self.topic,
                context_ptr=ptr,
                tenant_id=self.tenant_id,
                labels={LABEL_OP: "embed", LABEL_BATCH_KEY: "embed"},
            )
            await self.bus.publish(
                subj.SUBMIT, BusPacket.wrap(req, sender_id="bus-embedder")
            )
            job_ids.append(job_id)
            futs.append(fut)
        try:
            results = await asyncio.wait_for(asyncio.gather(*futs), self.timeout_s)
        finally:
            for jid in job_ids:
                self._pending.pop(jid, None)
        parts: list[np.ndarray] = []
        for jid, res in zip(job_ids, results):
            if res.status != JobState.SUCCEEDED.value:
                raise RuntimeError(
                    f"embed job {jid} reached {res.status}: {res.error_message}"
                )
            out = await self.mem.get_pointer(res.result_ptr)
            if not out or "embeddings" not in out:
                raise RuntimeError(f"embed job {jid} result missing embeddings")
            parts.append(np.asarray(out["embeddings"], np.float32))
        self.embeds_total += len(texts)
        self.jobs_total += len(job_ids)
        return np.concatenate(parts, axis=0)


class ContextService:
    def __init__(
        self,
        kv: KV,
        *,
        embedder: Optional[Any] = None,
        max_chunks: int = 10,
        embed_batch: int = 64,
    ):
        self.kv = kv
        self.embedder = embedder
        self.max_chunks = max_chunks
        # re-index embedding slice size (the `context.embed_batch` effective-
        # config field): bounds one embed call / one pool job per slice
        self.embed_batch = max(1, embed_batch)

    def _embed_texts(self, texts: list[str]) -> np.ndarray:
        """Embed through the bulk path in ``embed_batch``-sized slices so a
        large re-index becomes a few padded batch calls (local embedder) or
        a few pool jobs (PoolEmbedder) instead of one unbounded call."""
        parts = [
            np.asarray(self.embedder.embed(texts[i:i + self.embed_batch]))
            for i in range(0, len(texts), self.embed_batch)
        ]
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)

    async def _aembed_texts(self, texts: list[str]) -> np.ndarray:
        """Async twin of ``_embed_texts``: awaits an ``aembed``-capable
        embedder (BusEmbedder — pool jobs without blocking the event loop);
        sync embedders run inline as before."""
        aembed = getattr(self.embedder, "aembed", None)
        if aembed is None:
            return self._embed_texts(texts)
        parts = [
            np.asarray(await aembed(texts[i:i + self.embed_batch]))
            for i in range(0, len(texts), self.embed_batch)
        ]
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)

    # ------------------------------------------------------------------
    async def update_memory(
        self,
        memory_id: str,
        *,
        user_payload: Any = None,
        model_response: str = "",
        mode: str = MODE_CHAT,
    ) -> None:
        """Append chat events (RPUSH + LTRIM, reference :134-176)."""
        if user_payload is not None:
            ev = {"role": "user", "content": _as_text(user_payload)}
            await self.kv.rpush(_events_key(memory_id), json.dumps(ev).encode())
        if model_response:
            ev = {"role": "assistant", "content": model_response}
            await self.kv.rpush(_events_key(memory_id), json.dumps(ev).encode())
        await self.kv.ltrim(_events_key(memory_id), -HISTORY_CAP, -1)

    async def set_summary(self, memory_id: str, summary: str) -> None:
        await self.kv.set(_summary_key(memory_id), summary.encode())

    async def put_chunks(self, memory_id: str, chunks: list[dict[str, Any]]) -> int:
        """Store RAG chunks [{file_path, content, labels?}]; embeds them
        (incrementally — cached by content hash) when an embedder is wired."""
        await self.kv.set(_chunks_key(memory_id), json.dumps(chunks).encode())
        if self.embedder is None:
            return 0
        missing: list[tuple[str, str]] = []
        for c in chunks:
            h = _chunk_hash(c)
            if await self.kv.get(_embed_key(memory_id, h)) is None:
                missing.append((h, _chunk_text(c)))
        if missing:
            vecs = await self._aembed_texts([t for _, t in missing])
            for (h, _), v in zip(missing, np.asarray(vecs)):
                await self.kv.set(
                    _embed_key(memory_id, h), np.asarray(v, np.float32).tobytes()
                )
        return len(missing)

    # ------------------------------------------------------------------
    async def build_window(
        self,
        memory_id: str,
        *,
        mode: str = MODE_RAW,
        payload: Any = None,
        max_input_tokens: int = DEFAULT_MAX_INPUT_TOKENS,
    ) -> list[ModelMessage]:
        """RAW: payload only.  CHAT: last-20 history + payload.  RAG: ranked
        chunks (semantic when embedder present, else path/substring match)
        + summary fallback + history + payload."""
        msgs: list[ModelMessage] = []
        query = _as_text(payload)
        if mode in (MODE_CHAT, MODE_RAG):
            raw = await self.kv.lrange(_events_key(memory_id), -HISTORY_WINDOW, -1)
            for b in raw:
                try:
                    ev = json.loads(b)
                except ValueError:
                    continue
                msgs.append(ModelMessage(role=ev.get("role", "user"), content=ev.get("content", ""), source="history"))
        if mode == MODE_RAG:
            chunks = await self._rank_chunks(memory_id, query)
            if chunks:
                # reversed so the best-ranked chunk ends up first in the window
                for c, score in reversed(chunks):
                    msgs.insert(
                        0,
                        ModelMessage(
                            role="system",
                            content=f"[{c.get('file_path', 'chunk')}] {_chunk_text(c)}",
                            source=f"rag:{score:.3f}",
                        ),
                    )
            else:
                summary = await self.kv.get(_summary_key(memory_id))
                if summary:
                    msgs.insert(0, ModelMessage(role="system", content=summary.decode(), source="summary"))
        if payload is not None:
            msgs.append(ModelMessage(role="user", content=query, source="payload"))
        return trim_to_budget(msgs, max_input_tokens)

    async def _rank_chunks(self, memory_id: str, query: str) -> list[tuple[dict, float]]:
        b = await self.kv.get(_chunks_key(memory_id))
        if not b:
            return []
        chunks = json.loads(b)
        if not chunks:
            return []
        if self.embedder is not None and query:
            qv = np.asarray(await self._aembed_texts([query]))[0]
            scored = []
            to_embed: list[tuple[int, str]] = []
            vecs: dict[int, np.ndarray] = {}
            for i, c in enumerate(chunks):
                cached = await self.kv.get(_embed_key(memory_id, _chunk_hash(c)))
                if cached is not None:
                    vecs[i] = np.frombuffer(cached, np.float32)
                else:
                    to_embed.append((i, _chunk_text(c)))
            if to_embed:
                new_vecs = np.asarray(await self._aembed_texts([t for _, t in to_embed]))
                for (i, _), v in zip(to_embed, new_vecs):
                    vecs[i] = np.asarray(v, np.float32)
                    await self.kv.set(
                        _embed_key(memory_id, _chunk_hash(chunks[i])), vecs[i].tobytes()
                    )
            for i, c in enumerate(chunks):
                v = vecs[i]
                denom = float(np.linalg.norm(qv) * np.linalg.norm(v)) or 1.0
                scored.append((c, float(qv @ v) / denom))
            scored.sort(key=lambda cs: cs[1], reverse=True)
            return scored[: self.max_chunks]
        # lexical fallback (reference behavior: file_path substring match)
        q = query.lower()
        hits = [
            (c, 1.0)
            for c in chunks
            if q and (str(c.get("file_path", "")).lower() in q or _overlap(q, _chunk_text(c)))
        ]
        return hits[: self.max_chunks]


def trim_to_budget(msgs: list[ModelMessage], max_tokens: int) -> list[ModelMessage]:
    """Drop oldest non-payload messages until under budget (reference
    trimToBudget :279-296)."""
    if max_tokens <= 0:
        return msgs
    total = sum(estimate_tokens(m.content) for m in msgs)
    out = list(msgs)
    i = 0
    while total > max_tokens and i < len(out):
        if out[i].source == "payload":
            i += 1
            continue
        total -= estimate_tokens(out[i].content)
        out.pop(i)
    # a single over-budget payload gets hard-truncated
    if total > max_tokens and out:
        last = out[-1]
        keep = max_tokens * 4
        out[-1] = ModelMessage(role=last.role, content=last.content[:keep], source=last.source)
    return out


def _as_text(payload: Any) -> str:
    if payload is None:
        return ""
    if isinstance(payload, str):
        return payload
    try:
        return json.dumps(payload)
    except (TypeError, ValueError):
        return str(payload)


def _chunk_text(c: dict) -> str:
    return str(c.get("content", c.get("text", "")))


def _chunk_hash(c: dict) -> str:
    return hashlib.blake2b(
        (_chunk_text(c) + "|" + str(c.get("file_path", ""))).encode(), digest_size=8
    ).hexdigest()


def _overlap(query: str, text: str) -> bool:
    qtok = set(query.lower().split())
    ttok = set(text.lower().split())
    return len(qtok & ttok) >= max(1, len(qtok) // 4)
