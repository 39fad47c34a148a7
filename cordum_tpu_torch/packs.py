"""Pack system: installable behavior bundles ("products").

Recreates the reference pack pipeline (``core/controlplane/gateway/packs.go``
+ ``cmd/cordumctl/pack.go``; manifest example
``examples/demo-guardrails/pack.yaml``): a pack directory holds a
``pack.yaml`` manifest declaring topics (with capability/risk tags),
resource workflows + JSON schemas, config overlays (JSON-merge-patch onto
config-service docs), policy overlays (rule fragments installed under the
``cfg:system:policy/`` namespace with an ``enabled`` toggle), and policy
simulations that must pass before the install commits.

Install is plan → apply → verify → rollback-on-failure; installed packs are
recorded in the registry doc ``cfg:system:packs``.

Manifest shape::

    apiVersion: cordum-tpu/v1
    kind: Pack
    id: demo-guardrails
    name: Demo guardrails
    version: 0.1.0
    topics:
      - topic: job.tpu.infer
        capability: tpu
        risk_tags: [model-inference]
    resources:
      workflows: [workflows/*.yaml]      # or inline: [{...}]
      schemas:   [schemas/*.json]        # or inline: {id: {...}}
    overlays:
      config:
        - scope: system
          id: default
          patch: {rate_limits: {concurrent_jobs: 8}}
      policy:
        - id: guardrails
          fragment:
            enabled: true
            rules: [...]
    simulations:
      - name: deny-destructive
        request: {topic: job.x, metadata: {risk_tags: [destructive]}}
        expect: DENY
"""
from __future__ import annotations

import glob as globmod
import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional

import yaml

from .infra import logging as logx
from .infra.configsvc import ConfigService
from .infra.schemareg import SchemaRegistry
from .protocol.types import JobMetadata, PolicyCheckRequest
from .utils.ids import now_us
from .workflow.models import Workflow
from .workflow.store import WorkflowStore

PACKS_REGISTRY_ID = "packs"  # cfg:system:packs
POLICY_PREFIX = "policy/"
API_VERSION = "cordum-tpu/v1"


class PackError(Exception):
    pass


@dataclass
class PackManifest:
    id: str = ""
    name: str = ""
    version: str = "0.0.0"
    description: str = ""
    topics: list[dict] = field(default_factory=list)
    workflows: list[dict] = field(default_factory=list)       # resolved docs
    schemas: dict[str, dict] = field(default_factory=dict)    # id → schema
    config_overlays: list[dict] = field(default_factory=list)
    policy_overlays: list[dict] = field(default_factory=list)
    simulations: list[dict] = field(default_factory=list)


def load_pack_dir(path: str) -> PackManifest:
    manifest_path = os.path.join(path, "pack.yaml")
    if not os.path.exists(manifest_path):
        raise PackError(f"no pack.yaml in {path}")
    with open(manifest_path) as f:
        doc = yaml.safe_load(f) or {}
    if doc.get("apiVersion") != API_VERSION or doc.get("kind") != "Pack":
        raise PackError(f"not a {API_VERSION} Pack manifest")
    m = PackManifest(
        id=str(doc.get("id", "")),
        name=str(doc.get("name", doc.get("id", ""))),
        version=str(doc.get("version", "0.0.0")),
        description=str(doc.get("description", "")),
        topics=list(doc.get("topics") or []),
        simulations=list(doc.get("simulations") or []),
    )
    if not m.id:
        raise PackError("pack id is required")
    res = doc.get("resources") or {}
    for entry in res.get("workflows") or []:
        if isinstance(entry, dict):
            m.workflows.append(entry)
        else:
            for fp in sorted(globmod.glob(os.path.join(path, entry))):
                with open(fp) as f:
                    m.workflows.append(yaml.safe_load(f) or {})
    schemas = res.get("schemas")
    if isinstance(schemas, dict):
        m.schemas.update(schemas)
    else:
        for entry in schemas or []:
            for fp in sorted(globmod.glob(os.path.join(path, entry))):
                with open(fp) as f:
                    sid = os.path.splitext(os.path.basename(fp))[0]
                    m.schemas[sid] = json.load(f)
    overlays = doc.get("overlays") or {}
    m.config_overlays = list(overlays.get("config") or [])
    m.policy_overlays = list(overlays.get("policy") or [])
    return m


def manifest_from_doc(doc: dict) -> PackManifest:
    """Inline manifest (HTTP install path): resources must be inline."""
    m = PackManifest(
        id=str(doc.get("id", "")),
        name=str(doc.get("name", doc.get("id", ""))),
        version=str(doc.get("version", "0.0.0")),
        description=str(doc.get("description", "")),
        topics=list(doc.get("topics") or []),
        simulations=list(doc.get("simulations") or []),
    )
    if not m.id:
        raise PackError("pack id is required")
    res = doc.get("resources") or {}
    m.workflows = [w for w in (res.get("workflows") or []) if isinstance(w, dict)]
    schemas = res.get("schemas") or {}
    if isinstance(schemas, dict):
        m.schemas = dict(schemas)
    overlays = doc.get("overlays") or {}
    m.config_overlays = list(overlays.get("config") or [])
    m.policy_overlays = list(overlays.get("policy") or [])
    return m


class PackInstaller:
    """plan → apply (with undo journal) → verify → rollback-on-failure."""

    def __init__(
        self,
        *,
        configsvc: ConfigService,
        schemas: SchemaRegistry,
        wf_store: WorkflowStore,
        kernel: Any = None,  # SafetyKernel; needed for simulations + reload
    ):
        self.configsvc = configsvc
        self.schemas = schemas
        self.wf_store = wf_store
        self.kernel = kernel

    # -- registry -------------------------------------------------------
    async def list_installed(self) -> dict[str, dict]:
        doc = await self.configsvc.get("system", PACKS_REGISTRY_ID)
        return dict(doc.data) if doc else {}

    async def _record(self, m: PackManifest, record: dict) -> None:
        installed = await self.list_installed()
        installed[m.id] = record
        await self.configsvc.set("system", PACKS_REGISTRY_ID, installed)

    # -- plan -----------------------------------------------------------
    def plan(self, m: PackManifest) -> list[str]:
        actions = []
        for wf in m.workflows:
            actions.append(f"install workflow {wf.get('id', '?')}")
        for sid in m.schemas:
            actions.append(f"register schema {sid}")
        for ov in m.config_overlays:
            actions.append(f"patch config {ov.get('scope')}:{ov.get('id')}")
        for ov in m.policy_overlays:
            actions.append(f"install policy fragment {POLICY_PREFIX}{m.id}/{ov.get('id')}")
        for sim in m.simulations:
            actions.append(f"verify simulation {sim.get('name', '?')}")
        return actions

    # -- install --------------------------------------------------------
    async def install(self, m: PackManifest) -> dict:
        undo: list = []
        record: dict = {
            "id": m.id, "name": m.name, "version": m.version,
            "installed_at_us": now_us(),
            "workflows": [], "schemas": [], "policy_fragments": [],
            "config_overlays": [],
        }
        try:
            for wdoc in m.workflows:
                wf = Workflow.from_dict(wdoc)
                errs = wf.validate()
                if errs:
                    raise PackError(f"workflow {wf.id}: {'; '.join(errs)}")
                prev = await self.wf_store.get_workflow(wf.id)
                await self.wf_store.put_workflow(wf)
                undo.append(("workflow", wf.id, prev))
                record["workflows"].append(wf.id)
            for sid, schema in m.schemas.items():
                prev = await self.schemas.get(sid)
                await self.schemas.put(sid, schema)
                undo.append(("schema", sid, prev))
                record["schemas"].append(sid)
            for ov in m.config_overlays:
                scope, doc_id = str(ov.get("scope", "system")), str(ov.get("id", "default"))
                prev_doc = await self.configsvc.get(scope, doc_id)
                await self.configsvc.patch(scope, doc_id, ov.get("patch") or {})
                undo.append(("config", (scope, doc_id), prev_doc.data if prev_doc else None))
                record["config_overlays"].append({"scope": scope, "id": doc_id})
            for ov in m.policy_overlays:
                frag_id = f"{POLICY_PREFIX}{m.id}/{ov.get('id', 'fragment')}"
                prev_doc = await self.configsvc.get("system", frag_id)
                await self.configsvc.set("system", frag_id, ov.get("fragment") or {})
                undo.append(("policy", frag_id, prev_doc.data if prev_doc else None))
                record["policy_fragments"].append(frag_id)
            if self.kernel is not None and (m.policy_overlays or m.config_overlays):
                await self.kernel.reload()
            await self._verify(m)
            await self._record(m, record)
            logx.info("pack installed", pack=m.id, version=m.version)
            return record
        except Exception:
            await self._rollback(undo)
            raise

    async def _verify(self, m: PackManifest) -> None:
        """Run the pack's policy simulations against the live kernel
        (reference runPolicySimulation, packs.go:1725)."""
        if not m.simulations:
            return
        if self.kernel is None:
            raise PackError("pack declares simulations but no kernel is wired")
        for sim in m.simulations:
            reqdoc = sim.get("request") or {}
            meta = reqdoc.get("metadata")
            req = PolicyCheckRequest(
                tenant_id=str(reqdoc.get("tenant_id", "")),
                topic=str(reqdoc.get("topic", "")),
                labels={str(k): str(v) for k, v in (reqdoc.get("labels") or {}).items()},
                metadata=JobMetadata.from_dict(meta) if meta else None,
            )
            resp = await self.kernel.evaluate_raw(req)
            expect = str(sim.get("expect", "")).upper()
            if expect and resp.decision != expect:
                raise PackError(
                    f"simulation {sim.get('name', '?')}: expected {expect}, got "
                    f"{resp.decision} ({resp.reason})"
                )

    async def _rollback(self, undo: list) -> None:
        for kind, key, prev in reversed(undo):
            try:
                if kind == "workflow":
                    if prev is None:
                        await self.wf_store.delete_workflow(key)
                    else:
                        await self.wf_store.put_workflow(prev)
                elif kind == "schema":
                    if prev is None:
                        await self.schemas.delete(key)
                    else:
                        await self.schemas.put(key, prev)
                elif kind == "config":
                    scope, doc_id = key
                    if prev is None:
                        await self.configsvc.delete(scope, doc_id)
                    else:
                        await self.configsvc.set(scope, doc_id, prev)
                elif kind == "policy":
                    if prev is None:
                        await self.configsvc.delete("system", key)
                    else:
                        await self.configsvc.set("system", key, prev)
            except Exception:
                logx.error("pack rollback step failed", kind=kind, key=str(key))
        if self.kernel is not None:
            try:
                await self.kernel.reload()
            except Exception as e:  # noqa: BLE001 - rollback must not mask install error
                logx.error("kernel reload failed after pack rollback", err=str(e))

    # -- uninstall -------------------------------------------------------
    async def uninstall(self, pack_id: str) -> bool:
        installed = await self.list_installed()
        record = installed.pop(pack_id, None)
        if record is None:
            return False
        for wf_id in record.get("workflows", []):
            await self.wf_store.delete_workflow(wf_id)
        for sid in record.get("schemas", []):
            await self.schemas.delete(sid)
        for frag_id in record.get("policy_fragments", []):
            await self.configsvc.delete("system", frag_id)
        # config overlays are merge-patches; uninstall does not attempt to
        # un-merge them (matches reference semantics: overlays persist)
        await self.configsvc.set("system", PACKS_REGISTRY_ID, installed)
        if self.kernel is not None:
            await self.kernel.reload()
        logx.info("pack uninstalled", pack=pack_id)
        return True


# ---------------------------------------------------------------- catalogs


CATALOGS_DOC_ID = "pack_catalogs"  # cfg:system:pack_catalogs


class PackCatalog:
    """Pack catalogs: named collections of installable packs.

    The reference's marketplace catalogs fetch from allowed HTTP hosts
    (packs.go:933-1368); this deployment is network-isolated, so catalogs
    are *local directories* gated by an allowed-roots list stored alongside
    them — the same trust boundary (admins control which sources installs
    may come from), without the egress.
    """

    def __init__(self, configsvc: ConfigService, installer: PackInstaller):
        self.configsvc = configsvc
        self.installer = installer

    async def _doc(self) -> dict:
        doc = await self.configsvc.get("system", CATALOGS_DOC_ID)
        return dict(doc.data) if doc else {"catalogs": {}, "allowed_roots": []}

    async def add_catalog(self, name: str, path: str) -> dict:
        data = await self._doc()
        # Resolve symlinks before the containment check: a plain prefix test
        # would let /srv/packs-evil pass for allowed root /srv/packs, and a
        # symlink inside an allowed root could escape it.
        root = os.path.realpath(path)
        allowed = data.get("allowed_roots") or []
        if allowed and not any(self._contains(os.path.realpath(a), root) for a in allowed):
            raise PackError(f"catalog path {root} outside allowed roots {allowed}")
        if not os.path.isdir(root):
            raise PackError(f"catalog path {root} is not a directory")
        data.setdefault("catalogs", {})[name] = {"path": root}
        await self.configsvc.set("system", CATALOGS_DOC_ID, data)
        return data["catalogs"][name]

    @staticmethod
    def _contains(ancestor: str, path: str) -> bool:
        """True iff ``path`` is ``ancestor`` or lies inside it (both resolved)."""
        try:
            return os.path.commonpath([ancestor, path]) == ancestor
        except ValueError:  # different drives / mixed abs-rel
            return False

    async def set_allowed_roots(self, roots: list[str]) -> None:
        data = await self._doc()
        data["allowed_roots"] = [os.path.abspath(r) for r in roots]
        await self.configsvc.set("system", CATALOGS_DOC_ID, data)

    async def list_catalogs(self) -> dict:
        return (await self._doc()).get("catalogs", {})

    async def list_packs(self, catalog: str) -> list[dict]:
        catalogs = await self.list_catalogs()
        entry = catalogs.get(catalog)
        if entry is None:
            raise PackError(f"unknown catalog {catalog!r}")
        out = []
        for child in sorted(os.listdir(entry["path"])):
            pdir = os.path.join(entry["path"], child)
            if os.path.exists(os.path.join(pdir, "pack.yaml")):
                try:
                    m = load_pack_dir(pdir)
                    out.append({"id": m.id, "version": m.version, "name": m.name,
                                "description": m.description})
                except PackError:
                    continue
        return out

    async def install_from_catalog(self, catalog: str, pack_id: str) -> dict:
        catalogs = await self.list_catalogs()
        entry = catalogs.get(catalog)
        if entry is None:
            raise PackError(f"unknown catalog {catalog!r}")
        for child in sorted(os.listdir(entry["path"])):
            pdir = os.path.join(entry["path"], child)
            if not os.path.exists(os.path.join(pdir, "pack.yaml")):
                continue
            try:
                m = load_pack_dir(pdir)
            except PackError:
                continue
            if m.id == pack_id:
                return await self.installer.install(m)
        raise PackError(f"pack {pack_id!r} not found in catalog {catalog!r}")
