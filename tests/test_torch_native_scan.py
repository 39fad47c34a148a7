"""The port's native strategy scan (``cordum_tpu_torch/native``): its C
scan, built with ``cc`` into ``build/``, picks as its Python scan does and
as the JAX package's ``PackedWorkers`` does, over random registries and
requests (hypothesis, bounded examples); it counts the picks it serves; a
failed build raises where a compiler exists, and only a host without one
picks in Python.
"""
from __future__ import annotations

import shutil
from pathlib import Path

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from cordum_tpu.controlplane.scheduler import native_scan as ref_native_scan
from cordum_tpu.controlplane.scheduler import strategy as ref_strategy
from cordum_tpu.infra import config as ref_config
from cordum_tpu.infra import registry as ref_registry
from cordum_tpu.protocol import types as ref_types
from cordum_tpu_torch import native
from cordum_tpu_torch.controlplane.scheduler import native_scan, strategy
from cordum_tpu_torch.infra import config
from cordum_tpu_torch.infra import registry
from cordum_tpu_torch.protocol import types

REPO = Path(__file__).resolve().parents[1]
POOLS = {"topics": {"job.gpu.>": ["gpu", "gpu2"], "job.one": "gpu"},
         "pools": {"gpu": {"requires": ["gpu"]}, "gpu2": {"requires": ["gpu"]}}}
CAPS = ("gpu", "echo", "fp8")


@pytest.fixture(autouse=True)
def _compiler():
    if native.compiler() is None:
        pytest.skip("no C compiler on this host: the scheduler picks with the Python scan")


worker = st.fixed_dictionaries({
    "pool": st.sampled_from(["gpu", "gpu2", "other"]),
    "capabilities": st.lists(st.sampled_from(CAPS), unique=True, max_size=3),
    "chip_count": st.sampled_from([0, 1, 2, 4, 8]),
    "slice_topology": st.sampled_from(["", "2x2", "2x4"]),
    "active_jobs": st.integers(0, 12),
    "max_parallel_jobs": st.sampled_from([0, 1, 10, 64]),
    "cpu_load": st.sampled_from([0.0, 12.5, 50.0, 89.9, 90.0, 99.0]),
    "tpu_duty_cycle": st.sampled_from([0.0, 30.0, 90.0]),
    "devices_healthy": st.booleans(),
    "hbm_total_gb": st.sampled_from([0.0, 80.0]),
    "hbm_used_gb": st.sampled_from([0.0, 40.0, 79.0]),
})
request = st.tuples(
    st.sampled_from(["job.gpu.echo", "job.one", "job.unrouted"]),
    st.lists(st.sampled_from(["gpu", "fp8", "chips:2", "chips:4", "topology:2x2",
                              "topology:2x4"]), unique=True, max_size=3))


def _registries(workers):
    port, ref = registry.WorkerRegistry(), ref_registry.WorkerRegistry()
    for i, w in enumerate(workers):
        port.update(types.Heartbeat(worker_id=f"w{i:03d}", **w))
        ref.update(ref_types.Heartbeat(worker_id=f"w{i:03d}", **w))
    return port, ref


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(workers=st.lists(worker, max_size=40), requests=st.lists(request, min_size=1, max_size=8))
def test_c_scan_picks_as_the_python_scan_and_the_reference(workers, requests):
    port_reg, ref_reg = _registries(workers)
    c_scan = strategy.LeastLoadedStrategy(port_reg, config.parse_pool_config(POOLS))
    py_scan = strategy.LeastLoadedStrategy(port_reg, config.parse_pool_config(POOLS),
                                           native=False)
    ref_scan = ref_strategy.LeastLoadedStrategy(ref_reg, ref_config.parse_pool_config(POOLS),
                                                native=False)
    assert c_scan._packed is not None
    ref_packed = ref_native_scan.PackedWorkers(ref_reg)
    for i, (topic, requires) in enumerate(requests):
        req = types.JobRequest(job_id=f"j{i}", topic=topic,
                               metadata=types.JobMetadata(requires=requires))
        ref_req = ref_types.JobRequest(job_id=f"j{i}", topic=topic,
                                       metadata=ref_types.JobMetadata(requires=requires))
        want = ref_scan.pick_subject(ref_req)
        served = c_scan._packed.native_picks
        assert c_scan.pick_subject(req) == py_scan.pick_subject(req) == want
        if topic != "job.unrouted":
            # every routed shape here is one the C scan models
            assert c_scan._packed.native_picks == served + 1
        if ref_packed.available:
            caps, chips, topo = strategy._parse_tpu_requires(requires + ["gpu"])
            pools = ["gpu"] if topic == "job.one" else ["gpu", "gpu2"]
            got = c_scan._packed.pick(required_caps=caps, pool_names=pools,
                                      min_chips=chips, topology=topo)
            assert got == ref_packed.pick(required_caps=caps, pool_names=pools,
                                          min_chips=chips, topology=topo)


def test_the_port_builds_its_own_copy_of_the_scan_into_build():
    lib = native.load_strategy_scan()
    assert lib is not None and native.load_strategy_scan() is lib
    path = native.library_path()
    assert path.exists() and path.parent == REPO / "build"
    assert "build/" in (REPO / ".gitignore").read_text().split()
    ours = native.SOURCE.read_text().splitlines()
    theirs = (REPO / "cordum_tpu" / "native" / "strategy_scan.c").read_text().splitlines()
    assert native.SOURCE.parent == REPO / "cordum_tpu_torch" / "native"
    # the reference's C, word for word, but for the module path its comment names
    assert [a for a, b in zip(ours, theirs) if a != b] == [
        " * Selection semantics (must match cordum_tpu_torch/controlplane/scheduler/"]


def test_a_failed_build_raises_where_a_compiler_exists(tmp_path, monkeypatch):
    bad = tmp_path / "strategy_scan.c"
    bad.write_text("int pick_worker(void) { return }\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(native.NativeBuildError, match="failed"):
        native.load_strategy_scan(bad)
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(native.NativeBuildError):
        strategy.LeastLoadedStrategy(registry.WorkerRegistry(), config.parse_pool_config(POOLS))


def test_a_library_without_the_scan_raises(tmp_path, monkeypatch):
    src = tmp_path / "strategy_scan.c"
    src.write_text("int other(void) { return 0; }\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(native.NativeBuildError, match="cannot load"):
        native.load_strategy_scan(src)


def test_only_a_host_without_a_compiler_picks_in_python(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "_libs", {})
    assert native.compiler() is None and native.load_strategy_scan() is None
    s = strategy.LeastLoadedStrategy(registry.WorkerRegistry(), config.parse_pool_config(POOLS))
    assert s._packed is None
    packed = native_scan.PackedWorkers(registry.WorkerRegistry())
    assert not packed.available
