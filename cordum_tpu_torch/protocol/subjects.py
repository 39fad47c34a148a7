"""Bus subject constants (reference ``core/protocol/capsdk/constants.go:3-12``)."""
from __future__ import annotations

SUBMIT = "sys.job.submit"
RESULT = "sys.job.result"
HEARTBEAT = "sys.heartbeat"
PROGRESS = "sys.job.progress"
CANCEL = "sys.job.cancel"
DLQ = "sys.job.dlq"
WORKFLOW_EVENT = "sys.workflow.event"
# workflow-internal step results (``context.*`` steps executed in-engine,
# docs/WORKFLOWS.md §Context engine): the same JobResult payloads as RESULT,
# but on a subject the scheduler does NOT consume — the jobstore never saw
# these jobs, so riding ``sys.job.result`` would log an illegal-transition
# error per context step.  The workflow-engine queue group consumes it, so
# any replica may apply the result under the run lock.
STEP_RESULT = "sys.workflow.step.result"
# graceful worker drain (docs/SERVING.md §Migration, drain, and failover):
# fan-out — every worker hears it and the addressed one drains.  Not
# durable: a drain request is an operator action, re-issued if lost.
DRAIN = "sys.worker.drain"
# batch-job preemption (docs/ADMISSION.md §Preemption): fan-out — every
# worker hears the JobPreempt and the one holding the job hands it back
# (SESSION_REQUEUE) where safe.  Not durable: the preemption governor
# re-issues while interactive pressure persists, so a lost request only
# delays one preemption by an evaluation interval.
PREEMPT = "sys.job.preempt"
# overload-pressure beacons from the gateway admission controller
# (docs/ADMISSION.md): the scheduler's preemption governor and the serving
# engines consume them.  Not durable: pressure is a live signal.
ADMISSION_PRESSURE = "sys.admission.pressure"
# serving disaggregation (docs/SERVING.md §Disaggregation): ownership
# announcements after a session migration commits (the adopting worker
# fans out SessionMoved so scheduler shards retarget session affinity to
# the new owner), and the decode rebalancer's move requests (the scheduler
# governor fans out SessionRebalance; the addressed worker migrates its
# cheapest sessions toward the named headroom target).  Neither is
# durable: affinity self-heals via eviction + re-election on loss, and the
# governor re-evaluates skew every interval so a lost rebalance request
# only delays one move.
SERVING_MOVED = "sys.serving.moved"
SERVING_REBALANCE = "sys.serving.rebalance"
# gang scheduling (docs/GANG.md): every multi-chip gang owns one subject,
# ``sys.job.gang.<gang_id>``, carrying its whole coordination traffic —
# member rendezvous beacons, the abort fan-out, per-member completion
# reports, and MPMD stage activations/cotangents.  Fan-out (members and the
# owning scheduler shard all subscribe) and deliberately NOT durable: gang
# coordination is live state — a lost beacon is re-published by the member's
# rendezvous loop, and a wedged gang is recovered by the scheduler-side
# watchdog (rendezvous timeout / dead-member abort), never by redelivery.
GANG_PREFIX = "sys.job.gang."
GANG_WILDCARD = "sys.job.gang.>"
JOB_EVENTS_WILDCARD = "sys.job.>"  # every job lifecycle event (gateway tap)
TRACE_SPAN = "sys.trace.span"  # finished flight-recorder spans → collector

# Fleet telemetry plane (docs/OBSERVABILITY.md §Fleet telemetry): every
# process publishes periodic metric snapshots + a health beacon on
# ``sys.telemetry.<service>``; the gateway-hosted FleetAggregator consumes
# the wildcard.  Deliberately NOT durable: a snapshot is stale the moment
# the next one lands, so redelivery would only add load.
TELEMETRY_PREFIX = "sys.telemetry."
TELEMETRY_WILDCARD = "sys.telemetry.>"


def telemetry_subject(service: str) -> str:
    """Telemetry snapshot subject for a service (``sys.telemetry.<service>``)."""
    return f"{TELEMETRY_PREFIX}{service}"


def gang_subject(gang_id: str) -> str:
    """Coordination subject for one gang (``sys.job.gang.<gang_id>``)."""
    return f"{GANG_PREFIX}{gang_id}"

JOB_PREFIX = "job."
WORKER_PREFIX = "worker."

# Queue (consumer-group) names
QUEUE_SCHEDULER = "cordum-scheduler"
QUEUE_WORKFLOW_ENGINE = "cordum-workflow-engine"
QUEUE_SPAN_COLLECTOR = "cordum-span-collector"


def direct_subject(worker_id: str) -> str:
    """Direct worker-targeted delivery subject (reference bus/nats.go:94-99)."""
    return f"worker.{worker_id}.jobs"


# -- keyspace-partitioned lifecycle subjects (sharded scheduler) -----------
# Shard ``i`` of ``n`` owns every job with partition_of(job_id, n) == i and
# consumes its slice via ``sys.job.submit.<i>`` / ``sys.job.result.<i>`` /
# ``sys.job.cancel.<i>``.  The plain subjects stay live as the unstamped
# fallback: whichever shard draws an unstamped message from the queue group
# forwards it to the owner's partition subject (docs/PROTOCOL.md).

def submit_subject(partition: int, partition_count: int) -> str:
    """Submit subject for a partition; plain SUBMIT when unsharded."""
    if partition_count <= 1:
        return SUBMIT
    return f"{SUBMIT}.{partition}"


def result_subject(partition: int, partition_count: int) -> str:
    if partition_count <= 1:
        return RESULT
    return f"{RESULT}.{partition}"


def cancel_subject(partition: int, partition_count: int) -> str:
    if partition_count <= 1:
        return CANCEL
    return f"{CANCEL}.{partition}"


def submit_subject_for(job_id: str, partition_count: int) -> str:
    """Partition-stamped submit subject for a job (gateway/SDK submit leg)."""
    from .partition import partition_of

    return submit_subject(partition_of(job_id, partition_count), partition_count)


def stamped_result_subject(partition_label: str) -> str:
    """Result subject for a request that carries ``LABEL_PARTITION``
    (workers echo the owning shard's partition); plain RESULT otherwise."""
    if partition_label.isdigit():
        return f"{RESULT}.{partition_label}"
    return RESULT


def is_durable_subject(subject: str) -> bool:
    """Subjects that get at-least-once semantics under the durable bus
    (reference nats.go:369-381: submit/result/dlq/job.*/worker.*.jobs;
    TRACE_SPAN added so a bus blip cannot silently hole a trace; the
    partitioned ``sys.job.submit.<p>``/``result.<p>``/``cancel.<p>``
    variants inherit their parents' durability)."""
    if subject in (SUBMIT, RESULT, DLQ, TRACE_SPAN, STEP_RESULT):
        # STEP_RESULT is durable: a dropped context-step result would strand
        # its run in RUNNING (these jobs have no jobstore state to replay)
        return True
    for parent in (SUBMIT, RESULT, CANCEL):
        if subject.startswith(parent + "."):
            return True
    if subject.startswith(JOB_PREFIX):
        return True
    if subject.startswith(WORKER_PREFIX) and subject.endswith(".jobs"):
        return True
    return False
