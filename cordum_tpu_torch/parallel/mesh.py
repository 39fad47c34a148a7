"""The mesh vocabulary of ``cordum_tpu/parallel/mesh.py``: the five axis
names and :class:`MeshSpec` with its ``resolve``.

  * ``dp`` — data parallel (batch)
  * ``tp`` — tensor/model parallel
  * ``sp`` — sequence/context parallel (long-context activations)
  * ``ep`` — expert parallel (MoE routing)
  * ``pp`` — pipeline parallel (layer stages)

A training job on one card needs no device mesh: the train step runs on the
card, and the resolved axis sizes (all 1 there) are what the job reports.
Meshes over several ranks (``torch.distributed``) come with ROADMAP A6 and
A11.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

AXIS_DP = "dp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_EP = "ep"
AXIS_PP = "pp"


@dataclass
class MeshSpec:
    """Logical mesh shape; -1 on one axis means "absorb remaining devices"."""

    dp: int = -1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        """Each axis's size over ``n_devices`` devices, in the order dp, tp,
        sp, ep, pp.  Raises ``ValueError`` for an axis below 1 other than
        -1, more than one -1, or sizes that do not multiply out to
        ``n_devices``."""
        if n_devices < 1:
            raise ValueError("need at least one device")
        sizes = {"dp": self.dp, "tp": self.tp, "sp": self.sp, "ep": self.ep, "pp": self.pp}
        bad = {k: v for k, v in sizes.items() if v != -1 and v < 1}
        if bad:
            raise ValueError(f"mesh axes must be -1 or >= 1, got {bad}")
        fixed = math.prod(v for v in sizes.values() if v > 0)
        free = [k for k, v in sizes.items() if v == -1]
        if len(free) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if fixed > n_devices:
            raise ValueError(f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        if free:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[free[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return sizes
