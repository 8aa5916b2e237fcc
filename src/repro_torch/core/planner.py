"""Split-plan records: copies of the reference's ``SegmentPlan`` and
``SplitPlan`` (``repro.core.planner``), data only.

The serving meter reads ``plan.segments[i].tx_bytes``; these let a plan
made by the reference's planner be carried across
(``repro_torch.convert.plan_from_reference``). The planner itself is not
ported."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class SegmentPlan:
    device: int  # 1-indexed device/stage
    first_layer: int  # 1-indexed inclusive
    last_layer: int
    layer_names: tuple[str, ...]
    infer_s: float
    param_bytes: int
    tx_bytes: int  # activation bytes leaving this segment (0 for the last)
    cost_s: float


@dataclass(frozen=True)
class SplitPlan:
    model: str
    solver: str
    n_devices: int
    splits: tuple[int, ...]
    segments: tuple[SegmentPlan, ...]
    total_latency_s: float  # Eq. 8 incl. setup + feedback
    objective_cost_s: float  # solver objective (no overheads)
    planner_time_s: float
    nodes_expanded: int
    # joint (split, variant) solves: the adopted bottleneck variant's bank
    # index and accuracy proxy; None / 1.0 for single-variant plans
    variant: int | None = None
    accuracy_proxy: float = 1.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
