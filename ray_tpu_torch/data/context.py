"""Execution context for ray_tpu_torch.data: backpressure policies + knobs.

Analog of the reference's ``DataContext`` + pluggable backpressure
(``python/ray/data/context.py``,
``data/_internal/execution/backpressure_policy/``): the streaming executor
asks every installed policy before admitting another fused block task;
any policy can veto. Policies are swappable per-process (tests swap in a
concurrency cap of 1 to serialize execution; memory-tight hosts install a
smaller ``MemoryBudgetPolicy``).
"""

from __future__ import annotations

from typing import List, Optional


class BackpressurePolicy:
    """One admission-control rule for the streaming executor.

    ``can_admit`` is consulted before each new fused task launch with the
    current number of in-flight tasks and the executor's rolling estimate
    of in-flight block bytes; returning False pauses submission until a
    task completes (reference: ``backpressure_policy/backpressure_policy.py``).
    """

    def can_admit(self, inflight_tasks: int, inflight_bytes: int) -> bool:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


class ConcurrencyCapPolicy(BackpressurePolicy):
    """Bound in-flight fused tasks (reference:
    ``backpressure_policy/concurrency_cap_backpressure_policy.py``)."""

    def __init__(self, cap: int):
        self.cap = max(1, int(cap))

    def can_admit(self, inflight_tasks: int, inflight_bytes: int) -> bool:
        return inflight_tasks < self.cap

    def describe(self) -> str:
        return f"ConcurrencyCapPolicy(cap={self.cap})"


class MemoryBudgetPolicy(BackpressurePolicy):
    """Bound estimated in-flight object-store bytes — blocks already
    produced but not yet consumed count against the stream's budget
    (the role of the reference's resource-budget backpressure in
    ``streaming_executor_state.py``)."""

    def __init__(self, budget_bytes: int):
        self.budget = max(1, int(budget_bytes))

    def can_admit(self, inflight_tasks: int, inflight_bytes: int) -> bool:
        # Always allow some pipelining even when one block exceeds the
        # budget estimate (a stuck stream helps nobody).
        return inflight_tasks < 2 or inflight_bytes < self.budget

    def describe(self) -> str:
        return f"MemoryBudgetPolicy(budget={self.budget})"


class DataContext:
    """Per-process dataset-execution configuration.

    ``backpressure_policies=None`` means "defaults at execution time":
    a CPU-scaled concurrency cap plus the store memory budget — exactly
    the admission rule the executor applied before policies were
    pluggable.
    """

    _current: Optional["DataContext"] = None

    def __init__(self):
        self.backpressure_policies: Optional[List[BackpressurePolicy]] = None
        self.optimizer_enabled: bool = True
        # Prefer scheduling a fused task on a node already holding its
        # input block (soft affinity; multi-node clusters only).
        self.locality_aware_scheduling: bool = True
        # Optional ray.data.ExecutionOptions: resource_limits.
        # object_store_memory overrides the default memory budget and
        # locality_with_output forces locality scheduling on.
        self.execution_options = None

    @classmethod
    def get_current(cls) -> "DataContext":
        if cls._current is None:
            cls._current = DataContext()
        return cls._current

    @classmethod
    def reset(cls):
        cls._current = None
