"""Port copy of `inferno_tpu/core/__init__.py`, verbatim apart from its imports."""

from inferno_tpu_torch.core.allocation import (
    Allocation,
    AllocationDiff,
    allocation_diff,
    allocation_from_data,
    create_allocation,
    transition_penalty,
)
from inferno_tpu_torch.core.system import (
    Accelerator,
    Model,
    Server,
    ServiceClass,
    System,
)

__all__ = [
    "Allocation",
    "AllocationDiff",
    "allocation_diff",
    "allocation_from_data",
    "create_allocation",
    "transition_penalty",
    "Accelerator",
    "Model",
    "Server",
    "ServiceClass",
    "System",
]
