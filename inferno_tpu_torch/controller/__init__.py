"""Controller package.

The reconciler (and its solver stack) loads lazily via PEP 562 so that
lightweight submodules — watch transport, CRD types, constants — can be
imported without paying the solver import cost.

Port copy of `inferno_tpu/controller/__init__.py`, verbatim apart from its imports.
"""

from inferno_tpu_torch.controller.crd import (
    VariantAutoscaling,
    VariantAutoscalingSpec,
    VariantAutoscalingStatus,
)
from inferno_tpu_torch.controller.kube import InMemoryCluster, KubeClient

__all__ = [
    "VariantAutoscaling",
    "VariantAutoscalingSpec",
    "VariantAutoscalingStatus",
    "InMemoryCluster",
    "KubeClient",
    "Reconciler",
    "ReconcilerConfig",
]


def __getattr__(name):
    if name in ("Reconciler", "ReconcilerConfig"):
        from inferno_tpu_torch.controller import reconciler

        return getattr(reconciler, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
