"""TPU chip inventory from cluster nodes.

The reference ships only a stub for cluster inventory ("limited mode",
CollectInventoryK8S + a GPU vendor list,
upstream internal/collector/collector.go:23-42). Here it is
live: nodes advertising `google.com/tpu` extended resources are summed
into per-generation chip pools, keyed by the GKE TPU accelerator label —
exactly the CapacitySpec shape the greedy solver consumes, so the
limited optimizer can run against real cluster capacity with no static
configuration.

Port copy of `inferno_tpu/controller/inventory.py`, verbatim apart from its imports.
"""

from __future__ import annotations

from inferno_tpu_torch.config.types import CapacitySpec
from inferno_tpu_torch.controller.kube import KubeError

TPU_RESOURCE = "google.com/tpu"
ACCELERATOR_LABEL = "cloud.google.com/gke-tpu-accelerator"

# GKE accelerator label values -> capacity pool (generation)
GENERATION_BY_ACCELERATOR = {
    "tpu-v4-podslice": "v4",
    "tpu-v5-lite-podslice": "v5e",
    "tpu-v5-lite-device": "v5e",
    "tpu-v5p-slice": "v5p",
    "tpu-v6e-slice": "v6e",
}


def generation_of(node: dict) -> str | None:
    label = (node.get("metadata", {}).get("labels", {}) or {}).get(
        ACCELERATOR_LABEL, ""
    )
    if not label:
        return None
    return GENERATION_BY_ACCELERATOR.get(label, label)


def node_tpu_chips(node: dict) -> int:
    status = node.get("status", {}) or {}
    alloc = status.get("allocatable") or status.get("capacity") or {}
    try:
        return int(alloc.get(TPU_RESOURCE, 0) or 0)
    except (TypeError, ValueError):
        return 0


def collect_tpu_inventory(kube) -> CapacitySpec:
    """Sum allocatable `google.com/tpu` chips per generation pool across
    schedulable nodes. Raises KubeError upward (callers fall back to
    configured capacity)."""
    chips: dict[str, int] = {}
    for node in kube.list_nodes():
        spec = node.get("spec", {}) or {}
        if spec.get("unschedulable"):
            continue
        n = node_tpu_chips(node)
        if n <= 0:
            continue
        gen = generation_of(node)
        if gen is None:
            continue
        chips[gen] = chips.get(gen, 0) + n
    return CapacitySpec(chips=chips)


__all__ = [
    "ACCELERATOR_LABEL",
    "TPU_RESOURCE",
    "collect_tpu_inventory",
    "generation_of",
    "node_tpu_chips",
]
