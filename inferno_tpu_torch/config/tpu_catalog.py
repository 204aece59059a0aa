"""TPU slice-shape catalog.

The reference models accelerators as {type, multiplicity} card bundles
(upstream pkg/config/types.go:29-37). On TPU the natural allocation
unit is a *slice*: a contiguous block of chips connected by ICI, scheduled
atomically across `chips/chips_per_host` hosts. A "replica" of an inference
server is one pod-slice; capacity is counted in chips per generation pool;
feasible shapes are constrained by the ICI torus topology of each
generation.

This catalog is data, not code: deployments can extend it via the
accelerator ConfigMap; these entries are the built-in shapes.

Port copy of `inferno_tpu/config/tpu_catalog.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses

# Host granularity: one v5e/v5p/v6e host exposes 4 chips; multi-host slices
# scale in whole-host increments. This is the TPU analogue of the reference's
# capacity arithmetic in units × multiplicity (pkg/core/system.go:296).
CHIPS_PER_HOST = 4


@dataclasses.dataclass(frozen=True)
class SliceShape:
    """A feasible TPU slice: generation + ICI topology."""

    name: str  # e.g. "v5e-16"
    generation: str  # capacity pool: "v5e", "v5p", "v6e"
    topology: str  # ICI torus, e.g. "4x4" or "2x2x2"
    chips: int  # chips in the slice

    @property
    def hosts(self) -> int:
        """Whole hosts occupied (multi-host slices scale atomically)."""
        return max(1, self.chips // CHIPS_PER_HOST)

    @property
    def multi_host(self) -> bool:
        return self.hosts > 1

    @property
    def ici_links(self) -> int:
        """Approximate count of ICI links in the torus (used only as a
        relative interconnect-richness signal, not a performance model)."""
        dims = [int(d) for d in self.topology.split("x")]
        links = 0
        for i, d in enumerate(dims):
            other = 1
            for j, e in enumerate(dims):
                if j != i:
                    other *= e
            # wrap-around links only exist for dims >= 3 on a torus
            per_dim = d if d >= 3 else d - 1
            links += per_dim * other
        return links


@dataclasses.dataclass(frozen=True)
class GenerationSpec:
    """Per-chip hardware constants of one TPU generation, used by the
    cross-generation profile derivation (models/profiles.py): decode is
    HBM-bandwidth-bound, prefill compute-bound, collectives ride ICI.

    Values are public Cloud TPU specifications (cloud.google.com/tpu/docs
    system-architecture pages): v5e 16 GiB / 819 GB/s / 197 bf16 TFLOPs;
    v5p 95 GiB / 2765 GB/s / 459; v6e (Trillium) 32 GiB / 1640 GB/s /
    918. `ici_bw_gbs` is one-way per-link bandwidth (the scaling-book
    convention the TP derivation costs its ring all-reduces with)."""

    name: str
    hbm_per_chip_gb: float
    hbm_bw_gbs: float
    bf16_tflops: float
    ici_bw_gbs: float
    ici_latency_us: float = 1.0


TPU_GENERATIONS: dict[str, GenerationSpec] = {
    "v5e": GenerationSpec("v5e", 16.0, 819.0, 197.0, 45.0),
    "v5p": GenerationSpec("v5p", 95.0, 2765.0, 459.0, 90.0),
    "v6e": GenerationSpec("v6e", 32.0, 1640.0, 918.0, 90.0),
}


def generation_from_device_kind(kind: str) -> GenerationSpec:
    """Resolve a jax `device_kind` string (recorded by tools/profile_tpu.py
    under raw meta.device.kind) to its generation: "TPU v5 lite" -> v5e,
    "TPU v5p"/"TPU v5" -> v5p, "TPU v6 lite"/"TPU v6e"/Trillium -> v6e.

    Raises ValueError for unknown kinds — the cross-generation/cross-model
    derivations rescale from the SOURCE generation's hardware constants, so
    silently assuming a generation would rescale from the wrong baseline
    (ADVICE r5: build_cross_model hardcoded v5e)."""
    k = kind.lower()
    if "v5 lite" in k or "v5e" in k or "v5litepod" in k:
        return TPU_GENERATIONS["v5e"]
    if "v6 lite" in k or "v6e" in k or "trillium" in k:
        return TPU_GENERATIONS["v6e"]
    if "v5p" in k or "v5" in k:
        return TPU_GENERATIONS["v5p"]
    raise ValueError(
        f"cannot resolve TPU generation from device kind {kind!r} "
        f"(known: {sorted(TPU_GENERATIONS)})"
    )


def _v5e(chips: int, topology: str) -> SliceShape:
    return SliceShape(f"v5e-{chips}", "v5e", topology, chips)


def _v5p(chips: int, topology: str) -> SliceShape:
    return SliceShape(f"v5p-{chips}", "v5p", topology, chips)


def _v6e(chips: int, topology: str) -> SliceShape:
    return SliceShape(f"v6e-{chips}", "v6e", topology, chips)


# Feasible shapes per generation (2D torus for v5e/v6e, 3D for v5p).
TPU_SLICE_CATALOG: dict[str, SliceShape] = {
    s.name: s
    for s in [
        _v5e(1, "1x1"),
        _v5e(4, "2x2"),
        _v5e(8, "2x4"),
        _v5e(16, "4x4"),
        _v5e(32, "4x8"),
        _v5e(64, "8x8"),
        _v5e(128, "8x16"),
        _v5e(256, "16x16"),
        _v5p(4, "2x2x1"),
        _v5p(8, "2x2x2"),
        _v5p(16, "2x2x4"),
        _v5p(32, "2x4x4"),
        _v5p(64, "4x4x4"),
        _v5p(128, "4x4x8"),
        _v6e(1, "1x1"),
        _v6e(4, "2x2"),
        _v6e(8, "2x4"),
        _v6e(16, "4x4"),
        _v6e(32, "4x8"),
        _v6e(64, "8x8"),
        _v6e(256, "16x16"),
    ]
}


# Replica spin-up latency model: how long a NEW pod-slice takes from the
# scale-up decision to serving traffic. Dominated by slice scheduling +
# server boot + weight load; multi-host slices additionally coordinate
# every host of the atom (LeaderWorkerSet group), so spin-up grows with
# the host count. These are planning constants for the forecast horizon
# (forecast/ sizes scale-up against the predicted rate one spin-up
# ahead), not measurements — deployments with slower image pulls or
# larger checkpoints should raise them via their accelerator ConfigMap
# entries in a future revision.
SPINUP_BASE_S = 60.0  # single-host pod: schedule + boot + weight load
SPINUP_PER_EXTRA_HOST_S = 30.0  # per additional host in the slice atom


def spinup_seconds(shape: SliceShape | str) -> float:
    """Estimated replica spin-up latency for a slice shape (by object or
    canonical name) — the forecast horizon: sizing must anticipate the
    arrival rate at decision-time + spin-up, because capacity requested
    now arrives only then."""
    s = slice_shape(shape) if isinstance(shape, str) else shape
    return SPINUP_BASE_S + SPINUP_PER_EXTRA_HOST_S * (s.hosts - 1)


def slice_shape(name: str) -> SliceShape:
    """Look up a slice shape by canonical name, e.g. ``v5e-16``.

    Unknown names are synthesized as single-host custom shapes so that
    user-supplied accelerator entries outside the catalog still work.
    """
    if name in TPU_SLICE_CATALOG:
        return TPU_SLICE_CATALOG[name]
    if "-" in name:
        gen, _, tail = name.partition("-")
        try:
            chips = int(tail)
        except ValueError:
            chips = 1
        return SliceShape(name, gen, f"1x{chips}", chips)
    return SliceShape(name, name, "1x1", 1)
