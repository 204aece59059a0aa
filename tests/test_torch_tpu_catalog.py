"""Port of tests/test_tpu_catalog.py, on the port's imports.

Slice-shape catalog tests: the TPU-native replacement for the
reference's {type, multiplicity} accelerator model
(the upstream Go project's pkg/config/types.go:29-37). The catalog feeds capacity
arithmetic (chips, whole hosts), cost derivation, and the multi-host
workload decision, so its invariants are load-bearing.
"""

import pytest

from inferno_tpu_torch.config.tpu_catalog import (
    CHIPS_PER_HOST,
    TPU_SLICE_CATALOG,
    SliceShape,
    slice_shape,
)
from inferno_tpu_torch.config.types import AcceleratorSpec

import inferno_tpu.config.tpu_catalog as ref_catalog  # noqa: E402
from test_torch_analyzer import assert_same, hold  # noqa: E402

slice_shape = hold(slice_shape, ref_catalog.slice_shape)


def test_catalog_equals_the_references():
    """The port's copy of the slice catalog is the reference's, entry for
    entry (every field of every SliceShape), with the same host size."""
    assert CHIPS_PER_HOST == ref_catalog.CHIPS_PER_HOST
    assert list(TPU_SLICE_CATALOG) == list(ref_catalog.TPU_SLICE_CATALOG)
    for name, shape in TPU_SLICE_CATALOG.items():
        assert_same(shape, ref_catalog.TPU_SLICE_CATALOG[name], name)


def test_catalog_names_are_canonical():
    for name, shape in TPU_SLICE_CATALOG.items():
        assert name == shape.name
        gen, _, chips = name.partition("-")
        assert shape.generation == gen
        assert shape.chips == int(chips)


def test_topology_products_match_chip_counts():
    """The ICI torus dims must multiply to the slice's chip count — a
    catalog typo here corrupts every downstream hosts/links figure."""
    for shape in TPU_SLICE_CATALOG.values():
        dims = [int(d) for d in shape.topology.split("x")]
        product = 1
        for d in dims:
            product *= d
        assert product == shape.chips, shape


def test_generations_use_expected_torus_rank():
    for shape in TPU_SLICE_CATALOG.values():
        rank = len(shape.topology.split("x"))
        if shape.generation == "v5p":
            assert rank == 3, shape  # 3D torus
        else:
            assert rank == 2, shape  # v5e / v6e: 2D


def test_hosts_whole_host_arithmetic():
    assert slice_shape("v5e-1").hosts == 1  # sub-host slices round up to 1
    assert slice_shape("v5e-4").hosts == 1
    assert slice_shape("v5e-8").hosts == 2
    assert slice_shape("v5e-16").hosts == 4
    assert slice_shape("v5p-128").hosts == 32
    for shape in TPU_SLICE_CATALOG.values():
        if shape.chips >= CHIPS_PER_HOST:
            assert shape.hosts * CHIPS_PER_HOST == shape.chips, shape


def test_multi_host_boundary():
    assert not slice_shape("v5e-4").multi_host
    assert slice_shape("v5e-8").multi_host


def test_ici_links_grow_with_slice_size():
    """Links are a relative interconnect-richness signal: monotone within
    a generation."""
    for gen in ("v5e", "v5p", "v6e"):
        shapes = sorted(
            (s for s in TPU_SLICE_CATALOG.values() if s.generation == gen),
            key=lambda s: s.chips,
        )
        links = [s.ici_links for s in shapes]
        assert links == sorted(links), (gen, links)
        assert all(l >= 0 for l in links)


def test_ici_links_known_cases():
    # 2x2: each dim has d=2 -> (d-1)*other = 1*2 per dim -> 4 links
    assert slice_shape("v5e-4").ici_links == 4
    # 4x4 torus: wrap-around counts (d>=3): 4*4 + 4*4 = 32
    assert slice_shape("v5e-16").ici_links == 32
    # single chip: no links
    assert slice_shape("v5e-1").ici_links == 0


def test_unknown_shape_synthesized_not_rejected():
    """User-supplied accelerator entries outside the catalog still work
    (the ConfigMap can extend the fleet)."""
    s = slice_shape("v7x-12")
    assert s.generation == "v7x" and s.chips == 12
    assert s.hosts == 3
    s = slice_shape("v7x-notanumber")
    assert s.chips == 1
    s = slice_shape("weird")
    assert s.generation == "weird" and s.chips == 1


def test_accelerator_spec_defaults_from_catalog():
    """AcceleratorSpec fills pool and chips from the catalog, and slice
    cost is chips x per-chip-hour (config/types.py)."""
    spec = AcceleratorSpec(name="v5e-16", cost_per_chip_hr=1.25)
    assert spec.pool == "v5e"
    assert spec.chips == 16
    assert spec.cost == pytest.approx(20.0)
    assert spec.shape.multi_host


def test_accelerator_spec_overrides_win():
    spec = AcceleratorSpec(name="v5e-16", pool="reserved", chips=8,
                           cost_per_chip_hr=1.0)
    assert spec.pool == "reserved"
    assert spec.chips == 8
    assert spec.cost == pytest.approx(8.0)


def test_frozen_shapes():
    with pytest.raises(dataclasses_error()):
        slice_shape("v5e-4").chips = 8


def dataclasses_error():
    import dataclasses

    return dataclasses.FrozenInstanceError


def test_generation_from_device_kind():
    from inferno_tpu_torch.config.tpu_catalog import generation_from_device_kind

    # jax device_kind strings as recorded by tools/profile_tpu.py
    assert generation_from_device_kind("TPU v5 lite").name == "v5e"
    assert generation_from_device_kind("TPU v5p").name == "v5p"
    assert generation_from_device_kind("TPU v5").name == "v5p"
    assert generation_from_device_kind("TPU v6 lite").name == "v6e"
    assert generation_from_device_kind("TPU v6e").name == "v6e"
    assert generation_from_device_kind("Trillium").name == "v6e"
    with pytest.raises(ValueError, match="cannot resolve"):
        generation_from_device_kind("TPU v9 hyper")
