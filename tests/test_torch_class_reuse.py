"""The service-classes ConfigMap is parsed only where a key's text changed.

`Reconciler.read_service_classes` keeps each key's text and its parse
across cycles and reuses the parse while the text is the same. These
cases run one held reconciler (tests/test_torch_held_cycle.py: every clean
cycle's decisions are held to the reference's, which parses every cycle)
over a sequence of edits to the map, and pin per cycle the profile's
`service_class_docs_parsed` / `service_class_docs_reused`, the port's
`yaml.safe_load` calls and the classes read, against the reference's. The
last case holds the classes' target lists to one cycle's entries: the
cycle appends each variant's model key to its class, so a list kept
across cycles would grow.
"""

from __future__ import annotations

import types

import pytest
import yaml

from inferno_tpu_torch.controller import ReconcilerConfig
from inferno_tpu_torch.controller import reconciler as p_rec

from test_torch_apiserver import CFG_NS, MODEL, NS, make_cluster, make_prom
from test_torch_held_cycle import PORT_CPU, held_reconciler
from test_torch_reconciler_edges import OTHER, _class_doc, _key, _variant

CM = "service-classes-config"


def _fresh(text: str) -> str:
    """The same text in a new string object, as each GET of an API
    server over HTTP decodes it."""
    return "".join(list(text))


def _unchanged(data):
    return {k: _fresh(v) for k, v in data.items()}


def _edit_ttft(data):
    return {**data, "premium.yaml": _class_doc("Premium", 1, (MODEL, 300, 24))}


def _add_key(data):
    return {**data, "extra.yaml": _class_doc("Standard", 5, (OTHER, 1000, 50))}


def _remove_key(data):
    return {k: v for k, v in data.items() if k != "extra.yaml"}


def _malformed(data):
    return {**data, "freemium.yaml": "::: not yaml {{{"}


# (step, edit of the map before the cycle, keys parsed, keys reused,
# class names read, the variant's slo-ttft); the first cycle reads the map
# as shipped, and each later step edits the map the step before left
STEPS = [
    ("first", None, 2, 0, ["Freemium", "Premium"], 500.0),
    ("unchanged", _unchanged, 0, 2, ["Freemium", "Premium"], 500.0),
    ("slo_ttft_edited", _edit_ttft, 1, 1, ["Freemium", "Premium"], 300.0),
    ("key_added", _add_key, 1, 2, ["Standard", "Freemium", "Premium"], 300.0),
    ("key_removed", _remove_key, 0, 2, ["Freemium", "Premium"], 300.0),
    ("malformed", _malformed, 1, 1, ["Premium"], 300.0),
    ("malformed_unchanged", _unchanged, 0, 2, ["Premium"], 300.0),
]


class _CountingYaml:
    """The port's `yaml` module with its `safe_load` calls counted (the
    reference's own `yaml` is left alone)."""

    def __init__(self):
        self.calls = 0

    def safe_load(self, raw):
        self.calls += 1
        return yaml.safe_load(raw)

    YAMLError = yaml.YAMLError


def _seen_classes(target, seen: list):
    """Record each list of classes `target.read_service_classes` returns."""
    read = target.read_service_classes
    target.read_service_classes = lambda: seen.append(read()) or seen[-1]


@pytest.fixture(scope="module")
def sequence():
    """One held reconciler over STEPS on one cluster: per step the cycle's
    report, the port's `safe_load` calls, and the classes each side read
    (as the cycle left them)."""
    cluster = make_cluster()
    rec = held_reconciler(cluster, make_prom(), ReconcilerConfig(
        config_namespace=CFG_NS, **PORT_CPU))
    counting = _CountingYaml()
    seen = {"port": [], "ref": []}
    _seen_classes(rec._port, seen["port"])
    _seen_classes(rec._ref, seen["ref"])
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(p_rec, "yaml", counting)
        for step, edit, *_ in STEPS:
            if edit is not None:
                cluster.set_configmap(CFG_NS, CM, edit(cluster.get_configmap(CFG_NS, CM)))
            calls, held = counting.calls, rec.held_cycles
            report = rec.run_cycle()
            out[step] = types.SimpleNamespace(
                report=report, safe_loads=counting.calls - calls,
                held=rec.held_cycles - held,
                port=seen["port"][-1], ref=seen["ref"][-1])
    rec.close()
    return out


@pytest.mark.parametrize("step", STEPS, ids=[s[0] for s in STEPS])
def test_each_cycle_parses_only_the_keys_whose_text_changed(sequence, step):
    name, _, parsed, reused, classes, ttft = step
    got = sequence[name]
    report = got.report
    assert report.errors == [] and report.optimization_ok
    # the cycle's decisions were held to the reference's
    assert got.held == 1
    counters = report.profile["counters"]
    assert counters["service_class_docs_parsed"] == parsed
    assert counters["service_class_docs_reused"] == reused
    assert got.safe_loads == parsed
    assert [sc.name for sc in got.port] == classes
    assert [(sc.name, sc.priority, [t.to_dict() for t in sc.model_targets])
            for sc in got.port] == \
        [(sc.name, sc.priority, [t.to_dict() for t in sc.model_targets])
         for sc in got.ref]
    assert [d.slo_ttft_ms for d in report.decisions] == [ttft]


def test_unchanged_cycles_hand_out_one_cycles_targets(monkeypatch):
    """Over three cycles of an unchanged map each class's `model_targets`
    holds the shipped entries, then that cycle's model-key entries once,
    in variant order; no cycle after the first parses. A variant leaves
    after the first cycle and another joins in the third: a target list
    kept across cycles would still hold the leaver's entry."""
    cluster = make_cluster()
    _variant(cluster, "llama-second", MODEL, "Premium")
    _variant(cluster, "other-free", OTHER, "Freemium")
    _variant(cluster, "llama-third", MODEL, "Premium")
    rec = held_reconciler(cluster, make_prom(), ReconcilerConfig(
        config_namespace=CFG_NS, **PORT_CPU))
    counting = _CountingYaml()
    monkeypatch.setattr(p_rec, "yaml", counting)
    seen = []
    _seen_classes(rec._port, seen)
    shipped = {
        "Freemium": [(OTHER, 2000.0)],
        "Premium": [(MODEL, 500.0)],
    }
    variants = []
    for cycle in range(3):
        if cycle == 1:
            cluster.delete_variant_autoscaling(NS, "llama-second")
        if cycle == 2:
            _variant(cluster, "llama-fourth", MODEL, "Premium")
        calls = counting.calls
        report = rec.run_cycle()
        assert report.errors == [] and report.optimization_ok
        assert counting.calls - calls == (2 if cycle == 0 else 0)
        assert report.profile["counters"]["service_class_docs_parsed"] == (
            2 if cycle == 0 else 0)
        by_class = {"Freemium": [], "Premium": []}
        for d in report.decisions:
            model = OTHER if d.name == "other-free" else MODEL
            by_class["Freemium" if model == OTHER else "Premium"].append(
                (_key(model, d.name), d.slo_ttft_ms))
        for sc in seen[-1]:
            assert [(t.model, t.slo_ttft) for t in sc.model_targets] == \
                shipped[sc.name] + by_class[sc.name], (cycle, sc.name)
        variants.append(sorted(d.name for d in report.decisions))
    assert rec.held_cycles == 3
    assert variants == [
        ["llama-premium", "llama-second", "llama-third", "other-free"],
        ["llama-premium", "llama-third", "other-free"],
        ["llama-fourth", "llama-premium", "llama-third", "other-free"],
    ]
    rec.close()
