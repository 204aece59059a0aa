"""The port's reconcile loop against the reference's, on the CPU.

Both packages' clusters are built from the same dicts (VA custom
resources, ConfigMaps, Deployments) and both FakeProms from the same
per-variant load table; the reference runs backend "jax", the port
backend "torch" on the CPU. Each cycle is compared through plain data:
the decision records, every VA's status in its dict form (conditions
included, timestamps excluded) and the actuation gauges.

Comparison rule (ROADMAP): feasibility, reason, chosen shape and every
integer match exactly; replicas match exactly, except ±1 where the chosen
lane's rate ceiling (`lambda_max_rpm`) agrees within 1e-4 relative (a
ceil boundary); other floats within 1e-4 relative (the kernels' f32
operating point against XLA's), or 2e-4 absolute: decision records round
to 4 decimals, so a difference (SLO headroom) of two close values keeps
only the rounding. `scalar` against `scalar` is pure Python
in both packages and must match bit for bit. The profile corrector's state
per variant (active, surrogate used) matches exactly; where the surrogate
refit ran, its linearized DecodeParms agree within 1e-2 relative (80 f32
AdamW steps from the same initial weights; measured ~2e-5). The
reference's refit trains on a mesh of its 8 virtual devices and rounds its
batch down to a multiple of 8; the port's refits on the same dp
(`test_torch_held_cycle.at_reference_dp`).
"""

from __future__ import annotations

import copy
import json
import math

import numpy as np
import pytest
import torch

from inferno_tpu.controller import crd as r_crd
from inferno_tpu.controller import kube as r_kube
from inferno_tpu.controller import reconciler as r_rec
from inferno_tpu.parallel import fleet as r_fleet
from inferno_tpu.testing import fleet as r_fix
from inferno_tpu_torch.controller import crd as p_crd
from inferno_tpu_torch.controller import kube as p_kube
from inferno_tpu_torch.controller import reconciler as p_rec
from inferno_tpu_torch.controller.watch import SOURCE_WATCH
from inferno_tpu_torch.parallel import fleet as p_fleet
from inferno_tpu_torch.testing import fleet as p_fix
from test_torch_held_cycle import at_reference_dp

CFG_NS = "inferno-system"
NS = "fleet"
RTOL = 1e-4
ATOL = 2e-4  # two units of DecisionRecord's 4-decimal rounding
REFIT_RTOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The surrogate refits here are small, and the tests run beside other
    test workers: torch's intra-op threads would only contend with them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PKGS = {
    "ref": (r_crd, r_kube, r_rec, r_fix, r_fleet),
    "port": (p_crd, p_kube, p_rec, p_fix, p_fleet),
}

ACTUATION_SERIES = (
    "inferno_desired_replicas", "inferno_current_replicas",
    "inferno_desired_ratio",
)


# -- scenario data (one set of dicts for both packages) ---------------------


def model(i: int) -> str:
    return f"bench/model-{i:03d}"


def variant(i: int) -> str:
    return f"variant-{i:03d}"


def _profile(acc: str, max_batch: int, alpha: float, beta: float,
             gamma: float, delta: float) -> dict:
    return {
        "acc": acc, "accCount": 1, "maxBatchSize": max_batch, "atTokens": 128,
        "perfParms": {
            "decodeParms": {"alpha": str(alpha), "beta": str(beta)},
            "prefillParms": {"gamma": str(gamma), "delta": str(delta)},
        },
    }


def va_dict(i: int, two_shapes: bool) -> dict:
    """A VariantAutoscaling CR: v5e-4 with a max batch that varies by
    variant (so lanes fall in more than one K bucket), and on every
    `two_shapes` variant a second, v5e-16 profile, so the solve picks a
    shape."""
    batches = (32, 64, 256, 160)
    profiles = [_profile("v5e-4", batches[i % 4], 18.0, 0.3, 5.0, 0.02)]
    if two_shapes:
        profiles.append(_profile("v5e-16", 2 * batches[i % 4], 8.0, 0.04, 3.0, 0.008))
    return {
        "apiVersion": "llmd.ai/v1alpha1",
        "kind": "VariantAutoscaling",
        "metadata": {
            "name": variant(i), "namespace": NS,
            "labels": {"inference.optimization/acceleratorName": "v5e-4"},
            "generation": 1,
        },
        "spec": {
            "modelID": model(i),
            "sloClassRef": {"name": "service-classes-config", "key": "Premium"},
            "modelProfile": {"accelerators": profiles},
        },
    }


def scenario(n: int = 12, **over) -> dict:
    """A fleet of `n` variants; every third carries a v5e-16 profile.
    Keys: configmaps, vas, deployments, rows(cycle) -> FakeProm table,
    config (ReconcilerConfig kwargs), grouped (FakeProm's grouped shapes)."""
    entries = "".join(
        f"  - model: {model(i)}\n    slo-ttft: 500.0\n    slo-tpot: 24.0\n"
        for i in range(n)
    )
    rng = np.random.default_rng(7)
    base_rate = rng.uniform(0.5, 40.0, n)
    base_in = rng.choice([64.0, 128.0, 512.0], n)
    scn = {
        "n": n,
        "configmaps": {
            "accelerator-unit-costs": {
                "v5e-4": json.dumps({"cost": 10.0}),
                "v5e-16": json.dumps({"cost": 9.0}),
            },
            "service-classes-config": {
                "premium.yaml": f"name: Premium\npriority: 1\ndata:\n{entries}",
            },
            "inferno-autoscaler-config": {"GLOBAL_OPT_INTERVAL": "30s"},
        },
        "vas": [va_dict(i, i % 3 == 0) for i in range(n)],
        "deployments": [(NS, variant(i), 1 + i % 3) for i in range(n)],
        "missing": (),
        "config": {},
        "grouped": True,
        "itl_s": 0.02,
        "cycles": 4,
        # occupancy that swings from cycle to cycle with ITL on a line
        # above the CR profile's: the corrector's surrogate refit engages
        "swing": False,
    }

    def rows(cycle: int) -> dict:
        out = {}
        for i in range(n):
            if i in scn["missing"]:
                continue
            rate = float(base_rate[i])
            in_tok = float(base_in[i])
            if cycle >= 2 and i % 4 == 1:
                rate *= 1.3  # arrival rates move
            if cycle >= 3 and i % 5 == 2:
                in_tok *= 2.0  # token mix moves
            running, itl_s = 3.0 + i % 4, scn["itl_s"]
            if scn["swing"]:
                running = 2.0 + (3 * cycle + i) % 9
                itl_s = (30.0 + 1.5 * running) / 1e3
            out[(model(i), NS)] = {
                "running": running, "arrival_rps": rate,
                "in_tokens": in_tok, "out_tokens": 128.0,
                "ttft_s": 0.05, "itl_s": itl_s, "max_batch": 64.0,
            }
        return out

    scn["rows"] = rows
    for key, value in over.items():
        scn[key] = value
    return scn


def _limited(scn: dict, chips: int, spot: str = "") -> dict:
    cm = scn["configmaps"]["inferno-autoscaler-config"]
    cm["OPTIMIZER_MODE"] = "limited"
    cm["TPU_CAPACITY"] = json.dumps({"v5e": chips})
    if spot:
        cm["TPU_SPOT_POOLS"] = spot
    return scn


SCENARIOS = {
    "unlimited": lambda: scenario(),
    "limited_degraded": lambda: _limited(scenario(), chips=24),
    "spot_tier": lambda: _limited(
        scenario(), chips=60,
        spot='{"v5e": {"discount": 0.5, "hazardPerHr": 0.001, '
             '"blastRadius": 0.5, "chips": 12}}',
    ),
    "scale_to_zero": lambda: scenario(
        missing=(2, 7),
        deployments=[(NS, variant(i), 0 if i in (2, 7) else 1) for i in range(12)],
        config={"scale_to_zero": True},
    ),
    "metrics_missing": lambda: scenario(missing=(1, 5)),
    "per_variant_collection": lambda: scenario(grouped=False),
    "sizing_cache": lambda: scenario(config={"sizing_cache": True}),
    "no_correction": lambda: scenario(config={"profile_correction": False}),
    # KEEP_ACCELERATOR=false: the variants with two profiles pick a shape
    "free_shapes": lambda: scenario(config={"keep_accelerator": False}),
    # observed ITL ~1.7x the CR profile's: from the sixth cycle on the
    # corrector's ratio scaling is in force (below the surrogate's 12)
    "profile_corrected": lambda: scenario(itl_s=0.035, cycles=7),
    # twelve cycles of swinging occupancy: from the twelfth observation on
    # the corrector refits the surrogate (from each package's default
    # initial weights) and sizes on its linearization
    "surrogate_corrected": lambda: scenario(n=4, swing=True, cycles=12),
}


# -- driving both packages ---------------------------------------------------


def build_cluster(pkg: str, scn: dict):
    crd, kube = PKGS[pkg][0], PKGS[pkg][1]
    cluster = kube.InMemoryCluster()
    for name, data in scn["configmaps"].items():
        cluster.set_configmap(CFG_NS, name, dict(data))
    for d in scn["vas"]:
        cluster.add_variant_autoscaling(crd.VariantAutoscaling.from_dict(copy.deepcopy(d)))
    for ns, name, reps in scn["deployments"]:
        cluster.add_deployment(ns, name, replicas=reps)
    return cluster


def make_reconciler(pkg: str, scn: dict, backend: str, **cfg):
    _, _, rec_mod, fix, fleet_mod = PKGS[pkg]
    fleet_mod.reset_fleet_state()
    cluster = build_cluster(pkg, scn)
    kw = {"config_namespace": CFG_NS, "compute_backend": backend, **scn["config"], **cfg}
    if pkg == "port":
        kw.setdefault("compute_device", "cpu")
    rec = rec_mod.Reconciler(
        kube=cluster, prom=fix.fleet_fake_prom(scn["rows"](0), grouped=scn["grouped"]),
        config=rec_mod.ReconcilerConfig(**kw),
    )
    if pkg == "port":
        at_reference_dp(rec.corrector)
    return rec, cluster


def _gauges(registry) -> dict:
    out = {}
    for line in registry.render().splitlines():
        if line.startswith(ACTUATION_SERIES):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def _status(va) -> dict:
    st = va.status.to_dict()
    st["desiredOptimizedAlloc"].pop("lastRunTime", None)
    for c in st.get("conditions", []):
        c.pop("lastTransitionTime", None)
    return st


def _corrections(corrector) -> dict:
    if corrector is None:
        return {}
    out = {}
    for key, st in sorted(corrector._state.items()):
        refit = corrector._refit_cache.get(key, (0, None))[1]
        out[key] = {
            "active": st.active, "surrogate_used": st.surrogate_used,
            "refit": None if refit is None else (refit.alpha, refit.beta),
        }
    return out


def snapshot(pkg: str, rec, cluster, report, scn: dict) -> dict:
    return {
        "decisions": [r.to_dict() for r in report.decisions],
        "statuses": [
            _status(cluster.get_variant_autoscaling(NS, variant(i)))
            for i in range(scn["n"])
        ],
        "gauges": _gauges(rec.emitter.registry),
        "errors": list(report.errors),
        "ok": report.optimization_ok,
        "prepared": report.variants_prepared,
        "corrections": _corrections(rec.corrector),
    }


def run_cycles(pkg: str, scn: dict, backend: str, cycles: int, **cfg) -> list[dict]:
    rec, cluster = make_reconciler(pkg, scn, backend, **cfg)
    fix = PKGS[pkg][3]
    out = []
    for c in range(cycles):
        rec.prom = fix.fleet_fake_prom(scn["rows"](c), grouped=scn["grouped"])
        report = rec.run_cycle()
        out.append(snapshot(pkg, rec, cluster, report, scn))
    rec.close()
    return out


def _close(a, b, path: str) -> None:
    if isinstance(a, float) or isinstance(b, float):
        assert math.isclose(float(a), float(b), rel_tol=RTOL, abs_tol=ATOL), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _walk(a, b, path: str, skip=()) -> None:
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            if k not in skip:
                _walk(a[k], b[k], f"{path}.{k}", skip)
    elif isinstance(a, list):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _walk(x, y, f"{path}[{i}]", skip)
    else:
        _close(a, b, path)


def _replicas_match(ra: dict, rb: dict) -> bool:
    """Replicas equal, or ±1 where the chosen lane's rate ceiling agrees
    within 1e-4 relative (a ceil boundary)."""
    if ra["replicas"] == rb["replicas"]:
        return True
    return abs(ra["replicas"] - rb["replicas"]) == 1 and math.isclose(
        ra["lambda_max_rpm"], rb["lambda_max_rpm"], rel_tol=RTOL
    )


def assert_same_cycle(a: dict, b: dict) -> None:
    """The ROADMAP comparison rule over one cycle's snapshot."""
    assert a["ok"] == b["ok"] and a["prepared"] == b["prepared"]
    assert a["errors"] == b["errors"]
    assert len(a["decisions"]) == len(b["decisions"])
    boundary = set()
    for ra, rb in zip(a["decisions"], b["decisions"]):
        assert ra["variant"] == rb["variant"]
        assert ra["reason"] == rb["reason"], (ra["variant"], ra["reason"], rb["reason"])
        assert ra["accelerator"] == rb["accelerator"], ra["variant"]
        assert _replicas_match(ra, rb), (ra["variant"], ra["replicas"], rb["replicas"])
        if ra["replicas"] != rb["replicas"]:
            boundary.add(ra["variant"])
            continue  # cost, ratio and detail follow the replica count
        _walk(ra, rb, ra["variant"])
    assert set(a["corrections"]) == set(b["corrections"])
    for key, ca in a["corrections"].items():
        cb = b["corrections"][key]
        assert (ca["active"], ca["surrogate_used"]) == (cb["active"], cb["surrogate_used"]), key
        assert (ca["refit"] is None) == (cb["refit"] is None), key
        if ca["refit"] is not None:
            for x, y in zip(ca["refit"], cb["refit"]):
                assert math.isclose(x, y, rel_tol=REFIT_RTOL), (key, ca["refit"], cb["refit"])
    for sa, sb in zip(a["statuses"], b["statuses"]):
        _walk(sa, sb, "status", skip=("numReplicas",) if boundary else ())
    if not boundary:
        _walk(a["gauges"], b["gauges"], "gauges")


# -- the port against the reference ------------------------------------------


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_cycles_match_reference(name):
    """Four or more cycles (cold; unchanged; 1/4 of arrival rates moved;
    token mix moved on 1/5; unchanged) of each scenario: the port on
    backend torch against the reference on backend jax."""
    scn = SCENARIOS[name]()
    ref = run_cycles("ref", scn, "jax", cycles=scn["cycles"])
    port = run_cycles("port", scn, "torch", cycles=scn["cycles"])
    for c, (a, b) in enumerate(zip(ref, port)):
        try:
            assert_same_cycle(a, b)
        except AssertionError as e:
            raise AssertionError(f"{name}, cycle {c}: {e}") from None
    reasons = {r["reason"] for cyc in port for r in cyc["decisions"]}
    if name == "limited_degraded":
        assert "capacity_limited" in reasons
    if name == "spot_tier":
        assert any(r["spot_replicas"] > 0 for cyc in port for r in cyc["decisions"])
    if name == "scale_to_zero":
        assert any(r["asleep"] for r in port[0]["decisions"])
    if name == "metrics_missing":
        assert port[0]["prepared"] == scn["n"] - 2
    if name == "free_shapes":
        shapes = {r["accelerator"] for cyc in port for r in cyc["decisions"]}
        assert {"v5e-4", "v5e-16"} <= shapes, shapes
    if name == "profile_corrected":
        assert any(r["profile_provenance"] == "corrected" for r in port[-1]["decisions"])
    if name == "surrogate_corrected":
        used = [c["surrogate_used"] for c in port[-1]["corrections"].values()]
        assert len(used) == scn["n"] and all(used)
        assert all(r["profile_provenance"] == "corrected" for r in port[-1]["decisions"])


@pytest.mark.parametrize("name", ["unlimited", "limited_degraded", "scale_to_zero"])
def test_scalar_backends_bit_identical(name):
    """The per-variant oracle is pure Python in both packages: every
    decision record, status and gauge equal bit for bit."""
    scn = SCENARIOS[name]()
    ref = run_cycles("ref", scn, "scalar", cycles=3)
    port = run_cycles("port", scn, "scalar", cycles=3)
    assert ref == port


def test_optimization_failure_matches_reference(monkeypatch):
    """A failing solve marks every prepared VA OptimizationReady=False in
    both packages, with the same records and statuses."""

    class Boom:
        def __init__(self, *a, **k):
            pass

        def optimize(self, *a, **k):
            raise RuntimeError("solver exploded")

    monkeypatch.setattr(r_rec, "Optimizer", Boom)
    monkeypatch.setattr(p_rec, "Optimizer", Boom)
    scn = scenario(n=6)
    ref = run_cycles("ref", scn, "jax", cycles=2)
    port = run_cycles("port", scn, "torch", cycles=2)
    for a, b in zip(ref, port):
        assert not b["ok"]
        assert_same_cycle(a, b)
    assert all(r["reason"] == "error" for r in port[0]["decisions"])


# -- inside the port -----------------------------------------------------------


def test_event_cycle_matches_poll_cycle(monkeypatch):
    """A targeted cycle (the movers marked in the DirtyQueue) reproduces the
    decisions of a full poll scan of the same inputs."""
    scn = scenario(n=12)
    ev, ev_cluster = make_reconciler("port", scn, "torch")
    ev.run_cycle()
    rows = scn["rows"](2)
    ev.prom = p_fix.fleet_fake_prom(rows)
    ev.dirty_queue.mark(
        [f"{variant(i)}:{NS}" for i in range(12) if i % 4 == 1],
        source=SOURCE_WATCH, wake=False,
    )
    event = snapshot("port", ev, ev_cluster, ev.run_cycle(), scn)

    monkeypatch.setenv("EVENT_TARGETED_CYCLE", "0")
    poll, poll_cluster = make_reconciler("port", scn, "torch")
    poll.run_cycle()
    poll.prom = p_fix.fleet_fake_prom(rows)
    full = snapshot("port", poll, poll_cluster, poll.run_cycle(), scn)
    assert event["decisions"] == full["decisions"]
    assert event["statuses"] == full["statuses"]


def test_solve_span_reports_port_backend():
    scn = scenario(n=4)
    rec, _ = make_reconciler("port", scn, "torch")
    report = rec.run_cycle()
    solve = next(c for c in report.trace.children if c.name == "solve")
    assert solve.attrs["backend"] == "torch"
    assert [c.name for c in report.trace.children] == [
        "collect", "analyze", "solve", "actuate",
    ]
