"""The port's flight recorder (inferno_tpu_torch.obs.recorder) through the
port's reconciler, and the offline tools that read it, on the CPU (the
counterparts of tests/test_recorder.py): round trip, record -> replay
parity, drift, torn tails, corrupt blocks, newer schemas, queue drops,
rotation and retention, write failures, `python -m
inferno_tpu_torch.planner --trace` and `python -m
inferno_tpu_torch.obs.report`.

The artifact format is shared with the JAX reference: an artifact the
port's reconciler records is read and replayed with parity by the
reference's `read_artifact` / `replay_cycle_parity`, and the port reads
and replays one the reference recorded. Replays here run backend
"torch" on the CPU; parity is exact (choice, replicas, spot replicas).
"""

import gzip
import json
import os

import numpy as np
import pytest

from inferno_tpu_torch.controller.reconciler import Reconciler, ReconcilerConfig
from inferno_tpu_torch.obs import DecisionRecord
from inferno_tpu_torch.obs.recorder import (
    SCHEMA_VERSION,
    FlightRecorder,
    RecorderConfig,
    read_artifact,
)
from inferno_tpu_torch.testing.fleet import (
    CONFIG_NS,
    FLEET_NS,
    fleet_cluster,
    fleet_fake_prom,
    fleet_model,
    fleet_variant,
)

N = 4


def rows(n=N, arrival_rps=5.0, **overrides):
    out = {}
    for i in range(n):
        out[(fleet_model(i), FLEET_NS)] = {
            "running": 3.0, "arrival_rps": arrival_rps, "in_tokens": 128.0,
            "out_tokens": 128.0, "ttft_s": 0.05, "itl_s": 0.02,
            "max_batch": 64.0, **overrides,
        }
    return out


def recording_reconciler(tmp_path, n=N, backend="torch", arrival_rps=5.0, **kw):
    cfg = ReconcilerConfig(
        config_namespace=CONFIG_NS, compute_backend=backend, compute_device="cpu",
        flight_recorder_dir=str(tmp_path / "recorder"), **kw,
    )
    return Reconciler(
        kube=fleet_cluster(n), prom=fleet_fake_prom(rows(n, arrival_rps)),
        config=cfg,
    )


def record_cycles(tmp_path, cycles=3, n=N, backend="torch", **kw):
    rec = recording_reconciler(tmp_path, n=n, backend=backend, **kw)
    for _ in range(cycles):
        report = rec.run_cycle()
        assert report.errors == []
    rec.close()
    return str(tmp_path / "recorder")


class StubSpec:
    """Minimal snapshot stand-in for direct recorder tests."""

    def __init__(self, doc):
        self.doc = doc

    def to_dict(self):
        return self.doc


def stub_decisions(n=2, replicas=1):
    out = []
    for i in range(n):
        rec = DecisionRecord(
            variant=f"ns/v{i}", namespace="ns", name=f"v{i}",
            arrival_rpm=100.0 + i, sizing_rpm=100.0 + i,
            slo_ttft_ms=500.0, slo_itl_ms=24.0,
        )
        rec.decide("cost_bound", accelerator="v5e-4", replicas=replicas)
        out.append(rec)
    return out


def meta(seq, ts=1000.0):
    return {
        "seq": seq, "ts": ts + seq, "duration_ms": 1.0,
        "interval_seconds": 60, "optimization_ok": True, "errors": 0,
    }


# -- recorder core ------------------------------------------------------------


def test_round_trip_through_reconciler(tmp_path):
    d = record_cycles(tmp_path, cycles=3)
    rt = read_artifact(d)
    assert rt.warnings == []
    assert rt.schema_version == SCHEMA_VERSION
    assert rt.num_cycles == 3
    assert [c.seq for c in rt.cycles] == [1, 2, 3]
    # the static FakeProm table makes every cycle's snapshot identical:
    # the fingerprint dedup stores it once
    assert len(rt.snapshots) == 1
    c = rt.cycles[-1]
    assert c.variants == [f"{fleet_variant(i)}:{FLEET_NS}" for i in range(N)]
    assert c.interval_seconds == 60
    assert rt.step_seconds() == 60.0
    # inputs: per-variant λ, token mix, SLOs, the profile parms sizing ran
    np.testing.assert_allclose(c.columns["arrival_rpm"], 300.0)
    np.testing.assert_allclose(c.columns["sizing_rpm"], 300.0)
    np.testing.assert_allclose(c.columns["avg_in_tokens"], 128.0)
    np.testing.assert_allclose(c.columns["slo_ttft_ms"], 500.0)
    assert (c.columns["decode_alpha"] > 0).all()
    # outputs: chosen shape/replicas/cost, reasons
    assert list(c.columns["reason"]) == ["cost_bound"] * N
    assert list(c.columns["accelerator"]) == ["v5e-4"] * N
    assert (c.columns["replicas"] == 1).all()
    assert (c.columns["cost"] > 0).all()
    # the spec document round-trips to a System
    from inferno_tpu_torch.planner.replay import system_from_recorded

    system = system_from_recorded(rt)
    assert set(system.servers) == set(c.variants)


def test_profile_column_round_trips_and_renders(tmp_path):
    """A profiler-on controller records each cycle's profile
    document in the artifact; the reader surfaces it per cycle and
    aggregated (profile_summary), replay_recorded carries it next to the
    replay's own cost attribution, and obs.report renders it. A
    profiler-off recording (and any pre-profiler artifact) loads with
    profile=None and no summary — the column is optional on read."""
    from inferno_tpu_torch.obs.profiler import PROFILE_SCHEMA
    from inferno_tpu_torch.planner.replay import replay_recorded, system_from_recorded

    d = record_cycles(tmp_path, cycles=3)  # cycle_profiler defaults on
    rt = read_artifact(d)
    assert rt.warnings == []
    for c in rt.cycles:
        assert c.profile is not None
        assert c.profile["schema"] == PROFILE_SCHEMA
        assert {"collect", "analyze", "solve", "actuate"} <= set(
            c.profile["phases"]
        )
        assert c.profile["phases"]["solve"]["wall_ms"] >= 0.0
    summary = rt.profile_summary()
    assert summary["cycles_profiled"] == 3
    assert summary["mean_cycle_ms"] > 0.0
    assert "solve" in summary["mean_phase_ms"]

    # the replay report carries both cost attributions
    out = replay_recorded(system_from_recorded(rt), rt, backend="torch", device="cpu")
    assert out["profile"]["solve_ms"] >= 0.0
    assert "rates_ms" in out["profile"] and "aggregate_ms" in out["profile"]
    assert out["recorded_profile"]["cycles_profiled"] == 3

    # obs.report renders the recorded profile line / JSON block
    from inferno_tpu_torch.obs.report import main as report_main

    rc = report_main([d, "--no-replay", "--json", "--backend", "torch"])
    assert rc == 0

    # profiler off: column absent, summary None, replay block absent
    d_off = record_cycles(
        tmp_path / "off", cycles=2, cycle_profiler=False
    )
    rt_off = read_artifact(d_off)
    assert all(c.profile is None for c in rt_off.cycles)
    assert rt_off.profile_summary() is None
    out = replay_recorded(system_from_recorded(rt_off), rt_off, backend="torch", device="cpu")
    assert "recorded_profile" not in out


def test_record_replay_parity_bit_identical(tmp_path):
    """The acceptance pin: a recorded T=1 cycle replayed against its own
    fleet snapshot reproduces the live calculate_fleet decision exactly
    — same shape, same replica count, for every variant (no skips)."""
    from inferno_tpu_torch.planner.replay import replay_cycle_parity

    d = record_cycles(tmp_path, cycles=3, arrival_rps=40.0)  # slo_bound sizes up
    rt = read_artifact(d)
    assert (rt.cycles[-1].columns["replicas"] > 1).any()
    for k in range(rt.num_cycles):
        parity = replay_cycle_parity(rt, k, backend="torch", device="cpu")
        assert parity["match"], parity["mismatches"]
        assert parity["compared"] == N
        assert parity["skipped"] == 0
        assert parity["missing_from_snapshot"] == 0


def test_replay_recorded_reports_drift(tmp_path):
    """Variants added/removed between recording and the fleet snapshot
    being replayed against are reported explicitly, never silently
    dropped."""
    from inferno_tpu_torch.config.types import SystemSpec
    from inferno_tpu_torch.core import System
    from inferno_tpu_torch.planner.replay import replay_recorded

    d = record_cycles(tmp_path, cycles=2)
    rt = read_artifact(d)
    doc = rt.spec_doc_for()
    servers = doc["serverData"]["servers"]
    removed = servers[0]["name"]
    ghost = json.loads(json.dumps(servers[1]))
    ghost["name"] = "variant-999:fleet"
    doc = json.loads(json.dumps(doc))
    doc["serverData"]["servers"] = [ghost] + servers[1:]
    system = System(SystemSpec.from_dict(doc))

    out = replay_recorded(system, rt, backend="torch", device="cpu")
    drift = out["drift"]
    assert drift["removed_variants"] == [removed]
    assert drift["added_variants"] == ["variant-999:fleet"]
    assert drift["matched_variants"] == N - 1
    assert 0.0 < drift["coverage"] < 1.0
    assert out["variants"] == N  # ghost + N-1 matched


def test_truncated_tail_skipped_with_warning(tmp_path):
    """Crash recovery: a torn final gzip member (power loss mid-append)
    loses at most that member's cycles — earlier cycles load, a warning
    is recorded, nothing raises."""
    d = record_cycles(tmp_path, cycles=3)
    seg = os.path.join(d, sorted(
        f for f in os.listdir(d) if f.endswith(".jsonl.gz")
    )[-1])
    whole = read_artifact(d)
    assert whole.num_cycles == 3 and whole.warnings == []

    # torn member: valid gzip magic followed by garbage
    with open(seg, "ab") as fh:
        fh.write(b"\x1f\x8b\x08\x00garbage-not-a-deflate-stream")
    rt = read_artifact(d)
    assert rt.num_cycles == 3  # everything before the tear survives
    assert rt.warnings and "tail" in " ".join(rt.warnings)

    # truncation INSIDE the last valid member: strictly fewer cycles may
    # load, but never an exception and never zero segments read
    size = os.path.getsize(seg)
    with open(seg, "rb+") as fh:
        fh.truncate(size - 40)
    rt = read_artifact(d)
    assert rt.num_cycles <= 3
    assert rt.warnings


def test_corrupt_block_skips_cycles_not_crashes(tmp_path, caplog):
    rec = FlightRecorder(
        RecorderConfig(dir=str(tmp_path / "a")), autostart=False
    )
    for k in range(3):
        assert rec.record_cycle(StubSpec({"k": "same"}), stub_decisions(), meta(k))
    rec.start()
    rec.close()
    (block,) = [f for f in os.listdir(rec.config.dir) if f.endswith(".npz")]
    with open(os.path.join(rec.config.dir, block), "wb") as fh:
        fh.write(b"not a zip file")
    rt = read_artifact(rec.config.dir)
    assert rt.num_cycles == 0  # all three cycles lived in the one block
    assert any("unreadable block" in w for w in rt.warnings)
    # the snapshot stream is independent of the block and still loads
    assert len(rt.snapshots) == 1


def test_newer_schema_segment_skipped(tmp_path):
    d = tmp_path / "r"
    d.mkdir()
    with gzip.open(d / "seg-000001.jsonl.gz", "wt") as fh:
        fh.write(json.dumps({
            "kind": "header", "schema_version": SCHEMA_VERSION + 1,
            "segment": 1,
        }) + "\n")
        fh.write(json.dumps({"kind": "cycle", "block": "nope.npz",
                             "row": 0}) + "\n")
    rt = read_artifact(str(d))
    assert rt.num_cycles == 0
    assert any("newer than supported" in w for w in rt.warnings)


def test_bounded_queue_drops_and_counts(tmp_path):
    rec = FlightRecorder(
        RecorderConfig(dir=str(tmp_path / "q"), queue_max=2), autostart=False
    )
    assert rec.record_cycle(StubSpec({}), stub_decisions(), meta(0))
    assert rec.record_cycle(StubSpec({}), stub_decisions(), meta(1))
    # queue full: the cycle is dropped and counted, the caller never blocks
    assert not rec.record_cycle(StubSpec({}), stub_decisions(), meta(2))
    assert rec.dropped == 1
    rec.start()
    rec.close()
    rt = read_artifact(rec.config.dir)
    assert rt.num_cycles == 2
    assert [c.seq for c in rt.cycles] == [0, 1]


def test_rotation_and_retention(tmp_path):
    """A tiny segment budget rotates per batch; a tiny directory budget
    deletes the oldest segments; every retained segment stays
    self-contained (its cycles' snapshots re-written per segment)."""
    cfg = RecorderConfig(
        dir=str(tmp_path / "rot"), max_mb=0.01, segment_mb=1e-6,
        max_age_s=3600.0,
    )
    rec = FlightRecorder(cfg)
    for k in range(12):
        assert rec.record_cycle(
            StubSpec({"payload": "x" * 200}), stub_decisions(), meta(k)
        )
        rec.flush()  # one batch (and thus one rotation check) per cycle
    rec.close()
    segs = sorted(
        f for f in os.listdir(cfg.dir) if f.endswith(".jsonl.gz")
    )
    assert len(segs) > 1  # rotation happened
    assert "seg-000001.jsonl.gz" not in segs  # retention deleted the oldest
    total = sum(
        os.path.getsize(os.path.join(cfg.dir, f)) for f in os.listdir(cfg.dir)
    )
    # the budget holds up to one in-flight segment of slack
    assert total <= cfg.max_mb * 1e6 + cfg.segment_mb * 1e6 + 4096
    rt = read_artifact(cfg.dir)
    assert rt.num_cycles >= 1
    # oldest cycles were rotated away, newest survive, in order
    seqs = [c.seq for c in rt.cycles]
    assert seqs == sorted(seqs) and seqs[-1] == 11
    # self-containment: every surviving cycle's snapshot resolves
    for i in range(rt.num_cycles):
        assert rt.spec_doc_for(i)["payload"] == "x" * 200


def test_recorder_write_failure_never_raises(tmp_path, monkeypatch):
    """Disk trouble on the writer thread loses the batch, counts it, and
    keeps the recorder alive."""
    rec = FlightRecorder(RecorderConfig(dir=str(tmp_path / "w")), autostart=False)

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(rec, "_write_block", boom)
    rec.record_cycle(StubSpec({}), stub_decisions(), meta(0))
    rec.start()
    rec.flush()
    assert rec.write_errors == 1
    monkeypatch.undo()
    rec.record_cycle(StubSpec({}), stub_decisions(), meta(1))
    rec.close()
    rt = read_artifact(rec.config.dir)
    assert [c.seq for c in rt.cycles] == [1]


def test_recorder_survives_unserializable_spec(tmp_path):
    """A non-OSError on the writer thread (e.g. a spec whose to_dict
    carries something json can't serialize) must count as a write error
    and leave the writer alive — not kill the thread and misreport every
    later cycle as a queue-full drop."""
    rec = FlightRecorder(RecorderConfig(dir=str(tmp_path / "u")))
    rec.record_cycle(StubSpec({"bad": object()}), stub_decisions(), meta(0))
    rec.flush()
    assert rec.write_errors == 1
    # the writer is still alive: a clean cycle records fine afterwards
    rec.record_cycle(StubSpec({"ok": 1}), stub_decisions(), meta(1))
    rec.close()
    assert rec.dropped == 0
    rt = read_artifact(rec.config.dir)
    assert [c.seq for c in rt.cycles] == [1]


def test_block_with_missing_columns_skipped(tmp_path):
    """A block that LOADS but lacks expected columns (partial damage, a
    foreign npz matching the name pattern) is treated as unreadable —
    the reader's never-raise contract covers it."""
    rec = FlightRecorder(RecorderConfig(dir=str(tmp_path / "m")))
    rec.record_cycle(StubSpec({}), stub_decisions(), meta(0))
    rec.close()
    (block,) = [f for f in os.listdir(rec.config.dir) if f.endswith(".npz")]
    import numpy as _np

    _np.savez(os.path.join(rec.config.dir, block), variants=_np.asarray(["x"]))
    rt = read_artifact(rec.config.dir)
    assert rt.num_cycles == 0
    assert any("missing columns" in w for w in rt.warnings)


def test_recorder_default_off_and_dropped_metric(tmp_path):
    """No FLIGHT_RECORDER_DIR -> no recorder, no files; and the dropped
    counter rides the production registry."""
    cfg = ReconcilerConfig(config_namespace=CONFIG_NS, compute_backend="scalar",
                           compute_device="cpu")
    rec = Reconciler(kube=fleet_cluster(2), prom=fleet_fake_prom(rows(2)),
                     config=cfg)
    assert rec.recorder is None
    rec.run_cycle()
    body = rec.emitter.registry.render()
    assert "inferno_recorder_dropped_total" in body
    rec.close()


def test_snapshot_dedup_not_committed_on_write_failure(tmp_path, monkeypatch):
    """A transient append failure must not pre-commit the snapshot
    fingerprint dedup (or the recorded counter): the next successful
    batch has to re-emit the snapshot, or its cycles would reference a
    fingerprint that resolves nowhere in the artifact."""
    rec = FlightRecorder(RecorderConfig(dir=str(tmp_path / "d")), autostart=False)
    rec.record_cycle(StubSpec({"k": 1}), stub_decisions(), meta(0))
    real_open = gzip.open
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("transient append failure")
        return real_open(*a, **kw)

    monkeypatch.setattr(gzip, "open", flaky)
    rec.start()
    rec.flush()
    assert rec.write_errors == 1 and rec.recorded == 0  # nothing durable yet
    rec.record_cycle(StubSpec({"k": 1}), stub_decisions(), meta(1))
    rec.close()
    monkeypatch.undo()
    assert rec.recorded == 1
    rt = read_artifact(rec.config.dir)
    assert [c.seq for c in rt.cycles] == [1]
    # the surviving cycle's snapshot RESOLVES (the old bug left the
    # fingerprint in _seg_fps and skipped re-emitting it)
    assert rt.spec_doc_for(0) == {"k": 1}


def test_planner_trace_degrades_on_unresolvable_final_snapshot(tmp_path):
    """A cycle whose snapshot fingerprint resolves nowhere (damage,
    rotation) makes the CLI anchor on the newest RESOLVABLE cycle and
    report the bad sample as skipped — never a KeyError crash."""
    from inferno_tpu_torch.planner.__main__ import main as planner_main

    d = record_cycles(tmp_path, cycles=2)
    block = sorted(f for f in os.listdir(d) if f.endswith(".npz"))[0]
    (seg,) = sorted(f for f in os.listdir(d) if f.endswith(".jsonl.gz"))
    with gzip.open(os.path.join(d, seg), "ab") as fh:
        fh.write((json.dumps({
            "kind": "cycle", "block": block, "row": 0,
            "fingerprint": "deadbeef", "seq": 99, "ts": 9999.0,
            "duration_ms": 1.0, "interval_seconds": 60,
            "optimization_ok": True, "errors": 0, "variants": N,
        }) + "\n").encode())
    out = tmp_path / "r.json"
    assert planner_main(["--trace", d, "--backend", "torch", "--device", "cpu",
                         "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["fleet"]["snapshot_cycle_index"] == 1  # newest resolvable
    last = doc["parity_sampled"][-1]
    assert last["match"] is None and "skip_reason" in last
    assert all(p["match"] is True for p in doc["parity_sampled"][:-1])


def test_obs_report_fails_when_parity_cannot_run(tmp_path, capsys):
    """Requested replay parity that cannot check anything (no
    resolvable snapshots) exits 1 — never a vacuous clean pass; the
    telemetry-only read stays available via --no-replay."""
    from inferno_tpu_torch.obs.report import main as report_main

    d = record_cycles(tmp_path, cycles=2)
    (seg,) = sorted(f for f in os.listdir(d) if f.endswith(".jsonl.gz"))
    path = os.path.join(d, seg)
    with gzip.open(path, "rt") as fh:
        lines = [ln for ln in fh if json.loads(ln).get("kind") != "snapshot"]
    os.remove(path)
    with gzip.open(path, "wt") as fh:
        fh.writelines(lines)

    assert report_main([d, "--backend", "torch", "--device", "cpu"]) == 1
    assert "no sampled cycle has a resolvable" in capsys.readouterr().err
    assert report_main([d, "--no-replay"]) == 0


def test_recorder_close_bounded_when_writer_wedged(tmp_path, monkeypatch):
    """close(timeout) must return in bounded time even when the writer
    is wedged mid-write with a full queue (hung NFS): shutdown abandons
    the daemon thread instead of blocking forever on the sentinel put."""
    import time as _time

    rec = FlightRecorder(
        RecorderConfig(dir=str(tmp_path / "wedge"), queue_max=1),
        autostart=False,
    )
    monkeypatch.setattr(
        rec, "_write_batch", lambda batch: _time.sleep(30.0)
    )
    rec.start()
    rec.record_cycle(StubSpec({}), stub_decisions(), meta(0))  # wedges writer
    _time.sleep(0.05)
    rec.record_cycle(StubSpec({}), stub_decisions(), meta(1))  # fills queue
    t0 = _time.monotonic()
    rec.close(timeout=0.3)
    assert _time.monotonic() - t0 < 5.0


def test_config_validates_recorder_and_attainment_knobs():
    with pytest.raises(ValueError):
        ReconcilerConfig(flight_recorder_max_mb=0)
    with pytest.raises(ValueError):
        ReconcilerConfig(flight_recorder_max_age_s=0)
    with pytest.raises(ValueError):
        ReconcilerConfig(attainment_ewma_gain=0.0)
    with pytest.raises(ValueError):
        ReconcilerConfig(attainment_ewma_gain=1.5)


def test_sampled_cycles_policy_shared():
    """First/middle/last is THE parity sampling policy — one helper,
    consumed by the recorder bench, planner --trace, and obs.report."""
    from inferno_tpu_torch.obs.recorder import RecordedTrace

    def rt(n):
        return RecordedTrace(dir="", schema_version=1,
                             cycles=[None] * n, snapshots={}, warnings=[])

    assert rt(0).sampled_cycles() == []
    assert rt(1).sampled_cycles() == [0]
    assert rt(2).sampled_cycles() == [0, 1]
    assert rt(7).sampled_cycles() == [0, 3, 6]


# -- offline CLIs -------------------------------------------------------------


def test_planner_trace_cli(tmp_path, capsys):
    from inferno_tpu_torch.planner.__main__ import main as planner_main

    d = record_cycles(tmp_path, cycles=3, arrival_rps=40.0)
    out_path = tmp_path / "report.json"
    assert planner_main(["--trace", d, "--backend", "torch", "--device", "cpu",
                         "--out", str(out_path)]) == 0
    doc = json.loads(out_path.read_text())
    assert doc["steps"] == 3
    assert doc["fleet"]["variants"] == N
    assert doc["recorded"]["source"] == "recorded"
    assert doc["recorded"]["drift"]["coverage"] == 1.0
    assert doc["parity_sampled"] and all(
        p["match"] for p in doc["parity_sampled"]
    )
    # pool demand aggregated like any scenario replay
    assert doc["recorded"]["reactive"]["pools"]


def test_planner_trace_cli_rejects_empty_dir(tmp_path):
    from inferno_tpu_torch.planner.__main__ import main as planner_main

    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit):
        planner_main(["--trace", str(empty)])


def test_obs_report_cli_table_and_json(tmp_path, capsys):
    from inferno_tpu_torch.obs.report import main as report_main

    d = record_cycles(tmp_path, cycles=3)
    assert report_main([d, "--backend", "torch", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"{fleet_variant(0)}:{FLEET_NS}" in out
    assert "att_itl" in out and "burn" in out
    assert "MISMATCH" not in out

    assert report_main([d, "--json", "--no-replay"]) == 0
    doc = json.loads(capsys.readouterr().out)
    row = doc["variants"][f"{fleet_variant(0)}:{FLEET_NS}"]
    assert row["cycles"] == 3
    # FakeProm telemetry is static and inside both SLOs
    assert row["ttft_attainment"] == 1.0
    assert row["itl_attainment"] == 1.0
    # |observed - predicted| is scored from cycle 2 on
    assert row["itl_error_ewma_ms"] > 0.0


def test_obs_report_exit_1_on_mismatch_in_both_modes(tmp_path, capsys):
    """A replay-parity mismatch fails the report run in table AND --json
    mode — CI branches on the exit code either way."""
    from inferno_tpu_torch.obs.report import main as report_main

    d = record_cycles(tmp_path, cycles=3)
    # tamper with a recorded decision so the replay cannot match
    blocks = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
    path = os.path.join(d, blocks[0])
    data = dict(np.load(path, allow_pickle=False))
    data["replicas"] = data["replicas"] + 5
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **data)

    assert report_main([d, "--backend", "torch", "--device", "cpu"]) == 1
    assert "MISMATCH" in capsys.readouterr().out
    assert report_main([d, "--backend", "torch", "--device", "cpu", "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["replay_mismatches"] > 0


def test_stabilization_hold_not_scored_as_model_error():
    """A held decision actuates the window PEAK, not the size its
    prediction was computed for — the scoreboard must not store that
    prediction (it would report spurious model drift through every
    scale-down window)."""
    from inferno_tpu_torch.controller.reconciler import CycleReport
    from inferno_tpu_torch.obs import (
        REASON_SLO_BOUND,
        REASON_STABILIZATION_HOLD,
        Tracer,
    )

    cfg = ReconcilerConfig(config_namespace=CONFIG_NS, compute_backend="scalar",
                           compute_device="cpu")
    rec = Reconciler(kube=fleet_cluster(0), prom=fleet_fake_prom({}), config=cfg)

    def decision(variant, reason):
        d = DecisionRecord(
            variant=variant, namespace="ns", name=variant,
            ttft_observed_ms=50.0, itl_observed_ms=20.0,
            ttft_predicted_ms=45.0, itl_predicted_ms=22.0,
            slo_ttft_ms=500.0, slo_itl_ms=24.0,
        )
        d.decide(reason, accelerator="v5e-4", replicas=2)
        return d

    for _ in range(2):
        report = CycleReport(interval_seconds=60)
        report.decisions = [
            decision("held", REASON_STABILIZATION_HOLD),
            decision("free", REASON_SLO_BOUND),
        ]
        rec._finish_cycle(Tracer(), report)
    held, free = report.decisions
    assert held.ttft_model_error_ms == 0.0  # never scored
    assert free.ttft_model_error_ms == pytest.approx(50.0 - 45.0)
    assert rec.attainment.score_of("held").scored_cycles == 0
    assert rec.attainment.score_of("free").scored_cycles == 1
    rec.close()


def test_limited_cycle_parity_skips_capacity_limited(tmp_path):
    """A limited-mode cycle whose budget binds records capacity_limited
    decisions: the parity replay skips and counts them and matches the
    rest."""
    from inferno_tpu_torch.planner.replay import replay_cycle_parity

    kube = fleet_cluster(6)
    prom = fleet_fake_prom(rows(6, arrival_rps=40.0))
    cfg = ReconcilerConfig(config_namespace=CONFIG_NS, compute_backend="torch",
                           compute_device="cpu",
                           flight_recorder_dir=str(tmp_path / "lim"))
    rec = Reconciler(kube=kube, prom=prom, config=cfg)
    assert rec.run_cycle().errors == []
    chips = sum(r.replicas * (16 if r.accelerator == "v5e-16" else 4)
                for r in rec.run_cycle().decisions if r.accelerator)
    kube.set_configmap(CONFIG_NS, "inferno-autoscaler-config", {
        "OPTIMIZER_MODE": "limited",
        "TPU_CAPACITY": json.dumps({"v5e": int(chips * 0.5)}),
    })
    report = rec.run_cycle()
    assert report.errors == []
    rec.close()
    rt = read_artifact(str(tmp_path / "lim"))
    assert rt.num_cycles == 3 and rt.warnings == []
    last = rt.num_cycles - 1
    limited = int((rt.cycles[last].columns["reason"] == "capacity_limited").sum())
    assert limited > 0
    parity = replay_cycle_parity(rt, last, backend="torch", device="cpu")
    assert parity["match"], parity["mismatches"]
    assert parity["skipped"] == limited
    assert parity["compared"] == 6 - limited


# -- across packages: one artifact format -------------------------------------


def test_reference_reads_and_replays_a_port_recording(tmp_path):
    from inferno_tpu.obs.recorder import read_artifact as ref_read_artifact
    from inferno_tpu.planner.replay import replay_cycle_parity as ref_parity

    d = record_cycles(tmp_path, cycles=3, arrival_rps=40.0)
    port_rt = read_artifact(d)
    ref_rt = ref_read_artifact(d)
    assert ref_rt.warnings == [] and ref_rt.num_cycles == 3
    assert ref_rt.schema_version == port_rt.schema_version == SCHEMA_VERSION
    assert set(ref_rt.snapshots) == set(port_rt.snapshots)
    for a, b in zip(port_rt.cycles, ref_rt.cycles):
        assert (a.seq, a.fingerprint, a.variants) == (b.seq, b.fingerprint, b.variants)
        assert set(a.columns) == set(b.columns)
        for key in a.columns:
            np.testing.assert_array_equal(a.columns[key], b.columns[key])
    for k in range(3):
        parity = ref_parity(ref_rt, k, backend="jax")
        assert parity["match"], parity["mismatches"]
        assert parity["compared"] == N


def test_port_reads_and_replays_a_reference_recording(tmp_path):
    from inferno_tpu.controller.reconciler import Reconciler as RefReconciler
    from inferno_tpu.controller.reconciler import ReconcilerConfig as RefConfig
    from inferno_tpu.testing.fleet import fleet_cluster as ref_fleet_cluster
    from inferno_tpu.testing.fleet import fleet_fake_prom as ref_fleet_fake_prom
    from inferno_tpu_torch.planner.__main__ import main as planner_main
    from inferno_tpu_torch.planner.replay import replay_cycle_parity

    d = str(tmp_path / "ref-rec")
    rec = RefReconciler(
        kube=ref_fleet_cluster(N), prom=ref_fleet_fake_prom(rows(N, 40.0)),
        config=RefConfig(config_namespace=CONFIG_NS, compute_backend="jax",
                         flight_recorder_dir=d))
    for _ in range(3):
        assert rec.run_cycle().errors == []
    rec.close()
    rt = read_artifact(d)
    assert rt.warnings == [] and rt.num_cycles == 3
    assert (rt.cycles[-1].columns["replicas"] > 1).any()
    for k in range(3):
        parity = replay_cycle_parity(rt, k, backend="torch", device="cpu")
        assert parity["match"], parity["mismatches"]
        assert parity["compared"] == N
    out = tmp_path / "trace.json"
    assert planner_main(["--trace", d, "--backend", "torch", "--device", "cpu",
                         "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["recorded"]["drift"]["coverage"] == 1.0
    assert all(p["match"] for p in doc["parity_sampled"])
