"""Fleet flight recorder: durable per-cycle trace capture.

The control plane's whole output is a stream of per-cycle decisions
computed from a per-cycle snapshot of inputs. This module makes that
stream durable so it can be *replayed* (``planner/replay.py``,
``python -m inferno_tpu_torch.planner --trace``) and *scored*
(``python -m inferno_tpu_torch.obs.report``): capture what the live
controller saw and decided, then ask the sizing stack to reproduce it
— the loop "inference-fleet-sim" (PAPERS.md) motivates.

Artifact layout (one directory, env ``FLIGHT_RECORDER_DIR``):

    seg-000001.jsonl.gz        metadata stream — header line, fleet
                               snapshot lines, one line per cycle
    seg-000001-b000000.npz     columnar block: [cycles, variants]
                               input/decision arrays
    seg-000002.jsonl.gz ...    next rotation segment

* The ``.jsonl.gz`` stream is **append-only**: every flush writes one
  complete gzip member (gzip readers concatenate members
  transparently), so a crash can truncate at most the final member —
  the reader skips a torn tail with a warning, never a crash.
* Each npz block holds the columnar arrays of consecutive cycles that
  share one variant list; blocks are written to a temp file and
  ``os.replace``d into place *before* the cycle lines referencing them
  are appended, so a crash leaves an orphan block, never a dangling
  reference.
* **Fleet snapshots**: the full ``SystemSpec`` document each cycle's
  solve consumed — CANONICALIZED (`canonicalize_spec_doc`: per-cycle
  volatile observations that already live in the npz columns are
  zeroed, so a steady fleet fingerprints identically every cycle) —
  deduplicated by content fingerprint and re-written at the head of
  every segment (each segment is self-contained). Replay reconstructs
  a bit-faithful ``System`` from it — a recorded T=1 cycle replays
  bit-identical to the live ``calculate_fleet`` decision.
* **Rotation**: a segment rolls when it exceeds ``segment_mb`` (default
  ``max_mb / 4``) or ``max_age_s``; after rolling, the oldest segments
  are deleted until the directory fits ``max_mb``
  (``FLIGHT_RECORDER_MAX_MB``).

Hot-path contract: `record_cycle` only enqueues object references on a
bounded queue — serialization, compression, and disk I/O all happen on
the writer thread, so a slow or full disk can never stall a reconcile
cycle. A full queue *drops* the cycle and counts it (`dropped`,
surfaced as ``inferno_recorder_dropped_total``).

Schema versioning: ``SCHEMA_VERSION`` is stamped into every segment
header; the reader refuses nothing older and skips (with a warning)
anything newer.

Port of `inferno_tpu/obs/recorder.py`, verbatim apart from its imports:
the same `SCHEMA_VERSION`, column sets and artifact layout, so an
artifact either package writes is read and replayed by the other.
"""

from __future__ import annotations

import dataclasses
import gzip
import hashlib
import json
import logging
import os
import queue
import threading
import time
import zlib
from typing import Any, Callable, Iterable

import numpy as np

SCHEMA_VERSION = 1

# The FLIGHT_RECORDER_DIR / FLIGHT_RECORDER_MAX_MB /
# FLIGHT_RECORDER_MAX_AGE_S environment variables are parsed in ONE
# place — controller/main.py, into ReconcilerConfig — and arrive here as
# RecorderConfig fields. No parallel env reader exists on purpose.

log = logging.getLogger("inferno.recorder")

# columnar fields, pulled off each DecisionRecord by attribute name
_F64_FIELDS = (
    "arrival_rpm", "sizing_rpm",
    "decode_alpha", "decode_beta", "prefill_gamma", "prefill_delta",
    "cost", "prev_cost", "lambda_max_rpm",
)
_F32_FIELDS = (
    "avg_in_tokens", "avg_out_tokens",
    "slo_ttft_ms", "slo_itl_ms",
    "ttft_predicted_ms", "itl_predicted_ms",
    "ttft_observed_ms", "itl_observed_ms",
    "ttft_model_error_ms", "itl_model_error_ms",
)
_I32_FIELDS = ("replicas", "prev_replicas", "chip_shortfall")
_STR_FIELDS = (
    "accelerator", "prev_accelerator", "reason", "degradation_step",
    "profile_provenance", "rate_provenance", "sizing_provenance",
)
COLUMN_FIELDS = _F64_FIELDS + _F32_FIELDS + _I32_FIELDS + _STR_FIELDS
# Columns added AFTER schema v1 shipped: always written, but OPTIONAL on
# read — a block recorded by an older controller simply lacks them and
# the reader fills zeros, so adding one never invalidates an archive.
# (A column a reader must not default belongs in COLUMN_FIELDS plus a
# SCHEMA_VERSION bump instead.)
OPTIONAL_I32_FIELDS = ("spot_replicas",)  # spot-tier placement


def spec_fingerprint(spec_doc: dict) -> str:
    """Content fingerprint of a SystemSpec document (canonical JSON)."""
    blob = json.dumps(spec_doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def canonicalize_spec_doc(doc: dict) -> dict:
    """Strip the per-cycle VOLATILE observations from a SystemSpec
    document (in place; returns it): per-server observed arrival rate,
    observed latency averages, and the desired allocation. All of them
    already live in the per-cycle npz columns (`sizing_rpm` /
    `arrival_rpm`, `*_observed_ms`, `replicas`/`accelerator`), and none
    of them is a sizing input — the batched replay overrides arrival
    rates per timestep, and transition penalties read only the current
    allocation's shape/replicas/cost. Canonicalizing makes a steady
    fleet's snapshot fingerprint STABLE across cycles, so the ~hundreds
    of KB spec document serializes and stores once instead of every
    cycle (the recorder's main CPU cost, and pure GIL theft from the
    reconcile thread)."""
    for server in (doc.get("serverData", {}) or {}).get("servers", []) or []:
        cur = server.get("currentAlloc")
        if isinstance(cur, dict):
            load = cur.get("load")
            if isinstance(load, dict):
                load["arrivalRate"] = 0.0
            cur["itlAverage"] = 0.0
            cur["ttftAverage"] = 0.0
        server["desiredAlloc"] = {}
    return doc


@dataclasses.dataclass
class RecorderConfig:
    dir: str
    max_mb: float = 64.0  # directory retention budget
    max_age_s: float = 3600.0  # segment age before rotation
    segment_mb: float = 0.0  # segment size before rotation; 0 = max_mb/4
    queue_max: int = 8  # pending cycles before drops start

    def __post_init__(self) -> None:
        if not self.dir:
            raise ValueError("RecorderConfig.dir must be set")
        if self.max_mb <= 0 or self.max_age_s <= 0 or self.queue_max < 1:
            raise ValueError(f"invalid recorder config: {self}")
        if self.segment_mb <= 0:
            self.segment_mb = max(self.max_mb / 4.0, 0.25)


class _Close:
    pass


_CLOSE = _Close()


@dataclasses.dataclass
class _Pending:
    """One enqueued cycle: live object references only — everything
    here is per-cycle-fresh in the reconciler (never mutated after the
    cycle completes), so serialization can safely happen later on the
    writer thread."""

    spec: Any  # SystemSpec (anything with .to_dict())
    decisions: list[Any]  # DecisionRecords
    meta: dict[str, Any]


class FlightRecorder:
    """Append-only recorder; one instance per controller process.

    `autostart=False` leaves the writer thread unstarted (tests use it
    to fill the bounded queue deterministically); `start()` launches it.
    """

    def __init__(self, config: RecorderConfig, autostart: bool = True):
        self.config = config
        os.makedirs(config.dir, exist_ok=True)
        self._q: queue.Queue = queue.Queue(maxsize=config.queue_max)
        self.dropped = 0  # cycles lost to a full queue
        self.recorded = 0  # cycles durably written
        self.write_errors = 0  # batches lost to I/O failures
        self._seg = self._next_segment_index()
        self._seg_bytes = 0  # jsonl + npz bytes of the current segment
        self._seg_block_bytes = 0  # npz share (jsonl share is getsize'd)
        self._seg_started = time.monotonic()
        self._seg_fps: set[str] = set()
        self._seg_has_header = False
        self._block = 0
        # writer-thread snapshot dedup: the last canonicalized spec doc
        # and its fingerprint — an unchanged fleet skips the expensive
        # JSON serialization entirely (dict equality is a cheap C-level
        # walk; json.dumps of a large fleet is not)
        self._last_doc: dict | None = None
        self._last_fp = ""
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="inferno-flight-recorder", daemon=True
        )
        if autostart:
            self._thread.start()

    def start(self) -> None:
        if not self._thread.is_alive():
            self._thread.start()

    # -- hot path ------------------------------------------------------------

    def record_cycle(self, spec: Any, decisions: list, meta: dict) -> bool:
        """Enqueue one cycle for durable capture. Never blocks: a full
        queue (slow disk) drops the cycle and returns False."""
        if self._closed:
            return False
        try:
            self._q.put_nowait(_Pending(spec=spec, decisions=list(decisions),
                                        meta=dict(meta)))
            return True
        except queue.Full:
            self.dropped += 1
            return False

    # -- lifecycle -----------------------------------------------------------

    def flush(self, timeout: float = 30.0) -> None:
        """Block until everything enqueued so far is on disk."""
        deadline = time.monotonic() + timeout
        while self._q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.01)

    def close(self, timeout: float = 30.0) -> None:
        """Flush and stop the writer thread, waiting at most ~timeout.
        Idempotent. A wedged writer (disk hung mid-syscall with a full
        queue) is abandoned after the timeout — it is a daemon thread,
        so process exit reaps it; shutdown must never hang on it."""
        if self._closed:
            return
        self._closed = True
        if self._thread.is_alive():
            deadline = time.monotonic() + timeout
            try:
                # bounded: an unconditional put on the full queue of a
                # wedged writer would block forever
                self._q.put(_CLOSE, timeout=timeout)
            except queue.Full:
                return
            self._thread.join(timeout=max(deadline - time.monotonic(), 0.1))

    # -- writer thread -------------------------------------------------------

    def _run(self) -> None:
        while True:
            item = self._q.get()
            batch: list[_Pending] = []
            closing = item is _CLOSE
            if not closing:
                batch.append(item)
            # drain whatever else queued while we slept or wrote
            while True:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _CLOSE:
                    closing = True
                else:
                    batch.append(nxt)
            try:
                if batch:
                    self._write_batch(batch)
            except Exception as e:  # noqa: BLE001 — writer must survive
                # ANY write/serialization failure (disk trouble, an
                # unserializable spec value, ...) loses this batch and is
                # counted — it must never kill the writer thread, which
                # would silently end recording and misreport every later
                # cycle as a queue-full drop
                self.write_errors += 1
                log.warning("flight recorder write failed (%d cycles lost): %s",
                            len(batch), e)
            finally:
                for _ in range(len(batch) + (1 if closing else 0)):
                    self._q.task_done()
            if closing:
                return

    def _next_segment_index(self) -> int:
        existing = [
            int(name[4:10])
            for name in os.listdir(self.config.dir)
            if name.startswith("seg-") and name.endswith(".jsonl.gz")
            and name[4:10].isdigit()
        ]
        return (max(existing) + 1) if existing else 1

    def _seg_path(self) -> str:
        return os.path.join(self.config.dir, f"seg-{self._seg:06d}.jsonl.gz")

    def _maybe_rotate(self) -> None:
        if not self._seg_has_header:
            return  # nothing written to this segment yet
        age = time.monotonic() - self._seg_started
        if (self._seg_bytes <= self.config.segment_mb * 1e6
                and age <= self.config.max_age_s):
            return
        self._seg += 1
        self._seg_bytes = 0
        self._seg_block_bytes = 0
        self._seg_started = time.monotonic()
        self._seg_fps.clear()
        self._seg_has_header = False
        self._retain()

    def _retain(self) -> None:
        """Delete oldest segments until the directory fits max_mb (the
        current segment is never deleted)."""
        by_seg: dict[int, list[str]] = {}
        total = 0
        for name in os.listdir(self.config.dir):
            if not name.startswith("seg-") or not name[4:10].isdigit():
                continue
            seg = int(name[4:10])
            path = os.path.join(self.config.dir, name)
            try:
                total += os.path.getsize(path)
            except OSError:
                continue
            by_seg.setdefault(seg, []).append(path)
        budget = self.config.max_mb * 1e6
        for seg in sorted(by_seg):
            if total <= budget or seg >= self._seg:
                break
            for path in by_seg[seg]:
                try:
                    size = os.path.getsize(path)
                    os.remove(path)
                    total -= size
                except OSError:
                    pass

    def _write_batch(self, batch: list[_Pending]) -> None:
        self._maybe_rotate()
        # Dedup/bookkeeping state is staged in LOCALS and committed only
        # after the gzip append succeeds: committing first would let one
        # transient write failure permanently suppress the snapshot for
        # the rest of the segment (cycle lines whose fingerprint
        # resolves nowhere) and count never-written cycles as recorded.
        seen_fps = set(self._seg_fps)
        last_doc, last_fp = self._last_doc, self._last_fp
        n_cycles = 0
        lines: list[str] = []
        if not self._seg_has_header:
            lines.append(json.dumps({
                "kind": "header",
                "schema_version": SCHEMA_VERSION,
                "segment": self._seg,
                "created_at": time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
                ),
            }))

        # group consecutive cycles sharing a variant list into one block
        groups: list[list[_Pending]] = []
        for p in batch:
            key = tuple(rec.variant for rec in p.decisions)
            if groups and tuple(
                rec.variant for rec in groups[-1][0].decisions
            ) == key:
                groups[-1].append(p)
            else:
                groups.append([p])

        for group in groups:
            # the block index may advance past failed attempts — orphan
            # npz files are ignored by the reader; names never collide
            block_name = f"seg-{self._seg:06d}-b{self._block:06d}.npz"
            self._block += 1
            self._write_block(os.path.join(self.config.dir, block_name), group)
            for row, p in enumerate(group):
                fp = ""
                if p.spec is not None:
                    spec_doc = canonicalize_spec_doc(p.spec.to_dict())
                    if spec_doc == last_doc:
                        fp = last_fp  # unchanged fleet: no re-dump
                    else:
                        fp = spec_fingerprint(spec_doc)
                        last_doc, last_fp = spec_doc, fp
                    if fp not in seen_fps:
                        seen_fps.add(fp)
                        lines.append(json.dumps({
                            "kind": "snapshot",
                            "fingerprint": fp,
                            "spec": spec_doc,
                        }))
                lines.append(json.dumps({
                    "kind": "cycle",
                    "block": block_name,
                    "row": row,
                    "fingerprint": fp,
                    "variants": len(p.decisions),
                    **p.meta,
                }))
                n_cycles += 1

        payload = ("\n".join(lines) + "\n").encode()
        # one complete gzip member per flush: readers concatenate
        # members, and a crash can tear at most the final member
        with gzip.open(self._seg_path(), "ab") as fh:
            fh.write(payload)
        # the append is durable: commit the staged state
        self._seg_has_header = True
        self._seg_fps = seen_fps
        self._last_doc, self._last_fp = last_doc, last_fp
        self.recorded += n_cycles
        try:
            self._seg_bytes = (
                os.path.getsize(self._seg_path()) + self._seg_block_bytes
            )
        except OSError:
            pass

    def _write_block(self, path: str, group: list[_Pending]) -> None:
        cols: dict[str, np.ndarray] = {}
        n_cycles = len(group)
        variants = [rec.variant for rec in group[0].decisions]
        cols["variants"] = np.asarray(variants, dtype=np.str_)
        for field, dtype, fields in (
            ("f8", np.float64, _F64_FIELDS),
            ("f4", np.float32, _F32_FIELDS),
            ("i4", np.int32, _I32_FIELDS + OPTIONAL_I32_FIELDS),
        ):
            del field
            for name in fields:
                cols[name] = np.asarray(
                    [[getattr(rec, name) for rec in p.decisions] for p in group],
                    dtype=dtype,
                ).reshape(n_cycles, len(variants))
        for name in _STR_FIELDS:
            cols[name] = np.asarray(
                [[getattr(rec, name) for rec in p.decisions] for p in group],
                dtype=np.str_,
            ).reshape(n_cycles, len(variants))
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez_compressed(fh, **cols)
        os.replace(tmp, path)  # a crash leaves an orphan, never a torn block
        try:
            self._seg_block_bytes += os.path.getsize(path)
            self._seg_bytes += os.path.getsize(path)
        except OSError:
            pass


# -- reading ------------------------------------------------------------------


@dataclasses.dataclass
class RecordedCycle:
    """One recorded reconcile cycle: identity + per-variant column views
    (each ``columns[field]`` is the [V] row of its npz block)."""

    seq: int
    ts: float  # epoch seconds the cycle started
    duration_ms: float
    interval_seconds: float
    optimization_ok: bool
    errors: int
    fingerprint: str  # fleet-snapshot fingerprint ("" = none recorded)
    variants: list[str]
    columns: dict[str, np.ndarray]
    # per-cycle profile document (obs/profiler.py): the
    # cycle's own cost attribution, recorded when the live controller
    # ran with CYCLE_PROFILER on. OPTIONAL ON READ — pre-profiler
    # artifacts (and profiler-off recordings) load with None, so adding
    # the column never invalidated an archive (same contract as
    # OPTIONAL_I32_FIELDS, but carried in the jsonl cycle line: the
    # document is per-cycle, not per-variant, so the npz blocks are the
    # wrong home for it)
    profile: dict | None = None


@dataclasses.dataclass
class RecordedTrace:
    """A loaded flight-recorder artifact."""

    dir: str
    schema_version: int
    cycles: list[RecordedCycle]
    snapshots: dict[str, dict]  # fingerprint -> SystemSpec document
    warnings: list[str]

    @property
    def num_cycles(self) -> int:
        return len(self.cycles)

    def variant_ids(self) -> list[str]:
        """Union of recorded variant ids, in first-seen order."""
        seen: dict[str, None] = {}
        for cyc in self.cycles:
            for v in cyc.variants:
                seen.setdefault(v)
        return list(seen)

    def sampled_cycles(self) -> list[int]:
        """THE parity sampling policy (first / middle / last cycle),
        shared by the recorder bench, `planner --trace`, and `obs.report` so
        the three consumers can never drift. Callers decide what a
        sampled cycle without a resolvable snapshot means (skip-and-
        report vs hard failure)."""
        if not self.cycles:
            return []
        n = len(self.cycles)
        return sorted({0, n // 2, n - 1})

    def step_seconds(self) -> float:
        """The replay timestep: the recorded reconcile interval (first
        non-zero), falling back to the median cycle-start delta, then
        60s."""
        for cyc in self.cycles:
            if cyc.interval_seconds > 0:
                return float(cyc.interval_seconds)
        deltas = sorted(
            b.ts - a.ts for a, b in zip(self.cycles, self.cycles[1:])
            if b.ts > a.ts
        )
        if deltas:
            return float(deltas[len(deltas) // 2])
        return 60.0

    def column_matrix(
        self, field: str, variants: list[str] | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """[T, V] matrix of one numeric column aligned to `variants`
        (default: `variant_ids()` order), plus a [T, V] bool presence
        mask (False = the variant was not recorded that cycle; its value
        is 0)."""
        if variants is None:
            variants = self.variant_ids()
        idx = {v: j for j, v in enumerate(variants)}
        n_steps = len(self.cycles)
        out = np.zeros((n_steps, len(variants)), np.float64)
        present = np.zeros((n_steps, len(variants)), bool)
        pos_cache: dict[tuple, tuple[np.ndarray, np.ndarray]] = {}
        for t, cyc in enumerate(self.cycles):
            key = tuple(cyc.variants)
            cached = pos_cache.get(key)
            if cached is None:
                src = np.asarray(
                    [j for j, v in enumerate(cyc.variants) if v in idx], np.int64
                )
                dst = np.asarray(
                    [idx[v] for v in cyc.variants if v in idx], np.int64
                )
                cached = pos_cache[key] = (src, dst)
            src, dst = cached
            if len(src):
                out[t, dst] = np.asarray(cyc.columns[field], np.float64)[src]
                present[t, dst] = True
        return out, present

    def profile_summary(self) -> dict | None:
        """Aggregate cost attribution over the cycles that carry a
        profile column: mean cycle/phase wall-ms plus summed
        event counters. None when no recorded cycle has one (pre-
        profiler artifact, or CYCLE_PROFILER was off) — renderers skip
        the block rather than print zeros that read as a free cycle."""
        profiled = [c.profile for c in self.cycles if c.profile]
        if not profiled:
            return None
        n = len(profiled)
        phases: dict[str, float] = {}
        counters: dict[str, float] = {}
        cycle_ms = 0.0
        for doc in profiled:
            cycle_ms += float((doc.get("cycle") or {}).get("wall_ms", 0.0))
            for name, entry in (doc.get("phases") or {}).items():
                phases[name] = phases.get(name, 0.0) + float(
                    (entry or {}).get("wall_ms", 0.0)
                )
            for name, val in (doc.get("counters") or {}).items():
                if isinstance(val, (int, float)):
                    counters[name] = counters.get(name, 0.0) + float(val)
        return {
            "cycles_profiled": n,
            "mean_cycle_ms": round(cycle_ms / n, 3),
            "mean_phase_ms": {
                k: round(v / n, 3) for k, v in sorted(phases.items())
            },
            "counters_total": {
                k: (round(v, 3) if k.endswith(("_ms", "_kb")) else int(v))
                for k, v in sorted(counters.items())
            },
        }

    def spec_doc_for(self, cycle_index: int = -1) -> dict:
        """The fleet-snapshot document of the given cycle (raises
        KeyError when that cycle recorded none)."""
        fp = self.cycles[cycle_index].fingerprint
        return self.snapshots[fp]


def _iter_jsonl(path: str, warnings: list[str]) -> Iterable[dict]:
    """Yield parsed lines; a torn gzip member / corrupt tail ends the
    stream with a warning instead of raising (crash recovery)."""
    try:
        with gzip.open(path, "rt", encoding="utf-8") as fh:
            buf: list[str] = []
            while True:
                try:
                    line = fh.readline()
                except (OSError, EOFError, UnicodeDecodeError, zlib.error) as e:
                    warnings.append(
                        f"{os.path.basename(path)}: truncated/corrupt tail "
                        f"skipped ({e.__class__.__name__}: {e})"
                    )
                    break
                if not line:
                    break
                buf.append(line)
            for line in buf:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError as e:
                    warnings.append(
                        f"{os.path.basename(path)}: undecodable line skipped ({e})"
                    )
                    # a torn line can only be the tail of the final
                    # member; later lines of the same buffered read are
                    # suspect too, so stop here
                    break
    except (OSError, EOFError) as e:
        warnings.append(
            f"{os.path.basename(path)}: unreadable segment skipped ({e})"
        )


def read_artifact(
    directory: str, warn: Callable[[str], None] | None = None
) -> RecordedTrace:
    """Load a flight-recorder artifact. Damage tolerance: a truncated
    final gzip member, an undecodable line, or a missing/corrupt npz
    block each skip the affected tail/cycle with a warning — reading
    never raises for artifact damage (only for a missing directory)."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no flight-recorder artifact at {directory!r}")
    warnings: list[str] = []
    segments = sorted(
        name for name in os.listdir(directory)
        if name.startswith("seg-") and name.endswith(".jsonl.gz")
    )
    cycles: list[RecordedCycle] = []
    snapshots: dict[str, dict] = {}
    schema_version = SCHEMA_VERSION
    blocks: dict[str, dict | None] = {}  # path -> npz dict (None = bad)

    def load_block(name: str) -> dict | None:
        if name in blocks:
            return blocks[name]
        path = os.path.join(directory, name)
        try:
            with np.load(path, allow_pickle=False) as z:
                data = {k: z[k] for k in z.files}
            missing = {"variants", *COLUMN_FIELDS} - set(data)
            if missing:
                # loads cleanly but lacks expected columns (partial
                # damage, foreign file, column added without a schema
                # bump): same treatment as an unreadable block — the
                # reader's contract is that artifact damage warns, never
                # raises
                raise ValueError(f"missing columns {sorted(missing)[:4]}")
        except (OSError, ValueError, KeyError, EOFError) as e:
            warnings.append(f"{name}: unreadable block skipped "
                            f"({e.__class__.__name__}: {e})")
            data = None
        blocks[name] = data
        return data

    for seg_name in segments:
        for doc in _iter_jsonl(os.path.join(directory, seg_name), warnings):
            kind = doc.get("kind")
            if kind == "header":
                ver = int(doc.get("schema_version", 0) or 0)
                if ver > SCHEMA_VERSION:
                    warnings.append(
                        f"{seg_name}: schema v{ver} is newer than "
                        f"supported v{SCHEMA_VERSION}; segment skipped"
                    )
                    break
                schema_version = ver
            elif kind == "snapshot":
                fp = doc.get("fingerprint", "")
                if fp and isinstance(doc.get("spec"), dict):
                    snapshots[fp] = doc["spec"]
            elif kind == "cycle":
                block = load_block(str(doc.get("block", "")))
                if block is None:
                    continue
                row = int(doc.get("row", -1))
                variants = block.get("variants")
                if variants is None or not (
                    0 <= row < len(block[COLUMN_FIELDS[0]])
                ):
                    warnings.append(
                        f"{seg_name}: cycle references bad block row; skipped"
                    )
                    continue
                columns = {f: block[f][row] for f in COLUMN_FIELDS}
                for f in OPTIONAL_I32_FIELDS:
                    # pre-spot artifacts lack the column; zeros = the
                    # value every decision of that era actually had
                    columns[f] = (
                        block[f][row] if f in block
                        else np.zeros(len(variants), np.int32)
                    )
                cycles.append(RecordedCycle(
                    seq=int(doc.get("seq", 0) or 0),
                    ts=float(doc.get("ts", 0.0) or 0.0),
                    duration_ms=float(doc.get("duration_ms", 0.0) or 0.0),
                    interval_seconds=float(
                        doc.get("interval_seconds", 0.0) or 0.0
                    ),
                    optimization_ok=bool(doc.get("optimization_ok", True)),
                    errors=int(doc.get("errors", 0) or 0),
                    fingerprint=str(doc.get("fingerprint", "") or ""),
                    variants=[str(v) for v in variants],
                    columns=columns,
                    profile=(
                        doc["profile"]
                        if isinstance(doc.get("profile"), dict) else None
                    ),
                ))
    for w in warnings:
        (warn or log.warning)(w)
    return RecordedTrace(
        dir=directory,
        schema_version=schema_version,
        cycles=cycles,
        snapshots=snapshots,
        warnings=warnings,
    )
