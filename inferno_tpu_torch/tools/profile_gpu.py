"""Profile real transformer compute on the local GPU.

Produces the raw measurements behind the H100 performance profiles
(profiles/h100/*.json): decode step time per layer-stack depth (-> ITL =
alpha + beta*batch), the shared continuous-batching iteration (-> TTFT =
gamma + delta*in_tokens*batch) and prefill time, measured at a preset's
full width (Llama-3.1-8B by default) on the CUDA card.

The port's counterpart of `tools/profile_tpu.py`: the same sweep axes and
defaults, the same `--resume` refusals, the same per-depth structure and
the same raw schema (`meta`, `decode`, `prefill`, `mixed`), so that
`inferno_tpu_torch.models.profiles` fits its output unchanged.

Methodology (mirrors the reference's guidellm procedure,
upstream docs/tutorials/parameter-estimation.md:127-266, but measures
the model directly instead of a serving endpoint):

1. Build an L-layer decoder stack (inferno_tpu_torch.models.llama_block or
   gemma_block) for L in --layer-depths and verify that time is linear in
   L; the full-model profile is synthesized from the per-depth
   least-squares fit in inferno_tpu_torch.models.profiles.
2. Decode: one single-token step captured in a CUDA graph (the position
   and the accumulator are device tensors the step advances) and replayed
   N times between two CUDA events, swept over batch sizes at a fixed KV
   context: per-step dispatch never enters the inter-token latency.
3. Mixed: one continuous-batching iteration (B decode rows + one T-token
   chunk), captured and replayed the same way.
4. Prefill: one causal forward captured and replayed R times, each
   iteration's input perturbed by the previous one's output.

Timing: CUDA events around the replays, after one warm sequence; the
median over --iters, divided by the inner count. There is no tunnel round
trip to subtract. `--device cpu` runs the same sweep eagerly on the host
clock for the tests; it measures nothing about the card.

int8 weights (`--weight-dtype int8`) are cast to bf16 before each product
in torch eager, so the bytes a step moves exceed a bf16 step's; the raw
records `"int8_dequant": "eager"` and no profile document is built from it.

Writes one JSON file with every sample plus environment metadata. Run:
    python -m inferno_tpu_torch.tools.profile_gpu --model llama-3.1-8b
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import platform
import statistics
import subprocess
import time
from pathlib import Path

import torch

from inferno_tpu_torch.models import gemma_block, llama_block
from inferno_tpu_torch.models.llama_block import resolve_device
from inferno_tpu_torch.models.profiles import PROFILES_DIR

# Every preset across the measurable families; the layer-body module is
# resolved per model, because a profile measured on the wrong block is a
# wrong profile (Gemma-2's sandwich norms / softcaps / sliding window
# are not Llama's layer — llama_block.MODEL_PRESETS note).
ALL_PRESETS = {**llama_block.MODEL_PRESETS, **gemma_block.GEMMA_PRESETS}

GPU_RAW_DIR = PROFILES_DIR / "h100" / "raw"


def family_for(model: str):
    """The block module whose architecture `model` actually is —
    membership in the family's own preset dict, NOT a name prefix."""
    return gemma_block if model in gemma_block.GEMMA_PRESETS else llama_block


DECODE_BATCHES = [1, 2, 4, 8, 16, 24, 32, 48, 64, 96, 128]
PREFILL_BATCHES = [1, 2, 4]
PREFILL_TOKENS = [128, 256, 512, 1024, 2048]
MIXED_BATCHES = [1, 8, 16, 32, 48]
MIXED_TOKENS = [128, 512, 1024]
LAYER_DEPTHS = [2, 4, 8]


def default_out(model: str, weight_dtype: str) -> Path:
    suffix = "" if weight_dtype == "bfloat16" else f"_{weight_dtype}"
    return GPU_RAW_DIR / f"{model}_h100{suffix}.json"


def replayable(step, device: torch.device):
    """`step` (in place on device state) as a zero-argument callable: on
    the card one CUDA graph of it, captured after a warm-up step on a side
    stream (the warm-up advances the state: reset it before replaying);
    on the CPU the step itself."""
    if device.type != "cuda":
        return step
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    return graph.replay


def timed_ms(step, reset, iters: int, inner: int, device: torch.device) -> float:
    """Median over `iters` of one sequence of `inner` steps, msec per step:
    on the card `inner` replays of the step's CUDA graph between two CUDA
    events, after `reset()` restores the state; one warm sequence is
    dropped. On the CPU (tests only) the steps run eagerly on the host
    clock."""
    reset()
    run = replayable(step, device)
    ts = []
    for _ in range(iters + 1):
        reset()
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                run()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        else:
            # a measuring tool: the host clock is what it measures off the card
            t0 = time.perf_counter()  # noqa: INF005
            for _ in range(inner):
                run()
            ts.append((time.perf_counter() - t0) * 1000.0)  # noqa: INF005
    return statistics.median(ts[1:]) / inner


def _zeros_caches(dims, n_layers, b, s_max, device):
    return [torch.zeros((b, dims.n_kv_heads, s_max, dims.head_dim),
                        dtype=torch.bfloat16, device=device)
            for _ in range(2 * n_layers)]


def _release(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()


def profile_depth(blk, dims, n_layers, args, decode_out, prefill_out, mixed_out,
                  checkpoint, done, device):
    """Every configuration of one layer depth not in `done`, appended to
    the three sample lists (`checkpoint()` after each)."""
    has_mixed = getattr(blk, "make_mixed_fn", None) is not None
    needed = [("decode", n_layers, b, args.context) for b in args.decode_batches] + [
        ("prefill", n_layers, b, t)
        for b in args.prefill_batches for t in args.prefill_tokens
    ] + ([
        ("mixed", n_layers, b, t, args.context)
        for b in args.mixed_batches for t in args.mixed_tokens
    ] if has_mixed else [])
    if all(k in done for k in needed):
        print(f"depth L={n_layers}: fully measured, skipping init", flush=True)
        return
    gen = torch.Generator(device=device).manual_seed(n_layers)
    params = blk.init_stack(gen, dims, n_layers, args.weight_dtype, device=device)
    bf = torch.bfloat16

    steps = args.decode_steps
    decode = blk.make_decode_fn(dims, n_layers, steps)
    for b in args.decode_batches:
        if ("decode", n_layers, b, args.context) in done:
            continue
        s_max = args.context + steps
        cache_gb = (
            n_layers * 2 * b * s_max * dims.kv_dim * 2 / 2**30
        )
        if cache_gb > args.max_cache_gb:
            print(f"decode  L={n_layers:2d} B={b:3d}: skipped (KV cache {cache_gb:.1f} GiB)")
            continue
        caches = _zeros_caches(dims, n_layers, b, s_max, device)
        x = torch.zeros((b, 1, dims.hidden), dtype=bf, device=device)
        pos = torch.zeros((), dtype=torch.int64, device=device)
        acc = torch.zeros((), dtype=torch.float32, device=device)

        def reset():
            x.zero_()
            pos.fill_(args.context)
            acc.zero_()

        ms = timed_ms(lambda: decode.step(params, x, caches, pos, acc), reset,
                      args.iters, steps, device)
        decode_out.append(
            {"n_layers": n_layers, "batch": b, "context": args.context, "step_ms": ms}
        )
        print(f"decode  L={n_layers:2d} B={b:3d} ctx={args.context}: {ms:8.3f} ms/step", flush=True)
        checkpoint()
        del caches
        _release(device)

    if not has_mixed:
        print(f"mixed   L={n_layers:2d}: family has no mixed kernel; "
              "TTFT calibration will use the pessimistic bound", flush=True)
    else:
        msteps = max(4, args.decode_steps // 8)
        mixed = blk.make_mixed_fn(dims, n_layers, msteps)
        for b in args.mixed_batches:
            for t in args.mixed_tokens:
                if ("mixed", n_layers, b, t, args.context) in done:
                    continue
                s_max = args.context + msteps
                caches = _zeros_caches(dims, n_layers, b, s_max, device)
                x = torch.zeros((b, 1, dims.hidden), dtype=bf, device=device)
                chunk = torch.ones((t, dims.hidden), dtype=bf, device=device) * 0.01
                pos = torch.zeros((), dtype=torch.int64, device=device)
                acc = torch.zeros((), dtype=torch.float32, device=device)

                def reset():
                    x.zero_()
                    pos.fill_(args.context)
                    acc.zero_()

                ms = timed_ms(lambda: mixed.step(params, x, caches, chunk, pos, acc),
                              reset, args.iters, msteps, device)
                mixed_out.append(
                    {"n_layers": n_layers, "batch": b, "in_tokens": t,
                     "context": args.context, "step_ms": ms}
                )
                print(f"mixed   L={n_layers:2d} B={b:3d} T={t:5d}: {ms:8.3f} ms/step", flush=True)
                checkpoint()
                del caches
                _release(device)

    for b in args.prefill_batches:
        for t in args.prefill_tokens:
            if ("prefill", n_layers, b, t) in done:
                continue
            # the repeat count, quantized to powers of 4, from a rough
            # estimate of a prefill's time (it sizes the count only)
            est = 0.35 * n_layers * b * t / 512
            reps = 1
            while reps < 64 and est * reps < args.target_ms:
                reps *= 4
            prefill = blk.make_prefill_repeat_fn(dims, reps)
            x = torch.ones((b, t, dims.hidden), dtype=bf, device=device) * 0.01
            acc = torch.zeros((), dtype=torch.float32, device=device)
            ms = timed_ms(lambda: prefill.step(params, x, acc), acc.zero_,
                          args.iters, reps, device)
            prefill_out.append(
                {"n_layers": n_layers, "batch": b, "in_tokens": t, "reps": reps, "prefill_ms": ms}
            )
            print(f"prefill L={n_layers:2d} B={b:3d} T={t:5d} (x{reps}): {ms:8.3f} ms", flush=True)
            checkpoint()
            _release(device)
    del params
    _release(device)


def device_meta(device: torch.device) -> dict:
    """What the raw records of the device it was measured on."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": platform.processor() or platform.machine()}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    props = torch.cuda.get_device_properties(device)
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(device),
        "power_limit": smi[device.index or 0].strip(),
        "total_memory_gb": round(props.total_memory / 2**30, 2),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="",
                    help="output JSON; default profiles/h100/raw/<model>_h100[_<dtype>].json")
    ap.add_argument("--model", choices=sorted(ALL_PRESETS), default="llama-3.1-8b")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (cpu: tests only)")
    ap.add_argument("--iters", type=int, default=7)
    ap.add_argument("--weight-dtype", choices=["bfloat16", "int8"], default="bfloat16")
    ap.add_argument("--decode-steps", type=int, default=64)
    ap.add_argument("--context", type=int, default=1024)
    ap.add_argument("--target-ms", type=float, default=250.0)
    ap.add_argument("--max-cache-gb", type=float, default=6.0)
    ap.add_argument("--layer-depths", type=int, nargs="+", default=LAYER_DEPTHS)
    ap.add_argument("--decode-batches", type=int, nargs="+", default=DECODE_BATCHES)
    ap.add_argument("--prefill-batches", type=int, nargs="+", default=PREFILL_BATCHES)
    ap.add_argument("--prefill-tokens", type=int, nargs="+", default=PREFILL_TOKENS)
    ap.add_argument("--mixed-batches", type=int, nargs="+", default=MIXED_BATCHES)
    ap.add_argument("--mixed-tokens", type=int, nargs="+", default=MIXED_TOKENS)
    ap.add_argument("--resume", action="store_true",
                    help="skip configs already present in --out (crash recovery)")
    return ap


def main(argv: list[str] | None = None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)

    dims = ALL_PRESETS[args.model]
    blk = family_for(args.model)
    out = Path(args.out) if args.out else default_out(args.model, args.weight_dtype)
    out.parent.mkdir(parents=True, exist_ok=True)
    decode_out, prefill_out, mixed_out = [], [], []
    done: set = set()
    prev_meta: dict = {}
    if args.resume and out.exists():
        # validate the resume target BEFORE touching the device: a
        # cross-model/dtype mismatch must fail fast
        prev = json.loads(out.read_text())
        prev_meta = prev.get("meta") or {}
        for key, want in (("model", args.model), ("weight_dtype", args.weight_dtype)):
            have = prev_meta.get(key)
            if have and have != want:
                raise SystemExit(
                    f"refusing --resume: {out} holds {key}={have!r} "
                    f"measurements, not {want!r} — mixed timings in one raw "
                    "file would silently corrupt the downstream fits"
                )
        decode_out = list(prev.get("decode", []))
        prefill_out = list(prev.get("prefill", []))
        mixed_out = list(prev.get("mixed", []))
        done = {
            ("decode", s["n_layers"], s["batch"], s.get("context", args.context))
            for s in decode_out
        } | {
            ("prefill", s["n_layers"], s["batch"], s["in_tokens"]) for s in prefill_out
        } | {
            ("mixed", s["n_layers"], s["batch"], s["in_tokens"], s.get("context", args.context))
            for s in mixed_out
        }
        print(f"resuming: {len(done)} configs already measured", flush=True)

    device = resolve_device(args.device)
    if device.type == "cuda":
        # the products accumulate in float32, as the reference's
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # full dims record (family-specific fields included) so downstream
    # fits reconstruct the EXACT dataclass the sweep was measured with
    # (models/profiles.dims_from_meta)
    dims_meta = dataclasses.asdict(dims)
    dims_meta["n_layers_full"] = dims_meta.pop("n_layers")
    meta = {
        "model": args.model,
        "dims": dims_meta,
        "device": device_meta(device),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "dtype": "bfloat16",
        "weight_dtype": args.weight_dtype,
        "decode_context": args.context,
        "decode_steps_per_call": args.decode_steps,
        "iters": args.iters,
        "timing": "cuda-events" if device.type == "cuda" else "host-clock",
        "max_cache_gb": args.max_cache_gb,
        "captured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    if args.weight_dtype == "int8":
        meta["int8_dequant"] = "eager"
    print(f"profiling on {meta['device']['kind']} ({meta['device']['platform']}, "
          f"{meta['device'].get('power_limit', 'no power limit')})", flush=True)
    meta = {**prev_meta, **meta}

    t0 = time.time()  # noqa: INF005 (the sweep's wall time, recorded in its meta)

    def checkpoint() -> None:
        # write-through after every sample: a crash loses at most the
        # in-flight config, and --resume picks up from here
        out.write_text(
            json.dumps({"meta": meta, "decode": decode_out,
                        "prefill": prefill_out, "mixed": mixed_out}, indent=1)
        )

    for n_layers in args.layer_depths:
        profile_depth(blk, dims, n_layers, args, decode_out, prefill_out, mixed_out,
                      checkpoint, done, device)
    wall_s = time.time() - t0  # noqa: INF005 (as above)
    meta["wall_clock_s"] = round(wall_s, 1) + (meta.get("wall_clock_s") or 0)
    checkpoint()
    print(f"wrote {out} ({len(decode_out)} decode + {len(prefill_out)} prefill + "
          f"{len(mixed_out)} mixed samples, {meta['wall_clock_s']}s)", flush=True)


if __name__ == "__main__":
    main()
