"""HTTP front for the emulated engine.

The analogue of the upstream project's tools/vllm-emulator/server.py:21-126: an
OpenAI-compatible POST /v1/chat/completions plus GET /metrics in either
the vllm-tpu or jetstream exposition vocabulary, so a real Prometheus
(or the collector directly) can scrape it. Configured via constructor or
environment (MODEL_ID, DECODE_ALPHA/BETA, PREFILL_GAMMA/DELTA,
MAX_BATCH, ENGINE, PORT; DISAGG=true selects the prefill/decode-
separated replica unit with PREFILL_MAX_BATCH, DISAGG_PREFILL_ENGINES,
DISAGG_DECODE_ENGINES, KV_TRANSFER_MS). Over-length requests (KV
footprint beyond the engine's budget) get 400; timeouts/overload 503.

Port copy of `inferno_tpu/emulator/server.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from inferno_tpu_torch.config.defaults import env_bool, env_float, env_int, env_str
from inferno_tpu_torch.controller.engines import engine_for
from inferno_tpu_torch.emulator.engine import EmulatedEngine, EngineProfile


class EmulatorServer:
    def __init__(
        self,
        model_id: str = "emulated/model",
        profile: EngineProfile | None = None,
        engine_name: str = "vllm-tpu",
        port: int = 0,
        time_scale: float = 1.0,
        engine=None,
    ):
        """`engine` overrides the default aggregated EmulatedEngine with
        any object sharing its surface — e.g. emulator.disagg.DisaggEngine
        for a prefill/decode-separated (JetStream-style) replica unit."""
        self.model_id = model_id
        self.engine = engine or EmulatedEngine(
            profile or EngineProfile(), time_scale=time_scale
        )
        self.vocab = engine_for(engine_name)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path == "/metrics":
                    body = outer.render_metrics().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                elif self.path in ("/health", "/healthz"):
                    body = b"ok"
                    self.send_response(200)
                else:
                    body = b"not found"
                    self.send_response(404)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):  # noqa: N802
                if self.path != "/v1/chat/completions":
                    self.send_response(404)
                    self.end_headers()
                    return
                length = int(self.headers.get("Content-Length", "0"))
                try:
                    payload = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    self.send_response(400)
                    self.end_headers()
                    return
                messages = payload.get("messages", [])
                prompt = " ".join(str(m.get("content", "")) for m in messages)
                in_tokens = max(1, len(prompt.split()))
                out_tokens = int(payload.get("max_tokens", 64) or 64)
                result, rejected = outer.engine.generate_or_reject(
                    in_tokens, out_tokens
                )
                if rejected:
                    # over-length for the engine's KV budget: permanent,
                    # like a real engine's 400 — NOT a retryable 503
                    self.send_response(400)
                    self.end_headers()
                    return
                if result is None:
                    self.send_response(503)
                    self.end_headers()
                    return
                body = json.dumps(
                    {
                        "id": f"cmpl-{int(time.time()*1000)}",
                        "object": "chat.completion",
                        "model": outer.model_id,
                        "choices": [
                            {
                                "index": 0,
                                "message": {"role": "assistant", "content": "ok " * out_tokens},
                                "finish_reason": "stop",
                            }
                        ],
                        "usage": {
                            "prompt_tokens": result.in_tokens,
                            "completion_tokens": result.out_tokens,
                            "total_tokens": result.in_tokens + result.out_tokens,
                        },
                    }
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("", port), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        self.engine.start()
        self.thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.engine.stop()

    def render_metrics(self) -> str:
        return render_engine_metrics(self.engine, self.model_id, self.vocab)


def render_engine_metrics(e: EmulatedEngine, model_id: str, vocab) -> str:
    """Prometheus exposition for one engine in the given vocabulary
    (name-compatible with real servers, like the reference emulator's
    metrics.py). Shared by the HTTP server and MiniProm's in-process
    scrape targets."""
    v = vocab
    label = f'{{{v.model_label}="{model_id}"}}'
    now = time.time()
    window = [r for (t, r) in list(e.completions) if t >= now - 3600]
    lines = [
        f"# TYPE {v.num_requests_running} gauge",
        f"{v.num_requests_running}{label} {e.num_running}",
        f"# TYPE {v.request_success_total} counter",
        f"{v.request_success_total}{label} {len(e.completions)}",
        f"# TYPE {v.prompt_tokens_sum} counter",
        f"{v.prompt_tokens_sum}{label} {sum(r.in_tokens for r in window)}",
        f"{v.prompt_tokens_count}{label} {len(window)}",
        f"# TYPE {v.generation_tokens_sum} counter",
        f"{v.generation_tokens_sum}{label} {sum(r.out_tokens for r in window)}",
        f"{v.generation_tokens_count}{label} {len(window)}",
        f"# TYPE {v.ttft_seconds_sum} counter",
        f"{v.ttft_seconds_sum}{label} {sum(r.ttft_ms for r in window) / 1000.0}",
        f"{v.ttft_seconds_count}{label} {len(window)}",
        f"# TYPE {v.tpot_seconds_sum} counter",
        f"{v.tpot_seconds_sum}{label} "
        f"{sum((r.latency_ms - r.ttft_ms) / max(r.out_tokens - 1, 1) for r in window) / 1000.0}",
        f"{v.tpot_seconds_count}{label} {len(window)}",
    ]
    return "\n".join(lines) + "\n"


def main() -> None:
    engine = None
    if env_bool("DISAGG"):
        # disaggregated (JetStream-style) replica unit: separate prefill
        # and decode engine pools coupled by a KV-transfer delay
        from inferno_tpu_torch.emulator.disagg import DisaggEngine, DisaggProfile

        engine = DisaggEngine(DisaggProfile(
            alpha=env_float("DECODE_ALPHA", 20.0),
            beta=env_float("DECODE_BETA", 0.4),
            gamma=env_float("PREFILL_GAMMA", 5.0),
            delta=env_float("PREFILL_DELTA", 0.02),
            prefill_max_batch=env_int("PREFILL_MAX_BATCH", 8),
            decode_max_batch=env_int("MAX_BATCH", 64),
            prefill_engines=env_int("DISAGG_PREFILL_ENGINES", 1),
            decode_engines=env_int("DISAGG_DECODE_ENGINES", 1),
            kv_transfer_ms=env_float("KV_TRANSFER_MS", 2.0),
        ))
    profile = EngineProfile(
        alpha=env_float("DECODE_ALPHA", 20.0),
        beta=env_float("DECODE_BETA", 0.4),
        gamma=env_float("PREFILL_GAMMA", 5.0),
        delta=env_float("PREFILL_DELTA", 0.02),
        max_batch=env_int("MAX_BATCH", 64),
    )
    server = EmulatorServer(
        model_id=env_str("MODEL_ID", "emulated/model"),
        profile=profile,
        engine_name=env_str("ENGINE", "vllm-tpu"),
        port=env_int("PORT", 8000),
        engine=engine,
    )
    server.start()
    print(f"emulator serving {server.model_id} on :{server.port}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
