"""tests/test_miniprom.py's cases on the port's MiniProm — socketless,
via callable scrape targets and direct `evaluate()` calls: windowed
counter-reset-safe rates, ratio-of-rates, label matching, target
relabeling precedence, and failed-scrape isolation.
"""

import time

from inferno_tpu_torch.emulator.miniprom import MiniProm, _parse_vector_selector


def mk(prom_targets):
    """MiniProm with manual scraping (no threads, no sockets)."""
    return MiniProm(prom_targets, scrape_interval=999.0, window_seconds=60.0)


def expo(lines):
    return "\n".join(lines) + "\n"


def result_values(resp):
    return [float(r["value"][1]) for r in resp["data"]["result"]]


# -- selector parsing --------------------------------------------------------


def test_vector_selector_parsing():
    assert _parse_vector_selector("up") == ("up", {})
    name, m = _parse_vector_selector('vllm:num_requests_running{model_name="m",namespace="ns"}')
    assert name == "vllm:num_requests_running"
    assert m == {"model_name": "m", "namespace": "ns"}


# -- instant vectors ---------------------------------------------------------


def test_instant_vector_latest_sample_and_label_filter():
    counters = {"v": 3.0}
    prom = mk([lambda: expo([f'metric{{pod="a"}} {counters["v"]}',
                             'metric{pod="b"} 7'])])
    prom.scrape_once()
    counters["v"] = 4.0
    prom.scrape_once()

    resp = prom.evaluate('metric{pod="a"}')
    assert result_values(resp) == [4.0]  # latest, not first
    resp = prom.evaluate("metric")
    assert sorted(result_values(resp)) == [4.0, 7.0]
    assert prom.evaluate('metric{pod="zzz"}')["data"]["result"] == []
    assert prom.evaluate("other_metric")["data"]["result"] == []


def test_target_relabeling_precedence():
    """Target labels attach to every series, but series-native labels win
    (the ServiceMonitor relabeling convention)."""
    t = (lambda: expo(['m{namespace="native"} 1', "plain 2"]),
         {"namespace": "attached"})
    prom = mk([t])
    prom.scrape_once()
    assert result_values(prom.evaluate('m{namespace="native"}')) == [1.0]
    assert prom.evaluate('m{namespace="attached"}')["data"]["result"] == []
    assert result_values(prom.evaluate('plain{namespace="attached"}')) == [2.0]


# -- rates -------------------------------------------------------------------


def test_rate_is_positive_deltas_over_covered_time():
    counters = {"v": 0.0}
    prom = mk([lambda: expo([f'c_total{{m="x"}} {counters["v"]}'])])
    t0 = time.time()
    prom.scrape_once()
    counters["v"] = 30.0
    time.sleep(0.05)
    prom.scrape_once()
    resp = prom.evaluate('sum(rate(c_total{m="x"}[1m]))')
    (val,) = result_values(resp)
    elapsed = time.time() - t0
    # 30 increments over ~0.05s: rate should be near 30/elapsed, definitely
    # hundreds per second
    assert val > 30.0 / (elapsed * 4)


def test_rate_counter_reset_safe():
    """An engine restart drops the counter to 0; negative deltas must be
    clamped, not subtracted (miniprom._rate)."""
    counters = {"v": 100.0}
    prom = mk([lambda: expo([f"c_total {counters['v']}"])])
    prom.scrape_once()
    counters["v"] = 0.0  # reset
    time.sleep(0.02)
    prom.scrape_once()
    counters["v"] = 10.0
    time.sleep(0.02)
    prom.scrape_once()
    (val,) = result_values(prom.evaluate("sum(rate(c_total[1m]))"))
    assert val >= 0.0
    # only the +10 after the reset counts
    assert val * 0.04 < 100.0


def test_rate_needs_two_points():
    prom = mk([lambda: expo(["c_total 5"])])
    prom.scrape_once()
    resp = prom.evaluate("sum(rate(c_total[1m]))")
    assert result_values(resp) == [0.0]


def test_rate_unknown_series_is_empty_vector():
    prom = mk([lambda: expo(["c_total 5"])])
    prom.scrape_once()
    assert prom.evaluate("sum(rate(nope_total[1m]))")["data"]["result"] == []


def test_ratio_of_rates():
    counters = {"sum": 0.0, "count": 0.0}
    prom = mk([lambda: expo([f"s_total {counters['sum']}",
                             f"n_total {counters['count']}"])])
    prom.scrape_once()
    counters["sum"] = 1280.0
    counters["count"] = 10.0
    time.sleep(0.02)
    prom.scrape_once()
    (val,) = result_values(
        prom.evaluate("sum(rate(s_total[1m]))/sum(rate(n_total[1m]))")
    )
    assert val == 128.0  # avg tokens per request, elapsed cancels


def test_ratio_zero_denominator_reads_zero():
    counters = {"sum": 0.0}
    prom = mk([lambda: expo([f"s_total {counters['sum']}", "n_total 0"])])
    prom.scrape_once()
    counters["sum"] = 100.0
    time.sleep(0.02)
    prom.scrape_once()
    (val,) = result_values(
        prom.evaluate("sum(rate(s_total[1m]))/sum(rate(n_total[1m]))")
    )
    assert val == 0.0


def test_rate_sums_across_pods():
    c = {"a": 0.0, "b": 0.0}
    prom = mk([
        lambda: expo([f'r_total{{pod="a"}} {c["a"]}']),
        lambda: expo([f'r_total{{pod="b"}} {c["b"]}']),
    ])
    prom.scrape_once()
    c["a"], c["b"] = 6.0, 4.0
    time.sleep(0.05)
    prom.scrape_once()
    (combined,) = result_values(prom.evaluate("sum(rate(r_total[1m]))"))
    (only_a,) = result_values(prom.evaluate('sum(rate(r_total{pod="a"}[1m]))'))
    assert combined > only_a > 0.0
    assert abs(combined / only_a - 10.0 / 6.0) < 0.2


# -- scrape robustness -------------------------------------------------------


def test_failing_target_does_not_poison_others():
    def bad():
        raise RuntimeError("engine crashed")

    prom = mk([bad, lambda: expo(["good 1"])])
    prom.scrape_once()  # must not raise
    assert result_values(prom.evaluate("good")) == [1.0]


def test_up_lists_targets():
    prom = mk([lambda: expo(["x 1"]), ("http://127.0.0.1:1/metrics", {})])
    resp = prom.evaluate("up")
    assert len(resp["data"]["result"]) == 2
    assert all(r["value"][1] == "1" for r in resp["data"]["result"])


def test_max_by_groups_and_takes_max():
    """The prometheus-adapter sample rules' metricsQuery shape: max()
    over duplicate series (two controller replicas during a leader
    transition), grouped by the adapter's override labels."""
    prom = mk([lambda: expo([
        'inferno_desired_replicas{variant_name="a",namespace="ns",pod="p1"} 3',
        'inferno_desired_replicas{variant_name="a",namespace="ns",pod="p2"} 5',
        'inferno_desired_replicas{variant_name="b",namespace="ns",pod="p1"} 2',
    ])])
    prom.scrape_once()
    resp = prom.evaluate(
        'max(inferno_desired_replicas{namespace="ns"}) '
        'by (variant_name, namespace)')
    rows = {r["metric"]["variant_name"]: float(r["value"][1])
            for r in resp["data"]["result"]}
    assert rows == {"a": 5.0, "b": 2.0}
    assert all(set(r["metric"]) == {"variant_name", "namespace"}
               for r in resp["data"]["result"])
    # selector narrows before grouping
    resp = prom.evaluate(
        'max(inferno_desired_replicas{variant_name="b",namespace="ns"}) '
        'by (variant_name, namespace)')
    assert result_values(resp) == [2.0]


def test_in_process_client_round_trip():
    prom = mk([lambda: expo(['m{a="1"} 2.5'])])
    prom.scrape_once()
    client = prom.client()
    assert client.healthy()
    samples = client.query('m{a="1"}')
    assert len(samples) == 1
    assert samples[0].value == 2.5
    assert samples[0].labels.get("a") == "1"
