"""The generator, the open-loop timing and the tails."""

import json
import math
from collections import Counter
from pathlib import Path

import pytest

from benchmark import stats, traffic
from benchmark.drivers import serve

MIX = json.loads((Path(__file__).resolve().parent.parent / "traffic"
                  / "rag.json").read_text())
BIG_SEED = 2 ** 31 + 12345


def test_same_seed_same_stream_other_seed_other_stream():
    a = traffic.serve_stream(MIX, BIG_SEED, 30, 32768)
    b = traffic.serve_stream(MIX, BIG_SEED, 30, 32768)
    c = traffic.serve_stream(MIX, BIG_SEED + 1, 30, 32768)
    assert [(r.due_s, r.prompt, r.max_new_tokens) for r in a] == \
        [(r.due_s, r.prompt, r.max_new_tokens) for r in b]
    assert [r.prompt for r in a] != [r.prompt for r in c]
    rows = traffic.train_rows(BIG_SEED, 3, 64, 92544)
    assert (rows == traffic.train_rows(BIG_SEED, 3, 64, 92544)).all()
    assert not (rows == traffic.train_rows(7, 3, 64, 92544)).all()
    assert len({tuple(r) for r in rows}) == 3


def test_every_seed_gets_the_same_schedule_with_its_own_tokens():
    n = round(MIX["arrivals"]["rate_per_s"] * 30)
    lens = Counter(traffic.quantiles(MIX["prompt_tokens"], n))
    outs = Counter(traffic.quantiles(MIX["output_tokens"], n))
    schedules, prompts = set(), set()
    for seed in (1, 2, BIG_SEED):
        full = traffic.serve_stream(MIX, seed, 30, 32768)
        assert len(full) == n  # every arrival falls inside the window
        assert Counter(len(r.prompt) for r in full) == lens
        assert Counter(r.max_new_tokens for r in full) == outs
        schedules.add(tuple((r.due_s, len(r.prompt), r.max_new_tokens)
                            for r in full))
        prompts.add(tuple(full[0].prompt))
    assert len(schedules) == 1 and len(prompts) == 3
    other = dict(MIX, order_seed=MIX["order_seed"] + 1)
    assert tuple((r.due_s, len(r.prompt), r.max_new_tokens) for r in
                 traffic.serve_stream(other, 1, 30, 32768)) not in schedules


def test_lengths_follow_the_mix_distribution_and_clips():
    d = MIX["prompt_tokens"]
    q = traffic.quantiles(d, 1000)
    assert min(q) >= d["min"] and max(q) <= d["max"]
    assert sorted(q)[500] == pytest.approx(d["median"], rel=0.01)
    # A lognormal's quartiles sit at median * exp(+-0.6745 sigma).
    assert sorted(q)[250] == pytest.approx(
        d["median"] * math.exp(-0.6745 * d["sigma"]), rel=0.01)
    o = MIX["output_tokens"]
    assert max(traffic.quantiles(o, 1000)) == o["max"]
    # Prompt and answer always fit the engine's horizon (max_len - 1).
    assert d["max"] + o["max"] <= MIX["engine"]["max_len"] - 1


def test_gaps_are_exponential_at_the_rate():
    g = traffic.gaps({"kind": "poisson", "rate_per_s": 4.0}, 4000)
    assert sum(g) / len(g) == pytest.approx(0.25, rel=0.01)
    reqs = traffic.serve_stream(MIX, 3, 40, 32768)
    assert reqs[0].due_s == 0.0
    assert all(a.due_s <= b.due_s for a, b in zip(reqs, reqs[1:]))
    assert all(r.due_s < 40 for r in reqs)


def test_times_run_from_the_due_time_and_failures_count_as_missing():
    reqs = [traffic.Request(float(i), [5] * 4, 3) for i in range(10)]
    t_open = 100.0
    results = []
    for r in reqs:
        # Each sent 0.5 s late, first token 1 s after the send, done 2 s
        # later; request 9 failed.
        first = t_open + r.due_s + 1.5
        results.append({"first": first, "done": first + 2.0,
                        "tokens": [1, 2, 3]})
    results[9] = {"error": "boom"}
    s = serve.summarize(reqs, results, t_open, 10.0, 5.0)
    assert s["failed"] == 1
    assert s["ttft"][:9] == [1.5] * 9 and s["ttft"][9] is None
    # p90 of ten requests is the 9th smallest: a sound one.
    assert s["serve_ttft_p90_ms"] == pytest.approx(1500.0)
    assert s["serve_tpot_p90_ms"] == pytest.approx(1000.0)
    # Only requests done inside the window count towards the rate.
    done_in = sum(1 for r in reqs[:9] if t_open + r.due_s + 3.5 <= 110.0)
    assert s["serve_output_tokens_per_s"] == pytest.approx(
        3 * done_in / 10.0)
    results[8] = None  # never finished
    s = serve.summarize(reqs, results, t_open, 10.0, 5.0)
    assert s["serve_ttft_p90_ms"] == pytest.approx(15_000.0)


def test_nearest_rank_and_union():
    xs = list(range(1, 101))
    assert stats.nearest_rank(xs, 0.9) == 90
    assert stats.tail([1.0, None, 2.0], 1.0, missing=99.0) == 99.0
    assert stats.union_length([(0, 2), (1, 3), (5, 6)], 0, 10) == 4
    assert stats.union_length([(0, 2), (1, 3), (5, 6)], 1.5, 5.5) == 2.0


def test_backlog_trend_and_the_knee_rule():
    from benchmark import sweep

    reqs = [traffic.Request(float(i), [5], 3) for i in range(30)]
    steady = [2.0] * 30
    assert sweep.backlog_trend(reqs, steady, 30.0) == pytest.approx(1.0)
    # A queue that grows by a second a request doubles late over middle.
    growing = [1.0 + i for i in range(30)]
    assert sweep.backlog_trend(reqs, growing, 30.0) == pytest.approx(
        25.5 / 15.5)
    # The first third (an empty engine) is left out.
    assert sweep.backlog_trend(reqs, [0.1] * 10 + [2.0] * 20,
                               30.0) == pytest.approx(1.0)
    lines = [{"rate_per_s": 0.5, "failed": 0, "backlog_trend": 1.1},
             {"rate_per_s": 0.7, "failed": 0, "backlog_trend": 1.4},
             {"rate_per_s": 0.9, "failed": 0, "backlog_trend": 2.3},
             {"rate_per_s": 1.1, "failed": 0, "backlog_trend": 1.2}]
    assert sweep.knee(lines) == 0.7
    lines[1]["failed"] = 1
    assert sweep.knee(lines) == 0.5
