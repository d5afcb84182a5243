"""device_idle_pct.serve: the share of the traced slice (the harness's
``bench.window`` range) in which no kernel, copy or fill ran on the
card, in percent.  Moves ``serve_ttft_p90_ms``."""


def read(record):
    trace = record.get("trace")
    if trace is None:
        return None
    lo, hi = trace.window()
    return 100.0 * (1.0 - trace.busy_s(lo, hi) / (hi - lo))
