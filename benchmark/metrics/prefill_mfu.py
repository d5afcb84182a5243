"""prefill_mfu: model FLOPs of the real prompt tokens prefilled in the
traced slice (``arith.prefill_flops``) over the device time of the
kernels launched inside the engine's prefill calls
(``serve/llm.py`` ``_launch_prefill_group``, wrapped by the harness in
``bench.prefill#<n>`` ranges) and the bf16 peak, in percent.  Padding
to the prefill bucket counts as time and not as work.  Moves
``serve_ttft_p90_ms``."""

from benchmark import arith


def read(record):
    trace = record.get("trace")
    groups = record.get("prefills") or {}
    if trace is None or not groups:
        return None
    lo, hi = trace.window()
    flops = busy = 0.0
    for name, ops in trace.by_range("bench.prefill#").items():
        span = trace.range_span(name)
        # A call that began in the slice; the capture runs on past the
        # slice for longer than a call's work takes on the card.
        if name not in groups or not ops or span is None \
                or not lo <= span[0] <= hi:
            continue
        flops += sum(arith.prefill_flops(record["cfg"], p)
                     for p in groups[name])
        busy += sum(e - s for _n, s, e, _c in ops)
    if not busy:
        return None
    return 100.0 * flops / (busy * arith.PEAK_BF16_FLOPS)
