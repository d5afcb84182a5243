"""decode_roofline_pct: the decode chunks' share of their roofline in
the traced slice, in percent.  For each chunk the engine launched there
(``serve/llm.py`` ``_launch_chunk`` -> ``_decode_paged``, wrapped by the
harness in ``bench.chunk#<n>`` ranges): the least time of the steps the
requests needed (each step: the weights and the K/V each request attends
read once, its new row written once, at 3.35 TB/s, or its FLOPs at the
bf16 peak if that is longer), over the span on the device timeline from
the chunk's first operation to its last.  Moves ``serve_tpot_p90_ms``."""

from benchmark import arith


def needed_contexts(slots, k):
    """Per step of a chunk of ``k``, the cached positions each request
    that needed that step attends: a slot entry is (len0, prompt len,
    tokens finally served); the step writing position len0 + j is needed
    while that position is at most prompt + served - 2."""
    steps = []
    for j in range(k):
        steps.append([len0 + j for len0, p, n in slots
                      if len0 + j <= p + n - 2])
    return steps


def read(record):
    trace = record.get("trace")
    chunks = record.get("chunks") or {}
    if trace is None or not chunks:
        return None
    cfg = record["cfg"]
    lo, hi = trace.window()
    least = span_total = 0.0
    for name, ops in trace.by_range("bench.chunk#").items():
        span = trace.range_span(name)
        # A call that began in the slice; the capture runs on past the
        # slice for longer than a call's work takes on the card.
        if name not in chunks or not ops or span is None \
                or not lo <= span[0] <= hi:
            continue
        k, slots = chunks[name]
        for ctx in needed_contexts(slots, k):
            if ctx:
                least += max(
                    arith.decode_step_bytes(cfg, ctx) / arith.PEAK_HBM_BYTES_S,
                    arith.decode_step_flops(cfg, ctx) / arith.PEAK_BF16_FLOPS)
        span_total += max(e for _n, _s, e, _c in ops) - min(
            s for _n, s, _e, _c in ops)
    if not span_total:
        return None
    return 100.0 * least / span_total
