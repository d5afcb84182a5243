"""device_idle_pct.train: the share of the traced slice (between the
train driver's two marker kernels on the card's timeline) in which no
kernel, copy or fill ran on the card, in percent.  Moves
``train_tokens_per_s``."""


def read(record):
    trace = record.get("trace")
    if trace is None:
        return None
    lo, hi = trace.window()
    return 100.0 * (1.0 - trace.busy_s(lo, hi) / (hi - lo))
