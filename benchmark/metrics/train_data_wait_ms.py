"""train_data_wait_ms: mean milliseconds a window step waited in
``next()`` on ``iter_batches(device_put=True)`` (the input plane,
``ray_tpu_torch/data/dataset.py``), timed by the harness around each
call.  Moves ``train_tokens_per_s``."""


def read(record):
    waits = record.get("data_wait_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
