"""train_step_mfu: model FLOPs of the window's train steps over the
window and the H100's bf16 peak, in percent (``arith.train_step_flops``:
6 FLOP a token for each matmul parameter and the head, causal attention
at 3 x its forward; nothing remat recomputes).  The whole step's share
of the peak, under which every kernel's roofline sits.  Moves
``train_tokens_per_s``."""

from benchmark import arith


def read(record):
    if not record.get("steps") or not record.get("window_s"):
        return None
    flops = arith.train_step_flops(record["cfg"], record["batch"],
                                   record["seq"]) * record["steps"]
    return 100.0 * flops / (record["window_s"] * arith.PEAK_BF16_FLOPS)
