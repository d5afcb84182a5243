"""flash_roofline_pct: the flash kernels' share of their roofline in the
traced slice, in percent: the least time of every causal forward (B1,
``flash_fwd_kernel``) and backward (B2 + B3, ``flash_bwd_dq_kernel`` and
``flash_bwd_dkdv_kernel``) the trace holds, at 989 TFLOP/s or 3.35 TB/s
(``arith.flash_need_ms``), over those kernels' device time.  Moves
``train_tokens_per_s``."""

from benchmark import arith

FWD, DQ, DKDV = "flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel"


def read(record):
    trace = record.get("trace")
    if trace is None:
        return None
    n = {FWD: 0, DQ: 0, DKDV: 0}
    busy = 0.0
    for name, s, e, _c in trace.ops:
        for k in n:
            if k in name:
                n[k] += 1
                busy += e - s
    if not busy:
        return None
    cfg = record["cfg"]
    need = arith.flash_need_ms(record["batch"], cfg["n_heads"],
                               cfg["n_kv_heads"], record["seq"],
                               cfg["head_dim"])
    # A backward is both its kernels; one without its pair in the slice
    # is left out of the least time (its time stays in: the share can
    # only read low).
    least_ms = n[FWD] * need["fwd"] + min(n[DQ], n[DKDV]) * need["bwd"]
    return 100.0 * least_ms * 1e-3 / busy
