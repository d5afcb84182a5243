"""The reference's judgement of served tokens: one full forward of the
plain model over each prompt followed by the tokens served for it, and
at each served position the gap by which the served token's logit lies
below the reference's best there.  Under greedy decoding a correct
engine serves the best token up to rounding, so its widest gap is small.

``control_gaps`` reads the same positions for the control: the token
that the float8 reference ranks first, judged by the float32 one.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from . import model


@torch.no_grad()
def served_logits(params: Dict, prompt: Sequence[int],
                  served: Sequence[int], cfg: Dict, device,
                  fp8: bool = False) -> torch.Tensor:
    """Logits (n, V) at the n positions that predicted the served tokens:
    the prompt's last position and each served token's but the last."""
    model.set_precision()
    seq = list(prompt) + list(served[:-1])
    tokens = torch.tensor([seq], dtype=torch.long, device=device)
    h = model.hidden(params, tokens, cfg, fp8=fp8)
    return model.logits(params, h[0, len(prompt) - 1:], fp8=fp8)


def served_gap(params: Dict, prompt, served, cfg: Dict, device) -> float:
    """The widest gap of one request's served tokens."""
    lg = served_logits(params, prompt, served, cfg, device)
    idx = torch.tensor(served, device=device)[:, None]
    return float((lg.max(-1).values - lg.gather(-1, idx)[:, 0]).max())


def gaps(params: Dict, requests: List[Dict], cfg: Dict, device) -> List[float]:
    """Widest gap of each request ({"prompt", "tokens"})."""
    return [served_gap(params, r["prompt"], r["tokens"], cfg, device)
            for r in requests]


def control_gaps(params: Dict, requests: List[Dict], cfg: Dict,
                 device) -> List[float]:
    """The control's widest gap of each request: at the same positions,
    the float8 reference's first token judged by the float32 one."""
    out = []
    for r in requests:
        ref = served_logits(params, r["prompt"], r["tokens"], cfg, device)
        low = served_logits(params, r["prompt"], r["tokens"], cfg, device,
                            fp8=True)
        pick = low.argmax(-1, keepdim=True)
        out.append(float((ref.max(-1).values
                          - ref.gather(-1, pick)[:, 0]).max()))
    return out
