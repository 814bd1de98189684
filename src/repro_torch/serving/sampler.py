"""Token sampling (port of ``repro/serving/sampler.py``): greedy,
temperature and top-k, batched, on the logits' device so only token ids
cross to the host."""
from __future__ import annotations

import torch


def sample(logits: torch.Tensor, generator: torch.Generator,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32.  Greedy is ``argmax``, which takes
    the first index on ties, as ``jnp.argmax`` does.  ``generator`` must
    live on the logits' device."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lg = logits.float() / max(temperature, 1e-6)
    if 0 < top_k < lg.shape[-1]:
        vals, idx = torch.topk(lg, top_k, dim=-1)
        draw = torch.multinomial(torch.softmax(vals, dim=-1), 1,
                                 generator=generator)
        return torch.gather(idx, 1, draw)[:, 0].to(torch.int32)
    draw = torch.multinomial(torch.softmax(lg, dim=-1), 1,
                             generator=generator)
    return draw[:, 0].to(torch.int32)
