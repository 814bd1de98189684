"""Token sampling (port of ``repro/serving/sampler.py``): greedy,
temperature and top-k, batched, on the logits' device so only token ids
cross to the host.

``temperature`` is a 0-d tensor on the logits' device, as the
reference's is a traced scalar: both the greedy and the sampled ids are
computed and ``torch.where`` picks one, so a step captured as a CUDA
graph serves every value of the ``temperature`` knob without a new
capture.  The sampled ids are a Gumbel-max draw (``argmax(logits / T +
G)`` with ``G = -log E``, ``E`` exponential from ``generator``), which
reads nothing back to the host, as ``torch.multinomial``'s checks would;
under a CUDA graph the generator is registered with the graph
(``serving/graphs.py``), so each replay draws new numbers.
"""
from __future__ import annotations

import torch

# the smallest temperature the sampled branch divides by, as the
# reference's ``jnp.maximum(temperature, 1e-6)``
MIN_TEMPERATURE = 1e-6


def _gumbel_argmax(lg: torch.Tensor, generator: torch.Generator
                   ) -> torch.Tensor:
    """One categorical draw per row of the f32 logits ``lg`` (B, N)."""
    e = torch.empty_like(lg).exponential_(generator=generator)
    e = e.clamp_min(torch.finfo(torch.float32).tiny)    # log(0) never
    return torch.argmax(lg - torch.log(e), dim=-1)


def sample(logits: torch.Tensor, generator: torch.Generator,
           temperature: torch.Tensor, top_k: int = 0) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32.  ``temperature``: a 0-d tensor on
    the logits' device; at or below 0 the ids are greedy, ``argmax``,
    which takes the first index on ties, as ``jnp.argmax`` does.
    ``generator`` must live on the logits' device."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    lg = logits.float() / temperature.float().clamp_min(MIN_TEMPERATURE)
    if 0 < top_k < lg.shape[-1]:
        vals, idx = torch.topk(lg, top_k, dim=-1)
        draw = _gumbel_argmax(vals, generator)
        sampled = torch.gather(idx, 1, draw[:, None])[:, 0]
    else:
        sampled = _gumbel_argmax(lg, generator)
    return torch.where(temperature <= 0, greedy, sampled.to(torch.int32))
