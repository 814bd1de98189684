"""Model public API of the port (counterpart of ``repro.models``).

>>> from repro_torch import models
>>> gen = torch.Generator(device="cuda").manual_seed(0)
>>> params = models.init(cfg, gen)
>>> cache = models.init_cache(cfg, 8, 4096)                  # ring
>>> pool = models.init_cache(cfg, 8, 4096, layout="paged", num_pages=512)
"""
from repro_torch.models.params import from_jax
from repro_torch.models.transformer import (AUX_WEIGHT, boundary_saves,
                                            decode_step, default_positions,
                                            encode, forward, hidden_states,
                                            init, init_cache, loss_fn,
                                            model_defs, paged_extract,
                                            paged_insert, param_count,
                                            prefill, prefill_paged,
                                            prefill_paged_padded)

__all__ = [
    "AUX_WEIGHT", "boundary_saves", "decode_step", "default_positions",
    "encode", "forward", "from_jax", "hidden_states", "init", "init_cache",
    "loss_fn", "model_defs", "paged_extract", "paged_insert", "param_count",
    "prefill", "prefill_paged", "prefill_paged_padded",
]
