"""Model public API of the port (counterpart of ``repro.models``).

>>> from repro_torch import models
>>> gen = torch.Generator(device="cuda").manual_seed(0)
>>> params = models.init(cfg, gen)
>>> cache = models.init_cache(cfg, 8, 4096)                  # ring
>>> pool = models.init_cache(cfg, 8, 4096, layout="paged", num_pages=512)
"""
from repro_torch.models.params import from_jax
from repro_torch.models.transformer import (decode_step, default_positions,
                                            init, init_cache, model_defs,
                                            paged_extract, paged_insert,
                                            param_count, prefill,
                                            prefill_paged)

__all__ = [
    "decode_step", "default_positions", "from_jax", "init", "init_cache",
    "model_defs", "paged_extract", "paged_insert", "param_count", "prefill",
    "prefill_paged",
]
