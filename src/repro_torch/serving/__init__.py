"""Serving plane: page allocator, prefix cache, scheduler, engine core,
sampler, step graphs and the live PyTorch engine."""
