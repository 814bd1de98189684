"""Serving plane: page allocator, scheduler, engine core, sampler and
the live PyTorch engine."""
