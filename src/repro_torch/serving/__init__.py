"""Serving plane: page allocator, prefix cache, scheduler, engine core,
sampler, step graphs and the live PyTorch engine; the sim engine priced
by the cost model, the router, KV transfer and the disaggregated
prefill/decode pool."""
