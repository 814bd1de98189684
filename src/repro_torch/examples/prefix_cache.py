"""Prefix-cache plane end-to-end: cache-aware routing + an intent
program that pins the shared system prompt when the hit rate sags.

    PYTHONPATH=src python -m repro_torch.examples.prefix_cache

What happens:

1. The pipeline runs two tester instances with per-instance prefix
   caches behind a ``cache_aware`` router: fan-out requests land where
   their shared system header is already resident.
2. The installed intent program watches the cache plane's own metric
   (``tester-0.cache.hit_rate``, pushed like every other gauge) and
   reacts through the same audited control surface as every other knob:

       rule pin_hot: when last(tester-0.cache.hit_rate) < 0.9
           => pin system-prompt; note pinned system prompt

   Pinned blocks are exempt from eviction, so the hottest prefix
   survives page-pool pressure.
3. The run prints per-instance hit rates, tokens saved, routing stats,
   and the controller's audit trail.
"""
from repro_torch.agents import AgenticPipeline, PipelineConfig, TaskSpec
from repro_torch.core.intent import compile_intent

PROGRAM = """
# keep the system prompt resident while the cache is still warming up
rule pin_hot: when last(tester-0.cache.hit_rate) < 0.9
    => pin system-prompt; note pinned system prompt
"""


def main() -> int:
    p = AgenticPipeline(PipelineConfig(
        n_testers=2, header_tokens=256, router_policy="cache_aware"))
    p.controller.install(compile_intent(PROGRAM))

    for i in range(12):
        p.submit(TaskSpec(session=f"sess-{i % 3}", n_functions=3))
    p.run(until=60.0)

    print(f"tasks done: {len(p.done)}")
    for name, cache in sorted(p.cache_dir.caches.items()):
        pinned = sum(e.pinned for e in cache._entries.values())
        print(f"{name}: hit_rate={cache.hit_rate:.2f} "
              f"saved_prefill_tokens={cache.saved_prefill_tokens} "
              f"blocks={cache.blocks_resident} pinned={pinned} "
              f"evictions={cache.evictions}")
    print(f"router: routed={p.router.routed} "
          f"cache_routed={p.router.cache_routed}")
    print("audit trail:")
    for a in p.controller.actions[:12]:
        print(f"  t={a.t:7.3f}  {a.kind:<8} {a.target:<24} {a.detail}")

    assert len(p.done) == 12
    assert p.router.cache_routed > 0
    assert any(a.kind == "pin" for a in p.controller.actions)
    assert sum(c.saved_prefill_tokens
               for c in p.cache_dir.caches.values()) > 0
    print("OK: pin fired, cache-aware routing used, prefill tokens saved")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
