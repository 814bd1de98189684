"""Launch layer of the port: ``train.py``, the single-device training
step.  The mesh, the sharded specs, the serve-step factories and the
dry run are ROADMAP A6 (multi-GPU)."""
