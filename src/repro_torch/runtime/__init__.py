"""Runtime hardening utilities shared by the long-running layers.

`repro_torch.runtime.faults` is the deterministic fault-injection registry the
chaos tests and CI profile drive; it is strictly a no-op unless armed.
"""
