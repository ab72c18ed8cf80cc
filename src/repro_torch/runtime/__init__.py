"""Runtime hardening and observation utilities shared by the long-running layers.

`repro_torch.runtime.faults` is the deterministic fault-injection registry the
chaos tests and CI profile drive; `repro_torch.runtime.trace` holds the spans
and counters of the LM path.  Both are strictly no-ops unless armed.
"""
