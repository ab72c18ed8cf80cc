"""Arithmetic shared by the metrics' readers (``metrics/<name>.py``): each
takes the run's record and returns a number, or None where the record
holds nothing to read."""

from __future__ import annotations

import numpy as np

from . import arch, counts


def per_second(rec: dict, key: str):
    if key not in rec or not rec.get("window_s"):
        return None
    return rec[key] / rec["window_s"]


def p95(values):
    return float(np.percentile(values, 95)) if values else None


def profile(rec: dict):
    """The traced stretch's reduction, where it saw device work."""
    p = rec.get("profile")
    return p if p and p.get("n_device_ops") and p.get("steps") else None


def idle_pct(rec: dict):
    p = profile(rec)
    return None if p is None else 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def device_ms_per_step(rec: dict):
    p = profile(rec)
    return None if p is None else 1e3 * p["device_s"] / p["steps"]


def kernels_per_step(rec: dict):
    p = profile(rec)
    return None if p is None else p["n_kernels"] / p["steps"]


def serve_window_flops(rec: dict) -> float:
    """The work the window's requests asked for: each prompt, unpadded,
    through the prefill, and each of its decode tokens at the positions it
    attends.  Pads, and the decode slots of requests that had finished, are
    computed by the program but not counted."""
    a, total = rec["arch"], 0.0
    c = arch.module(a)
    for w in rec["waves"]:
        for n, m in zip(w["prompt_len"], w["max_new"]):
            total += c.prefill_flops(a, 1, n)
            total += sum(c.decode_flops(a, 1, n + t + 1) for t in range(m - 1))
    return total


def serve_mfu_pct(rec: dict):
    if not rec.get("waves"):
        return None
    return 100.0 * serve_window_flops(rec) / (rec["window_s"] * counts.BF16_FLOPS)


def decode_roofline_pct(rec: dict):
    """The least time of the traced wave's synchronized decode steps, each
    counted for its live requests (`counts`), over the spans' sum."""
    spans = rec.get("decode_spans")
    if not spans:
        return None
    a = rec["arch"]
    c = arch.module(a)
    least = sum(counts.least_seconds(
        c.decode_flops(a, s["live"], s["attended"]),
        c.decode_bytes(a, s["live"], s["attended"], s.get("experts_hit"))) for s in spans)
    return 100.0 * least / (sum(s["ms"] for s in spans) / 1e3)


def prefill_ms(rec: dict):
    ms = rec.get("prefill_ms")
    return float(np.mean(ms)) if ms else None


def train_mfu_pct(rec: dict):
    if not rec.get("steps"):
        return None
    a = rec["arch"]
    flops = rec["steps"] * arch.module(a).train_flops(a, rec["batch"], rec["seq"])
    return 100.0 * flops / (rec["window_s"] * counts.BF16_FLOPS)


def slot_waste_pct(rec: dict):
    """Decode slot-steps of requests that had finished (a wave decodes to its
    longest max_new) over all of the window's slot-steps."""
    waves, b = rec.get("waves"), rec.get("batch")
    if not waves:
        return None
    total = sum(b * w["decode_steps"] for w in waves)
    wasted = sum(w["decode_steps"] - (m - 1) for w in waves for m in w["max_new"])
    return 100.0 * wasted / total if total else None
