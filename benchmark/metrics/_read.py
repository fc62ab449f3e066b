"""What the per-layer metric readers share: each reads one number from a
traced run's record (benchmark/tracing.py's `reduce`, with the loop's
`record` merged in), or returns None where the record holds nothing for
it."""

from __future__ import annotations

from typing import Optional

from benchmark import roofline


def per_request_ms(rec: dict, span: str) -> Optional[float]:
    """Device ms of the kernels launched inside host span `span`, a request
    completed."""
    spent = rec.get("span_device_s", {}).get(span, 0.0)
    if not rec.get("completed") or spent <= 0:
        return None
    return spent * 1e3 / rec["completed"]


def _untraced(rec: dict) -> Optional[dict]:
    """The loop's record of the run's untraced window (with its wall time),
    where it holds work."""
    u = rec.get("untraced") or {}
    return u if u.get("flops") and u.get("window_s", 0) > 0 else None


def idle_pct(rec: dict) -> Optional[float]:
    """The card's idle share of the untraced window, in %: 1 - the device's
    busy time an operation in the traced window (the union of the
    profiler's kernel, copy and set intervals over the operations the
    window completed), times the operations the untraced window completed,
    over its wall time. The profiler slows the host, not the card's work,
    so the traced window's own idle share reads high."""
    u = _untraced(rec)
    if u is None or rec.get("busy_s", 0) <= 0 or not rec.get("flops"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["flops"] * u["flops"] / u["window_s"])


def mfu_pct(rec: dict) -> Optional[float]:
    """Useful operations the untraced window completed over its wall time,
    over the peak of the path's dtype (benchmark/roofline.py:MFU_PEAK)."""
    u = _untraced(rec)
    if u is None:
        return None
    return 100.0 * u["flops"] / u["window_s"] / roofline.MFU_PEAK[u["dtype"]]


def kernel_s(rec: dict, pattern: str) -> float:
    return sum(s for name, s in rec.get("kernel_s", {}).items() if pattern in name)
