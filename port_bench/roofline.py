"""A solve kernel's share of its roofline, read from the profiled steps:
the least time the card needs for the launched work (``yardstick``'s
counts over the record's ``solve_work``) over the kernel's device time in
the trace."""

from __future__ import annotations

from port_bench import yardstick


def share_pct(view, kernel: str) -> float | None:
    """None where the trace or the record holds nothing of ``kernel``."""
    work = (view.record.get("solve_work") or {}).get(kernel)
    if work is None or not view.has_device():
        return None
    us, launches = 0.0, 0
    for key, a in view.device_agg().items():
        if kernel in key.split(" @ ")[0]:
            us += a["total_us"]
            launches += a["count"]
    if launches == 0 or us <= 0.0:
        return None
    if "bytes_per_launch" in work:
        bound = launches * yardstick.bound_s(work["bytes_per_launch"],
                                             work["flops_per_launch"])
    elif launches == work["launches"]:
        bound = yardstick.bound_s(work["bytes"], work["flops"])
    else:
        return None
    return 100.0 * bound / (us * 1e-6)
