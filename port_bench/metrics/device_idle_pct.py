"""Share of the profiled steps' span with no kernel, memcpy or memset on
the device, in %."""


def read(view):
    if not view.has_device() or view.span() is None:
        return None
    lo, hi = view.span()
    return 100.0 * (1.0 - view.busy_us() / (hi - lo))
