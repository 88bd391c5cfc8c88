"""Host self time of the program's ops, ranges and CUDA calls, ms per
profiled step."""


def read(view):
    if view.trace is None:
        return None
    agg = view.host_agg()
    if not agg:
        return None
    return sum(a["total_us"] for a in agg.values()) / view.steps / 1e3
