"""Host self ms under ``tat.qp_build``, ``tat.local_solve``,
``tat.fused_solve`` and ``tat.pad``, per profiled step."""

PHASES = ("qp_build", "local_solve", "fused_solve", "pad")


def read(view):
    if view.trace is None:
        return None
    ph = view.host_phase_us()
    if not any(p in ph for p in PHASES):
        return None
    return sum(ph.get(p, 0.0) for p in PHASES) / view.steps / 1e3
