"""Device ms under ``tat.dynamics`` (the substeps' graph, its kernels
under their ``cudaGraphLaunch``), per profiled step."""


def read(view):
    if not view.has_device():
        return None
    us = view.device_phase_us().get("dynamics")
    return None if us is None else us / view.steps / 1e3
