"""Device ms under the ``tat.env_query`` and ``tat.cbf_rows`` ranges, per
profiled step."""


def read(view):
    if not view.has_device():
        return None
    ph = view.device_phase_us()
    if "env_query" not in ph and "cbf_rows" not in ph:
        return None
    return (ph.get("env_query", 0.0) + ph.get("cbf_rows", 0.0)) \
        / view.steps / 1e3
