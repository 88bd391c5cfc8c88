"""Fault injection and graceful degradation.

Counterpart of ``tpu_aerial_transport/resilience/`` (its fault schedules,
quarantine and resilient rollout):

- :mod:`faults` -- :class:`FaultSchedule`, per-agent faults (actuator
  degradation, agent loss, sensor noise, consensus-message dropout)
  evaluated to a per-step :class:`FaultStep`; the random draws are the JAX
  package's bits for the same key (:mod:`prng`);
- :mod:`quarantine` -- per-scenario NaN quarantine helpers;
- :mod:`rollout` -- :func:`resilient_rollout`, the rollout with fault
  evaluation, the fallback ladder and the quarantine, and the health-aware
  C-ADMM and DD steps.
"""

from tpu_aerial_transport_torch.resilience.faults import (  # noqa: F401
    NEVER,
    FaultSchedule,
    FaultStep,
    apply_sensor_noise,
    fault_step,
    make_schedule,
    no_faults,
    stack_schedules,
)
from tpu_aerial_transport_torch.resilience.quarantine import (  # noqa: F401
    tree_all_finite,
    tree_where,
)
from tpu_aerial_transport_torch.resilience.rollout import (  # noqa: F401
    RUNG_CLEAN,
    RUNG_EQUILIBRIUM,
    RUNG_HOLD,
    RUNG_RETRY,
    init_resilient_carry,
    jit_resilient_rollout,
    make_cadmm_hl_step,
    make_dd_hl_step,
    resilient_rollout,
)
