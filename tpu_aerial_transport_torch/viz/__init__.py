"""Host-side visualisation: matplotlib paper figures (:mod:`plots`) and 3-D
scenes and replays (:mod:`scene`), the port's copy of the JAX package's
``viz/``. Nothing here runs on a rollout's path; matplotlib is imported
only when a figure is drawn."""

from tpu_aerial_transport_torch.viz import plots  # noqa: F401
