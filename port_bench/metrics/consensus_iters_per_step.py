"""Mean over the window's steps of the batch's largest consensus
iteration count (``SolverStats.iters``)."""


def read(view):
    return view.record.get("consensus_iters_per_step")
