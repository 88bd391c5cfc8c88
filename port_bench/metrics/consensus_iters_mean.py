"""Mean over the window's steps and scenarios of the consensus iteration
count (``SolverStats.iters``): unlike the batch's largest, it falls when a
consensus change lets more scenarios stop before the cap."""


def read(view):
    return view.record.get("consensus_iters_mean")
