"""``fused_solve_early_kernel``'s share of its roofline, in %: its
operations at the iterations its lanes need on the profiled steps' inputs,
as the reference's own solver counts them."""

from port_bench.roofline import share_pct


def read(view):
    return share_pct(view, "fused_solve_early_kernel")
