"""``warp_solve_kernel``'s share of its roofline, in %."""

from port_bench.roofline import share_pct


def read(view):
    return share_pct(view, "warp_solve_kernel")
