"""Gradient-based SO(3) gain tuning through the differentiable simulator,
on the card.

The port's counterpart of ``examples/grad_tuning.py``: the two-rate cascade
(1 kHz low-level SO(3) attitude control + manifold-integrator physics) is
differentiated end to end with torch autograd (each MPC step checkpointed),
and the attitude PD gains are tuned by projected gradient descent from a
deliberately detuned start (``harness/diff.py tune_gains``: one descent
iteration replayed from a CUDA graph on the card).

Usage: python -m tpu_aerial_transport_torch.examples.grad_tuning [--n 3]
    [--steps 40] [--iters 25] [--lr 0.05] [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from tpu_aerial_transport_torch import convert, resolve_device
from tpu_aerial_transport_torch.control import centralized
from tpu_aerial_transport_torch.harness import diff, setup
from tpu_aerial_transport_torch.ops import lie
from tpu_aerial_transport_torch.resilience import prng

DETUNED = {"k_R": 0.02, "k_Omega": 0.2}
REFERENCE = {"k_R": 0.25, "k_Omega": 0.075}


def tilt_axes(n: int, device="cuda") -> torch.Tensor:
    """``0.3 * jax.random.normal(jax.random.PRNGKey(0), (n, 3))``: the JAX
    example's tilt axes, from the same Threefry bits."""
    return 0.3 * prng.normal(prng.prng_key(0, device=device), (n, 3))


def start(n: int = 3, device="cuda"):
    """``(params, f_eq, state0, xl_ref)``: the set-up with tilted initial
    attitudes and a position step of (0.5, 0, 0.3) m, so the attitude
    loop's gains shape the objective."""
    dev = resolve_device(device)
    params, _, state0 = setup.rqp_setup(n, device=dev)
    f_eq = centralized.equilibrium_forces(params)
    state0 = state0.replace(
        R=lie.expm_so3(tilt_axes(n, dev)) @ state0.R)
    xl_ref = state0.xl + torch.tensor([0.5, 0.0, 0.3], device=dev)
    return params, f_eq, state0, xl_ref


def problem(n: int = 3, steps: int = 40, device="cuda"):
    """``(loss, state0)``: the example's rollout loss (``k_att=1``) from
    :func:`start`."""
    params, f_eq, state0, xl_ref = start(n, device)
    loss = diff.make_rollout_loss(params, f_eq, xl_ref, n_steps=steps,
                                  k_att=1.0)
    return loss, state0


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=3)
    p.add_argument("--steps", type=int, default=40, help="MPC-rate steps")
    p.add_argument("--iters", type=int, default=25, help="SGD iterations")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    loss, state0 = problem(args.n, args.steps, dev)
    with torch.no_grad():
        detuned = float(loss(convert.gains(DETUNED, dev), state0))
        reference = float(loss(convert.gains(REFERENCE, dev), state0))
    print(f"loss @ detuned   (k_R=0.02, k_Omega=0.2):   {detuned:.5f}")
    print(f"loss @ reference (k_R=0.25, k_Omega=0.075): {reference:.5f}")

    gains, hist = diff.tune_gains(
        loss, convert.gains(DETUNED, dev), state0, lr=args.lr,
        iters=args.iters)
    print(f"tuned gains (best iterate): k_R={float(gains['k_R']):.4f} "
          f"k_Omega={float(gains['k_Omega']):.4f}")
    hist = hist.cpu()
    print("loss history:",
          " ".join(f"{float(v):.5f}" for v in hist[:: max(1, args.iters // 8)]))
    with torch.no_grad():
        best = float(loss(gains, state0))
    print(f"loss @ tuned gains: {best:.5f} "
          f"(improvement {float(hist[0]) / best:.2f}x over detuned)")
    return {"detuned": detuned, "reference": reference,
            "gains": {k: float(v) for k, v in gains.items()},
            "hist": hist.tolist(), "tuned": best}


if __name__ == "__main__":
    main()
