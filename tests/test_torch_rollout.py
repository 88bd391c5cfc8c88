"""The slice as a whole: the port's headline rollout (C-ADMM, n = 8,
``max_iter=20``, ``inner_iters=20``, forest seed 0, ``acc_des=(0.3, 0, 0)``)
over 4 seeded scenarios for 3 MPC steps, against the same rollout built from
the JAX modules by ``bench.py build()``.

Tolerance, and why: per-step consensus iteration counts are discrete and
must be equal. The states agree to 1e-4: the control forces agree to ~1e-6 N
(rounding of the inverses and products, see tests/test_torch_cadmm.py), and
the 30 physics substeps integrate that at dt = 1 ms, adding the float32
rounding of the 3x3 rotation products; positions are O(10) m, so 1e-4 is
~10 ulps of them.
"""

import bench
import numpy as np
import torch

from tpu_aerial_transport_torch.harness import rollout


def test_headline_rollout_matches_bench_build():
    S, steps = 4, 3
    jrun, jcss, jstates = bench.build("cadmm", n=8, n_scenarios=S)
    jcss, jstates, jiters = jrun(jcss, jstates, n_steps=steps)

    run, css, states = rollout.build(n=8, n_scenarios=S, device="cpu")
    np.testing.assert_array_equal(
        states.xl.numpy(),
        np.asarray(bench._scenario_batch(
            bench.make_mpc_step("cadmm", 8)[2], S).xl),
    )
    css, states, iters = run(css, states, steps)

    np.testing.assert_array_equal(iters.numpy(), np.asarray(jiters))
    assert iters.shape == (steps, S) and int(iters.max()) > 1
    for f in ("xl", "vl", "Rl", "wl", "R", "w"):
        np.testing.assert_allclose(getattr(states, f).numpy(),
                                   np.asarray(getattr(jstates, f)), atol=1e-4,
                                   rtol=0, err_msg=f)
    np.testing.assert_array_equal(states.step.numpy(),
                                  np.asarray(jstates.step))
    np.testing.assert_allclose(css.f_mean.numpy(), np.asarray(jcss.f_mean),
                               atol=1e-4, rtol=0)
    assert torch.isfinite(states.xl).all()
