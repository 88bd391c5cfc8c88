"""The RQP family's step loop: Monte-Carlo batches of the port's MPC step.

One MPC step is what the port's ``harness.rollout.rollout`` composes: the
command (the mix's tracking law, benchmark side), the controller
``rollout.make_controller(...).control`` and the ten low-level and physics
substeps ``rollout.make_substeps(...)``, replayed from a CUDA graph on the
card. Episodes of ``episode_steps`` steps restart every scenario from a
fresh seeded draw with the controller state reset, so a step's work does
not drift with how far the program flies in a window.

The check: at a seeded sample of steps (the first always) and of
scenarios, the step's inputs and outputs are kept on the device; after the
window the reference (:mod:`port_bench.reference`) runs the same step on
them. At an episode's first step the reference builds its own inputs from
the generator; at later steps it takes the program's carried state, and
the carried state the step hands on is compared itself.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference import controllers as ref_ctl
from port_bench.reference import rqp as ref
from port_bench.traffic import generator

SAMPLE_SCENARIOS = 128
SAMPLE_STEPS = 6
# The sampled steps lie among the first this many: the fewest a window of
# the benchmark completes (PERF.md).
SAMPLE_WITHIN = 200
# Full-batch solves are replayed by the reference in blocks of this many
# scenarios (the roofline's iteration counts).
REF_BLOCK = 4096


# How each key of a configuration reaches the program, by controller:
# ``pass`` keys are arguments of ``rollout.make_controller``; every key of
# ``holds``, passed or not, names the field of the controller's own config
# that has to equal it once built. The reference takes the same keys. A
# key in neither ``holds`` nor ``DESCRIBES`` is refused.
TO_PROGRAM = {
    "cadmm": {"pass": ("max_iter", "inner_iters", "socp_fused", "effort",
                       "socp_precision", "pad_operators"),
              "holds": {"res_tol": "res_tol", "rho": "rho0",
                        "tau_incr": "tau_incr", "solver_tol": "solver_tol",
                        "max_iter": "max_iter",
                        "inner_iters": "inner_iters",
                        "socp_fused": "socp_fused", "effort": "effort",
                        "socp_precision": "socp_precision",
                        "pad_operators": "pad_operators"}},
    "centralized": {"pass": (),
                    "holds": {"solver_iters": "solver_iters",
                              "solver_tol": "solver_tol",
                              "solver_check_every": "solver_check_every"}},
}
# Keys the driver reads itself, or that describe the file.
DESCRIBES = ("source", "reduced", "assumed", "driver", "controller", "n",
             "precision", "tf32", "low_level", "substeps", "dt", "scenarios",
             "limits")


def program_args(config: dict) -> dict:
    """``make_controller``'s keyword arguments from ``config``; a key that
    the program cannot honour raises."""
    route = TO_PROGRAM.get(config["controller"])
    if route is None:
        raise ValueError(f"controller {config['controller']!r}")
    unknown = set(config) - set(DESCRIBES) - set(route["holds"])
    if unknown:
        raise ValueError(f"configuration keys {sorted(unknown)} do not "
                         f"reach the {config['controller']} program")
    if config["precision"] != "float32" or config["tf32"] is not False:
        raise ValueError("the program runs float32 with TF32 off only")
    if config["low_level"] != "pd":
        raise ValueError("make_controller builds the PD low level only")
    return {k: config[k] for k in route["pass"] if k in config}


def check_program(config: dict, cfg) -> None:
    """Raise unless the controller's config ``cfg`` holds every ``holds``
    key of ``config`` and the matrix products run without TF32."""
    holds = TO_PROGRAM[config["controller"]]["holds"]
    for key, field in holds.items():
        if key in config and getattr(cfg, field) != config[key]:
            raise ValueError(f"configuration {key}={config[key]!r}: the "
                             f"program runs {field}={getattr(cfg, field)!r}")
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise ValueError("TF32 is on")


def _state_to_ref(s) -> ref.State:
    return ref.State(R=s.R, w=s.w, xl=s.xl, vl=s.vl, Rl=s.Rl, wl=s.wl,
                     step=s.step)


def _sol_to_ref(w) -> ref.Solution:
    return ref.Solution(x=w.x, y=w.y, z=w.z, prim_res=w.prim_res,
                        dual_res=w.dual_res)


def _css_to_ref(controller: str, c):
    if controller == "cadmm":
        return ref_ctl.CADMMState(f=c.f, lam=c.lam, f_mean=c.f_mean,
                                  warm=_sol_to_ref(c.warm))
    return ref_ctl.CentralizedState(prev_f=c.prev_f, warm=_sol_to_ref(c.warm))


def tmap(fn, *trees):
    """``fn`` over the tensors of NamedTuples of tensors."""
    t0 = trees[0]
    if isinstance(t0, tuple):
        parts = [tmap(fn, *xs) for xs in zip(*trees)]
        return type(t0)(*parts) if hasattr(t0, "_fields") else tuple(parts)
    return fn(*trees)


def _cat(trees):
    return tmap(lambda *ts: torch.cat(ts), *trees)


class Driver:
    """A cell of the RQP family on ``device``: set-up in the constructor
    and :meth:`warm_up`, then :meth:`step` once an MPC step."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 gen=generator):
        from tpu_aerial_transport_torch.envs import forest as forest_mod
        from tpu_aerial_transport_torch.harness import rollout
        from tpu_aerial_transport_torch.models import rqp as rqp_mod

        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.gen = gen
        self.dev = torch.device(device)
        self.controller = config["controller"]
        self.n = int(config["n"])
        self.S = int(config["scenarios"])
        self.ep_len = int(traffic["episode_steps"])
        kw = program_args(config)
        pos3, num = gen.make_world(traffic["world"], seed)
        self.world = (pos3, num)
        world = forest_mod.forest_from_tree_pos(
            pos3[:num], num, max_trees=pos3.shape[0], device=self.dev)
        self.ctl = rollout.make_controller(self.controller, self.n,
                                           forest=world, device=self.dev,
                                           **kw)
        check_program(config, self.ctl.cfg)
        self.substeps = rollout.make_substeps(
            self.ctl.params, self.ctl.ll.control,
            n_sub=int(config["substeps"]), dt=float(config["dt"]))
        self.law = gen.make_command(traffic["command"], self.dev)
        state0 = rqp_mod.rqp_identity_state(self.n, device=self.dev)
        self.state_tmpl = rollout.stack_scenarios(state0, self.S)
        self.css0 = rollout.stack_scenarios(self.ctl.cs0, self.S)
        self._starts: dict[int, tuple] = {}
        rng = np.random.default_rng(generator.seed_words(seed) + [7919])
        steps = rng.choice(np.arange(1, SAMPLE_WITHIN), SAMPLE_STEPS - 1,
                           replace=False)
        self.sample_steps = sorted({0, *map(int, steps)})
        self.sample_idx = torch.as_tensor(np.sort(rng.choice(
            self.S, min(SAMPLE_SCENARIOS, self.S), replace=False)),
            device=self.dev)
        self.captured: list[dict] = []
        self.iters_max: list[torch.Tensor] = []
        self.iters_mean: list[torch.Tensor] = []
        self.full: list[tuple] = []
        self._hold = 0
        self.k = 0
        self._reset(0)

    # ------------------------------------------------------------ run

    def _episode(self, ep: int):
        if ep not in self._starts:
            xl, vl = self.gen.episode_starts(self.traffic["starts"],
                                             self.seed, ep, self.S)
            f32 = dict(dtype=torch.float32, device=self.dev)
            self._starts[ep] = (torch.as_tensor(xl, **f32),
                                torch.as_tensor(vl, **f32))
        return self._starts[ep]

    def _reset(self, ep: int):
        xl, vl = self._episode(ep)
        self.states = self.state_tmpl.replace(xl=xl, vl=vl)
        self.css = self.css0

    def prepare(self, episodes: int):
        """Draw the first ``episodes`` episodes' starts (set-up)."""
        for ep in range(episodes):
            self._episode(ep)

    def warm_up(self, steps: int = 2):
        """Run ``steps`` steps (the graph capture and every kernel at the
        batch's shapes), then restart at episode 0."""
        for _ in range(steps):
            self._step(capture=False)
        self.k = 0
        self._reset(0)
        self.iters_max.clear()
        self.iters_mean.clear()

    def step(self):
        """One MPC step of every scenario."""
        self._step(capture=self.k in self.sample_steps)

    def _step(self, capture: bool):
        k = self.k
        if k and k % self.ep_len == 0:
            self._reset(k // self.ep_len)
        states, css = self.states, self.css
        (acc_des, _, _) = self.law(states.xl, states.vl)
        f_des, css_new, stats = self.ctl.control(css, states, acc_des)
        states_new = self.substeps(states, f_des)
        if self.controller == "cadmm":
            self.iters_max.append(torch.amax(stats.iters))
            self.iters_mean.append(stats.iters.to(torch.float32).mean())
        if capture:
            idx = self.sample_idx

            def pick(t):
                return t.index_select(0, idx)

            self.captured.append(dict(
                step=k, episode=k // self.ep_len,
                start=(k % self.ep_len == 0),
                state=tmap(pick, _state_to_ref(states)),
                css=tmap(pick, _css_to_ref(self.controller, css)),
                f=pick(f_des),
                css_out=tmap(pick, _css_to_ref(self.controller, css_new)),
                count=pick(stats.iters if self.controller == "cadmm"
                           else (stats.ok_frac > 0.5).to(torch.int32)),
                ok_frac=pick(stats.ok_frac),
                min_dist=pick(stats.min_env_dist),
                collision=pick(stats.collision),
                state_out=tmap(pick, _state_to_ref(states_new))))
        if self._hold:
            dst = self.full[len(self.full) - self._hold]
            tmap(lambda d, t: d.copy_(t), dst,
                 (_state_to_ref(states), _css_to_ref(self.controller, css)))
            self._hold -= 1
        self.states, self.css = states_new, css_new
        self.k = k + 1

    def hold_inputs(self, steps: int):
        """Keep the whole batch's inputs of the next ``steps`` steps (the
        centralized solves' iteration counts need them), in buffers
        allocated now, so that the held steps allocate nothing."""
        if self.controller == "cadmm":
            return
        for _ in range(steps):
            self.full.append(tmap(torch.empty_like, (
                _state_to_ref(self.states),
                _css_to_ref(self.controller, self.css))))
        self._hold = steps

    def record(self) -> dict:
        """The run's counters, read after the window."""
        out = {"scenarios": self.S, "steps": self.k}
        if self.iters_max:
            out["consensus_iters_per_step"] = float(
                torch.stack(self.iters_max).to(torch.float64).mean())
            out["consensus_iters_mean"] = float(
                torch.stack(self.iters_mean).to(torch.float64).mean())
        return out

    def free(self):
        """Drop the program's batch state (the samples stay)."""
        self.states = self.css = self.state_tmpl = self.css0 = None
        self._starts.clear()

    # ------------------------------------------------------ reference

    def reference(self, tf32: bool = False):
        nx = ref.Numerics(tf32=tf32)
        c = self.config
        if self.controller == "cadmm":
            return ref_ctl.CADMM(nx, self.n, ref_ctl.CADMMConfig(
                max_iter=int(c["max_iter"]),
                inner_iters=int(c["inner_iters"]),
                res_tol=float(c["res_tol"]), rho=float(c["rho"]),
                solver_tol=float(c["solver_tol"])), self.dev)
        return ref_ctl.Centralized(nx, self.n, ref_ctl.CentralizedConfig(
            solver_iters=int(c["solver_iters"]),
            solver_tol=float(c["solver_tol"]),
            solver_check_every=int(c["solver_check_every"])), self.dev)

    def ref_forest(self) -> ref.Forest:
        pos3, num = self.world
        return ref.Forest(
            tree_pos=torch.as_tensor(pos3, dtype=torch.float32,
                                     device=self.dev),
            tree_valid=torch.arange(pos3.shape[0], device=self.dev) < num)

    def ref_inputs(self, rc):
        """The sampled steps' inputs as the reference takes them: its own
        at an episode's first step, the program's carried ones after."""
        states, csss = [], []
        idx = self.sample_idx.cpu().numpy()
        for c in self.captured:
            if c["start"]:
                xl, vl = self.gen.episode_starts(self.traffic["starts"],
                                                 self.seed, c["episode"],
                                                 self.S)
                f32 = dict(dtype=torch.float32, device=self.dev)
                s = ref.identity_state(self.n, len(idx), self.dev)._replace(
                    xl=torch.as_tensor(xl[idx], **f32),
                    vl=torch.as_tensor(vl[idx], **f32))
                states.append(s)
                csss.append(rc.initial(len(idx)))
            else:
                states.append(c["state"])
                csss.append(c["css"])
        return _cat(states), _cat(csss)

    def gaps_of(self, rc, state, css, f_prog, css_prog, count_prog, okf_prog,
              dist_prog, coll_prog, state_prog) -> dict:
        """The gaps of the check, per sampled scenario-step: the judged
        side's step outputs against the reference ``rc``'s on the same
        inputs. ``same``: the consensus counts (centralized: the solve's
        outcome) and the worst fractions of agent solves that met their
        tolerance agree; ``all_ok``: every solve of the judged side met its
        tolerance; ``at_cap``: its consensus count is at the cap."""
        forest = self.ref_forest()
        acc_des, _, _ = self.law(state.xl, state.vl)
        out = rc.step(css, state, acc_des, forest)
        f_ref, css_ref = out.f, out.css
        dist_ref, coll_ref = out.min_dist, out.collision
        same = (out.outcome.to(torch.int32) == count_prog) & (
            out.ok_frac == okf_prog)
        gap_f = torch.abs(f_prog - f_ref).flatten(1).amax(1)
        if self.controller == "cadmm":
            gap_f = torch.maximum(
                gap_f, torch.abs(css_prog.f - css_ref.f).flatten(1).amax(1))
            carry = [(css_prog.lam, css_ref.lam),
                     (css_prog.f_mean, css_ref.f_mean)]
        else:
            carry = []
        carry += [(css_prog.warm.x, css_ref.warm.x),
                  (css_prog.warm.y, css_ref.warm.y),
                  (css_prog.warm.z, css_ref.warm.z)]
        gap_c = torch.zeros_like(gap_f)
        for a, b in carry:
            scale = 1.0 + torch.abs(b).flatten(1).amax(1)
            gap_c = torch.maximum(
                gap_c, torch.abs(a - b).flatten(1).amax(1) / scale)
        gap_d = torch.abs(dist_prog - dist_ref)
        gap_d = torch.where(coll_prog == coll_ref, gap_d,
                            torch.full_like(gap_d, math.inf))
        phys = ref.substeps(rc.nx, rc.params, state, f_prog,
                            int(self.config["substeps"]),
                            float(self.config["dt"]))
        gap_s = torch.zeros_like(gap_f)
        for a, b in zip(state_prog[:6], phys[:6]):
            gap_s = torch.maximum(gap_s, torch.abs(a - b).flatten(1).amax(1))
        gap_s = torch.where(state_prog.step == phys.step, gap_s,
                            torch.full_like(gap_s, math.inf))
        at_cap = (count_prog > self.config["max_iter"]
                  if self.controller == "cadmm"
                  else torch.zeros_like(same))
        return {"same": same.cpu(), "all_ok": (okf_prog >= 1.0).cpu(),
                "at_cap": at_cap.cpu(), "force": gap_f.cpu(),
                "env_active": (dist_ref < rc.lim.vision_radius).cpu(),
                "carry": gap_c.cpu(), "env": gap_d.cpu(),
                "state": gap_s.cpu()}

    def check(self, tf32_control: bool = False) -> dict:
        """Per sampled scenario-step gaps: the program's outputs against
        the float32 reference's, or, with ``tf32_control``, the TF32
        reference's (the control) against them."""
        rc = self.reference()
        state, css = self.ref_inputs(rc)
        if not tf32_control:
            cap = self.captured
            return self.gaps_of(
                rc, state, css, torch.cat([c["f"] for c in cap]),
                _cat([c["css_out"] for c in cap]),
                torch.cat([c["count"] for c in cap]),
                torch.cat([c["ok_frac"] for c in cap]),
                torch.cat([c["min_dist"] for c in cap]),
                torch.cat([c["collision"] for c in cap]),
                _cat([c["state_out"] for c in cap]))
        ctl = self.reference(tf32=True)
        forest = self.ref_forest()
        acc_des, _, _ = self.law(state.xl, state.vl)
        out = ctl.step(css, state, acc_des, forest)
        phys = ref.substeps(ctl.nx, ctl.params, state, out.f,
                            int(self.config["substeps"]),
                            float(self.config["dt"]))
        return self.gaps_of(rc, state, css, out.f, out.css,
                          out.outcome.to(torch.int32), out.ok_frac,
                          out.min_dist, out.collision, phys)

    def solve_work(self) -> dict | None:
        """The least work of the profiled steps' QP solves, from the
        reference's own solver on the captured full batches: per kernel
        name, ``{"bytes", "flops", "launches"}`` (None: nothing kept)."""
        from port_bench import yardstick as ys

        if self.controller == "cadmm":
            cfg = self.reference().cfg
            nv, n_box = 12, 7 + cfg.n_env_cbfs
            m = n_box + sum(ref.AGENT_SOC)
            lanes = self.S * self.n
            return {"warp_solve_kernel": {
                "bytes_per_launch": lanes * ys.fused_solve_bytes_per_lane(
                    nv, m, n_box),
                "flops_per_launch": lanes * ys.fused_solve_flops_per_lane(
                    nv, m, cfg.inner_iters, ref.AGENT_SOC)}}
        if not self.full:
            return None
        rc = self.reference()
        nv, n_box, m, soc = ref_ctl.centralized_dims(self.n,
                                                     rc.cfg.n_env_cbfs)
        ce = rc.cfg.solver_check_every
        forest = self.ref_forest()
        flops = bytes_ = 0
        for state, css in self.full:
            for lo in range(0, self.S, REF_BLOCK):
                sl = slice(lo, lo + REF_BLOCK)
                s = tmap(lambda t: t[sl], state)
                c = tmap(lambda t: t[sl], css)
                acc_des, _, _ = self.law(s.xl, s.vl)
                eff = rc.step(c, s, acc_des, forest).eff.to(torch.int64)
                lanes = int(eff.numel())
                iters = int(eff.sum())
                checks = int((eff // ce).sum()) + lanes
                built = int((eff > 0).sum())
                flops += (ys.fused_solve_flops_per_lane(
                    nv, m, 0, soc, residual_checks=0, build=True) * built
                    + iters * ys._iter_flops(nv, m, soc)
                    + checks * ys._residual_flops(nv, m))
                bytes_ += lanes * ys.fused_solve_bytes_per_lane(
                    nv, m, n_box, early=True)
        return {"fused_solve_early_kernel": {
            "bytes": bytes_, "flops": flops, "launches": len(self.full)}}


def build(config: dict, traffic: dict, seed: int, device,
          gen=generator) -> Driver:
    return Driver(config, traffic, seed, device, gen)
