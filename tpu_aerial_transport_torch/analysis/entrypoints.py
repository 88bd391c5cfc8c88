"""The port's hot surface, as pure data (stdlib only: Tier A and the lint
CLI load this by file path, importing neither torch nor jax).

The counterparts of the JAX package's ``analysis/entrypoints.py`` tables:

- :data:`HOT_FUNCTIONS` (JAX: ``TRACED_FUNCTIONS``): per module, the names
  whose bodies run on the hot path when the system is in use. Tier A seeds
  its hot-code inference with them: a per-file AST pass cannot see calls
  across modules, so the hot surface is declared here.
- :data:`CONTRACT_ENTRYPOINTS`: the public entry points that must have a
  Tier-B contract in ``analysis.contracts.REGISTRY`` (the same 35 names).
- :data:`HOT_NON_ENTRYPOINTS`: public functions that loop on the hot path
  but are deliberately not contract entry points, each with a reason.
- :data:`DONATION_CONTRACTS`: TC105's minimum of output tensors that
  share storage with an argument. It is empty: no registered entry
  donates (see :data:`NO_COUNTERPART`).
- :data:`SYNC_BUDGETS`: TC103's budgets of host synchronisations a call of
  each entry may make, with their derivation. It has no JAX twin: it is
  the torch meaning of JAX's "no host callback".
- :data:`NO_COUNTERPART`: the rows of the JAX tables that have no
  counterpart here, each with the reason. The JAX ``TILE_WAIVERS`` (TC104)
  and ``LOWERING_WAIVERS`` (TC106) have none as a whole: see
  ``analysis/contracts.py``. Three more tables hold what of the JAX tree
  keeps no counterpart: ``FILES:<path>`` (a file of the JAX package, a
  repo-root tool or example, or ``bench.py``, with no port file at the
  same path), ``NAMES:<path>:<name>`` (a public name or command-line flag
  of a JAX file with no port counterpart) and ``KNOBS:<NAME>`` (a JAX
  environment knob the port's ``analysis/knobs.py`` lacks).
  ``tests/test_torch_completeness.py`` holds the tables against both
  trees.

Keys are POSIX path suffixes relative to the repo root.
"""

from __future__ import annotations

_P = "tpu_aerial_transport_torch/"

HOT_FUNCTIONS: dict[str, tuple[str, ...]] = {
    _P + "control/centralized.py": (
        "control", "equilibrium_forces", "smooth_block",
    ),
    _P + "control/cadmm.py": ("control", "donated_step"),
    _P + "control/dd.py": ("control",),
    _P + "control/rp_cadmm.py": ("control",),
    _P + "control/rp_centralized.py": ("control", "equilibrium_forces"),
    _P + "control/pmrl_centralized.py": ("control", "equilibrium_forces"),
    _P + "control/lowlevel.py": ("lowlevel_control",),
    _P + "control/so3_tracking.py": (
        "so3_pd_tracking_control", "so3_sm_tracking_control",
    ),
    _P + "ops/socp.py": (
        "solve_socp", "solve_socp_padded", "pad_qp", "pad_warm",
        "unpad_solution", "padded_kkt_operator",
    ),
    _P + "ops/lie.py": (
        "hat", "hat_square", "expm_so3", "log_so3", "polar_project",
        "polar_project_svd", "rotation_from_z", "rotation_a_to_b",
    ),
    _P + "ops/admm_kernel.py": ("admm_chunk_lanes", "fused_solve_lanes"),
    _P + "models/rqp.py": (
        "forward_dynamics", "integrate_state", "integrate",
    ),
    _P + "models/rp.py": ("forward_dynamics", "integrate_state", "integrate"),
    _P + "models/pmrl.py": (
        "forward_dynamics", "integrate_state", "integrate",
    ),
    _P + "envs/forest.py": (
        "ground_height", "braking_capsule", "capsule_forest_distance",
        "capsule_distance_data", "cbf_rows_from_distance",
        "vision_cone_mask", "cone_mask_at",
        "point_cylinder_distance", "segment_cylinder_distance",
        "collision_cbf_rows",
    ),
    _P + "envs/spatial.py": (
        "candidate_slab", "bucketed_distance", "env_query_bucketed",
        "env_query_dense",
    ),
    # The rollout's step loop, the substeps (whose bodies GraphedFn
    # captures) and the chunk bodies, and the bucketed step.
    _P + "harness/rollout.py": (
        "rollout", "_rollout", "make_substeps", "make_chunked_rollout",
        "make_chunk_driver",
    ),
    _P + "harness/bucketing.py": ("bucketed_step",),
    _P + "harness/diff.py": (
        "substep_rollout", "payload_pd_forces", "simulate_commands",
        "plan_share_forces",
    ),
    _P + "resilience/rollout.py": (
        "resilient_rollout", "_resilient_rollout",
        "make_chunked_resilient_rollout", "make_cadmm_hl_step",
        "make_dd_hl_step",
    ),
    _P + "resilience/faults.py": ("fault_step", "apply_sensor_noise"),
    _P + "resilience/quarantine.py": ("tree_all_finite", "tree_where"),
    _P + "obs/telemetry.py": ("update", "_p2_update"),
    # JAX's _pallas_ring_allreduce and _ring_sum_kernel are the ring-sum
    # kernel's wrapper and its plain version here.
    _P + "parallel/ring.py": (
        "consensus_exchange", "consensus_gather", "_ring_allreduce_sum",
        "_rotate_allreduce", "_ring_gather", "ring_sum_shards",
        "ring_sum_shards_reference",
    ),
    _P + "parallel/mesh.py": ("sharded_step", "vmap_chunk_jit"),
    _P + "parallel/pods.py": ("pods_control_step",),
    # The serving chunk (the family's chunked rollout and its hl step).
    _P + "serving/batcher.py": ("_build_chunk",),
    _P + "serving/lanes.py": ("lane_surgery",),
    _P + "entry.py": ("entry",),
}

# name -> short description; analysis.contracts.REGISTRY carries exactly
# this key set (tests/test_torch_contracts.py).
CONTRACT_ENTRYPOINTS: dict[str, str] = {
    "control.centralized:control": "centralized SOCP+CBF control step",
    "control.cadmm:control": "C-ADMM consensus control step (Schur path)",
    "control.cadmm:control_forest": "C-ADMM step with env CBF rows active",
    "control.dd:control": "dual-decomposition control step",
    "control.rp_cadmm:control": "RP consensus-ADMM control step",
    "control.rp_centralized:control": "RP centralized QP control step",
    "control.pmrl_centralized:control": "PMRL centralized control step",
    "ops.socp:solve_socp": "batched conic-QP solve (route scan)",
    "ops.socp:solve_socp_padded": "padded-operator conic-QP solve",
    "ops.admm_kernel:solve_socp_interpret":
        "the chunk kernel's plain version (admm_chunk_lanes_reference)",
    "ops.admm_kernel:fused_solve_interpret":
        "the whole-solve kernel's plain version, fixed form",
    "ops.admm_kernel:fused_solve_pallas":
        "the whole-solve kernel (csrc/fused_solve.cu), fixed form; card only",
    "ops.admm_kernel:fused_solve_earlyexit_interpret":
        "the whole-solve kernel's plain version, early-exit form",
    "ops.admm_kernel:fused_solve_earlyexit_pallas":
        "the whole-solve kernel, early-exit form with the gate; card only",
    "control.cadmm:control_adaptive":
        "C-ADMM step with effort='adaptive' (gated early-exit solves)",
    "control.dd:control_adaptive": "DD step with effort='adaptive'",
    "harness.rollout:rollout": "nominal two-rate receding-horizon rollout",
    "harness.rollout:rollout_donated":
        "jit_rollout: the substeps replayed from a CUDA graph",
    "harness.rollout:chunked_rollout":
        "one chunk of the chunk-resumable rollout (every chunk one program)",
    "resilience.rollout:resilient_rollout":
        "fault-injected rollout with fallback ladder + quarantine",
    "resilience.rollout:resilient_rollout_donated":
        "jit_resilient_rollout: the substeps replayed from a CUDA graph",
    "harness.rollout:rollout_telemetry":
        "rollout with the run-health telemetry accumulator",
    "resilience.rollout:resilient_rollout_telemetry":
        "fault-injected rollout with telemetry + per-agent solve health",
    "parallel.mesh:cadmm_control_sharded":
        "agent-sharded C-ADMM step (allreduce exchange)",
    "parallel.mesh:cadmm_control_sharded_ring":
        "agent-sharded C-ADMM step with the ring exchange",
    "parallel.ring:consensus_exchange":
        "the ring exchange's sum, max and gather over stacked shards",
    "parallel.ring:consensus_exchange_pallas":
        "the ring-sum kernel (csrc/ring_sum.cu); card only",
    "parallel.mesh:scenario_rollout":
        "scenario-sharded Monte-Carlo batch rollout",
    "serving.batcher:serving_chunk":
        "the serving chunk of the canonical cadmm family",
    "serving.batcher:serving_chunk_centralized":
        "the serving chunk of the canonical centralized family",
    "serving.lanes:lane_surgery":
        "device boundary lane surgery (canonical cadmm family)",
    "serving.lanes:lane_surgery_centralized":
        "device boundary lane surgery (canonical centralized family)",
    "envs.spatial:env_query_bucketed":
        "bucketed environment query through the CBF rows",
    "envs.spatial:env_query_dense": "dense environment query",
    "parallel.pods:pods_control_step":
        "2-D (scenario, agent) pods-mesh C-ADMM step; a process group",
}

# Public functions that loop on the hot path but are not contract entry
# points, with the reason (the JAX table's rows, at the port's paths).
HOT_NON_ENTRYPOINTS: dict[str, str] = {
    _P + "envs/forest.py:segment_cylinder_distance":
        "geometry inside every forest-coupled control contract",
    _P + "ops/lie.py:polar_project":
        "fixed-iteration Newton polar decomposition inside every "
        "integrate() of the rollout contracts",
    _P + "harness/diff.py:substep_rollout":
        "differentiable-rollout research harness (tests/test_torch_diff.py)",
    _P + "harness/diff.py:make_rollout_loss":
        "loss factory over substep_rollout",
    _P + "harness/diff.py:simulate_commands": "sysid data generator",
    _P + "harness/diff.py:make_trajopt_loss":
        "trajectory-optimization research harness",
    _P + "harness/diff.py:tune_gains":
        "host-side descent loop around a loss, itself not hot",
    _P + "parallel/pods.py:make_pods_workload":
        "workload factory over pods_control_step, which carries the "
        "contract",
}

# TC105: entry -> the minimum of output tensors that share storage with an
# argument tensor. No registered entry donates: every row of the JAX table
# is in NO_COUNTERPART. The port's one donated carry is
# jit_control_step(donate=True) (control.cadmm.donated_step), which is not
# a registry entry; tests/test_torch_control_step.py holds its in-place
# write.
DONATION_CONTRACTS: dict[str, int] = {}

# Rows of the JAX tables with no counterpart in the port, by
# "<table>:<key>", with the reason.
NO_COUNTERPART: dict[str, str] = {
    "TRACED_FUNCTIONS:tpu_aerial_transport/parallel/pods.py:"
    "_physics_substeps":
        "pods_control_step has no substeps of its own: the pods rollout "
        "runs the harness's make_substeps (hot above)",
    "DONATION_CONTRACTS:harness.rollout:rollout_donated":
        "an eager rollout returns new tensors: XLA reuses a donated "
        "buffer for the output, PyTorch has no such reuse, and a copy of "
        "the final state into the input would move the state once more "
        "and save nothing",
    "DONATION_CONTRACTS:resilience.rollout:resilient_rollout_donated":
        "as harness.rollout:rollout_donated: the eager fault-aware "
        "rollout returns new tensors",
    "DONATION_CONTRACTS:harness.rollout:chunked_rollout":
        "the chunk driver snapshots each boundary carry "
        "(resilience/recovery.py): a chunk hands back new tensors so a "
        "published snapshot never aliases the next chunk's carry",
    "DONATION_CONTRACTS:parallel.mesh:scenario_rollout":
        "the scenario tier runs one program over every shard's scenarios "
        "on one card: it hands back new tensors, as jit_rollout does "
        "without donate",
    "DONATION_CONTRACTS:serving.lanes:lane_surgery":
        "the surgery selects between the carry, the template and the "
        "joins with torch.where, which writes a new tensor; the server "
        "drops the old carry",
    "DONATION_CONTRACTS:serving.lanes:lane_surgery_centralized":
        "the same select program as serving.lanes:lane_surgery, on the "
        "centralized family's carry",
    # FILES: what of the JAX tree has no port file at the same path.
    "FILES:bench.py":
        "the JAX package's benchmark harness; the port's benchmark comes in "
        "a benchmark PR of its own (ROADMAP Queue 1), which writes its "
        "harness from the port's cells",
    "FILES:tools/bench_retry.py":
        "bench.py's retrying driver for wedged TPU rounds; it waits for the "
        "port's benchmark PR with bench.py",
    "FILES:tools/tpu_watch.sh":
        "the TPU rounds' chip watcher around bench.py; it waits for the "
        "port's benchmark PR with bench.py",
    "FILES:tools/jaxlint.py":
        "its counterpart is tpu_aerial_transport_torch/tools/lint.py (the "
        "lint tiers A and C and the registry's contracts, on torch)",
    "FILES:tools/ci_check.sh":
        "its counterpart is tpu_aerial_transport_torch/tools/ci_check.py, "
        "which chains the port's gates in one process",
    "FILES:tpu_aerial_transport/utils/compat.py":
        "a JAX-version shim (shard_map, orbax); no port module needs one: "
        "see the NAMES rows of utils/compat.py",
    "FILES:tpu_aerial_transport/utils/platform.py":
        "JAX platform, XLA-cache and virtual-device set-up; no port module "
        "needs one: see the NAMES rows of utils/platform.py",
    # NAMES: public names and flags of a JAX file with no port counterpart.
    "NAMES:tpu_aerial_transport/utils/compat.py:shard_map":
        "the port's agent and scenario shards are an explicit shard axis "
        "of one program on the card (parallel/mesh.py make_mesh), not a "
        "shard_map over devices",
    "NAMES:tpu_aerial_transport/utils/compat.py:pytree_io":
        "orbax's pytree checkpointing; the port saves and loads state with "
        "harness/checkpoint.py save_state and load_state",
    "NAMES:tpu_aerial_transport/utils/platform.py:honor_jax_platforms_env":
        "JAX_PLATFORMS against a site hook; the port's entry points take "
        "device= and resolve_device (tpu_aerial_transport_torch/"
        "__init__.py) never falls back from the card",
    "NAMES:tpu_aerial_transport/utils/platform.py:XLA_CACHE_ENV":
        "XLA's persistent compilation cache; the port compiles its kernels "
        "once into ops/_build.py's build directory, and the AOT bundles "
        "carry them prebuilt",
    "NAMES:tpu_aerial_transport/utils/platform.py:default_cache_dir":
        "the XLA cache's default path; the port's counterpart is "
        "ops/_build.py build_dir() and the AOT bundles (aot/bundle.py)",
    "NAMES:tpu_aerial_transport/utils/platform.py:enable_persistent_cache":
        "turns XLA's persistent cache on; the port's build directory is "
        "always on (ops/_build.py), and the AOT bundles carry prebuilt "
        "libraries",
    "NAMES:tpu_aerial_transport/utils/platform.py:VIRTUAL_DEVICES_ENV":
        "XLA's forced host device count; the port runs its shards as a "
        "shard axis on one card, and the tier-1 pods ranks as threads",
    "NAMES:tpu_aerial_transport/utils/platform.py:virtual_device_count":
        "reads the virtual-device knob; the port needs no virtual devices "
        "(the shard axis on one card, pods ranks as threads)",
    "NAMES:tpu_aerial_transport/utils/platform.py:apply_virtual_devices":
        "sets XLA_FLAGS for virtual devices; the port needs no virtual "
        "devices (the shard axis on one card, pods ranks as threads)",
    "NAMES:tools/op_profile.py:load_xplanes":
        "reads XLA xplane protos; the port's tool reads torch.profiler "
        "Chrome traces with load_traces",
    "NAMES:tools/op_profile.py:device_op_times":
        "a back-compatibility shim over op_aggregate for callers of the "
        "JAX tool's first version; the port's tool has no such callers",
    "NAMES:tools/op_profile.py:load_hlo_map":
        "maps compiled HLO instructions to their scopes; PyTorch writes no "
        "HLO, and each kernel's launch carries its scope in the trace",
    "NAMES:tools/op_profile.py:find_hlo_dump":
        "finds the HLO text bench.py --profile writes beside a trace; "
        "PyTorch writes no HLO",
    "NAMES:tools/op_profile.py:--hlo":
        "names the HLO text for load_hlo_map; PyTorch writes no HLO, and "
        "each kernel's launch carries its scope in the trace",
    "NAMES:tools/aot_bundle.py:--platform":
        "a JAX export target other than this host's backend; the port "
        "builds and serves a bundle on the device --device names",
    "NAMES:tools/aot_bundle.py:--no-exec":
        "skips serialized XLA executables; a port bundle holds kernel "
        "libraries and shapes, and no executable",
    "NAMES:tools/aot_bundle.py:--cache-dir":
        "the XLA compilation cache of the serve ladder's cached rung; the "
        "port's cached rung is the kernel build directory",
    "NAMES:tools/pods_local.py:--platform":
        "the JAX platform of the workers; the port's harness takes "
        "--device (cuda or cpu)",
    "NAMES:tools/aot_bundle.py:REPO":
        "the repo root put on sys.path for a run by file path; the port's "
        "tools run as python -m from the package",
    "NAMES:tools/probe_chip.py:REPO":
        "the repo root of the JAX tool's log path; the port's tool puts its "
        "log under the build directory beside the package (LOG)",
    "NAMES:examples/serve_fleet.py:REPO":
        "the repo root put on sys.path for a run by file path; the port's "
        "examples run as python -m from the package",
    "NAMES:examples/serve_scenarios.py:REPO":
        "the repo root put on sys.path for a run by file path; the port's "
        "examples run as python -m from the package",
    "NAMES:examples/serve_sessions.py:REPO":
        "the repo root put on sys.path for a run by file path; the port's "
        "examples run as python -m from the package",
    "NAMES:examples/serve_sessions.py:HERE":
        "the examples directory put on sys.path for a run by file path; "
        "the port's examples run as python -m from the package",
    # KNOBS: JAX environment knobs the port's registry lacks.
    "KNOBS:TAT_MATMUL_PRECISION":
        "the port pins full float32 matmuls (TF32 off) at import "
        "(tpu_aerial_transport_torch/__init__.py), with no override",
    "KNOBS:TAT_SERVING_DISPATCH":
        "the port's serving/lanes.py resolve_dispatch takes no environment "
        "override: dispatch= on ScenarioServer only",
    "KNOBS:TAT_SERVING_SURGERY":
        "the port's serving/lanes.py resolve_surgery takes no environment "
        "override: surgery= on ScenarioServer only",
    "KNOBS:TAT_SWEEP_CELLS":
        "bench.py's sweep filter; it waits for the port's benchmark PR "
        "with bench.py",
    "KNOBS:TAT_SWEEP_SHARDED_N":
        "bench.py's sharded-cell agent count; it waits for the port's "
        "benchmark PR with bench.py",
    "KNOBS:TAT_VIRTUAL_DEVICES":
        "XLA's virtual host devices; see the NAMES rows of "
        "utils/platform.py (the shard axis on one card, pods ranks as "
        "threads)",
    "KNOBS:TAT_XLA_CACHE_DIR":
        "XLA's persistent compilation cache; see the NAMES rows of "
        "utils/platform.py (the kernel build directory and the AOT bundles)",
    "KNOBS:TPU_AERIAL_FUSED":
        "the port's route comes from ops/socp.py resolve_route(fused) at "
        "config build, with no environment override",
}

# TC103: entry -> {"budget": int, "reason": str}, and "card_only": int
# where a library call synchronises inside itself. "budget" holds the host
# syncs the dispatch mode counts in one call at the registry's size (on
# the CPU in tier-1, and on the card): the worst case at those sizes, its
# derivation in the reason. "card_only" holds the syncs that only the
# card's own count (``set_sync_debug_mode``) sees beyond the dispatched
# ones, checked on the card alone. The registry's sizes: max_iter=2
# consensus iterations, two control periods a rollout or chunk.
_INV = ("torch.linalg.inv reads its error flag on the host once a KKT "
        "operator build (ops/socp.py:274): 1")
_LOOP = ("the consensus loop tests its lanes on the host once an "
         "iteration, at most max_iter + 1 = 3 iterations, and once more to "
         "end ({}): 4")
_CADMM = _LOOP.format("control/cadmm.py:1289")
_CENTRAL = ("10 solver iterations in chunks of 25: the tolerance-chunked "
            "solve tests its lanes once, for the remainder (ops/socp.py:388; "
            "on the card the kernel stops each lane in place)")
_KERNEL = "a kernel launch or a plain tensor program: nothing read back"
_ROLLOUT = ("2 periods, each a centralized control step: " + _CENTRAL
            + "; and " + _INV + ": 2 x 2 = 4")
_RESILIENT = ("2 periods, each a health-aware C-ADMM step: " + _CADMM
              + "; and " + _INV + "; then the fallback ladder's "
              "equilibrium forces, one torch.linalg.solve check a call "
              "(control/centralized.py:167): 2 x 5 + 1 = 11. On the card "
              "only: the masked equilibrium's pseudo-inverse, an SVD that "
              "synchronises 4 times a step inside cuSOLVER "
              "(control/centralized.py:181): 2 x 4 = 8")
_ADAPTIVE = (_CADMM + "; in each of the at most 3 iterations the gated "
             "solve's 4 inner iterations in chunks of 2 test the lanes "
             "once a full chunk (2), once more after them, none for a "
             "remainder (ops/socp.py:380, :388): 3 x 3 = 9; and " + _INV
             + " (on the card the kernel stops each lane in place)")

SYNC_BUDGETS: dict[str, dict] = {
    "ops.socp:solve_socp": {"budget": 1, "reason": _INV},
    "ops.socp:solve_socp_padded": {"budget": 1, "reason": _INV},
    "ops.admm_kernel:solve_socp_interpret": {"budget": 0,
                                             "reason": _KERNEL},
    "ops.admm_kernel:fused_solve_interpret": {"budget": 0,
                                              "reason": _KERNEL},
    "ops.admm_kernel:fused_solve_pallas": {"budget": 0, "reason": _KERNEL},
    "ops.admm_kernel:fused_solve_earlyexit_interpret": {
        "budget": 4,
        "reason": "the plain version's early exit is the host's: 8 "
                  "iterations in chunks of 3 test the lanes once a full "
                  "chunk (2), once more after them, and once for the "
                  "remainder (ops/socp.py:380, :388): 4"},
    "ops.admm_kernel:fused_solve_earlyexit_pallas": {
        "budget": 0,
        "reason": "the kernel stops each lane on the card: " + _KERNEL},
    "control.centralized:control": {
        "budget": 2, "reason": _CENTRAL + ": 1; and " + _INV + ": 2"},
    "control.rp_centralized:control": {
        "budget": 1, "reason": "fixed solver iterations; " + _INV},
    "control.pmrl_centralized:control": {
        "budget": 2, "card_only": 2,
        "reason": _CENTRAL + ": 1; and " + _INV + ": 2. On the card only: "
                  "lstsq_min_norm's SVD synchronises twice inside "
                  "cuSOLVER (control/pmrl_centralized.py:122): 2"},
    "control.cadmm:control": {
        "budget": 5, "reason": _CADMM + "; and " + _INV + ": 5"},
    "control.cadmm:control_forest": {
        "budget": 6,
        "reason": _CADMM + "; " + _INV + "; and on the CPU the vision "
                  "cone's half angle, rounded through a float32 host "
                  "tensor (envs/forest.py:371), which reads no card: 6"},
    "control.dd:control": {
        "budget": 6,
        "reason": _LOOP.format("control/dd.py:664") + "; " + _INV
                  + "; and torch.linalg.solve's check of the dual step's "
                  "Newton matrix (control/dd.py:430): 6"},
    "control.rp_cadmm:control": {
        "budget": 5,
        "reason": _LOOP.format("control/rp_cadmm.py:246") + "; and "
                  + _INV + ": 5"},
    "control.cadmm:control_adaptive": {
        "budget": 14, "reason": _ADAPTIVE + ": 4 + 9 + 1 = 14"},
    "control.dd:control_adaptive": {
        "budget": 15,
        "reason": "as control.cadmm:control_adaptive (the loop at "
                  "control/dd.py:664), and the Newton matrix's check "
                  "(control/dd.py:430): 14 + 1 = 15"},
    "parallel.mesh:cadmm_control_sharded": {
        "budget": 5,
        "reason": "as control.cadmm:control (5): the shards' sums are "
                  "tensor ops on one card"},
    "parallel.mesh:cadmm_control_sharded_ring": {
        "budget": 5,
        "reason": "as control.cadmm:control (5): the ring's rotations are "
                  "tensor ops on one card"},
    "parallel.pods:pods_control_step": {
        "budget": 5,
        "reason": "as control.cadmm:control (5); the scenario-axis "
                  "statistics are collectives, not host reads (not run "
                  "by tier-1 or the smoke's contract phase: it needs a "
                  "process group)"},
    "parallel.ring:consensus_exchange": {"budget": 0, "reason": _KERNEL},
    "parallel.ring:consensus_exchange_pallas": {"budget": 0,
                                                "reason": _KERNEL},
    "envs.spatial:env_query_dense": {"budget": 0, "reason": _KERNEL},
    "envs.spatial:env_query_bucketed": {
        "budget": 0,
        "reason": "the slab gather indexes with a tensor on the card"},
    "harness.rollout:rollout": {"budget": 4, "reason": _ROLLOUT},
    "harness.rollout:rollout_donated": {
        "budget": 4,
        "reason": "as harness.rollout:rollout (4); the substeps replay "
                  "from a CUDA graph"},
    "harness.rollout:chunked_rollout": {
        "budget": 4,
        "reason": "as harness.rollout:rollout (4) over the chunk's 2 "
                  "periods"},
    "harness.rollout:rollout_telemetry": {
        "budget": 4,
        "reason": "as harness.rollout:rollout (4); the telemetry fold is "
                  "tensor ops on the card"},
    "parallel.mesh:scenario_rollout": {
        "budget": 4,
        "reason": "as harness.rollout:rollout (4) over the scenario "
                  "shards"},
    "resilience.rollout:resilient_rollout": {
        "budget": 11, "card_only": 8, "reason": _RESILIENT},
    "resilience.rollout:resilient_rollout_donated": {
        "budget": 11, "card_only": 8,
        "reason": "as resilience.rollout:resilient_rollout (11; on the "
                  "card only, 8 of the SVD inside cuSOLVER)"},
    "resilience.rollout:resilient_rollout_telemetry": {
        "budget": 11, "card_only": 8,
        "reason": "as resilience.rollout:resilient_rollout (11; on the "
                  "card only, 8 of the SVD inside cuSOLVER)"},
    "serving.batcher:serving_chunk": {
        "budget": 10,
        "reason": "2 periods, each a C-ADMM step: " + _CADMM + "; and "
                  + _INV + ": 2 x 5 = 10 (warm-started lanes may end "
                  "the loop sooner)"},
    "serving.batcher:serving_chunk_centralized": {
        "budget": 4,
        "reason": "2 periods, each a centralized step whose 4 solver "
                  "iterations in chunks of 25 test the lanes once, for "
                  "the remainder (ops/socp.py:388); and " + _INV
                  + ": 2 x 2 = 4"},
    "serving.lanes:lane_surgery": {
        "budget": 0, "reason": "selects with torch.where on the card"},
    "serving.lanes:lane_surgery_centralized": {
        "budget": 0, "reason": "selects with torch.where on the card"},
}
