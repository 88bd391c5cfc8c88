"""Operator tools of the PyTorch port, run as modules
(``python -m tpu_aerial_transport_torch.tools.<name>``), each with
``main(argv=None) -> int``:

- ``fleet_local``: the serving-fleet harness (replica processes on the
  card), and ``fleet_console``, its live SLO console;
- ``pods_local``: the localhost harness of scenario sharding across
  processes;
- ``aot_bundle``: build, check, diff and serve AOT bundles;
- ``lint``: the static analysis (Tiers A and C by file path, with neither
  torch nor jax imported) and the registry's contracts;
- ``run_health``: the run-health summary of a metrics jsonl, and its
  ``--validate`` gate;
- ``trace_view``: stitch ``trace_event`` rows into one Chrome/Perfetto
  trace, the critical path, and its ``--validate`` gate (by file path, it
  imports neither torch nor jax);
- ``op_profile``: device time per kernel and per ``tat.*`` phase from a
  ``torch.profiler`` Chrome trace;
- ``profile_dd64``: the component split of the batched DD step at n = 64,
  timed on the card;
- ``probe_chip``: a watchdogged liveness probe of the card, logged;
- ``ci_check``: the port's gates chained in one process.

A tool that computes on a device runs on the card unless it is given
``--device cpu``; the others read files.
"""
