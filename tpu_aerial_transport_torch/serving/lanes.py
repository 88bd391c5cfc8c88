"""Boundary lane surgery on the card for the continuous batcher:
harvest-read, filler reset and late-join write as lane selects over the
batched boundary carry, plus the resolvers of the serving tier's two
knobs (surgery impl, dispatch mode).

Counterpart of the JAX package's ``serving/lanes.py``. The host seam it
replaces (``serving/batcher.py``): after every chunk the server copies the
whole batch carry to the host, splices late joiners' initial states into
freed lanes with tensor assignments, and reads finished lanes' results
out of the host copy -- so the carry round-trips host <-> card once per
boundary, and chunk k+1 cannot start until the splice is done.
:func:`lane_surgery` keeps the carry on the card: the harvested scenario
state is returned as a SECOND output (the pre-surgery ``carry[0]``,
exactly what the host splice read), join lanes receive the family
template with the request's ``x0``/``v0`` selected in, and freed-but-
unfilled lanes are reset to the pristine template (quarantined filler, as
at launch). Every write is a ``torch.where`` lane select on the leading
lane axis, and a select copies bits verbatim, so the device path is
BITWISE the host splice (held across alone/busy/late-join compositions
and preempt + resume by ``tests/test_torch_serving.py``).

The boundary plan (which lanes finish, which join) is host arithmetic over
admission counters -- independent of the chunk's numeric results, which
is what makes pipelined dispatch legal (``serving/server.py``).
"""

from __future__ import annotations

import torch

from tpu_aerial_transport_torch.obs import phases
from tpu_aerial_transport_torch.tree import tree_map

# ----------------------------------------------------------------------
# Knob resolvers.
# ----------------------------------------------------------------------

SURGERY_MODES = ("host", "device")
DISPATCH_MODES = ("sync", "pipelined")


def resolve_surgery(configured: str | None = None) -> str:
    """Resolve the serving lane-surgery implementation: ``host`` (the
    splice on a host copy of the boundary carry) or ``device`` (the
    :func:`lane_surgery` selects on the carry on the card).

    ``None`` and ``"auto"`` resolve to ``host``, the JAX package's default
    and, on an H100, the cheaper boundary (a splice of about 0.03 ms
    against about 2 ms of device selects, PERF.md section 6). There is no
    environment override.

    FLIP CRITERION: flip the default to ``device`` when, on the card, the
    device surgery's per-boundary wall time is below the host splice's and
    the ``surgery`` + ``harvest`` critical-path segments shrink at equal
    throughput -- when keeping the full batch carry off the host beats the
    extra select launches. Device mode is also the prerequisite for
    pipelined dispatch.
    """
    mode = (configured or "").strip().lower() or "host"
    if mode == "auto":
        mode = "host"
    if mode not in SURGERY_MODES:
        raise ValueError(
            f"surgery={mode!r}: expected one of "
            f"{SURGERY_MODES} (or 'auto')"
        )
    return mode


def resolve_dispatch(configured: str | None = None) -> str:
    """Resolve the serving chunk-dispatch mode: ``sync`` (wait for chunk k
    before planning boundary k) or ``pipelined`` (enqueue the surgery and
    chunk k+1 BEFORE waiting for chunk k's harvest copy -- legal because
    the boundary plan depends only on host admission counters, never on
    chunk k's numeric results).

    ``None`` and ``"auto"`` resolve to ``sync`` (on an H100 pipelined
    serving showed no gain beyond the host's spread between runs, PERF.md
    section 6); there is no environment override. Pipelined dispatch needs
    device surgery (a host splice needs the chunk result on the host,
    which is the serialisation being removed); the server forces
    ``surgery=device`` when dispatch resolves pipelined.

    FLIP CRITERION: flip the default to ``pipelined`` when it shows a
    smaller boundary stall (the ``surgery`` + ``publish`` + ``harvest`` +
    ``batch_wait`` sum per completed request) than ``sync`` at equal
    result digests, on the card. The port's consensus loops read
    ``active.any()`` on the host every iteration, so a chunk enqueues only
    as fast as the card runs it, and the overlap is small until those
    syncs go.
    """
    mode = (configured or "").strip().lower() or "sync"
    if mode == "auto":
        mode = "sync"
    if mode not in DISPATCH_MODES:
        raise ValueError(
            f"dispatch={mode!r}: expected one of "
            f"{DISPATCH_MODES} (or 'auto')"
        )
    return mode


# ----------------------------------------------------------------------
# The surgery.
# ----------------------------------------------------------------------

def lane_surgery(carry, template_b, x0, v0, join_mask, reset_mask):
    """One boundary's lane surgery on a batched chunk carry.

    Args (all batched over the leading lane axis ``B``, on one device):

    - ``carry``: the chunk's output carry (``carry[0]`` is the batched
      scenario state; the rest is controller state);
    - ``template_b``: the family's pristine initial carry stacked to ``B``
      lanes (``Family.batched_template``);
    - ``x0`` / ``v0``: ``(B, 3)`` initial payload position/velocity, row
      ``i`` meaningful only where ``join_mask[i]``;
    - ``join_mask``: ``(B,)`` bool -- lanes a late-join request enters
      (the template written in, then ``x0``/``v0`` selected into the
      scenario state: the writes ``Family.lane_carry`` and the host splice
      make);
    - ``reset_mask``: ``(B,)`` bool -- lanes freed at this boundary with
      no joiner: reset to the pristine template.

    Returns ``(new_carry, harvested_state)``, ``harvested_state`` the
    PRE-surgery ``carry[0]``: the host reads finished lanes' results out
    of it (``Batch.harvest``), exactly as it read the boundary host copy.
    Nothing is written in place: the input carry stays valid.
    """
    with phases.scope(phases.LANE_SURGERY):
        harvested = carry[0]
        write = join_mask | reset_mask

        def lane_select(mask):
            def sel(new, old):
                m = mask.reshape((-1,) + (1,) * (old.dim() - 1))
                return torch.where(m, new.to(old.dtype), old)

            return sel

        new_carry = tree_map(lane_select(write), tuple(template_b),
                             tuple(carry))
        state = new_carry[0]
        state = state.replace(
            xl=lane_select(join_mask)(x0, state.xl),
            vl=lane_select(join_mask)(v0, state.vl),
        )
        return (state,) + tuple(new_carry[1:]), harvested


def make_surgery_args(template_b, joins, resets, bucket: int):
    """The operands of :func:`lane_surgery` after the carry, on the
    template's device: ``joins`` is ``[(lane, request), ...]``, ``resets``
    a lane list. The rows and masks are built on the host, each request's
    ``x0``/``v0`` converted as ``Family.lane_carry`` converts them, and
    copied over in one transfer each."""
    state = template_b[0]
    dev, dtype = state.xl.device, state.xl.dtype
    x0 = torch.zeros((bucket, 3), dtype=dtype)
    v0 = torch.zeros((bucket, 3), dtype=dtype)
    join_mask = torch.zeros(bucket, dtype=torch.bool)
    reset_mask = torch.zeros(bucket, dtype=torch.bool)
    for lane, req in joins:
        join_mask[lane] = True
        x0[lane] = torch.tensor(req.x0, dtype=dtype).reshape(3)
        v0[lane] = torch.tensor(req.v0, dtype=dtype).reshape(3)
    reset_mask[list(resets)] = True
    return (template_b,) + tuple(
        t.to(dev) for t in (x0, v0, join_mask, reset_mask))
