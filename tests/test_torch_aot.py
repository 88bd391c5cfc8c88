"""The port's AOT bundles (``tpu_aerial_transport_torch/aot/``) on the CPU,
mirroring the JAX package's ``tests/test_aot.py``: round trip
``bundle_exec`` bitwise the registry's callable, the probe entry, the
manifest refusals (stale fingerprint, tree structure, signature, corrupt
object, unreadable manifest, newer schema), registry coverage drift,
bucketing, the serve ladder's rungs and events, kernel-library install
(``ops._build.install``: every library the bundle carries, nothing
compiled after it, a foreign digest refused), the bundled
``ScenarioServer`` and backend probe (a wrong ring sum fails it), and the
registry's names against the JAX package's.

Parity with the JAX package: the serving chunk entries' ``make_args``
equal the JAX builders' leaf by leaf within 1e-6 (relative above
magnitude 1; both are float32 state factories of the same model), and one
chunk of the port's entry on those
inputs agrees with ``jax.jit`` of the JAX entry: states within 1e-4 (the
port's serving tolerance) and forces within 1e-2 N (the consensus
tolerance ``res_tol``).

One module-scoped bundle: ``aot:probe`` and the two ``cadmm4`` serving
entries at buckets (8, 16), built on the CPU (where no entry launches a
kernel, so it carries no library).
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from tpu_aerial_transport.analysis import contracts as jcontracts
from tpu_aerial_transport_torch import convert
from tpu_aerial_transport_torch.analysis import contracts
from tpu_aerial_transport_torch.aot import bundle as bundle_mod
from tpu_aerial_transport_torch.aot import loader
from tpu_aerial_transport_torch.aot.bundle import BundleError
from tpu_aerial_transport_torch.examples import serve_scenarios
from tpu_aerial_transport_torch.obs import export
from tpu_aerial_transport_torch.ops import _build
from tpu_aerial_transport_torch.resilience import backend
from tpu_aerial_transport_torch.serving import queue as queue_mod
from tpu_aerial_transport_torch.serving import server as server_mod
from tpu_aerial_transport_torch.serving.queue import ScenarioRequest
from tpu_aerial_transport_torch.tools import aot_bundle as cli
from tpu_aerial_transport_torch.tree import TensorSpec, leaves, tree_map

CHUNK = "serving.batcher:serving_chunk"
SURGERY = "serving.lanes:lane_surgery"
ENTRIES = (CHUNK, SURGERY)
BUCKETS = (8, 16)
STATE_BAR, FORCE_BAR = 1e-4, 1e-2
ARGS_BAR = 1e-6


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("aot") / "cpu")
    bundle_mod.build_bundle(out, names=list(ENTRIES), batch_buckets=BUCKETS,
                            device="cpu")
    return out


@pytest.fixture(scope="module")
def bundle(bundle_dir):
    return loader.load_bundle(bundle_dir)


def _bitwise(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _copy(bundle_dir, tmp_path, mutate=None):
    dst = str(tmp_path / "copy")
    shutil.copytree(bundle_dir, dst)
    if mutate is not None:
        path = os.path.join(dst, bundle_mod.MANIFEST_NAME)
        with open(path) as fh:
            manifest = json.load(fh)
        mutate(manifest)
        with open(path, "w") as fh:
            json.dump(manifest, fh)
    return dst


# ----------------------------------------------------------------------
# Round trip.
# ----------------------------------------------------------------------

@pytest.mark.parametrize("entry", ENTRIES)
def test_roundtrip_bundle_exec_bitwise(bundle, entry):
    """Served from the bundle (sample arguments, the registry's callable,
    the signature and outputs checked) is bitwise the registry callable
    called directly, at every bucket."""
    fn, _ = contracts.REGISTRY[entry].build("cpu")
    for batch in (None,) + BUCKETS:
        args = bundle.sample_args(entry, batch=batch)
        out, rung = bundle.call(entry, args)
        assert rung == loader.RUNG_EXEC
        _bitwise(out, fn(*bundle.sample_args(entry, batch=batch)))
    manifest = bundle.manifest
    assert manifest["kernels"] == {} and manifest["platform"] == "cpu"
    assert all(v["kernels"] == [] for v in bundle.variants(entry))


def test_probe_entry_runs(bundle):
    """The probe: the bf16 round trip's checksum (128 x 128 ones squared:
    128 every entry, exact in bf16) and the ring sum equal to x.sum(0)."""
    assert loader.call_probe(bundle, device="cpu") == 128.0 * 128 * 128
    s, ring = bundle.call(bundle_mod.PROBE_ENTRY,
                          bundle.probe_args(device="cpu"))[0]
    assert torch.equal(ring, torch.full((2, 128), 2.0))


# ----------------------------------------------------------------------
# Refusals.
# ----------------------------------------------------------------------

def test_stale_fingerprint_refusal(bundle_dir, tmp_path):
    """A copy whose torch version was edited refuses with ``bundle_stale``
    and the rebuild hint; ``backend.classify`` reads it as
    ``bundle_stale``, which is not a circuit-breaker kind."""
    def edit(m):
        m["fingerprint"]["torch"] = "0.0.1"

    stale = loader.load_bundle(_copy(bundle_dir, tmp_path, edit))
    with pytest.raises(BundleError) as err:
        stale.call(CHUNK, stale.sample_args(CHUNK))
    assert err.value.kind == "bundle_stale"
    assert "rebuild hint" in str(err.value)
    assert "tools.aot_bundle build --out" in str(err.value)
    assert backend.classify(err.value) == "bundle_stale"
    assert "bundle_stale" not in backend.BREAKER_KINDS
    with pytest.raises(BundleError, match="rebuild hint") as err:
        server_mod.ScenarioServer(families=("cadmm4",), device="cpu",
                                  bundle=stale, require_bundle=True)
    assert err.value.kind == "bundle_stale"


def test_treedef_mismatch_refusal(bundle):
    """Arguments of another tree structure (the carry without its
    controller state) refuse with ``treedef_mismatch``."""
    carry, i0 = bundle.sample_args(CHUNK)
    with pytest.raises(BundleError) as err:
        bundle.call(CHUNK, ((carry[0],), i0))
    assert err.value.kind == "treedef_mismatch"


def test_signature_mismatch_refusal(bundle):
    """The same structure at a bucket the bundle was not built for (4
    lanes) refuses with ``signature_mismatch``. Outputs whose shapes
    drifted from the recorded ones raise ``output_mismatch``, an integrity
    kind: the serve ladder re-raises it rather than run the drifted
    program a second time through its fallback."""
    carry, i0 = bundle.sample_args(CHUNK)
    narrow = tree_map(lambda t: t[:4].clone(), carry)
    with pytest.raises(BundleError) as err:
        bundle.call(CHUNK, (narrow, i0))
    assert err.value.kind == "signature_mismatch"
    fn, _ = contracts.REGISTRY[CHUNK].build("cpu")

    def drifted(c, i):
        out = fn(c, i)
        return out[0], tree_map(lambda t: t[:1], out[1])

    with pytest.raises(BundleError) as err:
        bundle.call(CHUNK, (carry, i0), fn=drifted)
    assert err.value.kind == "output_mismatch"
    assert err.value.kind in loader.INTEGRITY_KINDS
    calls = []

    def counted(c, i):
        calls.append(1)
        return drifted(c, i)

    with pytest.raises(BundleError) as err:
        loader.serve_entry(bundle, CHUNK, (carry, i0), fn=counted,
                           jit_fallback=counted)
    assert err.value.kind == "output_mismatch" and len(calls) == 1


def test_corrupt_object_refusal(bundle_dir, tmp_path):
    """A flipped byte in an object fails its sha256 on read: ``corrupt``."""
    path = _copy(bundle_dir, tmp_path)
    b = loader.load_bundle(path)
    ref = b.variants(CHUNK)[0]["args_sample"]
    obj = os.path.join(path, bundle_mod.OBJECTS_DIR, ref["object"])
    with open(obj, "r+b") as fh:
        byte = fh.read(1)
        fh.seek(0)
        fh.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(BundleError) as err:
        b.sample_args(CHUNK)
    assert err.value.kind == "corrupt"


def test_unreadable_and_newer_schema_refusal(tmp_path):
    d = tmp_path / "b"
    d.mkdir()
    with pytest.raises(BundleError) as err:
        loader.load_bundle(str(d))
    assert err.value.kind == "unreadable"
    (d / bundle_mod.MANIFEST_NAME).write_text("{truncated")
    with pytest.raises(BundleError) as err:
        loader.load_bundle(str(d))
    assert err.value.kind == "unreadable"
    (d / bundle_mod.MANIFEST_NAME).write_text(json.dumps(
        {"schema": bundle_mod.SCHEMA_VERSION + 1}))
    with pytest.raises(BundleError) as err:
        loader.load_bundle(str(d))
    assert err.value.kind == "schema"


# ----------------------------------------------------------------------
# Coverage.
# ----------------------------------------------------------------------

def test_coverage_diff_missing_stale_changed_and_ok(tmp_path):
    """A manifest-only bundle of the whole registry diffs ``ok`` against
    the live registry; dropping an entry is ``missing``, an entry the
    registry lacks ``stale``, an edited signature ``changed``, and a skip
    that no longer holds ``uncovered_skips``. ``check`` exits 0 and 1
    accordingly."""
    out = str(tmp_path / "manifest")
    full = bundle_mod.build_bundle(out, manifest_only=True, device="cpu")
    assert full["manifest_only"] and full["kernels"] == {}
    assert bundle_mod.coverage_diff(full, device="cpu")["ok"]
    assert cli.main(["check", out, "--device", "cpu"]) == 0

    m = json.loads(json.dumps(full))
    del m["entries"]["control.dd:control"]
    m["entries"]["control.retired:control"] = {"variants": [{"sig": "x"}]}
    m["entries"][CHUNK]["variants"][0]["sig"] = "0" * 16
    m["skipped"]["control.cadmm:control"] = "pretend"
    del m["entries"]["control.cadmm:control"]
    diff = bundle_mod.coverage_diff(m, device="cpu")
    assert diff["missing"] == ["control.dd:control"]
    assert diff["stale"] == ["control.retired:control"]
    assert [c.split(":")[0] + ":" + c.split(":")[1]
            for c in diff["changed"]] == [CHUNK]
    assert diff["uncovered_skips"][0].startswith("control.cadmm:control")
    assert not diff["ok"]
    with open(os.path.join(out, bundle_mod.MANIFEST_NAME), "w") as fh:
        json.dump(m, fh)
    assert cli.main(["check", out, "--device", "cpu"]) == 1
    with pytest.raises(BundleError) as err:
        loader.load_bundle(out).variants(CHUNK)
    assert err.value.kind == "missing_entry"


def test_registry_covers_the_jax_registry():
    """Every name of the JAX ``contracts.REGISTRY`` is in the port's, as an
    entry with a signature or a skip with a reason; the skips on the CPU
    are the kernel entries and the pods step."""
    assert set(contracts.REGISTRY) == set(jcontracts.REGISTRY)
    specs = bundle_mod.entry_specs(device="cpu")
    assert set(specs) == set(jcontracts.REGISTRY) | {bundle_mod.PROBE_ENTRY}
    skipped = {n for n, s in specs.items() if "skip" in s}
    assert skipped == {
        "ops.admm_kernel:fused_solve_pallas",
        "ops.admm_kernel:fused_solve_earlyexit_pallas",
        "parallel.ring:consensus_exchange_pallas",
        "parallel.pods:pods_control_step"}
    assert all(specs[n]["skip"] for n in skipped)
    assert all(len(s["sig"]) == 16 for s in specs.values() if "sig" in s)


# ----------------------------------------------------------------------
# Bucketing and signatures.
# ----------------------------------------------------------------------

def test_bucketed_batch_rounds_to_tile():
    """Batches round up to the tile (5 -> 8, 9 -> 16), leaves tile
    cyclically along the batch axis, the chunk offset stays alone."""
    x = torch.arange(6.0).reshape(3, 2)
    (y, i0), b = bundle_mod.bucketed_batch((x, 4), 0, 5)
    assert b == 8 and i0 == 4 and y.shape == (8, 2)
    assert torch.equal(y, x[[0, 1, 2, 0, 1, 2, 0, 1]])
    assert bundle_mod.bucketed_batch((x, 4), 0, 9)[1] == 16


def test_variant_for_batch_selection(bundle):
    assert bundle.batch_buckets(CHUNK) == [8, 16]
    assert [bundle.variant_for_batch(CHUNK, n)["batch"]
            for n in (1, 8, 9, 16, 100)] == [8, 8, 16, 16, 16]
    with pytest.raises(BundleError) as err:
        bundle.variant_for_batch(bundle_mod.PROBE_ENTRY, 4)
    assert err.value.kind == "missing_entry"


def test_abstract_signature_is_device_independent():
    """The signature reads structure, shapes and dtypes only: CPU tensors,
    host numpy and ``TensorSpec``s on the card hash alike; a shape or a
    dtype changes it."""
    _, make_args = contracts.REGISTRY[CHUNK].build("cpu")
    carry, i0 = make_args()
    sig = bundle_mod.abstract_signature((carry, i0))
    as_numpy = tree_map(lambda t: t.numpy(), carry)
    as_specs = tree_map(lambda t: TensorSpec(t.shape, t.dtype, "cuda"),
                        carry)
    assert bundle_mod.abstract_signature((as_numpy, i0)) == sig
    assert bundle_mod.abstract_signature((as_specs, i0)) == sig
    assert bundle_mod.abstract_signature((carry, i0 + 2)) == sig
    wider = tree_map(lambda t: torch.cat([t, t]), carry)
    assert bundle_mod.abstract_signature((wider, i0)) != sig
    doubled = tree_map(lambda t: t.double() if t.is_floating_point() else t,
                       carry)
    assert bundle_mod.abstract_signature((doubled, i0)) != sig


# ----------------------------------------------------------------------
# The serve ladder.
# ----------------------------------------------------------------------

class _Sink:
    def __init__(self):
        self.rows = []

    def emit(self, event, **kw):
        self.rows.append((event, kw))

    def append(self, row):
        self.rows.append((row["event"], row))


def test_serve_ladder_rungs_and_events(bundle, bundle_dir, tmp_path,
                                       monkeypatch):
    """``bundle_exec`` on a covered call; a coverage miss falls through to
    the fallback (``eager_cached`` in a process that ran no nvcc,
    ``eager_cold`` in one that did), its ``tried`` naming the miss;
    without a fallback the miss raises and journals an ``error`` row; an
    integrity failure raises despite a fallback."""
    fn, _ = contracts.REGISTRY[CHUNK].build("cpu")
    sink, journal = _Sink(), _Sink()
    args = bundle.sample_args(CHUNK)
    out, rung = loader.serve_entry(bundle, CHUNK, args, fn=fn,
                                   jit_fallback=fn, metrics=sink,
                                   journal=journal, label="L")
    assert rung == loader.RUNG_EXEC
    event = sink.rows[-1][1]
    assert sink.rows[-1][0] == "aot_serve"
    assert set(event) == {"entry", "rung", "label", "wall_s"}
    assert (event["entry"], event["rung"], event["label"]) == (
        CHUNK, "bundle_exec", "L")
    assert journal.rows[-1][1]["event"] == "aot_serve"

    carry, i0 = args
    narrow = (tree_map(lambda t: t[:4].clone(), carry), i0)
    out, rung = loader.serve_entry(bundle, CHUNK, narrow, jit_fallback=fn,
                                   metrics=sink)
    assert rung == loader.RUNG_EAGER_CACHED
    assert sink.rows[-1][1]["tried"] == ["bundle[signature_mismatch]"]
    _bitwise(out, fn(*narrow))
    monkeypatch.setattr(_build, "_NVCC_BUILDS", 1)
    assert loader.serve_entry(bundle, CHUNK, narrow, jit_fallback=fn)[1] \
        == loader.RUNG_EAGER_COLD
    monkeypatch.setattr(_build, "_NVCC_BUILDS", 0)
    with pytest.raises(BundleError):
        loader.serve_entry(bundle, CHUNK, narrow, metrics=sink)
    assert sink.rows[-1][1]["rung"] == "error"
    assert "signature_mismatch" in sink.rows[-1][1]["error"]

    path = _copy(bundle_dir, tmp_path)
    broken = loader.load_bundle(path)
    ref = broken.variants(CHUNK)[0]["out_treedef"]
    with open(os.path.join(path, bundle_mod.OBJECTS_DIR, ref["object"]),
              "ab") as fh:
        fh.write(b"rot")
    with pytest.raises(BundleError) as err:
        loader.serve_entry(broken, CHUNK, args, jit_fallback=fn,
                           metrics=sink)
    assert err.value.kind == "corrupt"
    assert sink.rows[-1][1]["rung"] == "error"


def test_kernel_library_install(bundle_dir, tmp_path, monkeypatch):
    """Every kernel library a bundle carries is installed into the build
    directory, under the name the live sources give it, before the bundle
    rung's first call; after it ``_build.build()`` compiles nothing. A
    library of other sources (or other than the one the process loaded)
    is refused as ``bundle_stale`` and never written; a card bundle that
    lacks a library is ``exec_unavailable`` before any call."""
    monkeypatch.setenv("TAT_TORCH_BUILD_DIR", str(tmp_path / "kernels"))
    path = _copy(bundle_dir, tmp_path)
    payloads = {n: f"prebuilt {n}".encode() for n in _build.KERNELS}
    refs = {n: {**bundle_mod._write_object(path, p),
                "digest": _build.source_digest(n)}
            for n, p in payloads.items()}
    manifest = os.path.join(path, bundle_mod.MANIFEST_NAME)
    with open(manifest) as fh:
        m = json.load(fh)

    def load_with(kernels):
        m["kernels"] = kernels
        with open(manifest, "w") as fh:
            json.dump(m, fh)
        return loader.load_bundle(path)

    b = load_with(refs)
    before = _build.nvcc_builds()
    assert loader.call_probe(b, device="cpu") == 128.0 * 128 * 128
    assert sorted(os.listdir(_build.build_dir())) == sorted(
        os.path.basename(_build.library_path(n)) for n in _build.KERNELS)
    for n, payload in payloads.items():
        with open(_build.library_path(n), "rb") as fh:
            assert fh.read() == payload
    assert b.install_kernels() == {n: "installed" for n in _build.KERNELS}
    assert _build.build() == {} and _build.nvcc_builds() == before

    monkeypatch.setenv("TAT_TORCH_BUILD_DIR", str(tmp_path / "stale"))
    b = load_with({**refs, "admm_chunk": {**refs["admm_chunk"],
                                          "digest": "0" * 16}})
    with pytest.raises(BundleError) as err:
        loader.call_probe(b, device="cpu")
    assert err.value.kind == "bundle_stale"
    assert not os.path.exists(_build.library_path("admm_chunk"))
    monkeypatch.setitem(_build._LOADED, "ring_sum", "f" * 16)
    with pytest.raises(_build.StaleLibrary):
        _build.install("ring_sum", payloads["ring_sum"],
                       _build.source_digest("ring_sum"))

    m["platform"] = m["fingerprint"]["platform"] = "cuda"
    b = load_with({n: r for n, r in refs.items() if n != "admm_chunk"})
    monkeypatch.setattr(loader, "runtime_fingerprint",
                        lambda platform: m["fingerprint"])
    with pytest.raises(BundleError) as err:
        b.check_runtime("cuda")
    assert err.value.kind == "exec_unavailable"
    assert "admm_chunk" in err.value.detail


# ----------------------------------------------------------------------
# The bundled server, the probe, the tools.
# ----------------------------------------------------------------------

def _stream(n=12, families=("cadmm4",)):
    rng = np.random.default_rng(0)
    return [ScenarioRequest(
        family=families[i % len(families)],
        horizon=2 * int(rng.integers(1, 4)),
        x0=tuple(float(v) for v in rng.normal(0.0, 1.0, 3)),
        v0=tuple(float(v) for v in rng.normal(0.0, 0.2, 3)),
        request_id=f"q{i:02d}") for i in range(n)]


@pytest.mark.parametrize("surgery", ["host", "device"])
def test_bundled_server_bitwise_the_eager_server(bundle, tmp_path, surgery):
    """``ScenarioServer(bundle=, require_bundle=True)`` on a seeded stream:
    every chunk (and device lane surgery) served ``bundle_exec``, the
    template carries from the bundle, results bitwise the bundle-less
    server's; ``centralized4``, which the bundle does not cover, is
    rejected at admission."""
    stream = _stream(12)
    ref_srv = server_mod.ScenarioServer(
        families=("cadmm4",), buckets=BUCKETS, device="cpu",
        surgery=surgery)
    ref = [ref_srv.submit(r) for r in stream]
    ref_srv.run_until_drained()
    metrics = str(tmp_path / "m.jsonl")
    srv = server_mod.ScenarioServer(
        families=("cadmm4", "centralized4"), buckets=(4,), device="cpu",
        bundle=bundle, require_bundle=True, metrics=metrics,
        surgery=surgery)
    got = [srv.submit(r) for r in stream]
    refused = srv.submit(_stream(2, ("centralized4",))[1])
    srv.run_until_drained()
    assert (refused.status, refused.reason) == (
        queue_mod.REJECTED, queue_mod.REASON_NO_COVERAGE)
    assert [t.status for t in got] == ["completed"] * len(stream)
    for a, b in zip(ref, got):
        _bitwise(a.result, b.result)
    rows = [e for e in export.read_events(metrics)
            if e["event"] == "aot_serve"]
    assert {e["rung"] for e in rows} == {"bundle_exec"}
    entries = {e["entry"] for e in rows}
    assert entries == ({CHUNK, SURGERY} if surgery == "device" else {CHUNK})
    fam = srv.families["cadmm4"]
    _bitwise(fam.template_carry_host(),
             ref_srv.families["cadmm4"].template_carry_host())


def test_bundled_server_requires_the_template(bundle_dir, tmp_path):
    """Under ``require_bundle`` a covered family whose ``args_sample``
    cannot be read raises at construction (its state factories would run
    unseen); without ``require_bundle`` the family keeps its own."""
    path = _copy(bundle_dir, tmp_path)
    ref = loader.load_bundle(path).variants(CHUNK)[0]["args_sample"]
    os.remove(os.path.join(path, bundle_mod.OBJECTS_DIR, ref["object"]))
    with pytest.raises(BundleError) as err:
        server_mod.ScenarioServer(families=("cadmm4",), device="cpu",
                                  bundle=path, require_bundle=True)
    assert err.value.kind == "unreadable"
    srv = server_mod.ScenarioServer(families=("cadmm4",), device="cpu",
                                    bundle=path)
    assert srv._family_buckets(srv.families["cadmm4"]) == (8, 16, 32)


def test_probe_subprocess_prefers_bundle(bundle_dir):
    """The child runs the bundle's probe entry (note ``bundle``); a
    missing bundle falls back to the plain probe, noted
    ``bundle_fallback:unreadable``, and the probe still passes."""
    notes, info = [], {}
    ok, detail = backend.probe_subprocess(
        timeout_s=120, device="cpu", bundle_dir=bundle_dir, notes=notes,
        info=info)
    assert ok and detail == "cpu" and notes == ["bundle"], (detail, notes)
    assert info["probe"] == {"ring_sum": 0, "nvcc_builds": 0}
    notes = []
    ok, _ = backend.probe_subprocess(
        timeout_s=120, device="cpu", env={**os.environ,
                                          backend.BUNDLE_ENV: "/nowhere"},
        notes=notes)
    assert ok and notes[0].startswith("bundle_fallback:unreadable:")


def test_probe_subprocess_fails_on_a_wrong_ring_sum(bundle_dir, tmp_path):
    """A bundled probe whose ring sum is not ``x.sum(0)`` fails the probe:
    only a bundle problem (a ``BundleError``) falls back to the plain
    probe. The child's ring sum is made wrong by a ``sitecustomize``
    module on its path."""
    (tmp_path / "sitecustomize.py").write_text(
        "import sys\n"
        f"sys.path.insert(0, {backend._REPO_DIR!r})\n"
        "from tpu_aerial_transport_torch.parallel import ring\n"
        "_plain = ring.ring_sum_shards_reference\n"
        "ring.ring_sum_shards_reference = lambda x: _plain(x) + 1\n")
    path = os.pathsep.join(
        p for p in (str(tmp_path), os.environ.get("PYTHONPATH")) if p)
    notes = []
    ok, detail = backend.probe_subprocess(
        timeout_s=120, device="cpu", bundle_dir=bundle_dir, notes=notes,
        env={**os.environ, "PYTHONPATH": path})
    assert not ok and notes == [], (detail, notes)
    assert "ring sum differs from x.sum(0)" in detail, detail


def test_cli_serve_and_bundled_example(bundle_dir, capsys):
    """``aot_bundle serve --mode bundled --expect-zero-compile`` on the CPU
    (rung ``bundle_exec``, no nvcc build), and ``serve_scenarios --bundle
    --require-bundle --expect-zero-compile`` exits 0 with every request
    of the covered family completed."""
    assert cli.main(["serve", "--entry", CHUNK, "--mode", "bundled",
                     "--bundle", bundle_dir, "--device", "cpu",
                     "--expect-zero-compile"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (row["rung"], row["nvcc_builds"]) == ("bundle_exec", 0)
    build_dir = os.environ.get("TAT_TORCH_BUILD_DIR")
    assert cli.main(["serve", "--entry", CHUNK, "--mode", "cold",
                     "--device", "cpu"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["rung"] == "eager_cached"
    assert os.environ.get("TAT_TORCH_BUILD_DIR") == build_dir
    assert serve_scenarios.main([
        "--requests", "8", "--families", "cadmm4", "--buckets", "8",
        "--bundle", bundle_dir, "--require-bundle", "--expect-zero-compile",
        "--device", "cpu"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (row["mode"], row["completed"], row["nvcc_builds"]) == (
        "bundled", 8, 0)


# ----------------------------------------------------------------------
# Parity with the JAX package.
# ----------------------------------------------------------------------

def _port_carry(jcarry, family):
    state = convert.rqp_state(jax.tree.map(np.asarray, jcarry[0]), "cpu")
    to_cs = convert.cadmm_state if family == "cadmm4" else convert.ctrl_state
    return (state, to_cs(jax.tree.map(np.asarray, jcarry[1]), "cpu"))


@pytest.mark.parametrize("family,entry", [
    ("cadmm4", CHUNK),
    ("centralized4", "serving.batcher:serving_chunk_centralized")])
def test_serving_entry_matches_jax(family, entry):
    """The port's serving-chunk builder's ``make_args`` equals the JAX
    builder's leaf by leaf (within 1e-6, relative above magnitude 1: the
    equilibrium warm starts, about 5.45 N, differ by a few float32 ulps
    between the two packages' closed forms), and one chunk of the port's
    entry on the JAX inputs agrees with ``jax.jit`` of the JAX entry:
    states within 1e-4, forces within 1e-2 N."""
    jfn, jmake = jcontracts.REGISTRY[entry].build()
    fn, make_args = contracts.REGISTRY[entry].build("cpu")
    jargs, (carry, i0) = jmake(), make_args()
    assert int(jargs[1]) == i0
    conv = _port_carry(jargs[0], family)
    for a, b in zip(leaves(carry), leaves(conv)):
        assert a.shape == b.shape and a.dtype == b.dtype
        a, b = a.double().numpy(), b.double().numpy()
        assert (np.abs(a - b) <= ARGS_BAR * np.maximum(1.0, np.abs(b))).all()
    jout = jax.jit(jfn)(*jargs)
    out = fn(conv, i0)
    ref = _port_carry(jout[0], family)
    for k in ("R", "w", "xl", "vl", "Rl", "wl"):
        np.testing.assert_allclose(getattr(out[0][0], k).numpy(),
                                   getattr(ref[0], k).numpy(), rtol=0,
                                   atol=STATE_BAR, err_msg=k)
    f = "f" if family == "cadmm4" else "prev_f"
    np.testing.assert_allclose(getattr(out[0][1], f).numpy(),
                               getattr(ref[1], f).numpy(), rtol=0,
                               atol=FORCE_BAR)
