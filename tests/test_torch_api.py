"""The port's public surface against the JAX package's, read from source.

Both trees are parsed with ``ast`` only: nothing of ``srtb_tpu`` is
imported here (reading its text is not an import), and nothing of the
port either, so the audit needs neither JAX nor a card.  It holds:

- every module of ``srtb_tpu/`` has a module at the same path under
  ``srtb_tpu_torch/``, or stands in ``MODULE_EXEMPT`` with its reason;
- every public top-level function and class of a reference module, and
  every public method of a public class, exists in the port's module
  (a method may be inherited there, or be an attribute the class sets),
  or stands in ``EXEMPT`` with its kind and reason;
- every named parameter of such a function or method is a parameter of
  the port's (or the port's takes ``**kwargs``), or stands in
  ``PARAM_EXEMPT`` with its kind and reason;
- every name a reference package's ``__init__`` imports or lists in
  ``__all__`` is bound by the port package's ``__init__``;
- no exemption is stale (its name exists in the port, or no longer in
  the reference) and none lacks a reason.

Kinds of exemption: ``tpu``, the JAX package's or the TPU's own;
``renamed``, the port computes the same thing under the name given
(which must exist; for a parameter, the port's parameter of that name);
``helper``, a test or soak helper of the JAX package
that the port's design replaces.

Run: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_api.py -q``.
"""

from __future__ import annotations

import ast
import functools
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF = REPO / "srtb_tpu"
PORT = REPO / "srtb_tpu_torch"

KINDS = ("tpu", "renamed", "helper")

# reference modules without a port module (ROADMAP §A): (kind, reason)
MODULE_EXEMPT = {
    "analysis/hlo_audit.py": (
        "tpu", "audits the HLO that JAX lowers for each plan"),
    "analysis/rules/donate.py": ("tpu", "lint rule on JAX's buffer donation"),
    "analysis/rules/dtype_drift.py": (
        "tpu", "lint rule on JAX's dtype promotion in traced code"),
    "analysis/rules/host_callback.py": (
        "tpu", "lint rule on host callbacks inside jax.jit"),
    "analysis/rules/host_sync.py": (
        "tpu", "lint rule on host syncs of JAX arrays in the hot path"),
    "analysis/rules/recompile.py": ("tpu", "lint rule on jax.jit retraces"),
    "ops/df64.py": (
        "tpu", "the TPU's emulated float64; K2 and B3 take the chirp's "
               "phase in native float64"),
    "ops/mxu_fft.py": (
        "tpu", "DFT matmuls on the TPU's matrix unit; fft_strategy mxu "
               "resolves to cuFFT"),
    "ops/pallas_fft.py": (
        "tpu", "Pallas kernels, ported as csrc/ (kernels.KERNELS)"),
    "ops/pallas_fft2.py": (
        "tpu", "Pallas kernels, ported as csrc/ (kernels.KERNELS)"),
    "ops/pallas_kernels.py": (
        "tpu", "Pallas kernels, ported as csrc/ (kernels.KERNELS)"),
    "parallel/compat.py": ("tpu", "shard_map's import across JAX versions"),
    "tools/pallas2_probe.py": ("tpu", "probes Mosaic's lowering limits"),
    "tools/plan_audit.py": (
        "tpu", "runs analysis/hlo_audit.py over analysis/plan_cards.json"),
    "tools/queue_decisions.py": (
        "tpu", "the decisions of the TPU queue scripts"),
    "utils/compile_cache.py": (
        "tpu", "JAX's persistent compilation cache; the port's "
               "compiled-kernel cache is utils/aot_cache.py"),
    "utils/platform.py": (
        "tpu", "which JAX backend runs; the port's device is "
               "utils/device.resolve_device"),
}

_REGISTRY = ("tpu", "the registry's families of jitted programs (AOT "
                    "lowering and the HLO audit); the port keeps the plan "
                    "names, ladder steps and cache keys")
_ORACLE = ("helper", "a numpy oracle of the JAX package's tests; the "
                     "port's tests hold the port against the reference "
                     "itself (tests/test_torch_ref.py)")
_XPLANE = ("tpu", "reads XLA's xplane protobufs; the port's trace_summary "
                  "reads torch.profiler's traces (find_traces)")
_JAX_AOT = ("tpu", "JAX's serialized executables; the port's cache holds "
                   "the kernel library (AotPlanCache.get_or_build)")

# "module:Name" or "module:Class.method" -> (kind, reason), or
# ("renamed", reason, "Name" or "Class.attr" in the same port module)
EXEMPT = {
    "analysis/sanitizer.py:expire_donated": (
        "tpu", "JAX's buffer donation; the port never donates"),
    "ops/dedisperse.py:chirp_factor_df64": (
        "tpu", "the chirp in the TPU's emulated float64; chirp_factor "
               "takes the phase in native float64"),
    "ops/dedisperse.py:chirp_factor_df64_ri": (
        "tpu", "the df64 chirp as the TPU programs' [re, im] planes"),
    "ops/dedisperse.py:anchored_chirp_consts": (
        "tpu", "the anchor constants of the df64 chirp"),
    "ops/dedisperse.py:chirp_factor_host_ri": (
        "tpu", "the host chirp in the stacked [2, ...] boundary form of "
               "the TPU programs; the port's tensors are complex64"),
    "ops/detect.py:detect_oracle": _ORACLE,
    "ops/unpack.py:unpack_oracle": _ORACLE,
    "pipeline/registry.py:PlanFamily": _REGISTRY,
    "pipeline/registry.py:family": _REGISTRY,
    "pipeline/registry.py:plan_families": _REGISTRY,
    "pipeline/registry.py:plan_keys": _REGISTRY,
    "pipeline/registry.py:register_family": _REGISTRY,
    "pipeline/registry.py:temp_family": _REGISTRY,
    "pipeline/segment.py:waterfall_to_numpy": (
        "tpu", "the stacked [2, S, F, T] (re, im) boundary form; the "
               "port's waterfall is complex64 (writers.to_host)"),
    "pipeline/segment.py:SegmentProcessor.lowerables": (
        "tpu", "the plan's jitted programs, lowerable without a device, "
               "for the HLO audit and JAX's AOT"),
    "pipeline/segment.py:SegmentProcessor.release_staging": (
        "tpu", "returns the pooled host copies jax.device_put needed; "
               "the port uploads the reader's pinned buffer itself "
               "(stage_input refuses other input) and copies nothing"),
    "pipeline/segment.py:SegmentProcessor.data_stream_count": (
        "renamed", "the packet format's stream count",
        "SegmentProcessor.streams"),
    "pipeline/segment.py:SegmentProcessor.run_device_cold": (
        "renamed", "the ring's cold step is run_device_ring(raw, "
                   "warm=False)", "SegmentProcessor.run_device_ring"),
    "tools/crash_soak.py:make_resumable_source": (
        "helper", "the port's soak children set "
                  "Config.deterministic_timestamps and let Pipeline build "
                  "its checkpoint-aware source"),
    "tools/fleet_soak.py:make_deterministic_source": (
        "helper", "the port's fleet soak sets "
                  "Config.deterministic_timestamps "
                  "(file_input.DeterministicTimestampReader)"),
    "tools/trace_summary.py:find_xplanes": _XPLANE,
    "tools/trace_summary.py:parse_xspace": _XPLANE,
    "utils/aot_cache.py:cpu_allowed": (
        "tpu", "lets JAX's AOT executables run on the CPU "
               "(SRTB_AOT_ALLOW_CPU); the port's cache is off on the CPU"),
    "utils/aot_cache.py:AotPlanCache.get_or_compile": _JAX_AOT,
    "utils/aot_cache.py:AotPlanCache.save": _JAX_AOT,
}

_DONATE = ("tpu", "JAX's buffer donation; the port never donates")
_LEN_CAP = ("tpu", "the longest row the TPU's row FFT takes before the "
                   "four-step recursion; this C2C is one torch.fft call at "
                   "any length")
_PREMUL = ("tpu", "a chirp bank precombined with the Hermitian twiddle; "
                  "the port keeps no bank: K2 and B3 make each chirp from "
                  "its float64 phase")
_SUBBYTE = ("tpu", "the reference unpacks (and windows) the bytes inside "
                   "the FFT's program for XLA to fuse; the port's "
                   "rfft_subbyte takes the packed planes z that B13 "
                   "(unpack_subbyte_planes_window) makes")
_WF_RI = ("renamed", "the waterfall is complex64, not the stacked "
                     "[2, ...] (re, im) form", "wf")

# "module:Name:param" or "module:Class.method:param" -> (kind, reason), or
# ("renamed", reason, "param" of the same port function)
PARAM_EXEMPT = {
    "gui/waterfall.py:WaterfallRenderer.render:wf_ri": _WF_RI,
    "gui/waterfall.py:WaterfallService.push:wf_ri": _WF_RI,
    "io/synth.py:make_dispersed_baseband:seed": (
        "renamed", "the noise is drawn on the device from a "
                   "torch.Generator (make_dispersed_baseband_host takes "
                   "the reference's seed and numpy stream)", "generator"),
    "ops/fft.py:c2c_forward:axis": (
        "renamed", "torch's name for the axis", "dim"),
    "ops/fft.py:c2c_backward:axis": (
        "renamed", "torch's name for the axis", "dim"),
    "ops/fft.py:waterfall_c2c:len_cap": _LEN_CAP,
    "ops/fft.py:ifft_refft_waterfall:len_cap": _LEN_CAP,
    "ops/fft.py:rfft_via_c2c:premul": _PREMUL,
    "ops/fft.py:hermitian_rfft_post:premul": _PREMUL,
    "ops/fft.py:rfft_subbyte:premul": _PREMUL,
    "ops/fft.py:finish_rfft_subbyte:premul": _PREMUL,
    "ops/fft.py:segment_rfft:premul": _PREMUL,
    "ops/fft.py:rfft_subbyte:data": _SUBBYTE,
    "ops/fft.py:rfft_subbyte:nbits": _SUBBYTE,
    "ops/fft.py:rfft_subbyte:planes": _SUBBYTE,
    "ops/fft.py:rfft_subbyte:window_planes": _SUBBYTE,
    "parallel/distributed.py:hybrid_dm_seq_mesh:devices": (
        "tpu", "JAX's device list; the port's mesh is over "
               "torch.distributed ranks, grouped by host by "
               "local_world_size"),
    "parallel/dm_grid.py:build_chirp_bank:mesh": (
        "tpu", "shards the bank over the mesh's dm axis; the port's "
               "trials run on one card and B3 makes each chirp"),
    "parallel/dm_grid.py:build_chirp_bank:on_device": (
        "tpu", "the bank in the TPU's emulated float64 on the device; the "
               "port's bank stays the host's, for the tests"),
    "parallel/dm_grid.py:build_chirp_bank:exact": (
        "tpu", "the df64 bank's per-element division chains"),
    "parallel/dm_grid.py:dm_trial_search:spectrum_ri": (
        "renamed", "the spectrum is complex64, not the stacked (re, im) "
                   "form", "spectrum"),
    "parallel/dm_grid.py:dm_trial_search:chirp_bank": (
        "tpu", "the sharded bank; B3 makes each trial's chirp from "
               "f_min, df, f_c and the trial's DM"),
    "parallel/dm_grid.py:dm_trial_search:mesh": (
        "tpu", "shard_map over the mesh's dm axis; the port's trials run "
               "one after the other on one card"),
    "parallel/dm_grid.py:dm_trial_search:len_cap": _LEN_CAP,
    "pipeline/fleet.py:SharedPlanCache.get:donate_input": _DONATE,
    "pipeline/segment.py:SegmentProcessor.plan_cache_key:donate_input":
        _DONATE,
    "pipeline/segment.py:SegmentProcessor.enable_aot:allow_cpu": (
        "tpu", "lets JAX's AOT executables run on the CPU; the port's "
               "cache is off on the CPU"),
    "pipeline/segment.py:SegmentProcessor.stack_batch:stride_only": (
        "tpu", "the strides stacked on the host for one device_put; the "
               "port's warm batch uploads them behind the carry "
               "(stage_batch(raws, carry))"),
    "pipeline/segment.py:SegmentProcessor.stage_input:stride_only": (
        "renamed", "the warm upload: given the carry, only "
                   "raw[reserved_bytes:] crosses to the device", "carry"),
    "pipeline/segment.py:SegmentProcessor.run_device_ring:carry": (
        "tpu", "the carry donated into the program; the port's "
               "stage_input copies it into the staged segment's head"),
    "pipeline/segment.py:SegmentProcessor.run_device_ring:new": (
        "renamed", "the staged segment, the stride's new bytes behind "
                   "the carry", "raw"),
    "tools/trace_summary.py:bucket:category": (
        "tpu", "the hlo_category stat of XLA's xplane events; "
               "torch.profiler's events carry none"),
}


def _modules(root: Path) -> list[str]:
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*.py"))


@functools.cache
def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _top_statements(body):
    """Top-level statements, the bodies of top-level ``if`` and ``try``
    blocks included."""
    for node in body:
        if isinstance(node, (ast.If, ast.Try)):
            for part in (node.body, node.orelse,
                         getattr(node, "finalbody", []),
                         *[h.body for h in getattr(node, "handlers", [])]):
                yield from _top_statements(part)
        else:
            yield node


def _targets(node) -> list:
    if isinstance(node, ast.Assign):
        return node.targets
    if isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        return [node.target]
    return []


def _bound(tree: ast.Module) -> set[str]:
    """Names a module binds at its top level: definitions, assignments,
    imports."""
    names = set()
    for node in _top_statements(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        for t in _targets(node):
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    names.add(n.id)
    return names


def _all(tree: ast.Module) -> set[str]:
    """The strings of a module's ``__all__``."""
    for node in _top_statements(tree.body):
        if any(isinstance(t, ast.Name) and t.id == "__all__"
               for t in _targets(node)) and node.value is not None:
            return {e.value for e in ast.walk(node.value)
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)}
    return set()


def _public(tree: ast.Module) -> dict[str, list[str]]:
    """Public top-level functions and classes -> each class's public
    methods (properties included)."""
    out = {}
    for node in tree.body:
        if getattr(node, "name", "_").startswith("_"):
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = []
        elif isinstance(node, ast.ClassDef):
            out[node.name] = [
                n.name for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                and not n.name.startswith("_")]
    return out


def _class(tree: ast.Module, name: str) -> ast.ClassDef | None:
    for node in _top_statements(tree.body):
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


def _imported_from(tree: ast.Module, name: str) -> Path | None:
    """The port module a name was imported from, if it was."""
    for node in _top_statements(tree.body):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("srtb_tpu_torch."):
            for a in node.names:
                if (a.asname or a.name) == name:
                    path = REPO / (node.module.replace(".", "/") + ".py")
                    return path if path.exists() else None
    return None


def _members(path: Path, cls: str, depth: int = 0) -> set[str]:
    """What instances of the port's class ``cls`` (in ``path``) carry:
    its methods and class attributes, the ``self.<name>`` it assigns,
    and the same of its bases, where they are the port's own."""
    tree = _tree(path)
    node = _class(tree, cls)
    if node is None:
        src = _imported_from(tree, cls)
        return _members(src, cls, depth + 1) if src and depth < 8 else set()
    out = set(_bound(ast.Module(body=node.body, type_ignores=[])))
    for n in ast.walk(node):
        for t in _targets(n):
            if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                    and t.value.id == "self":
                out.add(t.attr)
    for base in node.bases:
        if isinstance(base, ast.Name) and depth < 8:
            out |= _members(path, base.id, depth + 1)
    return out


def _port_has(mod: str, name: str) -> bool:
    """Whether the port's module ``mod`` carries ``name`` ("Name" or
    "Class.attr")."""
    path = PORT / mod
    if not path.exists():
        return False
    cls, _, attr = name.partition(".")
    if not attr:
        return name in _bound(_tree(path))
    return attr in _members(path, cls)


@functools.cache
def _ref_names() -> list[tuple[str, str]]:
    """(module, "Name" or "Class.method") for every public name of every
    reference module."""
    out = []
    for mod in _modules(REF):
        for name, methods in _public(_tree(REF / mod)).items():
            out.append((mod, name))
            out += [(mod, f"{name}.{m}") for m in methods]
    return out


_FUNC = (ast.FunctionDef, ast.AsyncFunctionDef)


def _def(path: Path, name: str, depth: int = 0):
    """The ``def`` of ``name`` ("Name" or "Class.method") in ``path``,
    through the port's base classes and imports, or None (an attribute,
    or a class)."""
    tree = _tree(path)
    cls, _, attr = name.partition(".")
    for node in _top_statements(tree.body):
        if not attr and isinstance(node, _FUNC) and node.name == cls:
            return node
        if attr and isinstance(node, ast.ClassDef) and node.name == cls:
            for n in node.body:
                if isinstance(n, _FUNC) and n.name == attr:
                    return n
            for base in node.bases:
                if isinstance(base, ast.Name) and depth < 8:
                    found = _def(path, f"{base.id}.{attr}", depth + 1)
                    if found is not None:
                        return found
            return None
    src = _imported_from(tree, cls)
    return _def(src, name, depth + 1) if src and depth < 8 else None


def _params(fn) -> set[str]:
    """A def's named parameters, ``self`` and ``cls`` left out."""
    a = fn.args
    return {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs} - \
        {"self", "cls"}


@functools.cache
def _param_gaps() -> dict[str, set[str]]:
    """"module:Name" -> the reference's parameters the port's def lacks,
    for every ported name both trees define by ``def``."""
    out = {}
    for mod, name in _ref_names():
        if mod in MODULE_EXEMPT or f"{mod}:{name}" in EXEMPT:
            continue
        ref, port = _def(REF / mod, name), _def(PORT / mod, name)
        if ref is None or port is None or port.args.kwarg is not None:
            continue
        gap = _params(ref) - _params(port)
        if gap:
            out[f"{mod}:{name}"] = gap
    return out

def _packages(root: Path) -> list[str]:
    return sorted(p.parent.relative_to(root).as_posix()
                  for p in root.rglob("__init__.py"))


def _exports(init: Path) -> set[str]:
    """Names a package's ``__init__`` binds by import, and its
    ``__all__``."""
    tree = _tree(init)
    names = _all(tree)
    for node in _top_statements(tree.body):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return names


# ------------------------------------------------------------------ tests

def test_the_trees_are_read():
    """The audit sees both trees (a wrong root would pass vacuously)."""
    assert len(_modules(REF)) >= 100 and len(_modules(PORT)) >= 100
    assert len(_ref_names()) >= 700


def test_every_reference_module_has_a_port_module():
    missing = [m for m in _modules(REF)
               if not (PORT / m).exists() and m not in MODULE_EXEMPT]
    assert missing == []


@pytest.mark.parametrize("mod", sorted(MODULE_EXEMPT))
def test_module_exemption_is_current(mod):
    kind, reason = MODULE_EXEMPT[mod]
    assert kind in KINDS and reason.strip()
    assert (REF / mod).exists(), f"{mod} is gone from the reference"
    assert not (PORT / mod).exists(), f"{mod} is ported: drop the entry"


def test_every_public_name_has_a_counterpart():
    """Every public function, class and method of a ported module exists
    in the port's module, or is exempt."""
    missing = [f"{mod}:{name}" for mod, name in _ref_names()
               if mod not in MODULE_EXEMPT and f"{mod}:{name}" not in EXEMPT
               and not _port_has(mod, name)]
    assert missing == []


@pytest.mark.parametrize("key", sorted(EXEMPT))
def test_exemption_is_current(key):
    """An entry names a reference name the port lacks, with a known kind
    and a reason; a ``renamed`` entry's port name exists."""
    entry = EXEMPT[key]
    kind, reason = entry[0], entry[1]
    assert kind in KINDS, kind
    assert reason.strip(), f"{key}: no reason"
    assert (len(entry) == 3) == (kind == "renamed"), key
    mod, name = key.split(":")
    assert (mod, name) in _ref_names(), f"{key} is gone from the reference"
    assert not _port_has(mod, name), f"{key} exists in the port: drop it"
    if kind == "renamed":
        assert _port_has(mod, entry[2]), f"{key}: no {entry[2]} in the port"


def test_every_parameter_has_a_counterpart():
    """A caller passing the reference's keyword reaches the port's
    parameter of that name, or the difference is exempt."""
    missing = [f"{key}:{p}" for key, gap in _param_gaps().items()
               for p in sorted(gap) if f"{key}:{p}" not in PARAM_EXEMPT]
    assert missing == []


@pytest.mark.parametrize("key", sorted(PARAM_EXEMPT))
def test_param_exemption_is_current(key):
    """An entry names a parameter of the reference's def that the port's
    lacks, with a known kind and a reason; a ``renamed`` entry's
    parameter is the port's."""
    entry = PARAM_EXEMPT[key]
    kind, reason = entry[0], entry[1]
    assert kind in KINDS, kind
    assert reason.strip(), f"{key}: no reason"
    assert (len(entry) == 3) == (kind == "renamed"), key
    mod, name, param = key.split(":")
    ref = _def(REF / mod, name)
    assert ref is not None and param in _params(ref), \
        f"{key} is gone from the reference"
    assert param in _param_gaps().get(f"{mod}:{name}", set()), \
        f"{key} exists in the port: drop it"
    if kind == "renamed":
        assert entry[2] in _params(_def(PORT / mod, name)), \
            f"{key}: no parameter {entry[2]} in the port"

@pytest.mark.parametrize("pkg", _packages(REF))
def test_package_exports(pkg):
    """What a reference package's ``__init__`` imports (or lists in
    ``__all__``) the port's binds, but modules exempt above."""
    port_init = PORT / pkg / "__init__.py"
    assert port_init.exists()
    exempt = {Path(m).stem for m in MODULE_EXEMPT
              if Path(m).parent.as_posix() == pkg}
    ref = _exports(REF / pkg / "__init__.py") - exempt - {"annotations"}
    port = _exports(port_init)
    assert sorted(ref - port) == []
    # a name the port lists in __all__ is bound or is a submodule
    tree = _tree(port_init)
    for name in _all(tree):
        assert name in _bound(tree) or (PORT / pkg / f"{name}.py").exists()


def test_the_audit_catches_a_gap(tmp_path):
    """The checks fail where they should: a missing method, a method
    inherited from a port base class, a stale entry."""
    mod = tmp_path / "m.py"
    mod.write_text("class Base:\n    def run(self): ...\n\n"
                   "class Kid(Base):\n    def __init__(self):\n"
                   "        self.streams = 2\n")
    assert _members(mod, "Kid") >= {"run", "streams", "__init__"}
    assert "missing" not in _members(mod, "Kid")
    assert not _port_has("no/such/module.py", "f")
    assert _port_has("utils/termination.py", "report_wedged")
    assert not _port_has("utils/termination.py", "report_wedged_twice")
    assert _port_has("io/udp.py", "AsyncioBlockReceiver.close")  # inherited
    assert _params(_def(PORT / "ops/fft.py", "c2c_forward")) == {"x", "dim"}
    assert _param_gaps()["ops/fft.py:c2c_forward"] == {"axis"}
    assert _def(PORT / "io/udp.py", "AsyncioBlockReceiver.close")
