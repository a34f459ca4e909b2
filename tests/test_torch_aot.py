"""The port's compiled-kernel cache (``srtb_tpu_torch/utils/aot_cache.py``
behind ``aot_plan_path``; ROADMAP A9d), case for case with the JAX
package's ``tests/test_aot_cache.py`` and ``test_perf_obs.py``'s cache
counters.  The CPU tests have no ``nvcc``, so the cache runs with a
builder and a loader of the test's own (the card's twin at the end
builds for real):
the keying (a changed plan misses, deployment-local settings do not, as
the reference's ``plan_signature`` decides: held to the reference through
``tests/test_torch_ref.py``'s runner), a miss then a hit with the
reference's counters, a corrupt entry that rebuilds instead of raising,
an atomic save, and the CPU policy (off: nothing built or written)."""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.pipeline.segment import SegmentProcessor
from srtb_tpu_torch.utils import aot_cache as A
from srtb_tpu_torch.utils.metrics import metrics
from test_torch_ref import run_reference

MAGIC = b"SRTB-KERNELS\n"


def _cfg(tmp_path, n=1 << 14, **kw):
    return Config(
        baseband_input_count=n,
        baseband_input_bits=2,
        baseband_format_type="simple",
        baseband_freq_low=1405.0,
        baseband_bandwidth=64.0,
        baseband_sample_rate=128e6,
        dm=30.0,
        spectrum_channel_count=1 << 6,
        signal_detect_max_boxcar_length=16,
        mitigate_rfi_average_method_threshold=1e9,
        mitigate_rfi_spectral_kurtosis_threshold=1e9,
        baseband_reserve_sample=False,
        aot_plan_path=str(tmp_path / "aot"),
        **kw,
    )


class FakeToolchain:
    """A builder that writes a marked file (counting its builds) and a
    loader that accepts only such files (a corrupt entry raises, as a
    failed ``dlopen`` does)."""

    def __init__(self):
        self.builds = 0

    def build(self, dest):
        self.builds += 1
        with open(dest, "wb") as f:
            f.write(MAGIC + os.urandom(64))
        return dest

    def load(self, path):
        with open(path, "rb") as f:
            blob = f.read()
        if not blob.startswith(MAGIC):
            raise OSError(f"{path}: invalid ELF header")
        return ("library", str(path))


@pytest.fixture
def fresh_metrics():
    metrics.reset()
    yield
    metrics.reset()


@pytest.fixture
def toolchain(monkeypatch):
    """The fake toolchain as the cache's defaults, and the cache on for
    the CPU's processors too (it is off there, with nothing to build)."""
    tc = FakeToolchain()
    monkeypatch.setattr(A, "_default_builder", tc.build)
    monkeypatch.setattr(A, "_default_loader", tc.load)
    monkeypatch.setattr(A.AotPlanCache, "enabled", lambda self: True)
    return tc


def _raw(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=cfg.segment_bytes(1), dtype=np.uint8)


def test_aot_miss_then_hit_counts(tmp_path, toolchain, fresh_metrics):
    """A cold get builds (one miss, one compile, its seconds and
    ``last_compile_ms``); a warm one loads (one hit, no new compile)."""
    cache = A.AotPlanCache(str(tmp_path / "aot"), allow_cpu=True)
    lib = cache.get_or_build("kernels", "sig-a")
    assert lib[0] == "library" and toolchain.builds == 1
    assert metrics.get("aot_cache_misses") == 1
    assert metrics.get("aot_cache_hits") == 0
    assert metrics.get("plan_compiles") == 1
    assert metrics.get("compile_seconds") > 0
    assert metrics.get("last_compile_ms") > 0
    again = A.AotPlanCache(str(tmp_path / "aot"), allow_cpu=True)
    assert again.get_or_build("kernels", "sig-a") == lib
    assert toolchain.builds == 1
    assert metrics.get("aot_cache_hits") == 1
    assert metrics.get("plan_compiles") == 1


def test_aot_keys_on_the_whole_key(tmp_path, toolchain, monkeypatch):
    """An entry's name hashes (torch and CUDA versions, device, program,
    plan signature, the kernel sources and flags): each changes it."""
    cache = A.AotPlanCache(str(tmp_path / "aot"), allow_cpu=True)
    base = cache.path("kernels", "sig-a")
    assert base == cache.path("kernels", "sig-a")
    assert os.path.basename(base).startswith("kernels.")
    assert base.endswith(".so")
    assert cache.path("kernels", "sig-b") != base
    assert cache.path("other", "sig-a") != base
    edited = A.AotPlanCache(str(tmp_path / "aot"), allow_cpu=True,
                            digest=lambda: "another-source-hash")
    assert edited.path("kernels", "sig-a") != base
    monkeypatch.setattr(torch, "__version__", "0.0.0-other")
    assert cache.path("kernels", "sig-a") != base


def test_aot_corrupt_entry_rebuilds(tmp_path, toolchain, fresh_metrics):
    """A truncated or corrupt entry is a miss that rebuilds, never an
    error."""
    cache = A.AotPlanCache(str(tmp_path / "aot"), allow_cpu=True)
    cache.get_or_build("kernels", "sig-a")
    entry = cache.path("kernels", "sig-a")
    with open(entry, "wb") as f:
        f.write(b"\x7fELF truncated")
    lib = cache.get_or_build("kernels", "sig-a")
    assert lib[0] == "library" and toolchain.builds == 2
    assert metrics.get("aot_cache_misses") == 2
    assert metrics.get("aot_cache_hits") == 0
    with open(entry, "rb") as f:
        assert f.read().startswith(MAGIC)


def test_aot_corrupt_entry_never_reaches_the_loader(tmp_path, toolchain):
    """A truncated entry whose head survived is caught by its checksum
    before it is opened (``dlopen`` of such a file dies of SIGBUS); an
    entry without its checksum is a miss too."""
    opened = []
    cache = A.AotPlanCache(str(tmp_path / "aot"), allow_cpu=True,
                           loader=lambda path: (opened.append(
                               open(path, "rb").read()), "lib")[1])
    cache.get_or_build("kernels", "sig-a")
    entry = cache.path("kernels", "sig-a")
    assert os.path.exists(entry + ".sha256")
    with open(entry, "r+b") as f:
        f.truncate(len(MAGIC) + 8)  # the head intact, the rest gone
    assert cache.load("kernels", "sig-a") is None
    os.remove(entry + ".sha256")
    assert cache.load("kernels", "sig-a") is None
    cache.get_or_build("kernels", "sig-a")
    assert toolchain.builds == 2
    assert all(len(blob) == len(MAGIC) + 64 for blob in opened)


def test_aot_save_is_atomic(tmp_path, toolchain):
    """A build that dies leaves no entry under the entry's name."""
    def dying(dest):
        with open(dest, "wb") as f:
            f.write(MAGIC[:4])
        raise RuntimeError("nvcc killed")
    cache = A.AotPlanCache(str(tmp_path / "aot"), allow_cpu=True,
                           builder=dying)
    with pytest.raises(RuntimeError, match="nvcc killed"):
        cache.get_or_build("kernels", "sig-a")
    assert not os.path.exists(cache.path("kernels", "sig-a"))
    assert cache.load("kernels", "sig-a") is None


def test_aot_cpu_default_off(tmp_path, monkeypatch):
    """On the CPU the cache builds nothing and writes nothing, and the
    processor says so (the reference's warning)."""
    cache = A.AotPlanCache(str(tmp_path / "plain"))
    assert not cache.enabled()
    assert cache.get_or_build("kernels", "sig") is None
    assert not os.path.exists(tmp_path / "plain")
    cfg = _cfg(tmp_path)
    from srtb_tpu_torch.pipeline import segment as SEG
    warned = []
    monkeypatch.setattr(SEG.log, "warning", warned.append)
    p = SegmentProcessor(cfg, device="cpu")
    assert not p.aot_active
    assert not glob.glob(str(tmp_path / "aot" / "*"))
    assert warned == [
        "[segment] aot_plan_path set but the AOT cache is inactive (CPU "
        "backend without SRTB_AOT_ALLOW_CPU=1) — restarts will recompile"]


def test_aot_counters_through_the_processor(tmp_path, toolchain,
                                            fresh_metrics):
    """The processor builds or loads at construction (the reference's
    ``test_aot_cache_hit_miss_counters``): a cold build records a miss and
    its seconds, a warm restart a hit and no new compile, and an AOT-
    active first dispatch is not a first-dispatch compile."""
    cfg = _cfg(tmp_path, n=1 << 12, fft_strategy="four_step").replace(
        spectrum_channel_count=16)
    p1 = SegmentProcessor(cfg, device="cpu")
    assert p1.aot_active
    assert metrics.get("aot_cache_misses") == 1
    assert metrics.get("aot_cache_hits") == 0
    assert metrics.get("compile_seconds") > 0
    compiles0 = metrics.get("plan_compiles")
    p2 = SegmentProcessor(cfg, device="cpu")
    assert p2.aot_active
    assert metrics.get("aot_cache_hits") == 1
    assert metrics.get("plan_compiles") == compiles0
    p2.process(_raw(cfg))
    assert metrics.get("plan_compiles") == compiles0
    assert toolchain.builds == 1


def test_aot_signature_miss_recompiles(tmp_path, toolchain):
    """A changed plan-shaping knob misses the cache (a new entry), never
    loads the other plan's."""
    cfg = _cfg(tmp_path)
    SegmentProcessor(cfg, device="cpu").process(_raw(cfg))
    n_entries = len(glob.glob(str(tmp_path / "aot" / "*.so")))
    assert n_entries == 1
    cfg2 = cfg.replace(spectrum_channel_count=1 << 5)
    SegmentProcessor(cfg2, device="cpu").process(_raw(cfg2))
    assert len(glob.glob(str(tmp_path / "aot" / "*.so"))) == 2 * n_entries
    assert toolchain.builds == 2


# (tag, config changes, environment): the reference's keying cases
KEY_CASES = [
    ("base", {}, {}),
    ("outputs", {"baseband_output_file_prefix": "/elsewhere/out_",
                 "udp_receiver_rcvbuf_bytes": 1 << 20,
                 "segment_deadline_s": 42.0}, {}),
    ("run_local_env", {}, {"SRTB_BENCH_AOT_DIR": "/tmp/other",
                           "SRTB_WATCH_LOG": "/tmp/w.log"}),
    ("channels", {"spectrum_channel_count": 1 << 5}, {}),
    ("strategy", {"fft_strategy": "four_step"}, {}),
    ("rows_impl", {}, {"SRTB_STAGED_ROWS_IMPL": "pallas"}),
]


def _case_fields(tmp_path, changes: dict) -> dict:
    fields = dataclasses.asdict(_cfg(tmp_path))
    fields.update(changes)
    return fields


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_aot")
    jobs = [{"key": tag, "fn": "test_torch_ref:plan_signature",
             "args": [_case_fields(tmp, changes)], "kwargs": {"env": env}}
            for tag, changes, env in KEY_CASES]
    return run_reference(jobs, tmp)


def test_plan_signature_keys_the_cache_as_the_reference(
        ref, tmp_path, toolchain, monkeypatch):
    """The cache's entry for each case is shared exactly where the
    reference's plan signatures are equal: deployment-local settings
    and run-local variables hit, a trace-shaping change misses."""
    cache = A.AotPlanCache(str(tmp_path / "aot"), allow_cpu=True)
    paths = {}
    for tag, changes, env in KEY_CASES:
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            proc = SegmentProcessor(Config(**_case_fields(tmp_path,
                                                          changes)),
                                    device="cpu")
            paths[tag] = cache.path("kernels", proc.plan_signature())
    for a, *_ in KEY_CASES:
        for b, *_ in KEY_CASES:
            same_ref = str(ref[f"{a}/json"]) == str(ref[f"{b}/json"])
            assert (paths[a] == paths[b]) == same_ref, (a, b)
    assert paths["outputs"] == paths["run_local_env"] == paths["base"]


# ------------------------------------------------------------- the card

@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
def test_aot_builds_then_loads_on_the_card(tmp_path, fresh_metrics):
    """On the card the cache builds the kernel library with ``nvcc`` into
    its directory, a second processor loads it (a hit, no build), and the
    kernels launch from the loaded library with the same results."""
    from srtb_tpu_torch.kernels import build
    cfg = _cfg(tmp_path, use_pallas=True, use_pallas_sk=True)
    p1 = SegmentProcessor(cfg)
    assert p1.aot_active and metrics.get("aot_cache_misses") == 1
    entries = glob.glob(str(tmp_path / "aot" / "kernels.*.so"))
    assert len(entries) == 1
    wf1, det1 = p1.process(_raw(cfg))
    p2 = SegmentProcessor(cfg)
    assert metrics.get("aot_cache_hits") == 1
    assert build.library()._name == entries[0]
    wf2, det2 = p2.process(_raw(cfg))
    assert torch.equal(wf1, wf2)
