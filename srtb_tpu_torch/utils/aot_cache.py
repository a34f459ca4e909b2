"""The compiled-kernel cache behind ``aot_plan_path`` (port of
``srtb_tpu/utils/aot_cache.py``).

The reference persists its compiled XLA executables so that a restarted
observation does not pay the compile again.  The port's compiled program
is the kernel library that ``kernels/build.py`` makes with ``nvcc`` for
``sm_90a``: one shared library of every ``csrc/*.cu``.  This cache keeps
that library in a directory of its own, so that a restarted process
loads it at the processor's construction and builds nothing.

Safety model, the reference's:

- an entry is keyed by SHA-256 of (torch version, CUDA version, device
  name and compute capability, program name, the processor's
  ``plan_signature()``, the kernel sources' hash and the ``nvcc``
  flags): a changed config, torch or toolkit upgrade, another card or an
  edited kernel misses cleanly and builds anew;
- a save is atomic: the library is built into ``<entry>.tmp`` and moved
  into place with ``os.replace``, so a crash never leaves a truncated
  entry under the entry's name;
- a load that fails for any reason (a truncated or corrupt file, a
  ``dlopen`` that fails, a missing symbol) builds anew; it never raises.
  Each entry has a SHA-256 sidecar (``<entry>.sha256``, written after
  the entry), checked before the library is opened: ``dlopen`` maps a
  truncated library whose headers survived and the process dies of
  SIGBUS on the first touch past the file's end, so such a file must
  never reach the loader;
- on the CPU there is nothing to build: :meth:`AotPlanCache.enabled` is
  False and nothing is written (``allow_cpu=True`` lets a test run the
  protocol with a builder and a loader of its own).

cuFFT's plans live inside the process and are not persisted: a restart
still makes them at its first segment.

Counters (the registry, ``utils/metrics.py``): ``aot_cache_hits``,
``aot_cache_misses``, ``plan_compiles``, ``compile_seconds`` and the gauge
``last_compile_ms``, where the compile is the ``nvcc`` build and link,
timed exactly.
"""

from __future__ import annotations

import hashlib
import os
import time
from pathlib import Path

from srtb_tpu_torch.utils.logging import log


def _device_key(device) -> str:
    """torch version / CUDA version / device name / capability."""
    import torch
    key = f"{torch.__version__}/{torch.version.cuda}"
    if device is not None and getattr(device, "type", "cpu") == "cuda":
        cap = torch.cuda.get_device_capability(device)
        key += (f"/{torch.cuda.get_device_name(device)}"
                f"/sm_{cap[0]}{cap[1]}")
    else:
        key += "/cpu"
    return key


def _default_builder(dest: Path) -> Path:
    from srtb_tpu_torch.kernels import build
    return build.build_library(dest)


def _default_loader(path: Path):
    from srtb_tpu_torch.kernels import build
    return build.load_library(path)


def _default_digest() -> str:
    from srtb_tpu_torch.kernels import build
    return build.sources_digest() + "|" + " ".join(build.NVCC_FLAGS)


class AotPlanCache:
    """Directory of compiled kernel libraries, one file per (program
    name, plan signature, device key, sources).  ``builder(dest)`` builds
    the library into ``dest`` and ``loader(path)`` loads one (the
    defaults: ``kernels/build.py``'s ``build_library`` and
    ``load_library``); ``labels`` adds a stream-labeled twin to every
    counter."""

    def __init__(self, root: str, device=None, allow_cpu: bool = False,
                 labels: dict | None = None, builder=None, loader=None,
                 digest=None):
        self.root = root
        self.device = device
        self.allow_cpu = allow_cpu
        self.labels = dict(labels) if labels else None
        self._builder = builder or _default_builder
        self._loader = loader or _default_loader
        self._digest = digest or _default_digest
        if self.enabled():
            os.makedirs(root, exist_ok=True)

    def _count(self, name: str, value: float = 1.0) -> None:
        from srtb_tpu_torch.utils.metrics import metrics
        metrics.add(name, value)
        if self.labels:
            metrics.add(name, value, labels=self.labels)

    def enabled(self) -> bool:
        """True on the card; on the CPU only with ``allow_cpu``."""
        on_card = getattr(self.device, "type", "cpu") == "cuda"
        if not on_card and not self.allow_cpu:
            log.debug("[aot_cache] skipped on CPU (nothing to build)")
            return False
        return True

    def path(self, name: str, signature: str) -> str:
        """The entry's file for ``name`` under ``signature``."""
        h = hashlib.sha256(
            f"{_device_key(self.device)}|{name}|{signature}|"
            f"{self._digest()}".encode()).hexdigest()
        return os.path.join(self.root, f"{name}.{h[:16]}.so")

    @staticmethod
    def _sha256(path) -> str:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            while chunk := f.read(1 << 22):
                h.update(chunk)
        return h.hexdigest()

    def load(self, name: str, signature: str):
        """The loaded library, or None on a miss or any error."""
        if not self.enabled():
            return None
        path = self.path(name, signature)
        if not os.path.exists(path):
            return None
        try:
            with open(path + ".sha256") as f:
                want = f.read().strip()
            if self._sha256(path) != want:
                raise OSError("the entry does not match its SHA-256 "
                              "(truncated or corrupt)")
            lib = self._loader(Path(path))
        except Exception as e:  # noqa: BLE001 - a corrupt entry: rebuild
            log.warning(f"[aot_cache] load failed for {name}: {e}; "
                        "rebuilding")
            return None
        log.info(f"[aot_cache] loaded {name} from {path}")
        self._count("aot_cache_hits")
        return lib

    def get_or_build(self, name: str, signature: str):
        """The cached library for ``name``, built (``nvcc``, timed
        exactly) and saved on a miss; None when the cache is off."""
        if not self.enabled():
            return None
        lib = self.load(name, signature)
        if lib is not None:
            return lib
        path = Path(self.path(name, signature))
        tmp = Path(str(path) + ".tmp")
        t0 = time.perf_counter()
        self._builder(tmp)
        dt = time.perf_counter() - t0
        # atomic: a crashed build or save never leaves a truncated entry
        # for the next start to trip on; the checksum comes last, so an
        # entry without one is never opened
        digest = self._sha256(tmp)
        os.replace(tmp, path)
        with open(str(path) + ".sha256.tmp", "w") as f:
            f.write(digest + "\n")
        os.replace(str(path) + ".sha256.tmp", str(path) + ".sha256")
        self._count("aot_cache_misses")
        self._count("plan_compiles")
        self._count("compile_seconds", dt)
        from srtb_tpu_torch.utils.metrics import metrics
        metrics.set("last_compile_ms", dt * 1e3)
        log.info(f"[aot_cache] built {name} -> {path} in {dt:.1f} s")
        return self._loader(path)
