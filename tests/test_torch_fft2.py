"""B9 and B10, the two passes of the large four-step C2C (``fft_strategy =
pallas2``).  On the CPU each wrapper runs its plain PyTorch version, held
here against the JAX package's ``pallas_fft2`` in interpret mode on the
same inputs: the factorization, each pass at small-leg shapes (the
plain versions take any block; the kernels' window starts at 2^24), the
composed transform at 2^24 with a batch of two, and the sub-byte R2C
through it.  The CUDA kernels are held against these plain versions on
the card by the ``cuda``-marked tests of ``test_torch_kernels.py``."""

import functools

import numpy as np
import pytest
import torch

from srtb_tpu_torch import kernels as K
from srtb_tpu_torch.kernels import fft2 as K2
from srtb_tpu_torch.kernels import unpack as KU
from srtb_tpu_torch.ops import fft as F
from test_torch_ref import run_reference

RNG = np.random.default_rng(2027)
M = 1 << 24  # the smallest two-pass length (n1 = n2 = 4096)
LOG2_FACTOR = range(10, 31)
BLOCKS = [(64, 256), (256, 128)]
PASS_CASES = [(b, inv) for b in BLOCKS for inv in (False, True)]


def _noise(shape, rng=RNG) -> np.ndarray:
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


BLOCK_IN = {b: _noise(b) for b in BLOCKS}


# the 2^24 inputs are made when a test first asks (every worker imports
# this module; only the one that runs it needs 256 MiB of input)
@functools.cache
def _c2c_in() -> np.ndarray:
    return _noise((2, M), np.random.default_rng(24))


@functools.cache
def _subbyte_in() -> np.ndarray:
    """4-bit bytes: one packed plane of M."""
    return np.random.default_rng(4).integers(0, 256, M, dtype=np.uint8)


def _ri(c: np.ndarray):
    return [np.ascontiguousarray(c.real), np.ascontiguousarray(c.imag)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    pf2 = "srtb_tpu.ops.pallas_fft2:"
    jobs = [{"key": f"factor/{e}", "fn": pf2 + "_factor", "args": [1 << e]}
            for e in LOG2_FACTOR]
    for b, inv in PASS_CASES:
        jobs += [{"key": f"pass{p}/{b}/{inv}", "fn": f"{pf2}pass{p}_2d",
                  "args": _ri(BLOCK_IN[b]) + [inv],
                  "kwargs": {"interpret": True}} for p in (1, 2)]
    jobs += [
        {"key": "c2c", "fn": pf2 + "fft2_c2c_ri", "args": _ri(_c2c_in()),
         "kwargs": {"interpret": True}},
        {"key": "subbyte", "fn": "srtb_tpu.ops.fft:rfft_subbyte",
         "args": [_subbyte_in(), 4, "pallas2_interpret"]},
    ]
    return run_reference(jobs, tmp_path_factory.mktemp("ref_fft2"))


def _close(got: np.ndarray, want: np.ndarray) -> None:
    """2e-5 of the largest value: the reference's own gate for the
    two-pass C2C against float64 (tests/test_pallas_fft2.py:48)."""
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


def test_factor_matches_reference(ref):
    """The same window and split as the reference's ``_factor`` at every
    power of two 2^10 ... 2^30: (4096, m/4096) for 2^24 ... 2^28, (8192,
    65536) at 2^29, none outside."""
    for e in LOG2_FACTOR:
        want = ref.get(f"factor/{e}")
        got = K2.factor(1 << e)
        assert got == (None if want is None else tuple(want.tolist())), e
        assert K2.supported(1 << e) == (got is not None)
    assert [e for e in LOG2_FACTOR if K2.supported(1 << e)] == \
        list(range(24, 30))
    assert not K2.supported(3 << 22) and not K2.supported(0)


@pytest.mark.parametrize("block,inverse", PASS_CASES)
def test_passes_plain_match_pallas(ref, block, inverse):
    """B9's plain version against ``pass1_2d`` (the column C2C and the
    four-step twiddle, the [n1, n2] layout) and B10's against
    ``pass2_2d`` (the row C2C, k1-major), on the same block."""
    x = torch.from_numpy(BLOCK_IN[block])
    for p, plain in ((1, K2.fft2_pass1_plain), (2, K2.fft2_pass2_plain)):
        key = f"pass{p}/{block}/{inverse}"
        want = ref[f"{key}/0"] + 1j * ref[f"{key}/1"]
        _close(plain(x, inverse).numpy(), want)


def test_fft2_c2c_matches_pallas(ref):
    """The composed transform at m = 2^24 on a batch of two (B9, B10 and
    the unblocking transpose; their plain versions here) against
    ``fft2_c2c_ri`` and the float64 FFT; the blocked form unblocks to the
    natural one."""
    x = torch.from_numpy(_c2c_in())
    K.reset_launch_counts()
    got = K2.fft2_c2c(x)
    _close(got.numpy(), ref["c2c/0"] + 1j * ref["c2c/1"])
    _close(got.numpy(), np.fft.fft(_c2c_in().astype(np.complex128)))
    blocked = K2.fft2_pass2(K2.fft2_pass1(x.reshape(2, 4096, 4096)))
    assert torch.equal(K2.unblock(blocked), got)
    assert not any(K.launch_counts().values())


def test_rfft_subbyte_pallas2_matches_pallas(ref):
    """The 4-bit blocked-plane R2C with the plane FFT on the two-pass
    route (one packed plane of M = 2^24) against the reference's
    ``rfft_subbyte`` with ``pallas2``."""
    z = KU.unpack_subbyte_planes_window(torch.from_numpy(_subbyte_in()), 4)
    assert tuple(z.shape) == (1, M)
    got = F.rfft_subbyte(z, "pallas2").numpy()
    _close(got, ref["subbyte"])


def test_wrappers_take_only_the_kernel_window():
    """The wrappers take [..., n1, n2] with n1 in {4096, 8192} and n2 in
    [2^12, 2^16] on every device; other shapes and types raise."""
    for shape in ((64, 256), (4096, 2048), (2048, 8192)):
        with pytest.raises(ValueError):
            K2.fft2_pass1(torch.zeros(shape, dtype=torch.complex64))
        with pytest.raises(ValueError):
            K2.fft2_pass2(torch.zeros(shape, dtype=torch.complex64))
    with pytest.raises(ValueError):
        K2.fft2_pass1(torch.zeros(4, 4, dtype=torch.complex128))
    with pytest.raises(ValueError):
        K2.fft2_c2c(torch.zeros(1 << 20, dtype=torch.complex64))
