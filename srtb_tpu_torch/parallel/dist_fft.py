"""Sequence-sharded large 1-D FFT over the ranks of a mesh axis (port of
``srtb_tpu/parallel/dist_fft.py``).

The four-step factorization (``ops/fft.four_step_fft``) distributed over
the ``seq`` axis with all-to-all transposes, so that no device holds the
whole segment.  Each rank holds one contiguous block of the array
(``n / D`` points, D ranks along the axis, in axis order) and gets its
block of the result.  Layout (n = n1 n2):

  x, each rank a j1-block                  [n1/D, n2]
  all-to-all transpose                  -> [n2/D, n1]
  local FFT (length n1) + twiddle exp(-2 pi i k1 j2 / n)
  all-to-all transpose back             -> [n1/D, n2]   rows B[k1, j2]
  local FFT (length n2)                 -> C[k1, k2]
  all-to-all transpose                  -> natural order X[k2 n1 + k1]

The local legs go through ``ops/fft.fft_minor`` by ``rows_impl``
(``SRTB_DIST_ROWS_IMPL``): ``xla`` ``torch.fft`` (cuFFT on the card),
``pallas`` the row kernel B6 (``csrc/fft_rows.cu``) with the four-step
recursion above the length cap, ``pallas_interpret`` B6's plain version.
The twiddles are built in float64 from the exact integer residue, so the
phase stays exact up to the 2^30 ceiling.

The R2C packs 2m reals as m complex, runs the distributed C2C and the
Hermitian post-process (ref: fft/fft_1d_r2c_post_process.hpp:33-82) with
the conjugate-mirrored spectrum made by a global flip: a local flip, the
ranks' reversal, then a roll right by one element (two point-to-point
exchanges, the reference's two ``ppermute``s).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from srtb_tpu_torch.ops.fft import fft_minor, pack_even_odd
from srtb_tpu_torch.parallel.mesh import Mesh

ROWS_IMPLS = ("xla", "pallas", "pallas_interpret")


def _local_transpose_a2a(x_block: torch.Tensor, mesh: Mesh, axis_name: str,
                         n_dev: int) -> torch.Tensor:
    """Global [R, C] -> [C, R] transpose of a row-sharded matrix: the
    local rows' columns split into n_dev chunks, all-to-all, reassembled."""
    r_loc, c = x_block.shape
    c_loc = c // n_dev
    # [r_loc, n_dev, c_loc] -> chunk d to rank d: [n_dev, r_loc, c_loc]
    t = x_block.reshape(r_loc, n_dev, c_loc).transpose(0, 1)
    t = mesh.all_to_all(t, axis_name)  # first axis now the source rank
    # this rank's global columns: [c_loc] x [R = n_dev r_loc]
    return t.permute(2, 0, 1).reshape(c_loc, n_dev * r_loc)


# the float64 tables are built this many entries at a time, so that their
# transients (an int64 residue, a float64 phase, a complex128 value:
# 32 bytes an entry) stay small beside the 2^29-entry tables of a 2^30
# segment on one rank
TABLE_CHUNK = 1 << 22


def _phase_table(rows: int, cols: int, residue, n: int, sign: float,
                 device: torch.device) -> torch.Tensor:
    """exp(sign 2 pi i r / n) as complex64 [rows, cols], r = ``residue(
    lo, hi)`` (int64 [hi - lo, cols] for rows lo .. hi - 1), each value
    built in float64 from the exact residue."""
    out = torch.empty(rows, cols, dtype=torch.complex64, device=device)
    step = max(1, TABLE_CHUNK // cols)
    for lo in range(0, rows, step):
        hi = min(rows, lo + step)
        phase = (residue(lo, hi) % n).to(torch.float64) * (
            sign * 2.0 * np.pi / n)
        out[lo:hi] = torch.polar(torch.ones_like(phase), phase)
    return out


@functools.lru_cache(maxsize=4)
def _twiddle_block(j0: int, rows: int, n1: int, n: int, inverse: bool,
                   device: torch.device) -> torch.Tensor:
    """exp(+-2 pi i (j2 k1 mod n) / n) for rows j2 in [j0, j0 + rows) and
    k1 < n1, from the exact integer residue in float64, as complex64."""
    k1 = torch.arange(n1, dtype=torch.int64, device=device)

    def residue(lo, hi):
        j2 = torch.arange(j0 + lo, j0 + hi, dtype=torch.int64, device=device)
        return j2[:, None] * k1[None, :]
    return _phase_table(rows, n1, residue, n, 1.0 if inverse else -1.0,
                        device)


def _dist_fft_block(x_block: torch.Tensor, *, mesh: Mesh, axis_name: str,
                    n1: int, n2: int, n_dev: int, inverse: bool,
                    rows_impl: str = "xla",
                    len_cap: int | None = None) -> torch.Tensor:
    """One rank's part: ``x_block [n / D]`` = this rank's j1-block rows
    viewed as [n1/D, n2]; returns its block of the spectrum."""
    a = x_block.reshape(n1 // n_dev, n2)
    # transpose so that the columns (the j1 axis) become local rows
    at = _local_transpose_a2a(a, mesh, axis_name, n_dev)     # [n2/D, n1]
    bt = fft_minor(at, inverse, rows_impl, len_cap)
    # twiddle: row j2 (global), column k1
    rows = n2 // n_dev
    bt = bt * _twiddle_block(mesh.index(axis_name) * rows, rows, n1,
                             n1 * n2, inverse, bt.device)
    # transpose back: rows k1 local again
    b = _local_transpose_a2a(bt, mesh, axis_name, n_dev)     # [n1/D, n2]
    del bt
    c = fft_minor(b, inverse, rows_impl, len_cap)
    del b
    # natural order: X[k2 n1 + k1] = C[k1, k2], a global transpose
    return _local_transpose_a2a(c, mesh, axis_name, n_dev).reshape(-1)


def resolve_rows_impl(impl: str, device=None) -> str:
    """A distributed leg implementation, validated (a typo raises, the
    ``segment.resolve_rows_impl`` rule); ``pallas`` on the CPU is B6's
    plain version, as the reference's is interpret mode off the TPU."""
    if impl not in ROWS_IMPLS:
        raise ValueError(
            f"unknown SRTB_DIST_ROWS_IMPL / rows_impl {impl!r}")
    if impl == "pallas" and device is not None \
            and torch.device(device).type == "cpu":
        return "pallas_interpret"
    return impl


def split(n: int, n_dev: int) -> tuple[int, int]:
    """(n1, n2) of the four-step at n, checked against the 2^30 ceiling
    and the rank count."""
    if n > 1 << 30:
        # the twiddle residue j2 k1 < n: 2^30 is the reference's static
        # ceiling (int32 residues there)
        raise ValueError(f"n={n} exceeds the int32 twiddle-residue ceiling "
                         "of 2^30; split the segment or use int64 residues")
    log2n = n.bit_length() - 1
    n1 = 1 << (log2n // 2)
    n2 = n // n1
    if n1 % n_dev or n2 % n_dev:
        raise ValueError(f"n1={n1}, n2={n2} must divide by {n_dev} devices")
    return n1, n2


def dist_fft(x: torch.Tensor, mesh: Mesh, axis_name: str = "seq",
             inverse: bool = False, rows_impl: str = "xla",
             len_cap: int | None = None) -> torch.Tensor:
    """Distributed unnormalized C2C FFT of a power-of-two array of which
    ``x`` is this rank's block along ``axis_name`` (n = D x.numel()).
    Returns this rank's block of the spectrum, in natural order."""
    n_dev = mesh.shape[axis_name]
    rows_impl = resolve_rows_impl(rows_impl, x.device)
    n1, n2 = split(x.shape[-1] * n_dev, n_dev)
    return _dist_fft_block(x.to(torch.complex64), mesh=mesh,
                           axis_name=axis_name, n1=n1, n2=n2, n_dev=n_dev,
                           inverse=inverse, rows_impl=rows_impl,
                           len_cap=len_cap)


# ----------------------------------------------------------------
# distributed R2C with the Hermitian post-process
# ----------------------------------------------------------------

def _global_conj_mirror(f_block: torch.Tensor, mesh: Mesh, axis_name: str,
                        n_dev: int) -> torch.Tensor:
    """Given F in blocks, this rank's block of G[k] = conj(F[(m - k) % m]).
    The global flip is a local flip and the ranks' reversal; the ``% m``
    is a global roll right by one element."""
    rev = torch.flip(f_block, (-1,))
    rev = mesh.ppermute(rev, axis_name,
                        [(d, n_dev - 1 - d) for d in range(n_dev)])
    # each rank takes the last element of the previous rank's block
    prev_last = mesh.ppermute(rev[..., -1:], axis_name,
                              [(d, (d + 1) % n_dev) for d in range(n_dev)])
    rolled = torch.cat([prev_last, rev[..., :-1]], -1)
    del rev
    return torch.conj_physical(rolled)


@functools.lru_cache(maxsize=4)
def _post_weights(k0: int, bins: int, m: int, device: torch.device):
    """(A, B) = ((1 - i w^k) / 2, (1 + i w^k) / 2) for k in [k0, k0 +
    bins), w = exp(-i pi / m), float64-built from the exact k: X[k] =
    A F[k] + B conj F[m - k]."""
    # w^k = exp(-2 pi i k / 2m) for k0 <= k < k0 + bins, as rows of cols
    cols = min(bins, TABLE_CHUNK)
    base = torch.arange(cols, dtype=torch.int64, device=device)
    w = _phase_table(bins // cols, cols, lambda lo, hi: k0 + base[None, :]
                     + cols * torch.arange(lo, hi, dtype=torch.int64,
                                           device=device)[:, None],
                     2 * m, -1.0, device).reshape(-1)
    iw = 1j * w
    return (0.5 * (1 - iw), 0.5 * (1 + iw))


def _dist_rfft_post_block(zf_block: torch.Tensor, *, mesh: Mesh,
                          axis_name: str, m: int,
                          n_dev: int) -> torch.Tensor:
    """The Hermitian reconstruction of this rank's block of the m-point
    C2C spectrum of packed reals: m bins in all (the Nyquist bin
    dropped, as ``segment_rfft``)."""
    g = _global_conj_mirror(zf_block, mesh, axis_name, n_dev)
    bins = m // n_dev
    a, b = _post_weights(mesh.index(axis_name) * bins, bins, m,
                         zf_block.device)
    return torch.mul(zf_block, a).add_(g.mul_(b))


def dist_rfft_drop_nyquist(x: torch.Tensor, mesh: Mesh,
                           axis_name: str = "seq", rows_impl: str = "xla",
                           len_cap: int | None = None) -> torch.Tensor:
    """Distributed R2C of 2m reals, of which ``x`` is this rank's block,
    to this rank's block of the m drop-Nyquist bins (ref:
    fft_pipe.hpp:75-77)."""
    n_dev = mesh.shape[axis_name]
    m = x.shape[-1] * n_dev // 2
    zf = dist_fft(pack_even_odd(x.to(torch.float32)), mesh, axis_name,
                  rows_impl=rows_impl, len_cap=len_cap)
    return _dist_rfft_post_block(zf, mesh=mesh, axis_name=axis_name, m=m,
                                 n_dev=n_dev)
