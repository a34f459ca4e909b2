"""FFT window functions (ref: fft/fft_window.hpp:27-123).

Cosine-sum windows evaluated at x = i / (n - 1) for i in [0, n); the
reference's default window is the rectangle (fft_window.hpp:83), in which
case application is skipped entirely.
"""

from __future__ import annotations

import numpy as np

# cosine-sum coefficients a_k with alternating sign (-1)^k, as in
# cosine_sum_window::operator() (fft_window.hpp:42-49)
_COSINE_SUM_COEFFS = {
    "hann": (0.5, 0.5),
    "hamming": (25.0 / 46.0, 21.0 / 46.0),
}


def window_coefficients(name: str, n: int, dtype=np.float32) -> np.ndarray | None:
    """Window coefficient array of length n, or None for the rectangle window
    (meaning: skip application, as the reference does for its default)."""
    name = name.lower()
    if name in ("rectangle", "boxcar", "none", ""):
        return None
    if name not in _COSINE_SUM_COEFFS:
        raise ValueError(f"unknown window {name!r}")
    if n == 1:
        # degenerate single-sample window: x = 0/0; the natural limit of
        # every cosine-sum window is 1.0 (scipy agrees), not NaN
        return np.ones(1, dtype=dtype)
    coeffs = _COSINE_SUM_COEFFS[name]
    x = np.arange(n, dtype=np.float64) / (n - 1)
    ret = np.zeros(n, dtype=np.float64)
    for k, a_k in enumerate(coeffs):
        sign = 1.0 if (k % 2 == 0) else -1.0
        ret += sign * a_k * np.cos(2.0 * np.pi * k * x)
    return ret.astype(dtype)


def dewindow_coefficients(name: str, n: int,
                          dtype=np.float32) -> np.ndarray | None:
    """Safe divisors for de-applying a window after the waterfall backward
    C2C (ref: fft_pipe.hpp:346-359): same as :func:`window_coefficients`
    but with exact zeros (hann edges) replaced by 1 so the division never
    produces inf — the shared sanitization for both the single-chip and
    distributed paths."""
    w = window_coefficients(name, n, dtype=dtype)
    if w is None:
        return None
    return np.where(w == 0.0, dtype(1.0), w)


DEFAULT_WINDOW = "rectangle"  # ref: fft_window.hpp:83
