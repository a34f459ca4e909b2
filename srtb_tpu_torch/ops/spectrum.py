"""Spectrum-waterfall simplification: resample, normalize, colormap (port of
``srtb_tpu/ops/spectrum.py``).

The reference's resample kernels (ref: spectrum/simplify_spectrum.hpp:
137-230) downsample a dynamic spectrum to pixmap size, area-weighted along
frequency and linearly interpolated along time.  Both are banded weight
matrices, so the resample is two products

    out[H, W] = W_freq[H, in_h] @ power[in_h, in_w] @ W_time[in_w, W]

as in the JAX package, which computes them outside any Pallas kernel; here
they are ``torch.matmul`` in float32 on the tensors' device.  TF32 would
round the products' inputs to 10 mantissa bits and flip pixmap colours, so
:func:`resample_spectrum` refuses to run with it (it reads the process's
setting and never changes it).  Normalization (ref:
simplify_spectrum.hpp:627-644) and the ARGB colormap (ref:
simplify_spectrum.hpp:652-731, colours config.hpp:60-68) follow.
"""

from __future__ import annotations

import numpy as np
import torch

# GUI colours (ref: config.hpp:60-68)
OPAQUE = 0xFF000000
COLOR_0 = 0x1F1E33 | OPAQUE
COLOR_1 = 0x33E1F1 | OPAQUE
COLOR_OVERFLOW = 0xE0E1CC | OPAQUE


def time_interp_weights(in_w: int, out_w: int,
                        dtype=np.float32) -> np.ndarray:
    """[in_w, out_w] linear-interpolation weights along the time axis
    (ref: simplify_spectrum.hpp:152-181: x1 = x2/out_w*in_w, split between
    floor(x1) and floor(x1)+1), built in float64 and then cast."""
    w = np.zeros((in_w, out_w), dtype=np.float64)
    for x2 in range(out_w):
        x1 = x2 / out_w * in_w
        left = int(np.floor(x1))
        right = left + 1
        left_portion = (left + 1) - x1
        right_portion = x1 - left
        w[min(left, in_w - 1), x2] += left_portion
        w[min(right, in_w - 1), x2] += right_portion
    return w.astype(dtype)


def freq_area_weights(in_h: int, out_h: int,
                      dtype=np.float32) -> np.ndarray:
    """[out_h, in_h] area-sum weights along the frequency axis
    (ref: simplify_spectrum.hpp:183-225: output row y2 sums input rows in
    [y2/out_h*in_h, (y2+1)/out_h*in_h) with fractional edge weights),
    built in float64 and then cast."""
    w = np.zeros((out_h, in_h), dtype=np.float64)
    for y2 in range(out_h):
        up_acc = y2 / out_h * in_h
        down_acc = (y2 + 1) / out_h * in_h
        up = int(np.ceil(up_acc))
        down = int(np.floor(down_acc))
        if up > up_acc:
            w[y2, up - 1] += up - up_acc
        w[y2, up:down] += 1.0
        if down_acc > down and down < in_h:
            w[y2, down] += down_acc - down
    return w.astype(dtype)


def check_no_tf32(device: torch.device) -> None:
    """Raise when float32 products on ``device`` would run in TF32."""
    if device.type == "cuda" and \
            torch.get_float32_matmul_precision() != "highest":
        raise ValueError(
            "the waterfall resample needs float32 products: TF32 is on "
            f"(float32 matmul precision "
            f"{torch.get_float32_matmul_precision()!r}), which flips "
            "pixmap colours; leave it at 'highest'")


def resample_spectrum(power: torch.Tensor, w_freq: torch.Tensor,
                      w_time: torch.Tensor) -> torch.Tensor:
    """power [in_h(freq), in_w(time)] -> [out_h, out_w] by two products,
    in the reference's order."""
    check_no_tf32(power.device)
    return (w_freq @ power) @ w_time


def normalize_by_average(img: torch.Tensor) -> torch.Tensor:
    """Scale so the average maps to 0.5 (ref: simplify_spectrum.hpp:
    627-644); skipped when the average is ~0.  Stays on the device."""
    avg = torch.mean(img)
    eps = torch.finfo(img.dtype).eps
    coeff = torch.where(avg > eps, 1.0 / (2.0 * avg),
                        torch.ones((), dtype=img.dtype, device=img.device))
    return img * coeff


def _argb_components(argb: int):
    return ((argb >> 24) & 0xFF, (argb >> 16) & 0xFF,
            (argb >> 8) & 0xFF, argb & 0xFF)


def generate_pixmap(intensity: torch.Tensor, color_0: int = COLOR_0,
                    color_1: int = COLOR_1,
                    color_overflow: int = COLOR_OVERFLOW) -> np.ndarray:
    """Map intensities in [0,1] to ARGB32 by per-channel lerp; out-of-range
    values (NaN included) get the overflow colour (ref:
    simplify_spectrum.hpp:652-731).  Computed on the intensity's device:
    per channel the float32 lerp ``(1 - x) c0 + x c1``, each product and
    the sum rounded apart as the reference's, truncated and shifted into
    place in int64 words.  Returns numpy uint32 [H, W], the reference's
    bit layout (A<<24 | R<<16 | G<<8 | B); only the 4-byte words leave
    the device (those above 2^31 - 1 brought into int32 range by
    subtracting 2^32, the same bits)."""
    x = intensity.to(torch.float32)
    in_range = (x >= 0) & (x <= 1)
    x = torch.clamp(x, 0.0, 1.0)
    one_minus = 1.0 - x
    words = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    for shift, c0, c1 in zip((24, 16, 8, 0), _argb_components(color_0),
                             _argb_components(color_1)):
        chan = (one_minus * float(c0) + x * float(c1)).to(torch.int64)
        words |= chan << shift
    words = torch.where(in_range, words,
                        torch.full((), color_overflow, dtype=torch.int64,
                                   device=x.device))
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32).cpu().numpy().view(np.uint32)


# ----------------------------------------------------------------
# float64 golden model of the reference kernel (for tests)
# ----------------------------------------------------------------

def resample_oracle(power: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Direct per-pixel transliteration of the v1 kernel semantics."""
    in_h, in_w = power.shape
    out = np.zeros((out_h, out_w), dtype=np.float64)
    for y2 in range(out_h):
        for x2 in range(out_w):
            x1 = x2 / out_w * in_w
            left = int(np.floor(x1))
            right = left + 1
            lp = (left + 1) - x1
            rp = x1 - left

            def sample(y):
                r = power[y, min(right, in_w - 1)]
                return lp * power[y, left] + rp * r

            up_acc = y2 / out_h * in_h
            down_acc = (y2 + 1) / out_h * in_h
            up = int(np.ceil(up_acc))
            down = int(np.floor(down_acc))
            s = 0.0
            if up > up_acc:
                s += (up - up_acc) * sample(up - 1)
            for y in range(up, down):
                s += sample(y)
            if down_acc > down and down < in_h:
                s += (down_acc - down) * sample(down)
            out[y2, x2] = s
    return out
