"""The yardstick of the kernels: the card's published peaks, and the
operations and bytes of each device call worked out from its shapes.

Bytes count each input byte read once and each output byte written once,
whatever a kernel reads again; operations count what the call needs (an
FFT's 5 N log2 N for a complex transform of length N, 2.5 N log2 N for a
real one), not the most it could do.  A call the model does not know
counts 0 towards the bound, so a share can only read low, never high.

Two sources of shapes:

- a PyTorch operator (the kernels it launched are linked to it by the
  profiler): its input shapes and types as recorded, and its output by a
  rule of the operator's kind (:func:`op_cost`);
- one of the program's own CUDA kernels, which the program launches
  without an operator: its shapes are the segment's, from the
  configuration (:func:`port_kernel_cost`).
"""

from __future__ import annotations

import math

# NVIDIA's data sheet, H100 SXM, dense rates, at the 700 W limit
PEAK = {
    "hbm_bytes_per_s": 3.35e12,
    "float32_flops": 67e12,
    "float64_flops": 34e12,
}

ITEMSIZE = {
    "float": 4, "double": 8, "c10::Half": 2, "c10::BFloat16": 2,
    "c10::complex<float>": 8, "c10::complex<double>": 16,
    "c10::complex<c10::Half>": 4, "unsigned char": 1, "signed char": 1,
    "bool": 1, "short int": 2, "int": 4, "long int": 8, "long": 8,
}

REDUCTIONS = {
    "aten::sum", "aten::mean", "aten::amax", "aten::amin", "aten::max",
    "aten::min", "aten::linalg_vector_norm", "aten::norm", "aten::any",
    "aten::all", "aten::std", "aten::var", "aten::prod", "aten::argmax",
    "aten::argmin", "aten::count_nonzero", "aten::_local_scalar_dense",
}
COMPARISONS = {
    "aten::gt", "aten::lt", "aten::ge", "aten::le", "aten::eq", "aten::ne",
    "aten::logical_and", "aten::logical_or", "aten::logical_not",
    "aten::logical_xor", "aten::isnan", "aten::isinf", "aten::isfinite",
}
WRITE_ONLY = {
    "aten::fill_", "aten::zero_", "aten::normal_", "aten::uniform_",
    "aten::random_", "aten::bernoulli_", "aten::exponential_",
}


def _tensors(shapes, dtypes):
    """(numel, itemsize) of every tensor argument."""
    out = []
    for shape, dtype in zip(shapes or [], dtypes or []):
        if dtype in ITEMSIZE and isinstance(shape, (list, tuple)):
            if shape and isinstance(shape[0], (list, tuple)):
                for s in shape:  # a tensor list
                    out.append((math.prod(s), ITEMSIZE[dtype]))
            else:
                out.append((math.prod(shape), ITEMSIZE[dtype]))
        elif dtype == "TensorList" and isinstance(shape, (list, tuple)):
            for s in shape:
                if isinstance(s, (list, tuple)):
                    out.append((math.prod(s), 4))
    return out


def fft_flops(length: int, transforms: int, real: bool) -> float:
    if length < 2:
        return 0.0
    per = 5.0 * length * math.log2(length)
    return transforms * (per / 2 if real else per)


def op_cost(name: str, shapes, dtypes) -> tuple[float, float] | None:
    """(bytes, flops) of one PyTorch operator's device work, or None when
    it has no tensor argument to count from."""
    ts = _tensors(shapes, dtypes)
    if not ts:
        return None
    inputs = sum(n * s for n, s in ts)
    big_n, big_s = max(ts)
    first_n, first_s = ts[0]
    if name in ("aten::_fft_r2c", "aten::_fft_c2c", "aten::_fft_c2r"):
        shape = shapes[0]
        length = shape[-1] if shape else 1
        batch = math.prod(shape[:-1]) if shape else 1
        if name == "aten::_fft_r2c":
            out = batch * (length // 2 + 1) * 2 * first_s
            return inputs + out, fft_flops(length, batch, True)
        if name == "aten::_fft_c2r":
            # the output length is an argument, not a shape: 2 (L - 1)
            n_out = 2 * (length - 1)
            out = batch * n_out * first_s // 2
            return inputs + out, fft_flops(n_out, batch, True)
        return 2 * inputs, fft_flops(length, batch, False)
    if name in REDUCTIONS:
        return inputs, float(big_n)
    if name in WRITE_ONLY:
        return first_n * first_s, 0.0
    if name == "aten::copy_":
        return inputs, 0.0
    if name == "aten::cat":
        return 2 * inputs, 0.0
    if name.endswith("_"):
        # in place: the inputs read, the first written back
        return inputs + first_n * first_s, float(first_n)
    if name in COMPARISONS:
        return inputs + big_n, float(big_n)
    if name == "aten::where":
        item = max(s for n, s in ts[1:]) if len(ts) > 1 else big_s
        return inputs + big_n * item, float(big_n)
    return inputs + big_n * big_s, float(big_n)


def port_kernel_cost(kernel: str, geo: dict) -> tuple[float, float] | None:
    """(bytes, flops) of one launch of the program's own CUDA kernels on
    one stream of the cell's segment: ``geo`` has ``n`` (samples),
    ``nbits``, ``m`` (spectrum bins, n / 2) and ``masked`` (a keep mask
    is read).  None for a kernel this table does not know."""
    n, m = geo["n"], geo["m"]
    raw = n * geo["nbits"] // 8
    if "unpack_subbyte_window_kernel" in kernel \
            or "unpack_subbyte_planes_kernel" in kernel:
        return raw + 4 * n, float(n)
    if "rfi_s1_dedisperse_kernel" in kernel:
        return 16 * m + (m if geo["masked"] else 0), 12.0 * m
    if "dedisperse_kernel" in kernel:
        return 16 * m, 6.0 * m
    if "sk_stats_kernel" in kernel:
        return 8 * m, 4.0 * m
    if "sk_apply_kernel" in kernel:
        return 16 * m, 4.0 * m
    return None


def bound_s(nbytes: float, flops: float, flops_peak: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM peak and the operations over the arithmetic peak."""
    return max(nbytes / PEAK["hbm_bytes_per_s"], flops / flops_peak)
