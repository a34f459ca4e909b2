from srtb_tpu_torch.gui import waterfall  # noqa: F401
