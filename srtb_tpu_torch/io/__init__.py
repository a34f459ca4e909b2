from srtb_tpu_torch.io import file_input, formats, writers  # noqa: F401
