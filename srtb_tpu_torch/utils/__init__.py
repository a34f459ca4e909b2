from srtb_tpu_torch.utils.expression import parse_expression  # noqa: F401
from srtb_tpu_torch.utils.logging import get_logger, log  # noqa: F401
