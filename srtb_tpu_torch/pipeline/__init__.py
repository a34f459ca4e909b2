from srtb_tpu_torch.pipeline.work import (SegmentResultWork,  # noqa: F401
                                          SegmentWork)
from srtb_tpu_torch.pipeline.segment import SegmentProcessor  # noqa: F401
# the fleet (StreamFleet, StreamSpec) is imported from
# srtb_tpu_torch.pipeline.fleet: it pulls in the whole runtime, which this
# package's import does not
