from atlaspatch_tpu_torch.orchestration.parallel import (
    ExtractionTask,
    InflightTracker,
    PatchExtractionExecutor,
)
from atlaspatch_tpu_torch.orchestration.runner import ProcessingRunner

__all__ = [
    "ExtractionTask",
    "InflightTracker",
    "PatchExtractionExecutor",
    "ProcessingRunner",
]
