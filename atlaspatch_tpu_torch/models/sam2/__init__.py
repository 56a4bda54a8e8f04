from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
from atlaspatch_tpu_torch.models.sam2.model import SAM2ImageModel

__all__ = ["SAM2Config", "SAM2ImageModel"]
