from soundscope_tpu_torch.core import constants  # noqa: F401
from soundscope_tpu_torch.core.config import MeterConfig  # noqa: F401
