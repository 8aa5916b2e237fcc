"""AdamW and learning-rate schedules: the reference's ``repro.optim``."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup_cosine  # noqa: F401
