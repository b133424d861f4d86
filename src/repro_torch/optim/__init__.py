# The port's optimizers (``repro.optim``'s counterpart): Adam, AdamW and
# SGD over trees of tensors, global-norm clipping, LR schedules.
from repro_torch.optim.adam import (  # noqa: F401
    AdamState,
    adam_init,
    adam_update,
    Optimizer,
    adam,
    adamw,
    sgd,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    linear_warmup_cosine,
)
