# The port's synthetic data pipeline (``repro.data``'s counterpart).
from repro_torch.data.synthetic import (  # noqa: F401
    synthetic_batch,
    token_spec,
    batch_specs,
    context_spec,
)
