# Comparison methods from the paper's Table III, in PyTorch.
from repro_torch.core.baselines.gumbel_sinkhorn import (  # noqa: F401
    GumbelSinkhornConfig,
    gumbel_sinkhorn_sort,
)
from repro_torch.core.baselines.kissing import (  # noqa: F401
    KissingConfig,
    kissing_sort,
)
