# ShuffleSoftSort in PyTorch: softsort, the Algorithm 1 driver (fixed
# schedule, dense and banded apply), losses eq. 2-4, metrics, and the
# shuffle sources.
from repro_torch.core.softsort import (  # noqa: F401
    softsort_matrix,
    softsort_apply_chunked,
    softsort_apply_banded,
    band_tail_bound,
    hard_permutation,
    is_valid_permutation,
    fix_permutation,
)
from repro_torch.core.losses import (  # noqa: F401
    neighbor_loss_grid,
    stochastic_constraint_loss,
    std_loss,
    grid_sorting_loss,
    mean_pairwise_distance,
)
from repro_torch.core.metrics import dpq, mean_neighbor_distance  # noqa: F401
from repro_torch.core.prng import (  # noqa: F401
    ReplayShuffleSource,
    ShuffleSource,
    TorchShuffleSource,
    instance_seeds,
)
from repro_torch.core.shufflesoftsort import (  # noqa: F401
    BatchedSortResult,
    NumericalDivergence,
    ShuffleSoftSortConfig,
    resolve_band,
    resolve_device,
    shuffle_soft_sort,
    shuffle_soft_sort_batched,
)
from repro_torch.core.reference import (  # noqa: F401
    config_from_reference,
    state_from_reference,
)
