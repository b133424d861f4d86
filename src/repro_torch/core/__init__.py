# ShuffleSoftSort in PyTorch: softsort, the Algorithm 1 driver (fixed and
# adaptive schedules, dense and banded apply, the restart tournament and
# round segments), the plain SoftSort baseline, the adaptive controller,
# losses eq. 2-4, metrics, the shuffle sources and the jax.random-bitwise
# threefry draws (``core.threefry``; the other Table III baselines are in
# ``core.baselines``).
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
from repro_torch.core.annealing import (  # noqa: F401
    AdaptiveController,
    RungDecision,
    adaptive_seg_len,
)
from repro_torch.core.metrics import dpq, mean_neighbor_distance  # noqa: F401
from repro_torch.core.prng import (  # noqa: F401
    ReplayShuffleSource,
    ShuffleSource,
    ThreefryShuffleSource,
    TorchShuffleSource,
    instance_seeds,
)
from repro_torch.core.threefry import prng_key  # noqa: F401
from repro_torch.core.shufflesoftsort import (  # noqa: F401
    BatchedSortResult,
    NumericalDivergence,
    ShuffleSoftSortConfig,
    TournamentResult,
    make_adaptive_controller,
    resolve_band,
    resolve_device,
    restart_tournament,
    run_round_segment,
    rung_aligned_switch,
    shuffle_soft_sort,
    shuffle_soft_sort_batched,
    soft_sort_baseline,
)
from repro_torch.core.reference import (  # noqa: F401
    carry_reference_checkpoint,
    config_from_reference,
    controller_state_from_reference,
    read_reference_checkpoint,
    state_from_reference,
)
