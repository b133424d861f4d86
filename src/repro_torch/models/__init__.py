# The LM model zoo, the counterpart of ``repro.models``: configs, layers,
# attention on the port's flash kernels, MoE, Mamba2 / SSD, the layer
# kinds and the end-to-end model.
from repro_torch.models.config import (  # noqa: F401
    SHAPE_CELLS,
    ModelConfig,
    ShapeCell,
    cell_by_name,
)
from repro_torch.models.model import (  # noqa: F401
    LM,
    decode_step,
    forward,
    init_model,
    loss_fn,
    make_caches,
    param_count,
    param_specs,
    params_from_jax,
    prefill,
    reduced_config,
)
