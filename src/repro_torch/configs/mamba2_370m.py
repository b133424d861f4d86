"""Mamba2-370m [arXiv:2405.21060]: pure SSD (state-space duality),
attention-free; O(1) decode state."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=16,          # unused (attention-free); kept for validation
    num_kv_heads=16,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
)
