"""Jamba-v0.1-52B [arXiv:2403.19887]: hybrid Mamba+attention 1:7
interleave with MoE every other layer (16 experts, top-2)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    num_experts_per_tok=2,
    moe_period=2,
    attn_layer_period=8,        # 1 attention layer per 8 (1:7)
    ssm_state=16,               # Jamba uses Mamba(1)-style d_state=16
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    # NOTE: moe_impl stays "einsum" here — the gather dispatch inside the
    # 8-layer hybrid scan unit blows up SPMD compile time (>10 min);
    # einsum compiles in ~35 s.  Recorded in EXPERIMENTS.md §Perf.
)
