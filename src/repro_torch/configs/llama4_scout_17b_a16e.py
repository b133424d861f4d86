"""Llama-4-Scout-17B-16E [hf:meta-llama]: MoE top-1 routing, 16 experts.
(The release interleaves a shared expert; we model pure top-1 routed
experts every layer — a deliberate simplification, recorded here so the
config is not mistaken for a faithful replica.)"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    num_experts_per_tok=1,
    moe_d_ff=8192,
    moe_period=1,
    # §Perf defaults (EXPERIMENTS.md): 40 heads don't divide 16-way TP ->
    # sequence-sharded attention; sparse gather dispatch for the MoE.
    attn_seq_shard=True,
    moe_impl="gather",
)
