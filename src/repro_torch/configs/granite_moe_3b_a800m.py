"""Granite-3.0 MoE 3B-A800M [hf:ibm-granite]: 40 experts top-8 with
narrow (512) expert FFNs in every layer."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    num_experts_per_tok=8,
    moe_d_ff=512,
    moe_period=1,
    # §Perf defaults: 24 heads don't divide 16-way TP; narrow experts
    # want small dispatch groups + sparse gather dispatch.
    attn_seq_shard=True,
    moe_impl="gather",
    moe_group_size=256,
)
