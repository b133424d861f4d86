"""Qwen1.5-0.5B [hf:Qwen]: dense with QKV bias."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
)
