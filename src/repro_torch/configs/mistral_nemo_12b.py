"""Mistral-Nemo-12B [hf:mistralai]: dense GQA, head_dim 128 (5120/32=160
is NOT the head dim — Nemo pins 128), 128k context."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    rope_theta=1_000_000.0,
    remat_policy="dots",  # §Perf E: -18% recompute FLOPs, fits HBM
)
