"""Llama-3-405B [arXiv:2407.21783]: 126L dense GQA.  Optimizer moments in
bf16 so params+moments fit 16 GB/chip on the 256-chip single-pod mesh
(topology: ``repro/launch/mesh.py``)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    moment_dtype="bfloat16",
    remat_policy="dots",  # §Perf E: -18% recompute FLOPs, fits HBM
)
