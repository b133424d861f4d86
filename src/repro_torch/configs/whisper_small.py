"""Whisper-small [arXiv:2212.04356]: enc-dec; the conv frontend is a STUB
(input_specs() provides precomputed frame embeddings at d_model, 1500
frames).  Decoder layers: self-attn + cross-attn + MLP."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,              # decoder layers
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    cross_attn_period=1,        # every decoder layer cross-attends
    encoder_layers=12,
    audio_frames=1500,
    attn_seq_shard=True,        # 12 heads don't divide 16-way TP (§Perf)
)
