"""Training presets of the LM zoo.

Counterpart of ``PRESETS`` in ``repro.launch.train``: overrides on top of
``reduced_config`` for host-runnable scales, which the serve CLI's
``--preset`` names.  The training loop itself is not ported yet
(ROADMAP.md A16b).
"""
PRESETS = {
    "tiny": dict(d_model=64, num_layers=2, d_ff=128, vocab_size=512),
    "10m": dict(d_model=256, num_layers=6, d_ff=1024, vocab_size=8192,
                num_heads=8, num_kv_heads=8, head_dim=32),
    "100m": dict(d_model=768, num_layers=12, d_ff=3072, vocab_size=32768,
                 num_heads=12, num_kv_heads=12, head_dim=64),
}
