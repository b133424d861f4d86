# Benchmarks of the port, run as modules:
#
#   kernel_bench.py — the SoftSort apply, fwd and fwd+grad, one row per
#                     tier (dense, chunked, kernel_v1, fused, banded),
#                     with parity against the oracles and each kernel
#                     tier's bound on the card
