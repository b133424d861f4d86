# Benchmarks of the port, run as modules:
#
#   kernel_bench.py — the SoftSort apply, fwd and fwd+grad, one row per
#                     tier (dense, chunked, kernel_v1, fused, banded),
#                     with parity against the oracles and each kernel
#                     tier's bound on the card
#
#   serving_bench.py   — SortServer under Poisson load: steady, faults,
#                        overload, preempt; gates itself with --check
#   guardrail_bench.py — the serving chaos grid and the probes' overhead;
#                        gates itself with --check
