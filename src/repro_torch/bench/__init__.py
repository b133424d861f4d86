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
#   paper_table.py     — the paper's Table III (Gumbel-Sinkhorn, Kissing,
#                        SoftSort, ShuffleSoftSort); gates itself with
#                        --check
#   run.py             — the reference's CSV entry point: Table III, the
#                        kernel bench's cells and the dry-run's roofline
#                        rows
#   fixed_path_ab.py   — A/B of the fixed path between two checkouts
#   roofline.py        — the dry-run records' roofline at H100 peaks
#   compare_sweeps.py  — before / after table of two dry-run sweeps
#   hillclimb.py       — one cell's costs under named sharding variants
