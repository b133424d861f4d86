# Runtime pieces of the port, host-side around the engine:
#
#   sog_compress.py — self-organizing checkpoint compression: sort the
#                     columns of each weight with ShuffleSoftSort, then
#                     int8-quantize, delta-code and deflate them
#
#   checkpoint.py          — CheckpointManager: atomic step directories,
#                            manifest, keep-k GC, async save (the
#                            reference's on-disk format)
#   anneal_checkpoint.py   — AnnealCheckpointer: the engines' flat rung
#                            snapshots with a structural fingerprint
#   fault_tolerance.py     — RetryPolicy, CorruptionSpec, FaultInjector,
#                            DivergencePolicy, AnnealSupervisor
#   guardrails.py          — GuardrailPolicy, GuardrailMonitor: the
#                            integrity probes at rung boundaries
#   straggler.py           — StragglerMonitor (the sort server's
#                            per-dispatch timing), DeviceHealthMonitor
