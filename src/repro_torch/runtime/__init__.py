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
#                            TrainSupervisor (the LM trainer's restarts),
#                            DivergencePolicy, AnnealSupervisor
#   compression.py         — int8 gradient compression with error
#                            feedback (the trainer's --compress-grads)
#   guardrails.py          — GuardrailPolicy, GuardrailMonitor: the
#                            integrity probes at rung boundaries
#   straggler.py           — StragglerMonitor (the sort server's
#                            per-dispatch timing), DeviceHealthMonitor
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: F401,E402
from repro_torch.runtime.compression import (  # noqa: F401,E402
    CompressionState,
    compress_gradients,
    init_compression,
)
from repro_torch.runtime.fault_tolerance import (  # noqa: F401,E402
    AnnealSupervisor,
    CorruptionSpec,
    DivergencePolicy,
    FaultInjector,
    RetryPolicy,
    TrainSupervisor,
    WorkerFailure,
)
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401,E402
