"""End-to-end LM training example: trains a ~10M-parameter decoder LM
for a few hundred steps through the port's training stack: the synthetic
data pipeline, Adam, checkpoints, an injected failure and its recovery,
the straggler monitor.  Counterpart of ``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm
    PYTHONPATH=src python -m repro_torch.examples.train_lm \\
        --preset 100m --steps 30
    PYTHONPATH=src python -m repro_torch.examples.train_lm \\
        --preset tiny --steps 40 --device cpu

It takes ``repro_torch.launch.train``'s flags, runs on the CUDA device
unless ``--device`` names another, and asserts that the loss fell.
"""
from __future__ import annotations

from repro_torch.launch.train import main as train


def main(argv=None):
    stats = train(argv)
    assert stats["last_loss"] < stats["first_loss"], "loss must decrease"
    print("OK: loss decreased through failure-recovery training")
    return stats


if __name__ == "__main__":
    main()
