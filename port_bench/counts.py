"""The SoftSort apply's least work, counted from shapes alone, and the
H100's peaks it is held against.

Whatever implements the apply (four kernels today, a fused or tensor-core
one later), one inner step of B instances needs:

* pairs: every (row, column) pair the soft permutation holds, N^2 an
  instance dense, N (2K + 1) - K (K + 1) banded (rank space, |r - c| <= K);
* contractions, 4d FLOPs a pair: y = P x forward (2d) and dP = dy x^T
  backward (2d).  The keys alone are trained, so no dx = P^T dy;
* elementwise work, FLOPs a pair from the algorithm: forward 9 (score:
  difference, |.|, 1/tau; running max; shift and exp; row sum; normalise;
  column sum), backward 13 (the score again, 6; dP + dc; - delta_r; times
  p; sign and 1/tau; row and column sums of the key gradient);
* bytes: each input and output of the forward and the backward once: w,
  x, tau, y, colsum forward; dy, dcolsum, the saved keys, dw backward.

The least time is the largest of the contractions at 165 TFLOP/s (float32
accuracy on the tensor cores: TF32's 495 over the three products 3xTF32
takes), the elementwise FLOPs at 67 TFLOP/s (float32 off the tensor
cores) and the bytes at 3.35 TB/s, an H100 SXM's data sheet at 700 W.
"""
from __future__ import annotations

PEAKS = {
    "contraction_flops": 495e12 / 3,   # 3xTF32 on the tensor cores
    "elementwise_flops": 67e12,        # float32 CUDA cores
    "bytes": 3.35e12,                  # HBM3
}
EW_FWD, EW_BWD = 9, 13
F32_BYTES = 4


def pairs(n: int, k: int | None) -> int:
    """Pairs of one instance's soft permutation: dense (k None) or
    banded."""
    if k is None or k >= n - 1:
        return n * n
    return n * (2 * k + 1) - k * (k + 1)


def step_work(b: int, n: int, d: int, k: int | None) -> dict:
    """FLOPs and bytes of one inner step (forward and backward) of B
    instances."""
    p = b * pairs(n, k)
    # forward: w, x, tau in; y, colsum out.  backward: dy, dcolsum, w
    # (saved) in; dw out.
    words = b * (n + n * d + 1 + n * d + n) + b * (n * d + n + n + n)
    return {"contraction_flops": 4 * d * p,
            "elementwise_flops": (EW_FWD + EW_BWD) * p,
            "bytes": F32_BYTES * words}


def least_seconds(work: dict) -> float:
    return max(work[key] / PEAKS[key] for key in PEAKS)


def run_least_seconds(b: int, n: int, d: int, rounds: list[int | None],
                      inner_steps: int) -> float:
    """Least seconds of the apply over the given rounds, each named by its
    band half-width (None: dense)."""
    return sum(inner_steps * least_seconds(step_work(b, n, d, k))
               for k in rounds)
