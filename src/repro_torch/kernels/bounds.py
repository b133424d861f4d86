"""The least time an H100 could take for each kernel's work.

A bound is the larger of two times: the bytes the function must move
(each input read once, each output written once) over the card's memory
rate, and the float32 operations it does over the card's CUDA-core peak
(the kernels use no tensor cores), or for the threefry hash its integer
operations over the card's INT32 peak.  Operations are counted per scored
pair from the algorithm; pairs are what these inputs need: N^2 per
SoftSort instance dense, N (2K + 1) - K (K + 1) within K ranks banded,
and for attention the (query, key) pairs the causal mask leaves.

``chip_smoke.py`` and ``repro_torch.bench.kernel_bench`` both read these
counts, so a kernel's bound is the same number wherever it is printed.
"""
from __future__ import annotations

# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 on the CUDA cores,
# HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# H100 SXM (NVIDIA data sheet): bfloat16 dense on the tensor cores, and
# NVLink 4, per direction per GPU (the LM roofline's rates,
# ``repro_torch.bench.roofline``).
PEAK_BF16_FLOPS = 989e12
PEAK_LINK_BYTES = 450e9
# INT32 operations per second: 132 SMs x 64 INT32 lanes at the clock at
# which 132 SMs x 128 FP32 lanes x 2 (an FMA) give the 67 TFLOP/s above,
# 67e12 / (132 * 256) = 1.983 GHz: 16.75e12 per second.
PEAK_INT32_OPS = 132 * 64 * PEAK_F32_FLOPS / (132 * 128 * 2)
# Integer instructions of one threefry2x32 hash in the SASS that nvcc
# builds for sm_90a: cuobjdump -sass of csrc/threefry.cu's
# threefry_round_kernel (chip_smoke.py's ``threefry_sass``, in its build
# line, built for an H100) holds 19.8 hashes (396 rotations), each 20.0
# SHF.L.W (the rotations), 20.8 LOP3.LUT (the xors) and, for the adds of
# the rounds and of the key injections, 6.4 IADD3, 17.6 IMAD.IADD and 4.2
# VIADD.  They issue to two pipes of 64 lanes per SM each: SHF, LOP3 and
# IADD3 to the INT32 (ALU) pipe only, 47.2 a hash; IMAD.IADD to the FMA
# pipe, beside it.  Counting VIADD on the FMA pipe too (the assignment
# that costs least time), that pipe's 21.8 stay under the ALU pipe's, so
# a hash holds the card for its 47.2 ALU operations at the INT32 rate.
THREEFRY_ALU_OPS_PER_HASH = (396 + 412 + 126) / 19.8
THREEFRY_FMA_OPS_PER_HASH = (348 + 84) / 19.8
THREEFRY_OPS_PER_HASH = max(THREEFRY_ALU_OPS_PER_HASH,
                            THREEFRY_FMA_OPS_PER_HASH)

# The kernels one fwd+grad of each kernel tier of the SoftSort apply
# launches (the v1 backward is plain torch and launches none).
TIER_KERNELS = {
    "kernel_v1": ("v1_stats", "v1_apply", "colsum"),
    "fused": ("fwd_fused", "colsum", "bwd_dws_delta", "bwd_dx"),
    "banded": ("fwd_band", "colsum_band", "bwd_band_dws_delta",
               "bwd_band_dcol"),
}


def _roofline(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def bound_ms(kernel: str, bsz: int, n: int, d: int, k: int | None = None,
             payload_bytes: int = 4) -> tuple[float, str]:
    """(ms, "operations" or "bytes") of a SoftSort-apply kernel at B
    instances of N keys and a d-wide payload of ``payload_bytes`` per
    value; ``k`` is the band half-width of the banded kernels."""
    pairs = bsz * (n * n if k is None else n * (2 * k + 1) - k * (k + 1))
    bn, bnd = bsz * n * 4, bsz * n * d * payload_bytes
    work = {   # (flops per pair, bytes moved)
        "fwd_fused": (2 * d + 6, 2 * bn + bnd + 4 + bnd + 2 * bn),
        "colsum": (6, 4 * bn + 4 + bn),
        "bwd_dws_delta": (2 * d + 14, 4 * bn + 3 * bnd + bn + 4 + 2 * bn),
        "bwd_dx": (4 * d + 13, 5 * bn + 2 * bnd + bn + 4 + bnd + 2 * bn),
        "fwd_band": (2 * d + 6, bn + bnd + 4 + bnd + 2 * bn),
        "colsum_band": (6, 3 * bn + 4 + bn),
        "bwd_band_dws_delta": (2 * d + 14, 4 * bn + 3 * bnd + 4 + 2 * bn),
        "bwd_band_dcol": (4 * d + 13, 5 * bn + 2 * bnd + 4 + bnd + 2 * bn),
        # score (sub, abs, mul), max, subtract m, exp, add; ws, w and tau
        # in, m and l out
        "v1_stats": (7, 2 * bn + 4 + 2 * bn),
        # score (sub, abs, mul), subtract m, exp, d FMAs of P x; ws, w, m,
        # l, x and tau in, y out
        "v1_apply": (2 * d + 5, 4 * bn + bnd + 4 + bnd),
    }
    flops_per_pair, nbytes = work[kernel]
    flops = pairs * flops_per_pair
    if kernel == "v1_apply":   # per row: 1 / l, then d multiplies
        flops += bsz * n * (d + 1)
    return _roofline(flops, nbytes)


def tier_bound_ms(tier: str, bsz: int, n: int, d: int, k: int,
                  payload_bytes: int = 4) -> float | None:
    """Sum of the bounds of the kernels one fwd+grad of ``tier`` launches
    (None for a tier with no kernel).  The banded tier runs the dense
    kernels when the band covers every pair (K >= N - 1)."""
    if tier == "banded" and k >= n - 1:
        tier = "fused"
    if tier not in TIER_KERNELS:
        return None
    band = k if tier == "banded" else None
    return sum(bound_ms(name, bsz, n, d, band,
                        4 if name.startswith("v1") else payload_bytes)[0]
               for name in TIER_KERNELS[tier])


def attention_pairs(tq: int, tk: int, causal: bool, q_offset: int) -> int:
    """Scored (query, key) pairs of one plane: row i scores keys
    j <= i + q_offset when causal (all tk keys if it has none)."""
    if not causal:
        return tq * tk
    total = 0
    for i in range(tq):
        reach = i + q_offset + 1
        total += tk if reach <= 0 else min(tk, reach)
    return total


def flash_bound_ms(kernel: str, bh: int, bhkv: int, tq: int, tk: int,
                   dh: int, causal: bool = True, q_offset: int = 0,
                   splits: int = 1) -> tuple[float, str]:
    """(ms, "operations" or "bytes") of a flash-attention kernel on bh
    query planes of (tq, dh) float32 over bhkv key/value planes of
    (tk, dh); ``splits`` the key splits whose partials ``flash_combine``
    (or the forward's cluster epilogue, ``flash_merge_cluster``) merges."""
    pairs = bh * attention_pairs(tq, tk, causal, q_offset)
    bq, bkv, brow = bh * tq * dh * 4, bhkv * tk * dh * 4, bh * tq * 4
    work = {   # (flops, bytes moved)
        # q.k, scale, max, exp, add, 2 dh of P v, rescale; q, k, v in,
        # o, m and l out
        "flash_forward": (pairs * (4 * dh + 6), bq + 2 * bkv + bq + 2 * brow),
        # per row and split: max, exp, l and o terms; partials in, o, m, l
        # out
        "flash_combine": (splits * bh * tq * (2 * dh + 5),
                          splits * (bq + 2 * brow) + bq + 2 * brow),
        # the same merge in the forward's cluster epilogue: the partials
        # pass through distributed shared memory, and o, m and l are the
        # forward's own output, so no device-memory byte is its own
        "flash_merge_cluster": (splits * bh * tq * (2 * dh + 5), 0),
    }
    return _roofline(*work[kernel])


def _hashes_per_row(m: int, mode: int) -> int:
    """Hashes of one key's m words in a ``kernels.threefry`` layout:
    ORIGINAL (0) one per pair, ceil(m / 2); XOR (1) one per word; PAIRS
    (2) and FOLD (3) one per two words."""
    return -(-m // 2) if mode == 0 else m if mode == 1 else m // 2


def _int_roofline(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops = ops / PEAK_INT32_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def threefry_bound_ms(r: int, m: int, mode: int) -> tuple[float, str]:
    """(ms, "operations" or "bytes") of ``threefry_bits``: R keys of two
    int64 words in, R x m int32 words out; the hashes of the layout at
    ``THREEFRY_OPS_PER_HASH`` integer operations each, those of the busier
    of the two integer pipes."""
    ops = r * _hashes_per_row(m, mode) * THREEFRY_OPS_PER_HASH
    return _int_roofline(ops, r * 2 * 8 + r * m * 4)


def threefry_given_bound_ms(r: int, m: int) -> tuple[float, str]:
    """(ms, "operations" or "bytes") of ``threefry_given``: R keys of two
    int64 words and the m int64 words of the count in, R x m int32 words
    out; one hash per pair of count words, ceil(m / 2) per key."""
    ops = r * -(-m // 2) * THREEFRY_OPS_PER_HASH
    return _int_roofline(ops, r * 2 * 8 + m * 8 + r * m * 4)


def threefry_round_bound_ms(r: int, n: int, rounds: int,
                            partitionable: bool) -> tuple[float, str]:
    """(ms, "operations" or "bytes") of ``threefry_round`` with the
    source's keys split first: R keys in and R kept keys out (int64
    words), rounds x R x n int32 sort words out; per row the key chain (a
    split of the source and one per round, two hashes each) and each
    round's words (one hash per word partitionable, per pair original)."""
    per_round = n if partitionable else -(-n // 2)
    hashes = r * (2 * (1 + rounds) + rounds * per_round)
    return _int_roofline(hashes * THREEFRY_OPS_PER_HASH,
                         2 * r * 2 * 8 + rounds * r * n * 4)
