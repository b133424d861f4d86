"""Roofline analysis of the dry-run records, the port's counterpart of
``benchmarks/roofline.py``.

Reads the JSON that ``python -m repro_torch.launch.dryrun --all --out ...``
writes and derives, per (arch x shape), at an H100 SXM's peaks
(``repro_torch.kernels.bounds``):

    compute_s    = per-device FLOPs / 989e12         (bf16 dense)
    memory_s     = per-device bytes / 3.35e12        (HBM3)
    collective_s = per-device wire bytes / 450e9     (NVLink 4, per
                                                      direction)

plus MODEL_FLOPS = 6 N_active D (train) / 2 N_active D (prefill, decode)
and the useful-compute ratio MODEL_FLOPS / FLOPs counted, which catches
remat and redundant work.  The reference's meshes keep their shapes: a
"model" axis of 16 spans two 8-GPU NVLink domains, so its collectives
cross the slower inter-node links, and ``collective_s`` at the NVLink rate
is a floor on the collective term, not an estimate of it.

    python -m repro_torch.bench.roofline --records dryrun_single.json
"""
from __future__ import annotations

import argparse
import json

from repro_torch.kernels.bounds import (PEAK_BF16_FLOPS, PEAK_BYTES,
                                        PEAK_LINK_BYTES)

PEAK_FLOPS = PEAK_BF16_FLOPS     # H100 SXM, bf16 dense
HBM_BW = PEAK_BYTES              # H100 SXM, HBM3, B/s
LINK_BW = PEAK_LINK_BYTES        # H100 SXM, NVLink 4 per direction, B/s
CHIPS = {"single": 256, "multi": 512}


def active_param_counts(arch: str) -> tuple[int, int]:
    """(total_active_params, embed_params) from the ``meta`` skeleton; MoE
    expert weights scale by k/E, rounded down per stacked leaf (each unit
    position's weight over all repeats), as the reference rounds."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    cfg = get_config(arch)
    model = LM(cfg, None, torch.device("meta"))
    unit_len = len(cfg.block_program()[0])
    moe_frac = (cfg.num_experts_per_tok / cfg.num_experts
                if cfg.num_experts else 1.0)
    active = embed = 0
    moe = {}
    for name, p in model.named_parameters():
        n = p.numel()
        if "embed" in name:
            embed += n
        elif "moe" in name and "router" not in name:
            _, layer, rest = name.split(".", 2)
            key = (int(layer) % unit_len, rest)
            moe[key] = moe.get(key, 0) + n
        else:
            active += n
    active += sum(int(n * moe_frac) for n in moe.values())
    return active, embed


def model_flops(arch: str, shape: str, kind: str) -> float:
    from repro_torch.models.config import cell_by_name
    cell = cell_by_name(shape)
    n_active, _ = active_param_counts(arch)
    if kind == "train":
        return 6.0 * n_active * cell.global_batch * cell.seq_len
    if kind == "prefill":
        return 2.0 * n_active * cell.global_batch * cell.seq_len
    return 2.0 * n_active * cell.global_batch     # decode: one token each


def analyze(records: list[dict], peak_flops: float = PEAK_FLOPS,
            hbm_bw: float = HBM_BW, link_bw: float = LINK_BW) -> list[dict]:
    """One row per ``ok`` record with roofline inputs, at the given rates
    (default the H100 SXM's)."""
    out = []
    for rec in records:
        if rec.get("status") != "ok" or rec.get("kind") == "paper":
            continue
        ri = rec.get("roofline_inputs", {})
        if "flops" not in ri:
            continue
        compute_s = ri["flops"] / peak_flops
        memory_s = ri["bytes_accessed"] / hbm_bw
        coll_s = ri["collective_bytes"] / link_bw
        mf_dev = model_flops(rec["arch"], rec["shape"],
                             rec["kind"]) / CHIPS[rec["mesh"]]
        terms = {"compute": compute_s, "memory": memory_s,
                 "collective": coll_s}
        dominant = max(terms, key=terms.get)
        bound = max(terms.values())
        out.append({
            "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            "compute_s": compute_s, "memory_s": memory_s,
            "collective_s": coll_s, "dominant": dominant,
            "model_flops_dev": mf_dev,
            "useful_ratio": mf_dev / max(ri["flops"], 1.0),
            "roofline_frac": (mf_dev / peak_flops) / max(bound, 1e-12),
        })
    return out


def print_table(rows):
    hdr = (f"{'arch':26s} {'shape':12s} {'compute_s':>10s} {'memory_s':>9s} "
           f"{'coll_s':>9s} {'bound':>10s} {'useful':>7s} {'roofline':>8s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['arch']:26s} {r['shape']:12s} {r['compute_s']:>10.4f} "
              f"{r['memory_s']:>9.4f} {r['collective_s']:>9.4f} "
              f"{r['dominant']:>10s} {r['useful_ratio']:>7.3f} "
              f"{r['roofline_frac']:>8.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", default="dryrun_single.json")
    args = ap.parse_args(argv)
    with open(args.records) as f:
        print_table(analyze(json.load(f)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
