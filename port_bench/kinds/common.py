"""What the kinds share: the program's configuration, the inputs made
from the seed, device readings."""
from __future__ import annotations

import importlib
import subprocess
import sys

import numpy as np


def seed_of(seed: int, *path: int) -> int:
    """A 63-bit seed for one purpose of a run, from ``--seed`` and a
    path of small integers (NumPy's SeedSequence: any size of seed)."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 128 - 1), *path])
    return int(ss.generate_state(1, np.uint64)[0]) & (2 ** 63 - 1)


def program_config(config: dict):
    """The program's ``ShuffleSoftSortConfig``: the anneal's published
    keys (``cfg``) and the program's own (``program``)."""
    from repro_torch.core import ShuffleSoftSortConfig
    return ShuffleSoftSortConfig(**config["cfg"], **config["program"])


def make_inputs(config: dict, count: int, seed: int, device):
    """(count, N, d) float32 inputs on ``device`` from one generator."""
    import torch
    gen_mod = importlib.import_module(f"port_bench.gen.{config['generator']}")
    h, w = config["grid"]
    g = torch.Generator(device=device).manual_seed(seed)
    return gen_mod.make(count, h * w, config["d"], g,
                        **config["generator_args"]).contiguous()


def sync(device) -> None:
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def device_info(device, peak_bytes: int) -> dict:
    import torch
    if str(device).startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak_bytes)}


def peak_bytes(device) -> int:
    import torch
    if str(device).startswith("cuda"):
        return int(torch.cuda.max_memory_allocated())
    return 0


def reset_peak(device) -> None:
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()


def log_card(device) -> None:
    """The card's name and power limit, beside every number of a run."""
    if not str(device).startswith("cuda"):
        return
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable: {e}"
    print(f"card: {out}", file=sys.stderr)


def rounds_k(config: dict) -> list:
    """Each round's band half-width (None: dense), as the configuration
    states the band and its switch."""
    from port_bench.reference import anneal
    h, w = config["grid"]
    n = h * w
    k = anneal.band_k(config["cfg"], n)
    sw = anneal.switch_round(config["cfg"], n)
    return [k if r >= sw else None for r in range(config["cfg"]["rounds"])]
