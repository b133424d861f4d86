"""The port's LM decode serving (``repro_torch.launch.serve``'s
``--workload lm``, ``serve_lm``) on the CPU, against the reference CLI.

The CLI serves at the ``tiny`` preset for a dense, an MoE, an SSM and the
audio architecture.  With the reference CLI's own weights (its
``init_model(PRNGKey(0), cfg)``, captured and handed over by
``params_from_jax``), ``serve_lm`` generates the reference CLI's greedy
tokens, and its per-step logits agree within atol 1e-4 (float32).  The
reference CLI runs as it is; the logits its greedy ``argmax`` reads are
recorded through the module's ``jnp``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.serve as jserve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.train import PRESETS  # noqa: E402
from repro_torch.models import params_from_jax, reduced_config  # noqa: E402

ARCHS = ["qwen1.5-0.5b", "granite-moe-3b-a800m", "mamba2-370m",
         "whisper-small"]
FLAGS = ["--preset", "tiny", "--requests", "4", "--max-new", "8"]


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_lm(arch, capsys):
    out = tserve.main(["--workload", "lm", "--device", "cpu", "--arch", arch,
                       *FLAGS])
    assert "served 4 requests" in capsys.readouterr().out
    assert out["tokens"].shape == (4, 8)
    assert out["tok_per_s"] > 0 and out["prefill_s"] > 0
    assert len(out["logits"]) == 8


class _RecordingJnp:
    """``jax.numpy`` for the reference CLI's module, recording the logits
    that its greedy ``argmax`` reads (outside ``jit``)."""

    def __init__(self, logits):
        self.logits = logits

    def __getattr__(self, name):
        return getattr(jnp, name)

    def argmax(self, a, axis=None):
        self.logits.append(np.asarray(a))
        return jnp.argmax(a, axis=axis)


def _reference_cli(arch, monkeypatch):
    """Run the reference CLI; return its params and each step's logits."""
    seen = {"logits": []}
    init = jserve.init_model

    def init_model(key, cfg):
        out = init(key, cfg)
        seen["params"] = out[0]
        return out

    monkeypatch.setattr(jserve, "init_model", init_model)
    monkeypatch.setattr(jserve, "jnp", _RecordingJnp(seen["logits"]))
    jserve.main(["--workload", "lm", "--arch", arch, *FLAGS])
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_generates_the_reference_tokens(arch, monkeypatch, capsys):
    seen = _reference_cli(arch, monkeypatch)
    cfg = reduced_config(get_config(arch), **PRESETS["tiny"])
    model = params_from_jax(cfg, jax.tree.map(np.asarray, seen["params"]),
                            device="cpu")
    out = tserve.serve_lm(cfg, requests=4, max_new=8, device="cpu",
                          model=model)
    want = np.concatenate([lg.argmax(-1) for lg in seen["logits"]], axis=1)
    np.testing.assert_array_equal(out["tokens"], want)
    assert len(out["logits"]) == len(seen["logits"]) == 8
    for got, ref in zip(out["logits"], seen["logits"]):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def test_serve_lm_pads_attention_caches_by_type():
    """Only the attention caches grow to the decode horizon; an SSM state
    whose head count equals the prompt length (which the reference's
    ``shape[2] == max_len`` rule would pad) keeps its shape."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.ssm import SSMCache
    kv = KVCache(torch.ones(2, 5, 3, 4), torch.ones(2, 5, 3, 4))
    ssm = SSMCache(torch.ones(2, 3, 8), torch.ones(2, 3, 4),
                   torch.ones(2, 3, 4), torch.ones(2, 5, 4, 4))
    padded = tserve.pad_caches([kv, ssm], 3)
    assert padded[0].k.shape == padded[0].v.shape == (2, 8, 3, 4)
    assert not padded[0].k[:, 5:].any() and bool(padded[0].k[:, :5].all())
    assert padded[1] is ssm


def test_lm_prompts_are_the_reference_clis():
    cfg = reduced_config(get_config("qwen1.5-0.5b"), **PRESETS["tiny"])
    prompts, max_len = tserve.lm_prompts(cfg, 8, 24)
    rng = np.random.RandomState(0)
    lens = rng.randint(4, 25, size=8)
    assert max_len == lens.max()
    np.testing.assert_array_equal(
        prompts, rng.randint(0, cfg.vocab_size, size=(8, max_len)))
    assert prompts.dtype == np.int32


def test_cli_lm_is_the_default_and_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--preset", "tiny"])


@pytest.mark.parametrize("flags,needle", [
    (["--max-new", "0"], "--max-new"), (["--requests", "0"], "--requests"),
    (["--prompt-len", "3"], "--prompt-len")])
def test_cli_rejects_bad_lm_traffic_with_argparse_error(flags, needle,
                                                         capsys):
    with pytest.raises(SystemExit) as ei:
        tserve.main(["--device", "cpu", *flags])
    assert ei.value.code == 2
    assert needle in capsys.readouterr().err
