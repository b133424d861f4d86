"""The port's synthetic data (``repro_torch.data``) against the reference
(``repro.data.synthetic``) on the CPU.

``tokens`` and ``labels`` are bitwise the reference's at several
``(batch, seq, step, seed)``.  The bfloat16 ``context`` of the vlm and
audio models is ``jax.random.normal`` at bfloat16, reproduced from its
8-bit draws: bitwise too, element for element, on every case here (0 of
the 13 824 context elements differ, and 0 of a 262 144-element draw).
Then the reference's own data cases (``tests/test_optim_data.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.data import synthetic as jdata  # noqa: E402
from repro.models import reduced_config as jreduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.data import synthetic as tdata  # noqa: E402
from repro_torch.models import SHAPE_CELLS, reduced_config  # noqa: E402

CASES = [(2, 16, 0, 0), (4, 33, 7, 3), (3, 128, 12345, 2 ** 31 + 5)]
ARCHS = ["qwen1.5-0.5b", "whisper-small", "llama-3.2-vision-90b"]


def _i16(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b,s,step,seed", CASES)
def test_synthetic_batch_is_the_reference_bitwise(arch, b, s, step, seed):
    want = jdata.synthetic_batch(jreduced(jget(arch)), b, s, step,
                                 seed=seed)
    got = tdata.synthetic_batch(reduced_config(get_config(arch)), b, s,
                                step, seed=seed, device="cpu")
    assert sorted(got) == sorted(want)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    if "context" in want:
        assert got["context"].dtype == torch.bfloat16
        assert got["context"].shape == want["context"].shape
        np.testing.assert_array_equal(_i16(got["context"]),
                                      _i16(want["context"]))


def test_bf16_normal_is_jaxs_bitwise():
    key = jax.random.PRNGKey(11)
    want = jax.random.normal(key, (256, 1024), jnp.bfloat16)
    got = tdata.normal_bf16(threefry.as_keys(
        np.asarray(jax.random.key_data(key)), "cpu"), (256, 1024))
    np.testing.assert_array_equal(_i16(got), _i16(want))


def test_full_vocab_tokens_match_reference():
    """Qwen's published vocab (151 936): randint's span reduction at a
    non-power-of-two span."""
    want = jdata.synthetic_batch(jget("qwen1.5-0.5b"), 2, 64, 3)
    got = tdata.synthetic_batch(get_config("qwen1.5-0.5b"), 2, 64, 3,
                                device="cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))


def test_synthetic_batch_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdata.synthetic_batch(reduced_config(get_config("qwen1.5-0.5b")), 2,
                              8, 0)


def test_specs_are_meta_tensors_of_the_reference_shapes():
    cell = SHAPE_CELLS[0]
    for arch in ARCHS:
        want = jdata.batch_specs(jget(arch), cell)
        got = tdata.batch_specs(get_config(arch), cell)
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == want[k].shape
            assert str(v.dtype).split(".")[-1] == str(want[k].dtype)
    assert tdata.context_spec(get_config("qwen1.5-0.5b"), 4) is None
    assert tuple(tdata.token_spec(2, 5).shape) == (2, 5)


# --------------------------------------- the reference's own data cases

def _cfg():
    return reduced_config(get_config("qwen1.5-0.5b"))


def test_synthetic_batch_deterministic_across_calls():
    b1 = tdata.synthetic_batch(_cfg(), 4, 16, step=7, device="cpu")
    b2 = tdata.synthetic_batch(_cfg(), 4, 16, step=7, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])


def test_synthetic_batch_differs_across_steps():
    b1 = tdata.synthetic_batch(_cfg(), 4, 16, step=1, device="cpu")
    b2 = tdata.synthetic_batch(_cfg(), 4, 16, step=2, device="cpu")
    assert not torch.equal(b1["tokens"], b2["tokens"])


def test_synthetic_labels_are_shifted_tokens():
    b = tdata.synthetic_batch(_cfg(), 2, 32, step=0, device="cpu")
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_synthetic_context_for_modalities():
    vlm = reduced_config(get_config("llama-3.2-vision-90b"))
    b = tdata.synthetic_batch(vlm, 2, 8, step=0, device="cpu")
    assert b["context"].shape == (2, vlm.vision_tokens, vlm.vision_d)
    aud = reduced_config(get_config("whisper-small"))
    b = tdata.synthetic_batch(aud, 2, 8, step=0, device="cpu")
    assert b["context"].shape == (2, aud.audio_frames, aud.d_model)
