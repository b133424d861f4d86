"""The port's threefry draws (``repro_torch.core.threefry``, the kernel
twin of ``repro_torch.kernels.threefry``) and ``ThreefryShuffleSource``
against the installed jax, on the CPU.

* In both counter layouts (``jax.threefry_partitionable(True / False)``):
  ``prng_key``, ``split``, ``random_bits``, ``uniform``, ``randint`` and
  ``permutation`` bitwise, batched and unbatched; ``normal`` within 4 ulp
  (XLA's ``log1p`` is not torch's: measured at most 3 ulp, on about 1% of
  the values).  The hash on jax's known-answer vectors.
* The stable sort of ``permutation`` on crafted sort keys with ties: the
  earlier index first, as ``lax.sort_key_val(..., is_stable=True)``.
* ``ThreefryShuffleSource``: its rounds along the reference's chains
  (sequential: the key itself; batched: per row), rows drawn apart, and
  ``fork``, ``advanced``, ``take``, ``stack_sources``.
* The engines with ``key=`` / ``keys=`` on the plain tier: bitwise the
  same engines fed a ``ReplayShuffleSource`` of the JAX chains, and
  against the reference's own run with the same key (orders equal, losses
  rtol 1e-5, ``lambda_sigma=0``: ROADMAP.md Queue C1).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax._src import prng as jprng  # noqa: E402

from repro.core import shufflesoftsort as jeng  # noqa: E402
from repro.core.losses import mean_pairwise_distance as jmpd  # noqa: E402
from repro_torch.core import shufflesoftsort as teng  # noqa: E402
from repro_torch.core import threefry as tf  # noqa: E402
from repro_torch.core.prng import (  # noqa: E402
    ReplayShuffleSource,
    ThreefryShuffleSource,
    TorchShuffleSource,
    stack_sources,
)
from repro_torch.core.reference import config_from_reference  # noqa: E402
from repro_torch.kernels import threefry as ktf  # noqa: E402

CPU = "cpu"
LAYOUTS = [True, False]


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread is several times faster than
    many contending ones (the suite runs in parallel workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
# (key, count) -> the two words: jax's threefry2x32 known-answer vectors
# (the Random123 test vectors), checked against the installed jax too.
KNOWN = [((0x00000000, 0x00000000), (0x00000000, 0x00000000),
          (0x6B200159, 0x99BA4EFE)),
         ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
          (0x1CB996FC, 0xBB002BE7)),
         ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
          (0xC4923A9C, 0x483DF7A0))]
NORMAL_ULP = 4


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                  np.asarray(want).astype(np.int64))


def _key(seed=42):
    return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("key,count,want", KNOWN)
def test_threefry_2x32_known_answers(key, count, want):
    k = np.array(key, np.uint32)
    c = np.array(count, np.uint32)
    got = tf.threefry_2x32(k, c, device=CPU)
    _eq(got, want)
    _eq(got, jprng.threefry_2x32(jnp.asarray(k), jnp.asarray(c)))
    k0, k1 = (torch.tensor([[v]]) for v in key)
    x0, x1 = ktf.threefry2x32_plain(k0, k1, torch.tensor([[count[0]]]),
                                    torch.tensor([[count[1]]]))
    _eq([int(x0), int(x1)], want)


# counts of threefry_2x32 on any shape (Queue C15): 1, 2, 3, 7 and 4096
# words, and a 2-D count
COUNT_SHAPES = [(1,), (2,), (3,), (7,), (4096,), (3, 5)]


@pytest.mark.parametrize("shape", COUNT_SHAPES)
def test_threefry_2x32_of_any_count_is_jaxs(shape):
    """``threefry_given`` hashes a count of any shape bitwise
    ``jax._src.prng.threefry_2x32``, and its twin is the halves of the
    padded count through the bare hash (the CPU path before it)."""
    rng = np.random.default_rng(int(np.prod(shape)))
    k = rng.integers(0, 2 ** 32, 2, dtype=np.uint32)
    c = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    got = tf.threefry_2x32(k, c, device=CPU)
    assert got.shape == shape and got.dtype == torch.int64
    _eq(got, jprng.threefry_2x32(jnp.asarray(k), jnp.asarray(c)))
    flat = torch.as_tensor(c.astype(np.int64)).reshape(-1)
    m, h = flat.numel(), (flat.numel() + 1) // 2
    padded = torch.cat([flat, flat.new_zeros(2 * h - m)])
    kt = torch.as_tensor(k.astype(np.int64))
    x0, x1 = ktf.threefry2x32_plain(kt[0], kt[1], padded[:h], padded[h:])
    _eq(ktf.words(ktf.threefry_given_plain(kt[None], flat))[0],
        torch.cat([x0, x1])[:m])


def test_threefry_given_checks_its_inputs():
    keys = torch.zeros((1, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        ktf.threefry_given(keys, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="int64"):
        ktf.threefry_given(keys, torch.zeros((2, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="keys"):
        ktf.threefry_given(keys[0], torch.zeros(4, dtype=torch.int64))
    assert ktf.threefry_given(keys, torch.zeros(0, dtype=torch.int64)
                              ).shape == (1, 0)


@pytest.mark.parametrize("seed", [0, 1, 42, -1, 2 ** 40 + 3])
def test_prng_key_matches_jax(seed):
    got = tf.prng_key(seed)
    assert got.dtype == np.uint32
    _eq(got, jax.random.PRNGKey(seed))


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("num", [2, 7])
def test_split_matches_jax(partitionable, num):
    with jax.threefry_partitionable(partitionable):
        k = _key()
        _eq(tf.split(np.asarray(k), num, partitionable=partitionable,
                     device=CPU), jax.random.split(k, num))
        ks = jax.random.split(k, 3)
        _eq(tf.split(np.asarray(ks), num, partitionable=partitionable,
                     device=CPU),
            np.stack([np.asarray(jax.random.split(kk, num)) for kk in ks]))


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("shape", [(1,), (7,), (4096,), (3, 5), (64, 64)])
def test_random_bits_match_jax(partitionable, shape):
    with jax.threefry_partitionable(partitionable):
        k = _key(7)
        _eq(tf.random_bits(np.asarray(k), shape, partitionable=partitionable,
                           device=CPU),
            jax.random.bits(k, shape, jnp.uint32))
        ks = jax.random.split(k, 2)
        _eq(tf.random_bits(np.asarray(ks), shape,
                           partitionable=partitionable, device=CPU),
            np.stack([np.asarray(jax.random.bits(kk, shape, jnp.uint32))
                      for kk in ks]))


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (1e-9, 1.0), (-2.5, 3.0)])
def test_uniform_matches_jax_bitwise(partitionable, bounds):
    with jax.threefry_partitionable(partitionable):
        k = _key(3)
        got = tf.uniform(np.asarray(k), (33, 31), *bounds,
                         partitionable=partitionable, device=CPU).numpy()
        want = np.asarray(jax.random.uniform(k, (33, 31), minval=bounds[0],
                                             maxval=bounds[1]))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("lo,hi", [(0, 4096), (-5, 1000003), (0, 65536)])
def test_randint_matches_jax(partitionable, lo, hi):
    with jax.threefry_partitionable(partitionable):
        k = _key(11)
        got = tf.randint(np.asarray(k), (2048,), lo, hi,
                         partitionable=partitionable, device=CPU)
        assert got.dtype == torch.int32
        _eq(got, jax.random.randint(k, (2048,), lo, hi))


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("n", [1, 2, 36, 1024, 4096])
def test_permutation_matches_jax(partitionable, n):
    with jax.threefry_partitionable(partitionable):
        k = _key(n)
        _eq(tf.permutation(np.asarray(k), n, partitionable=partitionable,
                           device=CPU), jax.random.permutation(k, n))
        ks = jax.random.split(k, 3)
        _eq(tf.permutation(np.asarray(ks), n, partitionable=partitionable,
                           device=CPU),
            np.stack([np.asarray(jax.random.permutation(kk, n))
                      for kk in ks]))


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_normal_within_ulp_bound(partitionable):
    """Every value within NORMAL_ULP of XLA's (measured: at most 3 ulp, on
    about 1% of the values), at one and at several intra-op threads."""
    with jax.threefry_partitionable(partitionable):
        k = _key(5)
        want = np.asarray(jax.random.normal(k, (64, 500)))
    for threads in (1, 4):
        torch.set_num_threads(threads)
        got = tf.normal(np.asarray(k), (64, 500), partitionable=partitionable,
                        device=CPU).numpy()
        ulp = np.abs(got.view(np.int32).astype(np.int64)
                     - want.view(np.int32).astype(np.int64))
        worst = np.argsort(ulp.ravel())[-3:]
        assert ulp.max() <= NORMAL_ULP, (threads, worst, ulp.ravel()[worst],
                                         got.ravel()[worst],
                                         want.ravel()[worst])
        assert np.mean(ulp > 0) < 0.05


def test_permutation_sort_is_stable_on_tied_keys(monkeypatch):
    """Crafted sort keys with ties in both rounds of an n = 4096 shuffle:
    the port keeps the earlier index first, as XLA's stable sort."""
    n = 4096
    rng = np.random.default_rng(0)
    crafted = [rng.integers(0, 40, n).astype(np.int64),
               np.where(rng.random(n) < 0.5, 7,
                        rng.integers(0, 2 ** 32, n)).astype(np.int64)]
    monkeypatch.setattr(tf, "threefry_round_op",
                        lambda keys, n, rounds, *args: torch.stack([
                            torch.as_tensor(sk - 2 ** 31).to(torch.int32)[None]
                            for sk in crafted[:rounds]]))
    got = tf.permutation(np.asarray(_key()), n, device=CPU)
    x = jnp.arange(n)
    for sk in crafted:
        _, x = lax.sort_key_val(jnp.asarray(sk.astype(np.uint32)), x,
                                is_stable=True)
    _eq(got, x)


def test_kernel_wrapper_routes_cpu_tensors_to_the_twin():
    keys = torch.tensor([[0, 42], [1, 2]], dtype=torch.int64)
    ktf.threefry_bits.launches = 0
    for mode, m in ((ktf.ORIGINAL, 7), (ktf.XOR, 9), (ktf.PAIRS, 8)):
        _eq(ktf.threefry_bits(keys, m, mode),
            ktf.threefry_bits_plain(keys, m, mode))
    assert ktf.threefry_bits.launches == 0
    with pytest.raises(ValueError):
        ktf.threefry_bits(keys, 7, ktf.PAIRS)
    with pytest.raises(ValueError):
        ktf.threefry_bits(keys.to(torch.int32), 8, ktf.XOR)


FOLD_DATA = [0, 1, 2 ** 31, 2 ** 32 - 1]


@pytest.mark.parametrize("data", FOLD_DATA)
def test_fold_in_twin_is_jax_bitwise(data):
    """The kernel twin's FOLD layout (the counter ``(0, data)``) and
    ``fold_in`` over a batch of keys, bitwise ``jax.random.fold_in`` of
    each key (one layout under either ``jax_threefry_partitionable``)."""
    keys = np.asarray(jax.random.split(_key(13), 5))
    want = np.stack([np.asarray(jax.random.fold_in(k, data)) for k in keys])
    t = torch.as_tensor(keys.astype(np.int64))
    _eq(ktf.words(ktf.threefry_bits_plain(t, 2, ktf.FOLD, data)), want)
    _eq(tf.fold_in(keys, data, device=CPU), want)
    _eq(tf.fold_in(keys[None], data, device=CPU), want[None])


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("n", [1000, 4096])
def test_fused_round_twin_is_the_unfused_draws_and_jaxs(partitionable, n):
    """``threefry_round_plain`` at N = 1000 (1 permutation round) and 4096
    (2): bitwise the unfused ``split`` and ``_sort_words`` draws (composed
    here, as ``permutation`` drew them before the fused round), and
    through the stable sorts jax's ``split`` then ``permutation`` of each
    key, with the source split first (the kept keys jax's first halves)
    and without."""
    rounds = ktf.permutation_rounds(n)
    assert rounds == {1000: 1, 4096: 2}[n]
    with jax.threefry_partitionable(partitionable):
        keys = jax.random.split(_key(n), 3)
        pairs = jax.vmap(jax.random.split)(keys)
        want_kept = np.asarray(pairs[:, 0])
        want_split = np.stack([np.asarray(jax.random.permutation(k, n))
                               for k in pairs[:, 1]])
        want_plain = np.stack([np.asarray(jax.random.permutation(k, n))
                               for k in keys])
    t = torch.as_tensor(np.asarray(keys).astype(np.int64))
    for split_keys, want in ((True, want_split), (False, want_plain)):
        kept, words_ = ktf.threefry_round_plain(t, n, rounds, partitionable,
                                                split_keys)
        kept_u, k = (None, t)
        if split_keys:
            pair = tf.split(t, partitionable=partitionable)
            kept_u, k = pair[:, 0], pair[:, 1]
        words_u = []
        for _ in range(rounds):
            pair = tf.split(k, partitionable=partitionable)
            k = pair[:, 0]
            words_u.append(tf._sort_words(pair[:, 1], (n,), partitionable,
                                          None))
        assert words_.shape == (rounds, 3, n)
        for a, b in zip(words_, words_u):
            _eq(a, b)
        _eq(tf._shuffle(words_, 3, n, t.device), want)
        if split_keys:
            _eq(kept, want_kept)
            _eq(kept_u, want_kept)
        else:
            assert kept is None and kept_u is None
    got_kept, got = tf.shuffle_round(t, n, partitionable=partitionable)
    _eq(got_kept, want_kept)
    _eq(got, want_split)


def test_fold_in_and_threefry_2x32_on_cpu_launch_nothing():
    """CPU tensors take the twins: no kernel launch is counted, and the
    one-pair hash of the kernel's FOLD layout is the known answer."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    tf.fold_in(np.asarray(jax.random.split(_key(2), 4)), 7, device=CPU)
    tf.threefry_2x32(np.array(KNOWN[2][0], np.uint32),
                     np.array(KNOWN[2][1], np.uint32), device=CPU)
    ThreefryShuffleSource(np.asarray(jax.random.split(_key(3), 2)), 64,
                          CPU).next_round()
    assert not any(launch_counts().values())
    (k0, k1), (x0, x1), want = KNOWN[2]
    got = ktf.threefry_bits_plain(torch.tensor([[k0, k1]]), 2, ktf.FOLD,
                                  x0 << 32 | x1)
    _eq(ktf.words(got)[0], want)


def test_threefry_bounds_by_hand():
    """Row 11's bound: the larger of the bytes (16 B of key per row in, 4
    B per word out) over 3.35 TB/s and the hashes at the ALU pipe's
    operations of one (the SASS's 396 SHF.L.W, 412 LOP3.LUT and 126 IADD3
    over its 19.8 hashes, 47.2: more than the FMA pipe's 348 IMAD.IADD and
    84 VIADD) over 132 x 64 INT32 lanes at 67e12 / (132 x 256) Hz; the
    fused round's: its keys in and out, its words, and two hashes per
    split of the key chain."""
    from repro_torch.kernels.bounds import (PEAK_INT32_OPS,
                                            THREEFRY_OPS_PER_HASH,
                                            threefry_bound_ms,
                                            threefry_round_bound_ms)
    np.testing.assert_allclose(PEAK_INT32_OPS, 132 * 64 * 67e12 / (132 * 256))
    ops = (396 + 412 + 126) / 19.8
    assert (348 + 84) / 19.8 < ops
    np.testing.assert_allclose(THREEFRY_OPS_PER_HASH, ops, rtol=1e-12)
    for (r, m, mode), hashes in (((1, 1024 ** 2, ktf.XOR), 1024 ** 2),
                                 ((8, 4096, ktf.XOR), 8 * 4096),
                                 ((3, 1001, ktf.ORIGINAL), 3 * 501),
                                 ((5, 2, ktf.FOLD), 5)):
        ms, by = threefry_bound_ms(r, m, mode)
        t_ops = hashes * ops / PEAK_INT32_OPS * 1e3
        t_bytes = (r * 16 + r * m * 4) / 3.35e12 * 1e3
        np.testing.assert_allclose(ms, max(t_ops, t_bytes), rtol=1e-12)
        assert by == ("operations" if t_ops >= t_bytes else "bytes")
    ms, by = threefry_round_bound_ms(8, 4096, 2, True)
    hashes = 8 * (2 * 3 + 2 * 4096)
    np.testing.assert_allclose(ms, hashes * ops / PEAK_INT32_OPS * 1e3,
                               rtol=1e-12)
    assert by == "operations"


@pytest.mark.parametrize("r,m", [(1, 4096), (1, 7), (3, 5)])
def test_threefry_given_bound_by_hand(r, m):
    """``threefry_given``'s bound: the keys, the count's int64 words and
    the int32 words out over 3.35 TB/s, or ceil(m / 2) hashes per key at
    the hash's operations over the INT32 peak, whichever is longer."""
    from repro_torch.kernels.bounds import (PEAK_INT32_OPS,
                                            THREEFRY_OPS_PER_HASH,
                                            threefry_given_bound_ms)
    ms, by = threefry_given_bound_ms(r, m)
    t_ops = r * -(-m // 2) * THREEFRY_OPS_PER_HASH / PEAK_INT32_OPS * 1e3
    t_bytes = (r * 16 + m * 8 + r * m * 4) / 3.35e12 * 1e3
    np.testing.assert_allclose(ms, max(t_ops, t_bytes), rtol=1e-12)
    assert by == ("operations" if t_ops >= t_bytes else "bytes")


@pytest.fixture
def recorded(monkeypatch):
    """CPU tensors routed to the CUDA path, the kernel library replaced by
    a recorder of (symbol, args)."""
    import contextlib
    import types

    from repro_torch.kernels import clib
    calls = []

    def symbol(stem, name, argtypes, restype):
        def fn(*args):
            assert len(args) == len(argtypes)
            calls.append((name, args))
            return 0
        return fn

    monkeypatch.setattr(clib, "route", lambda *tensors: "cuda")
    monkeypatch.setattr(clib, "_symbol", symbol)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    return calls


def test_wrappers_launch_the_fold_and_round_kernels(recorded):
    """On the CUDA route ``fold_in``'s words come from one ``tf_bits``
    launch in the FOLD layout with ``data`` as the counter, and a shuffle
    round from one ``tf_round`` launch, the kept keys' pointer given only
    when the source splits first."""
    keys = torch.tensor([[0, 42], [1, 2], [3, 4]], dtype=torch.int64)
    for k in ktf.KERNELS:
        k.launches = 0
    ktf.threefry_bits(keys, 2, ktf.FOLD, 2 ** 32 - 1)
    kept, words_ = ktf.threefry_round(keys, 4096, 2, True, True)
    _, words2 = ktf.threefry_round(keys, 1000, 1, False, False)
    (n1, a1), (n2, a2), (n3, a3) = recorded
    assert (n1, a1[2:]) == ("tf_bits", (3, 2, ktf.FOLD, 2 ** 32 - 1, 0))
    assert n2 == n3 == "tf_round"
    assert a2[1] == kept.data_ptr() and a2[3:] == (3, 4096, 2, 1, 0)
    assert a3[1] is None and a3[3:] == (3, 1000, 1, 0, 0)
    assert words_.shape == (2, 3, 4096) and words2.shape == (1, 3, 1000)
    assert (ktf.threefry_bits.launches, ktf.threefry_round.launches) == (1, 2)


@pytest.mark.parametrize("shape", [(4,), (4096,), (3, 5)])
def test_threefry_2x32_launches_one_given_kernel(recorded, shape):
    """On the CUDA route ``threefry_2x32`` of any count is one ``tf_given``
    launch that reads the count's words from the device tensor (its data
    pointer, never its values on the host), counted on ``threefry_given``
    and on no other wrapper."""
    for k in ktf.KERNELS:
        k.launches = 0
    seen = []
    real = ktf.threefry_given

    def spy(keys, counts):
        seen.append(counts)
        return real(keys, counts)
    import unittest.mock
    with unittest.mock.patch.object(tf, "threefry_given", spy):
        tf.threefry_2x32(np.array([1, 2], np.uint32),
                         np.arange(int(np.prod(shape)),
                                   dtype=np.uint32).reshape(shape),
                         device=CPU)
    ((name, args),) = recorded
    m = int(np.prod(shape))
    assert name == "tf_given" and args[1] == seen[0].data_ptr()
    assert args[3:] == (1, m, 0)          # R, M, the stream
    assert {k.__name__: k.launches for k in ktf.KERNELS} == {
        "threefry_bits": 0, "threefry_round": 0, "threefry_given": 1}


# ------------------------------------------------ ThreefryShuffleSource

def _chain(keys, rounds, n):
    """(R, BS, n): each key's next shuffles along the reference's chain
    (``pair = split(keys); keys, sub = pair[:, 0], pair[:, 1]``)."""
    out, k = [], jnp.asarray(keys)
    for _ in range(rounds):
        pair = jax.vmap(jax.random.split)(k)
        k, subs = pair[:, 0], pair[:, 1]
        out.append(np.stack([np.asarray(jax.random.permutation(sk, n))
                             for sk in subs]))
    return np.stack(out)


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_source_rounds_follow_the_reference_chains(partitionable):
    n = 36
    with jax.threefry_partitionable(partitionable):
        seq_key = _key(1)
        keys = jax.random.split(_key(2), 3)
        seq_want = _chain(np.asarray(seq_key)[None], 3, n)
        want = _chain(keys, 3, n)
        last = np.asarray(jax.vmap(jax.random.split)(
            jax.vmap(jax.random.split)(keys)[:, 0])[:, 0])
    seq = ThreefryShuffleSource(np.asarray(seq_key)[None], n, CPU,
                                partitionable)
    for t in range(3):
        _eq(seq.next_round(), seq_want[t])
    src = ThreefryShuffleSource(np.asarray(keys), n, CPU, partitionable)
    assert src.kind == ("threefry" if partitionable else "threefry-original")
    _eq(src.next_round(), want[0])
    # rows drawn apart: row 1 alone, then rows 0 and 2 together
    _eq(src.next_round([1]), want[1][1:2])
    _eq(src.next_round([2, 0]), want[1][[2, 0]])
    assert src.state_dict().dtype == np.uint32
    _eq(src.state_dict(), last)


def test_source_fork_advanced_take_and_stack():
    n = 16
    keys = np.asarray(jax.random.split(_key(4), 4))
    src = ThreefryShuffleSource(keys, n, CPU)
    s0 = src.state_dict()
    fork = src.fork()
    a = src.next_round([0, 2])
    _eq(fork.next_round([0, 2]), a)
    _eq(src.advanced(s0, [0, 2], 1), src.state_dict())
    _eq(src.advanced(s0, None, 0), s0)
    part = src.take([3, 1])
    assert len(part) == 2 and part.kind == src.kind
    _eq(part.state_dict(), src.state_dict()[[3, 1]])
    _eq(part.next_round(), src.fork().next_round([3, 1]))
    both = stack_sources([src.take([0]), src.take([1, 2])])
    _eq(both.state_dict(), src.state_dict()[:3])
    with pytest.raises(ValueError):
        stack_sources([src, TorchShuffleSource([1], n, CPU)])
    with pytest.raises(ValueError):
        src.load_state_dict(np.zeros((3, 2), np.uint32))
    fork.load_state_dict(s0)
    _eq(fork.state_dict(), s0)


# ------------------------------------------------ the engines with key=

N, HW, D = 16, (4, 4), 3
LS0 = dict(lambda_sigma=0.0)


def _cfgs(**kw):
    jcfg = jeng.ShuffleSoftSortConfig(rounds=5, inner_steps=2, chunk=16,
                                      **LS0, **kw)
    return jcfg, config_from_reference(dataclasses.asdict(jcfg))


def _xs(seed, b):
    return np.random.default_rng(seed).normal(size=(b, N, D)).astype(
        np.float32)


def _norms(xs):
    return [float(jmpd(jnp.asarray(x))) for x in xs]


def test_sequential_key_is_the_reference_chain():
    jcfg, cfg = _cfgs()
    x = _xs(0, 1)[0]
    key = _key(9)
    replay = ReplayShuffleSource(_chain(np.asarray(key)[None], 5, N), CPU)
    got = teng.shuffle_soft_sort(x, HW, cfg, key=np.asarray(key),
                                 norm=_norms([x])[0], device=CPU)
    via = teng.shuffle_soft_sort(x, HW, cfg, source=replay,
                                 norm=_norms([x])[0], device=CPU)
    _eq(got[0], via[0])
    assert got[2] == via[2]
    want = jeng.shuffle_soft_sort(x, HW, jcfg, key=key)
    _eq(got[0], want[0])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
    with pytest.raises(ValueError):
        teng.shuffle_soft_sort(x, HW, cfg, key=np.asarray(key), device=CPU,
                               source=TorchShuffleSource([1], N, CPU))


@pytest.mark.parametrize("schedule", ["fixed", "adaptive"])
def test_sequential_default_seed_is_zero(schedule):
    """With no seed=, key= or source=, the sequential engine draws from
    seed 0's stream: bitwise seed=0 and an explicit source of seed 0."""
    kw = (dict(schedule="adaptive", patience=1, plateau_rtol=1.0,
               adapt_every=1) if schedule == "adaptive" else {})
    _, cfg = _cfgs(**kw)
    x = _xs(3, 1)[0]
    got = teng.shuffle_soft_sort(x, HW, cfg, device=CPU)
    for want in (teng.shuffle_soft_sort(x, HW, cfg, seed=0, device=CPU),
                 teng.shuffle_soft_sort(
                     x, HW, cfg, device=CPU,
                     source=TorchShuffleSource([0], N, CPU))):
        _eq(got[0], want[0])
        assert got[2] == want[2]


@pytest.mark.parametrize("schedule", ["fixed", "adaptive"])
def test_batched_key_is_the_reference_chain(schedule):
    kw = (dict(schedule="adaptive", patience=1, plateau_rtol=1.0,
               adapt_every=1) if schedule == "adaptive" else {})
    jcfg, cfg = _cfgs(**kw)
    xs = _xs(1, 2)
    key = _key(5)
    keys = np.asarray(jax.random.split(key, 4))
    got = teng.shuffle_soft_sort_batched(xs, HW, cfg, n_restarts=2,
                                         key=np.asarray(key),
                                         norms=_norms(xs), device=CPU)
    via = teng.shuffle_soft_sort_batched(
        xs, HW, cfg, n_restarts=2, norms=_norms(xs), device=CPU,
        source=ReplayShuffleSource(_chain(keys, 5, N), CPU))
    _eq(got.all_orders, via.all_orders)
    np.testing.assert_array_equal(got.all_losses, via.all_losses)
    want = jeng.shuffle_soft_sort_batched(xs, HW, jcfg, n_restarts=2,
                                          key=key)
    _eq(got.all_orders, want.all_orders)
    np.testing.assert_allclose(got.all_losses, np.asarray(want.all_losses),
                               rtol=1e-5)
    with pytest.raises(ValueError):
        teng.shuffle_soft_sort_batched(xs, HW, cfg, seeds=[1, 2, 3, 4],
                                       keys=keys, device=CPU)


def test_tournament_keys_are_the_reference_chain():
    jcfg, cfg = _cfgs()
    xs = _xs(2, 2)
    keys = np.asarray(jax.random.split(_key(6), 8))
    got = teng.restart_tournament(xs, HW, cfg, n_restarts=4, keys=keys,
                                  n_rungs=2, norms=_norms(xs), device=CPU)
    via = teng.restart_tournament(
        xs, HW, cfg, n_restarts=4, n_rungs=2, norms=_norms(xs), device=CPU,
        source=ReplayShuffleSource(_chain(keys, 5, N), CPU))
    _eq(got.order, via.order)
    np.testing.assert_array_equal(got.all_losses, via.all_losses)
    want = jeng.restart_tournament(xs, HW, jcfg, n_restarts=4,
                                   keys=jnp.asarray(keys), n_rungs=2)
    for a, b in zip(got.survivors, want.survivors):
        _eq(a, b)
    _eq(got.order, want.order)
    np.testing.assert_allclose(got.all_losses, np.asarray(want.all_losses),
                               rtol=1e-5)


def test_chip_smoke_digests_are_jaxs():
    """The digests ``chip_smoke.py`` holds the card to are jax's draws, and
    the port's on the CPU."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.THREEFRY_KNOWN == KNOWN
    for part in LAYOUTS:
        with jax.threefry_partitionable(part):
            k0 = jax.random.PRNGKey(0)
            keys8 = jax.random.split(k0, 8)
            want = {
                "split_8": keys8,
                "bits_8x4096": jnp.stack([jax.random.bits(
                    k, (4096,), jnp.uint32) for k in keys8]),
                "bits_1x1048576": jax.random.bits(k0, (1048576,),
                                                  jnp.uint32),
                "bits_3x1001": jnp.stack([jax.random.bits(
                    k, (1001,), jnp.uint32) for k in jax.random.split(
                        jax.random.PRNGKey(3), 3)]),
                "permutation_8x4096": jnp.stack([jax.random.permutation(
                    k, 4096) for k in keys8]),
                "uniform_1024x3": jax.random.uniform(
                    jax.random.PRNGKey(42), (1024, 3)),
            }
        want = {k: cs.draw_digest(np.asarray(v)) for k, v in want.items()}
        assert want == cs.THREEFRY_DIGESTS[part]
        got = {k: cs.draw_digest(v) for k, v in
               cs.threefry_draws(tf, CPU, part).items()}
        assert got == want
