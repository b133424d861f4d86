import os
import sys

# Make `repro` importable without an install step.  NOTE: deliberately no
# XLA_FLAGS here — smoke tests and benches must see 1 device; only the
# dry-run entrypoint forces 512 host devices (see repro/launch/dryrun.py).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped without one")


# ---------------------------------------------------------------------------
# Shared hypothesis strategies (tests/test_properties.py).
#
# hypothesis is an OPTIONAL dependency: the container tier-1 image does
# not ship it, so everything below is guarded and the property suite
# self-skips via ``pytest.importorskip`` — the adaptive determinism
# contract keeps hypothesis-free coverage in tests/test_annealing.py.
# The CI `properties` job runs with a pinned profile: derandomized, no
# deadline (jit compile time would trip any wall-clock budget), small
# example counts (each example traces a full anneal).
# ---------------------------------------------------------------------------
try:
    from hypothesis import HealthCheck, settings
    from hypothesis import strategies as st

    settings.register_profile(
        "ci", derandomize=True, deadline=None, max_examples=20,
        suppress_health_check=[HealthCheck.too_slow,
                               HealthCheck.data_too_large])
    settings.register_profile(
        "dev", deadline=None, max_examples=8,
        suppress_health_check=[HealthCheck.too_slow])
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "dev"))

    def grid_shapes(max_side: int = 4):
        """(h, w) grid shapes — N = h * w stays small enough that every
        example's full anneal traces in test time."""
        side = st.integers(min_value=2, max_value=max_side)
        return st.tuples(side, side)

    def prng_seeds():
        return st.integers(min_value=0, max_value=2**31 - 1)

    def key_vectors(min_n: int = 4, max_n: int = 24):
        """(N,) float32 sort-key vectors, finite, duplicates allowed —
        the raw input of hard_permutation / band_tail_bound."""
        return st.integers(min_value=min_n, max_value=max_n).flatmap(
            lambda n: st.lists(
                st.floats(min_value=-1e3, max_value=1e3, width=32,
                          allow_nan=False, allow_infinity=False),
                min_size=n, max_size=n))

    def tau_schedule_cfgs():
        """(rounds, tau_start, tau_end) draws spanning hot->cold anneals
        including degenerate flat schedules."""
        return st.tuples(
            st.integers(min_value=1, max_value=8),
            st.floats(min_value=0.05, max_value=4.0, width=32),
            st.floats(min_value=0.005, max_value=0.5, width=32))

    def segment_splits(rounds: int):
        """Partitions of ``rounds`` into ordered positive segment
        lengths — every way a scheduler could chop one anneal."""
        def build(draw_lens):
            out, left = [], rounds
            for v in draw_lens:
                if left == 0:
                    break
                take = 1 + v % left
                out.append(take)
                left -= take
            if left:
                out.append(left)
            return out
        return st.lists(st.integers(min_value=0, max_value=rounds - 1),
                        min_size=0, max_size=rounds).map(build)
except ImportError:                                    # pragma: no cover
    pass
