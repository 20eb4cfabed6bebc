"""``tools/profile_step.profile_fullest``: the launch counts of the card
checks read the fullest of a fixed number of profiled calls.  CPU only:
the profiler's readings are stood in for by a list of rows."""
import pytest

from mc_nerf_torch.tools import profile_step


@pytest.mark.parametrize("short_at", [None, 0, 1, 2])
def test_profile_fullest_reads_the_call_with_the_most_records(monkeypatch, short_at):
    """Every call is profiled, ``after`` runs after each, and the rows of
    the call with the most kernel records come back: a call whose record
    of a kernel was lost never wins over one that kept it."""
    full = [(1.0, 40, "hash_encode_fwd_kernel"), (2.0, 80, "gemm")]
    lossy = [(1.0, 38, "hash_encode_fwd_kernel"), (2.0, 80, "gemm")]
    readings = [lossy if i == short_at else full for i in range(profile_step.FULLEST_OF)]
    calls, afters = [], []

    def fake(step, n, steps_per_call=1):
        assert (n, steps_per_call) == (1, 5)
        step()
        return 0.0, readings[len(calls) - 1], []

    monkeypatch.setattr(profile_step, "profile_steps", fake)
    rows = profile_step.profile_fullest(lambda: calls.append(1), 5,
                                        after=lambda: afters.append(len(calls)))
    assert rows == full
    assert len(calls) == profile_step.FULLEST_OF
    assert afters == list(range(1, profile_step.FULLEST_OF + 1))
    assert profile_step.count_named(rows, ["hash_encode_fwd_kernel"]) == {
        "hash_encode_fwd_kernel": 40}
