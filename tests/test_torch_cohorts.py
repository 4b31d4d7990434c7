"""The port's heterogeneous-K cohort rounds against the JAX package's, on
the CPU at a tiny size: the cases, draws and tolerances of
``test_torch_executors.py`` (see its docstring), whose ``run_cases`` and
``check_round`` run and hold them.

* ``client_local_steps=(1, 2, 1, 2)``, C = 4: two cohorts, round 1
  anchored and round 2 carried;
* the same at participation 0.5, one round, given the reference's
  participants (two clients of unequal K: two cohorts).
"""
import pytest

pytest.importorskip("torch")

from test_torch_executors import check_round, run_cases  # noqa: E402

CASES = {
    "cohorts_firm_wan": ("firm", "wan", 2, dict(
        n_clients=4, client_local_steps=(1, 2, 1, 2))),
    "cohorts_firm_wan_participation_half": ("firm", "wan", 1, dict(
        n_clients=4, client_local_steps=(1, 2, 1, 2), participation=0.5)),
}


@pytest.fixture(scope="module")
def rounds():
    return run_cases(CASES)


@pytest.mark.parametrize("case", [
    "cohorts_firm_wan_round1", "cohorts_firm_wan_round2_carried",
    "cohorts_firm_wan_participation_half_round1"])
def test_cohort_round_matches_the_jax_cohort_round(rounds, case):
    check_round(rounds[case], case)
