"""The bounded path with the targeted destination column off, the port
against the JAX package.

Above ``fill.TARGET_DESTS_MAX_P`` partitions (500,000: the 7k-broker /
1M-partition stage) both packages drop the targeted column: the round
builds its candidate grid without ``extra_dst`` and K3 reduces without
the extra last column. Here the gate is lowered in both packages
(monkeypatched, so the JAX package reads it when it traces) until the
16/512 and 100/10k fixtures take that branch, and the solves are held to
each other as test_torch_optimizer_bounded.py holds them: assignment,
leader slots, every ``GoalResult`` field but the duration, the violated
sets, balancedness, the proposals and the dispatch statistics, the
violation fingerprint included.
"""

import jax
import pytest

from cruise_control_tpu.analyzer import fill as jfill
from cruise_control_tpu_torch.analyzer import fill as tfill
from tests.test_torch_optimizer_bounded import (
    assert_same_solve, bounded_config, solve_both,
)
from tests.torch_support import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture
def targets_off(monkeypatch):
    """Both packages' gate lowered below every fixture's partition count,
    with JAX's traces dropped before and after, so no program traced with
    the column on is reused and none traced without it outlives the
    test."""
    jax.clear_caches()
    monkeypatch.setattr(jfill, "TARGET_DESTS_MAX_P", 100)
    monkeypatch.setattr(tfill, "TARGET_DESTS_MAX_P", 100)
    assert not jfill.targets_enabled(512) and not tfill.targets_enabled(512)
    yield
    jax.clear_caches()


@pytest.mark.parametrize("fixture,dead", [("16_512", 0), ("16_512", 2),
                                          ("100_10k", 0)])
def test_bounded_optimizations_match_with_targets_off(targets_off, fixture,
                                                      dead):
    conf = bounded_config(16, True)
    j, t = solve_both(fixture, conf, dead=dead)
    assert sum(g.rounds for g in t[3].goal_results) > 0
    assert_same_solve(j, t, conf)
