"""The reference outcomes the port carries as data
(``cruise_control_tpu_torch/testing/reference_outcomes.json``) are the
JAX package's own: every entry is recomputed here with the JAX package on
the CPU and must equal the file field for field.

Each entry is a ``bench.py::_run_stage`` fixture, at 1,000 brokers /
100k partitions (healthy, and with the last 50 brokers DEAD) and at
7,000 brokers / 1M partitions / 700 topics (healthy: bench.py's STAGES
(7_000, 1_000_000, 0), above ``fill.TARGET_DESTS_MAX_P``, so the
targeted column is off), solved by the JAX ``GoalOptimizer`` with the
default config and ``solver.dispatch.target.seconds=0``, so the bounded
path's dispatch boundaries do not depend on wall-clock. About a minute
per 1k entry and seven for 7k/1M on a CPU, so the file is marked slow.

Regenerate the file (after a deliberate change to the reference) with
``python -m tests.test_torch_reference_outcomes`` from the repo root.
"""

import json

import numpy as np
import pytest

from cruise_control_tpu_torch.testing import (
    REFERENCE_FILE, load_reference_outcomes, outcome,
)

STAGE = dict(num_brokers=1000, num_topics=100, num_partitions=100_000, rf=3,
             num_racks=8, dist="exponential", seed=42, skew_to_first=2.0,
             target_utilization=0.55)
CONFIG = {"solver.dispatch.target.seconds": 0}
SPECS = {
    "1k_100k": dict(fixture=dict(STAGE, drain=0), config=CONFIG),
    "1k_100k_drain50": dict(fixture=dict(STAGE, drain=50), config=CONFIG),
    # bench.py's STAGES (7_000, 1_000_000, 0): the README's headline shape,
    # above fill.TARGET_DESTS_MAX_P, so the targeted column is off.
    "7k_1m": dict(fixture=dict(STAGE, num_brokers=7000, num_topics=700,
                               num_partitions=1_000_000, drain=0),
                  config=CONFIG),
}


def jax_outcome(spec: dict) -> dict:
    """The JAX package's outcome of one entry's solve on the CPU."""
    import jax.numpy as jnp

    from cruise_control_tpu.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu.common.broker_state import BrokerState
    from cruise_control_tpu.config.cruise_control_config import (
        CruiseControlConfig,
    )
    from cruise_control_tpu.model.fixtures import Dist, random_cluster
    from cruise_control_tpu.model.tensors import set_broker_state
    fx = dict(spec["fixture"])
    drain = fx.pop("drain")
    fx["dist"] = Dist(fx["dist"])
    state, meta = random_cluster(**fx)
    if drain:
        b = fx["num_brokers"]
        state = set_broker_state(state, jnp.arange(b - drain, b),
                                 BrokerState.DEAD)
    opt = GoalOptimizer(CruiseControlConfig(spec["config"]))
    final, result = opt.optimizations(state, meta)
    return outcome(np.asarray(final.assignment),
                   np.asarray(final.leader_slot), result,
                   opt.last_dispatch_stats())


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(SPECS))
def test_reference_outcome_is_the_jax_packages(name):
    want = load_reference_outcomes()[name]
    assert want["fixture"] == SPECS[name]["fixture"]
    assert want["config"] == SPECS[name]["config"]
    got = jax_outcome(SPECS[name])
    for key, value in got.items():
        assert value == want[key], key


if __name__ == "__main__":
    from cruise_control_tpu.utils import force_host_cpu_devices
    force_host_cpu_devices(8)
    entries = []
    for name in sorted(SPECS):
        out = jax_outcome(SPECS[name])
        entries.append({"name": name, **SPECS[name], **out})
        print(name, out["num_proposals"], out["balancedness_after"],
              out["assignment_sha256"][:16], flush=True)
    with open(REFERENCE_FILE, "w") as fh:
        json.dump({"source": "the JAX package (cruise_control_tpu) on the "
                   "CPU; regenerated by tests/test_torch_reference_"
                   "outcomes.py", "entries": entries}, fh, indent=1)
        fh.write("\n")
