"""Reference outcomes of the JAX package, carried across as data.

``reference_outcomes.json`` holds the JAX package's CPU outcomes of
``GoalOptimizer.optimizations`` on named fixtures (the ``bench.py``
``_run_stage`` recipe at 1,000 brokers / 100k partitions, healthy and with
its last 50 brokers DEAD), regenerated and checked by
``tests/test_torch_reference_outcomes.py``. ``chip_smoke.py`` holds the
port's card run against them without importing JAX.

:func:`outcome` summarises a solve in the file's form. It reads only the
attributes both packages' ``OptimizerResult`` share and numpy copies of
the final ``assignment`` and ``leader_slot``, so one function serves the
reference's side and the port's.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any

import numpy as np

REFERENCE_FILE = Path(__file__).with_name("reference_outcomes.json")

# Outcome fields a run with the default (wall-clock adaptive) dispatch is
# held to: the reference's per-goal round counts and dispatch statistics
# depend on where the dispatch boundaries fall, its result does not.
OUTCOME_FIELDS = ("violated_goals_before", "violated_goals_after",
                  "balancedness_before", "balancedness_after")


def digest(array) -> str:
    """sha256 of an integer array's C-order bytes."""
    return hashlib.sha256(np.ascontiguousarray(np.asarray(array))
                          .tobytes()).hexdigest()


def outcome(assignment, leader_slot, result, dispatch_stats: dict,
            ) -> dict[str, Any]:
    """A solve's outcome in the reference file's form."""
    return {
        "goals": [{"name": g.name, "rounds": int(g.rounds),
                   "moves_applied": int(g.moves_applied),
                   "swaps_applied": int(g.swaps_applied),
                   "succeeded": bool(g.succeeded),
                   "violated_before": bool(g.violated_before)}
                  for g in result.goal_results],
        "violated_goals_before": list(result.violated_goals_before),
        "violated_goals_after": list(result.violated_goals_after),
        "balancedness_before": float(result.balancedness_before),
        "balancedness_after": float(result.balancedness_after),
        "num_proposals": len(result.proposals),
        "assignment_sha256": digest(np.asarray(assignment, dtype=np.int32)),
        "leader_slot_sha256": digest(np.asarray(leader_slot,
                                                dtype=np.int32)),
        "dispatch_stats": {k: (float(v) if isinstance(v, float) else v)
                           for k, v in dispatch_stats.items()},
    }


def load_reference_outcomes() -> dict[str, dict]:
    """{entry name: entry} of the committed reference file."""
    with open(REFERENCE_FILE) as fh:
        return {e["name"]: e for e in json.load(fh)["entries"]}


def first_goal_differing(got: dict, want: dict) -> str | None:
    """Name of the first goal whose rounds, moves or swaps differ between
    two outcomes, or None."""
    for g, w in zip(got["goals"], want["goals"]):
        if any(g[k] != w[k] for k in ("rounds", "moves_applied",
                                      "swaps_applied")):
            return g["name"]
    return None


def build_fixture(entry: dict, device):
    """The port's (state, meta) for a reference entry's fixture: the
    ``_run_stage`` recipe, then its last ``drain`` brokers set DEAD."""
    import torch

    from ..common.broker_state import BrokerState
    from ..model.fixtures import Dist, random_cluster
    from ..model.tensors import set_broker_state
    fx = dict(entry["fixture"])
    drain = fx.pop("drain")
    fx["dist"] = Dist(fx["dist"])
    state, meta = random_cluster(**fx, device=device)
    if drain:
        b = fx["num_brokers"]
        state = set_broker_state(state, torch.arange(b - drain, b),
                                 BrokerState.DEAD)
    return state, meta


def k4_adversarial_batch(num_brokers: int, num_topics: int, device,
                         m: int = 2048, seed: int = 0):
    """A K4 batch that stresses its event order: all ``m`` rows leave one
    source broker (0) within one topic (0), towards destinations drawn
    from ``seed``, with load deltas over seven decades; every 4th row is
    unselected and names broker B-1 at both ends. Returns
    ``(sub, sel, pot_delta, lbi_delta)`` for ``apply_deltas_to_agg``."""
    import types

    import torch
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.integers(-3, 4, (m, 1))
    dst = rng.integers(1, num_brokers, m).astype(np.int32)
    src = np.zeros(m, np.int32)
    sel = np.arange(m) % 4 != 3
    src[~sel] = num_brokers - 1
    dst[~sel] = num_brokers - 1
    cols = dict(
        src_broker=src, dst_broker=dst,
        load_delta=(rng.random((m, 4)) * scale).astype(np.float32),
        replica_delta=np.ones(m, np.int32),
        leader_delta=rng.integers(0, 2, m).astype(np.int32),
        topic=np.zeros(m, np.int32) if num_topics else np.full(m, -1,
                                                               np.int32),
        partition=np.zeros(m, np.int32))
    sub = types.SimpleNamespace(**{k: torch.from_numpy(v).to(device)
                                   for k, v in cols.items()})
    pot = torch.from_numpy((rng.random(m) * scale[:, 0]).astype(np.float32))
    lbi = torch.from_numpy((rng.random(m) * scale[:, 0]).astype(np.float32))
    return (sub, torch.from_numpy(sel).to(device), pot.to(device),
            lbi.to(device))


def k4_drain_batch(state, m: int = 2048, seed: int = 0):
    """A K4 batch draining DEAD brokers: the first ``m`` replicas (in flat
    slot order) that DEAD brokers host, each moved to a live broker drawn
    from ``seed``, with its partition's topic and its own load row
    (leader or follower); every 8th row is unselected. Returns
    ``(sub, sel, pot_delta, lbi_delta)`` for ``apply_deltas_to_agg``."""
    import types

    import torch

    from ..analyzer.agg import pot_lbi_deltas
    from ..model.tensors import alive_mask
    assignment = state.assignment.cpu().numpy()
    pmask = state.partition_mask.cpu().numpy()
    live = alive_mask(state).cpu().numpy()
    b = state.num_brokers
    hosted = (assignment >= 0) & pmask[:, None]
    dead_host = hosted & ~live[np.clip(assignment, 0, b - 1)]
    flat = np.flatnonzero(dead_host)[:m]
    if len(flat) < m:
        raise ValueError(f"only {len(flat)} replicas on DEAD brokers, "
                         f"{m} wanted")
    p, s = np.divmod(flat, assignment.shape[1])
    lead = state.leader_slot.cpu().numpy()[p] == s
    rng = np.random.default_rng(seed)
    dst = rng.choice(np.flatnonzero(live), m).astype(np.int32)
    leader_load = state.leader_load.cpu().numpy()[p]
    follower_load = state.follower_load.cpu().numpy()[p]
    cols = dict(
        src_broker=assignment[p, s].astype(np.int32), dst_broker=dst,
        load_delta=np.where(lead[:, None], leader_load,
                            follower_load).astype(np.float32),
        replica_delta=np.ones(m, np.int32),
        leader_delta=lead.astype(np.int32),
        topic=state.topic.cpu().numpy()[p].astype(np.int32),
        partition=p.astype(np.int32))
    sub = types.SimpleNamespace(**{k: torch.from_numpy(v).to(state.device)
                                   for k, v in cols.items()})
    pot, lbi = pot_lbi_deltas(state, sub)
    sel = torch.from_numpy(np.arange(m) % 8 != 7).to(state.device)
    return sub, sel, pot, lbi
