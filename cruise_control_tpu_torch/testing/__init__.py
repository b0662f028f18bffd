"""Reference outcomes of the JAX package, carried across as data.

``reference_outcomes.json`` holds the JAX package's CPU outcomes of
``GoalOptimizer.optimizations`` on named fixtures (the ``bench.py``
``_run_stage`` recipe at 1,000 brokers / 100k partitions, healthy and with
its last 50 brokers DEAD, and at 7,000 brokers / 1M partitions), regenerated
and checked by
``tests/test_torch_reference_outcomes.py``. ``chip_smoke.py`` holds the
port's card run against them without importing JAX. The module also
holds what the card checks and the tests share: the kernels' adversarial
inputs, the swap grid's inputs, the CUDA-graph capture that counts a
call's launches, K3's edge cases (``k3_case``), the JBOD disk fixtures of
K5 (``jbod_disks``, ``sentinel_case``, ``random_disk_case``), KD1's and
KD2's edge cases (``kd1_case``, ``kd2_case``, ``kd2_checks``), all built
from numpy alone, and K7's goal of each weight family
(``K7_FAMILY_GOALS``).

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
            direct=None) -> dict[str, Any]:
    """A solve's outcome in the reference file's form. ``direct``, a
    (moves, sweeps) pair per goal of a solve with the direct-assignment
    transport on, adds each goal's ``direct_moves`` and
    ``direct_sweeps``."""
    out = {
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
    if direct is not None:
        for g, (moves, sweeps) in zip(out["goals"], direct):
            g["direct_moves"], g["direct_sweeps"] = int(moves), int(sweeps)
    return out


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
    ``_run_stage`` recipe, then its last ``drain`` brokers set DEAD and its
    last ``demote`` brokers DEMOTED."""
    import torch

    from ..common.broker_state import BrokerState
    from ..model.fixtures import Dist, random_cluster
    from ..model.tensors import set_broker_state
    fx = dict(entry["fixture"])
    drain = fx.pop("drain")
    demote = fx.pop("demote", 0)
    fx["dist"] = Dist(fx["dist"])
    state, meta = random_cluster(**fx, device=device)
    b = fx["num_brokers"]
    if drain:
        state = set_broker_state(state, torch.arange(b - drain, b),
                                 BrokerState.DEAD)
    if demote:
        state = set_broker_state(state, torch.arange(b - demote, b),
                                 BrokerState.DEMOTED)
    return state, meta


def last_broker_ids(entry: dict, key: str) -> tuple[int, ...]:
    """The broker ids of a fixture's last ``entry["fixture"][key]``
    brokers (ids equal indices in ``random_cluster``)."""
    b = entry["fixture"]["num_brokers"]
    return tuple(range(b - entry["fixture"].get(key, 0), b))


def entry_disks(entry: dict, cluster_arrays: dict) -> dict[str, np.ndarray]:
    """The DiskTensors arrays of a JBOD reference entry, from its
    fixture's cluster arrays (either package's, ``np.asarray``-ed):
    ``jbod_disks`` with ``entry["disks"]["num_disks"]`` dirs a broker, then
    dir ``dead_dir`` of the last ``dead_brokers`` brokers marked dead."""
    spec = entry["disks"]
    disks = jbod_disks(cluster_arrays["assignment"],
                       cluster_arrays["partition_mask"],
                       np.asarray(cluster_arrays["capacity"])[:, 3],
                       spec["num_disks"])
    if spec.get("dead_brokers"):
        b = disks["disk_alive"].shape[0]
        disks["disk_alive"][b - spec["dead_brokers"]:, spec["dead_dir"]] = \
            False
    return disks


def disk_outcome(cluster_arrays: dict, before: dict, after: dict,
                 violations_before, violations_after) -> dict[str, Any]:
    """An intra-broker solve's outcome in the reference file's form: the
    final disk assignment's digest, the replicas moved, the violations'
    bits (digest) and sums, and the replicas left on dead dirs."""
    assign = np.asarray(cluster_arrays["assignment"])
    exists = (assign >= 0) & np.asarray(cluster_arrays["partition_mask"]
                                        )[:, None]
    da0 = np.asarray(before["disk_assignment"])
    da1 = np.asarray(after["disk_assignment"])
    alive = np.asarray(before["disk_alive"])
    b = alive.shape[0]
    on_dead = exists & (da1 >= 0) & ~alive[np.clip(assign, 0, b - 1),
                                           np.clip(da1, 0, None)]
    v0 = np.asarray(violations_before, np.float32)
    v1 = np.asarray(violations_after, np.float32)
    return {
        "disk_assignment_sha256": digest(da1.astype(np.int32)),
        "num_moves": int(((da0 != da1) & exists).sum()),
        "violations_before_sha256": digest(v0.view(np.int32)),
        "violations_after_sha256": digest(v1.view(np.int32)),
        "violation_sum_before": float(v0.astype(np.float64).sum()),
        "violation_sum_after": float(v1.astype(np.float64).sum()),
        "replicas_on_dead_dirs": int(on_dead.sum()),
    }


DISK_OUTCOME_FIELDS = ("disk_assignment_sha256", "num_moves",
                       "violations_before_sha256", "violations_after_sha256",
                       "violation_sum_before", "violation_sum_after",
                       "replicas_on_dead_dirs")


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


# K3's edge cases (``k3_case``): (move rows, move columns, leadership
# rows, leadership columns, m, targeted column) and what the case stresses.
K3_CASES = {
    "mixed": (48, 9, 32, 3, 40, True),            # the _world-like mix
    "equal_scores": (64, 6, 32, 3, 64, False),    # ties: lower row first
    "partition_dups": (64, 6, 32, 3, 80, False),  # six partitions in all
    "low_scores": (48, 5, 24, 3, 60, False),      # <= 1e-9 share partitions
    "none_scoring": (32, 5, 16, 3, 40, False),    # nothing above 1e-9
    "m_one": (32, 5, 16, 3, 1, True),
    "m_all_rows": (30, 5, 18, 3, 60, False),      # k = nr = 48
    "odd_sizes": (37, 7, 11, 3, 23, True),
    "small_leadership": (96, 9, 2, 3, 64, True),
    "top_brokers": (48, 6, 24, 3, 64, False),     # brokers B-3 .. B-1
    "deep_scan": (300, 4, 300, 3, 520, False),    # three scan levels
    "cap": (2048, 8, 2048, 3, 2048, False),       # 4,096 rows, m = 2,048
}


def k3_case(name: str, num_partitions: int, num_brokers: int,
            num_topics: int, seed: int = 0) -> dict[str, Any]:
    """One K3 input of ``K3_CASES`` drawn from ``seed`` with numpy:
    the ``CandidateDeltas`` fields of a [r0 × c0] move block and a [r1 ×
    c1] leadership block (``src_broker`` ... ``valid``), ``score``,
    ``layout``, ``m`` and ``extra_last_col``. Loads mix signs, magnitudes
    and signed zeros; invalid rows score -inf."""
    r0, c0, r1, c1, m, extra = K3_CASES[name]
    rng = np.random.default_rng([seed, sorted(K3_CASES).index(name)])
    n0, n1 = r0 * c0, r1 * c1
    n = n0 + n1
    is_move = np.arange(n) < n0
    part = rng.integers(0, num_partitions, n)
    if name in ("partition_dups", "low_scores"):
        part = rng.choice(rng.integers(0, num_partitions, 6 if name ==
                                       "partition_dups" else 12), n)
    lo_b = num_brokers - 3 if name == "top_brokers" else 0
    src = rng.integers(lo_b, num_brokers, n)
    dst = rng.integers(lo_b, num_brokers, n)
    topic = part % max(1, num_topics // (4 if name == "top_brokers" else 1))
    load = (rng.standard_normal((n, 4))
            * 10.0 ** rng.integers(-3, 4, (n, 1))).astype(np.float32)
    load[rng.random((n, 4)) < 0.05] = 0.0
    load[rng.random((n, 4)) < 0.05] = -0.0
    valid = rng.random(n) < 0.9
    if name == "equal_scores":
        score = rng.choice(np.float32([0.5, 1.0, 2.0]), n)
    elif name == "low_scores":
        score = rng.choice(np.float32([0.0, -0.0, 1e-9, 5e-10, -1e-9, 2e-9,
                                       1.0, 3.0]), n)
    elif name == "none_scoring":
        score = rng.choice(np.float32([0.0, -0.0, 1e-9, -1.0, -np.inf]), n)
    else:
        score = (rng.integers(0, 4, n) + rng.random(n) * 0.005
                 ).astype(np.float32)
        score[rng.random(n) < 0.1] *= -1
    score = np.where(valid, score, -np.inf).astype(np.float32)
    i32 = np.int32
    return dict(
        src_broker=src.astype(i32), dst_broker=dst.astype(i32),
        load_delta=load, replica_delta=is_move.astype(i32),
        leader_delta=np.where(is_move, rng.integers(0, 2, n), 1).astype(i32),
        partition=part.astype(i32), topic=topic.astype(i32),
        src_slot=rng.integers(0, 3, n).astype(i32),
        dst_slot=np.where(is_move, 0, rng.integers(0, 3, n)).astype(i32),
        valid=valid, score=score, layout=((r0, c0), (r1, c1)), m=m,
        extra_last_col=extra)


K3_OUTPUTS = ("idx", "part_ok", "sub", "has_earlier", "pot", "lbi", "sel")


def k3_case_tail(state, num_topics: int, moves_cap: int):
    """A tail (``search.SelectTail``) for a ``k3_case`` input on
    ``state``: the joint recheck of the default chain's
    ReplicaDistributionGoal round (the six goals before it prior, no
    exclusion) and the move cap ``moves_cap``, not independent."""
    from ..analyzer import agg as agg_mod
    from ..analyzer import chain as chain_mod
    from ..analyzer.constraint import BalancingConstraint
    from ..analyzer.score_grid import JointRecheck
    from ..analyzer.search import ExclusionMasks, SelectTail
    goals = k6_goals("default", state.num_brokers)
    active = [g.name for g in goals].index("ReplicaDistributionGoal")
    prior = [j < active for j in range(len(goals))]
    agg = agg_mod.compute_agg(state, num_topics)
    derived = chain_mod._derived(state, ExclusionMasks(), agg)
    constraint = BalancingConstraint()
    aux_list = chain_mod._aux_list(goals, active, prior, state, derived,
                                   constraint, num_topics, agg)
    return SelectTail(JointRecheck(state, derived, constraint, goals,
                                   aux_list, active, prior, num_topics),
                      moves_cap, False)


def k3_plain(args, kwargs):
    """The twins of a recorded ``select_batch`` call: ``select_batch_plain``
    and the final sel ``select_tail_plain`` makes of it with the call's
    tail (``search.SelectTail``)."""
    from ..analyzer import search
    args, kwargs = list(args), dict(kwargs)
    tail = kwargs.pop("tail") if "tail" in kwargs else args.pop(6)
    out = search.select_batch_plain(*args, **kwargs)
    return out + (search.select_tail_plain(out[1], out[2], out[3], tail),)


def k3_mismatches(got, want) -> list[str]:
    """The outputs of two ``select_batch`` calls that differ: integer and
    bool outputs exactly, f32 ones bit for bit (signed zeros too), every
    ``CandidateDeltas`` field of ``sub`` (the gathered rows and the
    pre-deltas) by name."""
    import dataclasses

    import torch

    def same(a, b) -> bool:
        if a is None or b is None:
            return a is b
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype == torch.float32:
            a, b = (x.contiguous().view(torch.int32) for x in (a, b))
        return torch.equal(a, b)

    bad = [name for name, a, b in zip(K3_OUTPUTS, got, want)
           if name != "sub" and not same(a, b)]
    bad += [f.name for f in dataclasses.fields(want[2])
            if not same(getattr(got[2], f.name), getattr(want[2], f.name))]
    return bad


# Inputs on which K2's order is hardest to keep: ties in the value bits
# that only the row index breaks, signed zeros, fewer source rows than the
# global block, and a top broker without a second row.
K2_CASES = ("offline_1e30", "signed_zeros", "all_equal", "few_sources",
            "single_replica_broker")


def k2_half(num_rows: int, num_brokers: int, num_sources: int) -> int:
    """The global block's size for ``select_sources`` at these shapes."""
    k_src = min(num_sources, num_rows)
    return k_src - 2 * min(k_src // 4, num_brokers)


def k2_adversarial_inputs(assignment, num_brokers: int, num_sources: int,
                          case: str, seed: int = 0,
                          ) -> tuple[np.ndarray, np.ndarray]:
    """``(replica_weight [P, S] f32, source_score [B] f32)`` for
    ``select_sources`` over ``assignment`` (numpy, -1 for an empty slot)
    in one of ``K2_CASES``, drawn from ``seed``:

    - ``offline_1e30``: uniform weights, and the weight 1e30 on every
      replica of the last brokers, as the chain gives offline replicas,
      taking brokers until they host 1.5 x the global block (so ties fill
      the block and spill past it); those brokers' scores positive;
    - ``signed_zeros``: -0.0 and +0.0 on 60 % of the rows, small
      integers on the rest;
    - ``all_equal``: every weight 1.0;
    - ``few_sources``: one or more brokers with a positive score, hosting
      together fewer rows than the global block;
    - ``single_replica_broker``: broker 1 scores highest and has one
      finite-weight replica (weight 0, below the global block), so it
      has no second-best row.
    Elsewhere scores are uniform in [-0.5, 0.5)."""
    assignment = np.asarray(assignment)
    rng = np.random.default_rng(seed)
    shape = assignment.shape
    half = k2_half(assignment.size, num_brokers, num_sources)
    score = (rng.random(num_brokers) - 0.5).astype(np.float32)
    weight = rng.random(shape).astype(np.float32)
    hosted = np.bincount(assignment[assignment >= 0].ravel(),
                         minlength=num_brokers)
    if case == "offline_1e30":
        taken, b = 0, num_brokers
        while taken <= 1.5 * half and b > 0:
            b -= 1
            taken += hosted[b]
        weight[assignment >= b] = np.float32(1e30)
        score[b:] = np.abs(score[b:]) + np.float32(1.0)
    elif case == "signed_zeros":
        weight = rng.integers(0, 3, shape).astype(np.float32)
        zero = rng.random(shape) < 0.6
        weight[zero] = np.where(rng.random(shape) < 0.5, np.float32(-0.0),
                                np.float32(0.0))[zero]
    elif case == "all_equal":
        weight[:] = 1.0
    elif case == "few_sources":
        score[:] = -1.0
        taken = 0
        for b in np.argsort(hosted, kind="stable"):
            if taken + hosted[b] >= half:
                break
            score[b] = 1.0
            taken += hosted[b]
        if taken == 0:
            raise ValueError("no broker hosts fewer rows than the block")
    elif case == "single_replica_broker":
        rows = np.argwhere(assignment == 1)
        weight[assignment == 1] = -np.inf
        weight[tuple(rows[len(rows) // 2])] = 0.0
        score[1] = np.float32(10.0)
    else:
        raise ValueError(f"unknown K2 case {case!r}")
    return weight, score


def k2_round_inputs(state, num_topics: int,
                    goal_name: str = "DiskUsageDistributionGoal",
                    offline_override: bool = True):
    """``(source_score, replica_weight)`` as the chain's round body builds
    them for ``goal_name`` on ``state`` (``analyzer/chain.py``): with
    ``offline_override``, each broker's offline replica count is added to
    its score and every offline replica weighs 1e30."""
    import torch

    from ..analyzer.agg import offline_per_broker
    from ..analyzer.constraint import BalancingConstraint
    from ..analyzer.derived import compute_derived
    from ..analyzer.goals import ALL_GOALS
    from ..analyzer.search import goal_aux
    from ..model.tensors import offline_replicas
    goal = ALL_GOALS[goal_name]()
    derived = compute_derived(state)
    constraint = BalancingConstraint()
    aux = goal_aux(goal, state, derived, constraint, num_topics)
    score = goal.source_score(state, derived, constraint, aux) \
        .to(torch.float32)
    weight = goal.replica_weight(state, derived, constraint, aux) \
        .to(torch.float32)
    if offline_override:
        score = score + offline_per_broker(state)
        weight = torch.where(offline_replicas(state),
                             torch.full((), 1e30, device=state.device),
                             weight)
    return score, weight


# One goal of each K7 weight family (goals/base.py WeightFamily): the
# goal whose round times the family.
K7_FAMILY_GOALS = {
    "LOAD_TOTAL": "MinTopicLeadersPerBrokerGoal",
    "NEG_LOAD_TOTAL": "ReplicaDistributionGoal",
    "LOAD_COLUMN": "DiskCapacityGoal",
    "FIT_PRIORITY": "DiskUsageDistributionGoal",
    "LEADER_LOAD": "PotentialNwOutGoal",
    "TOPIC_DONOR": "TopicReplicaDistributionGoal",
    "RACK_DUPLICATE": "RackAwareGoal",
    "PREFERRED_LEADER": "PreferredLeaderElectionGoal",
    "BROKER_SET": "BrokerSetAwareGoal",
    "KAFKA_ASSIGNER_RACK": "KafkaAssignerEvenRackAwareGoal",
}


def k7_family_goal_args(family: str, num_brokers: int) -> tuple[str, dict]:
    """The name and arguments of ``K7_FAMILY_GOALS[family]``, with what its
    family needs to weigh anything: BrokerSetAwareGoal on sets of broker
    index mod 4, MinTopicLeadersPerBrokerGoal at two leaders."""
    name = K7_FAMILY_GOALS[family]
    kwargs = {"BrokerSetAwareGoal": {"broker_sets": tuple(
        b % 4 for b in range(num_brokers))},
        "MinTopicLeadersPerBrokerGoal": {"min_leaders": 2}}.get(name, {})
    return name, kwargs


def k7_family_goal(family: str, num_brokers: int):
    """The goal of ``K7_FAMILY_GOALS[family]``."""
    from ..analyzer.goals import ALL_GOALS
    name, kwargs = k7_family_goal_args(family, num_brokers)
    return ALL_GOALS[name](**kwargs)


def swap_grid_inputs(state, num_topics: int,
                     goal_name: str = "DiskUsageDistributionGoal"):
    """``(derived, source_score, swap_dest_score, replica_weight)`` as the
    chain's swap round builds them for ``goal_name`` on ``state``
    (``analyzer/chain.py::_chain_swap_body``): the inputs of
    ``search.swap_grid``."""
    import torch

    from ..analyzer.constraint import BalancingConstraint
    from ..analyzer.derived import compute_derived
    from ..analyzer.goals import ALL_GOALS
    from ..analyzer.search import goal_aux
    goal = ALL_GOALS[goal_name]()
    derived = compute_derived(state)
    constraint = BalancingConstraint()
    aux = goal_aux(goal, state, derived, constraint, num_topics)
    return (derived,
            goal.source_score(state, derived, constraint, aux)
            .to(torch.float32),
            goal.swap_dest_score(state, derived, constraint, aux)
            .to(torch.float32),
            goal.replica_weight(state, derived, constraint, aux)
            .to(torch.float32))


def cuda_graph_capture(fn):
    """``(graph, output)``: one call of ``fn`` captured in a CUDA graph
    (after one call outside it), its cudaGraph_t kept for inspection. The
    capture fails if the call synchronises or reads device data on the
    host."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def cuda_graph_nodes(graph) -> int:
    """The nodes of a captured graph: every kernel launch and memset."""
    import ctypes
    libcuda = ctypes.CDLL("libcuda.so.1")
    libcuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_size_t)]
    count = ctypes.c_size_t(0)
    code = libcuda.cuGraphGetNodes(graph.raw_cuda_graph(), None,
                                   ctypes.byref(count))
    if code != 0:
        raise RuntimeError(f"cuGraphGetNodes returned {code}")
    return int(count.value)


# ---- JBOD disk fixtures (K5) ------------------------------------------------

def jbod_disks(assignment, partition_mask, broker_disk_capacity,
               num_disks: int) -> dict[str, np.ndarray]:
    """DiskTensors arrays for a cluster with ``num_disks`` log dirs per
    broker, each holding ``broker_disk_capacity[b] / num_disks``: each
    broker's replicas go round-robin over its dirs in flat slot order (as
    Kafka puts a new replica on the dir with the fewest partitions); every
    dir alive."""
    assignment = np.asarray(assignment)
    p, s = assignment.shape
    b = len(broker_disk_capacity)
    exists = (assignment >= 0) & np.asarray(partition_mask)[:, None]
    flat = np.where(exists, assignment, b).ravel()
    order = np.argsort(flat, kind="stable")
    starts = np.searchsorted(flat[order], np.arange(b + 1))
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order)) - starts[flat[order]]
    disk = np.where(exists.ravel(), rank % num_disks, -1).reshape(p, s)
    cap = np.repeat((np.asarray(broker_disk_capacity, np.float32)
                     / np.float32(num_disks))[:, None], num_disks, axis=1)
    return {"disk_assignment": disk.astype(np.int32),
            "disk_capacity": cap.astype(np.float32),
            "disk_alive": np.ones((b, num_disks), bool)}


def disk_cluster_arrays(assignment, partition_load, num_brokers: int,
                        broker_disk_capacity: float = 1e6,
                        ) -> dict[str, np.ndarray]:
    """ClusterTensors arrays of a small hand-made cluster: replicas at
    ``assignment`` ([P, S], -1 empty), every replica of partition p
    carrying DISK load ``partition_load[p]`` (leader or follower), one rack
    and host per broker, every broker ALIVE, one topic."""
    assignment = np.asarray(assignment, np.int32)
    p = assignment.shape[0]
    load = np.zeros((p, 4), np.float32)
    load[:, 3] = np.asarray(partition_load, np.float32)
    cap = np.full((num_brokers, 4), 1e6, np.float32)
    cap[:, 3] = broker_disk_capacity
    return {"assignment": assignment,
            "leader_slot": np.zeros(p, np.int32),
            "leader_load": load, "follower_load": load.copy(),
            "capacity": cap,
            "rack": np.arange(num_brokers, dtype=np.int32),
            "broker_state": np.zeros(num_brokers, np.int8),
            "topic": np.zeros(p, np.int32),
            "partition_mask": np.ones(p, bool),
            "broker_mask": np.ones(num_brokers, bool),
            "host": np.arange(num_brokers, dtype=np.int32)}


# Cases of the reference's sentinel collision (model/disks.py): a broker
# without a pick writes onto slot (P-1, 0) (every replica of its source
# disk pinned) or (P-1, 2147483647 % S) (none there), undoing the owner's
# move of that slot when it has the higher index.
SENTINEL_CASES = ("empty_above", "empty_below", "pinned_above",
                  "late_empty_above", "rf3_both")


def sentinel_case(name: str):
    """``(cluster arrays, disk arrays, movable [P] bool or None, band)``
    of one of ``SENTINEL_CASES``, for ``balance_intra_broker`` with
    capacity threshold 0.8 (``band`` None: the capacity goal)."""
    def disks(da, cap, alive=None):
        cap = np.asarray(cap, np.float32)
        return {"disk_assignment": np.asarray(da, np.int32),
                "disk_capacity": cap,
                "disk_alive": (np.ones(cap.shape, bool) if alive is None
                               else np.asarray(alive, bool))}

    loads = [100.0, 150.0, 200.0, 250.0]
    if name in ("empty_above", "empty_below"):
        # Four RF-1 partitions on one broker's disk 0 (400 MB a disk),
        # the other broker empty; the heaviest replica sits on the
        # sentinel slot (3, 0).
        owner = 0 if name == "empty_above" else 1
        cl = disk_cluster_arrays([[owner]] * 4, loads, 2, 800.0)
        return cl, disks([[0]] * 4, [[400.0, 400.0]] * 2), None, None
    if name == "pinned_above":
        # Broker 0 owns the sentinel slot; broker 1 hosts only pinned
        # replicas (partitions 0-1), so it has no pick from round 0.
        assign = [[1], [1], [0], [0], [0], [0]]
        cl = disk_cluster_arrays(assign, [50.0, 60.0] + loads, 2, 800.0)
        movable = np.array([False, False, True, True, True, True])
        return (cl, disks([[0]] * 6, [[400.0, 400.0]] * 2), movable, None)
    if name == "late_empty_above":
        # Broker 1 drains its dead disk 2 (three replicas) onto disk 1,
        # then all its pressures are 0 and its source is disk 0, an
        # unused slot without replicas: no pick from round 3 on. Broker 0
        # moves its sentinel slot (partition 6, its heaviest) in round 0,
        # back in a later round, and is undone from round 3.
        assign = [[1], [1], [1], [0], [0], [0], [0]]
        load = [10.0, 20.0, 30.0, 100.0, 150.0, 200.0, 250.0]
        cl = disk_cluster_arrays(assign, load, 2, 1200.0)
        da = [[2], [2], [2], [0], [0], [0], [0]]
        cap = [[400.0, 400.0, 400.0], [0.0, 400.0, 400.0]]
        alive = [[True, True, True], [True, True, False]]
        return cl, disks(da, cap, alive), None, (0.91, 1.09)
    if name == "rf3_both":
        # RF 3: sentinel slots (7, 0) and (7, 1) differ. Brokers 0-2 host
        # partitions 2-7 on disk 0; broker 3 hosts only pinned replicas
        # (partitions 0-1, one replica each) and broker 4 none.
        assign = [[3, -1, -1], [3, -1, -1]] + [[0, 1, 2]] * 6
        load = [40.0, 40.0, 90.0, 120.0, 60.0, 80.0, 110.0, 130.0]
        cl = disk_cluster_arrays(assign, load, 5, 800.0)
        da = [[0, -1, -1], [0, -1, -1]] + [[0, 0, 0]] * 6
        movable = np.array([False, False] + [True] * 6)
        return cl, disks(da, [[400.0, 400.0]] * 5), movable, None
    raise ValueError(f"unknown sentinel case {name!r}")


def random_disk_case(seed: int, num_brokers: int = 8,
                     num_partitions: int = 40, rf: int = 3,
                     num_disks: int = 3):
    """``(cluster arrays, disk arrays, movable, band)``: a small random
    JBOD cluster drawn from ``seed`` with empty brokers, pinned partitions,
    dead and unused dirs and uneven capacities, so that brokers without a
    pick (both sentinel kinds) are common."""
    rng = np.random.default_rng(seed)
    hosts = rng.permutation(num_brokers)[:max(2, num_brokers - 2)]
    rf_p = np.minimum(rng.integers(1, rf + 1, num_partitions), len(hosts))
    assign = np.full((num_partitions, rf), -1, np.int32)
    for p in range(num_partitions):
        assign[p, :rf_p[p]] = rng.choice(hosts, rf_p[p], replace=False)
    load = rng.exponential(100.0, num_partitions).astype(np.float32)
    cl = disk_cluster_arrays(assign, load, num_brokers, 1e4)
    da = np.where(assign >= 0, rng.integers(0, num_disks, assign.shape),
                  -1).astype(np.int32)
    cap = rng.uniform(100.0, 600.0, (num_brokers, num_disks)) \
        .astype(np.float32)
    cap[rng.random(cap.shape) < 0.1] = 0.0
    alive = rng.random(cap.shape) >= 0.15
    movable = rng.random(num_partitions) >= 0.3
    band = (0.91, 1.09) if seed % 2 else None
    return cl, {"disk_assignment": da, "disk_capacity": cap,
                "disk_alive": alive}, movable, band


def random_placement_disks(assignment, partition_mask, broker_disk_capacity,
                           num_disks: int, seed: int,
                           ) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """(DiskTensors arrays, movable [P] bool): every replica on a dir drawn
    from ``seed``, dirs of ``broker_disk_capacity[b] / num_disks`` each,
    one dir in 16 dead, and one partition in 10 pinned."""
    assignment = np.asarray(assignment)
    rng = np.random.default_rng(seed)
    b = len(broker_disk_capacity)
    exists = (assignment >= 0) & np.asarray(partition_mask)[:, None]
    disk = np.where(exists, rng.integers(0, num_disks, assignment.shape), -1)
    cap = np.repeat((np.asarray(broker_disk_capacity, np.float32)
                     / np.float32(num_disks))[:, None], num_disks, axis=1)
    alive = rng.random((b, num_disks)) >= 1 / 16
    movable = rng.random(assignment.shape[0]) >= 0.1
    return ({"disk_assignment": disk.astype(np.int32),
             "disk_capacity": cap.astype(np.float32), "disk_alive": alive},
            movable)


def crowded_broker_case(num_disks: int, seed: int = 0):
    """``(cluster arrays, disk arrays)``: 12,000 RF-1 partitions on 4
    brokers, the first 9,000 on broker 1 (more replicas than K5's
    balancer stages on one broker; its load mode takes them), the rest
    drawn from ``seed``, every replica on a dir drawn from ``seed`` or
    none (-1)."""
    rng = np.random.default_rng(seed)
    p = 12_000
    assign = np.where(np.arange(p) < 9_000, 1,
                      rng.integers(0, 4, p))[:, None].astype(np.int32)
    cl = disk_cluster_arrays(assign, rng.exponential(50.0, p), 4)
    return cl, {"disk_assignment": rng.integers(-1, num_disks, (p, 1))
                .astype(np.int32),
                "disk_capacity": np.full((4, num_disks), 1e6, np.float32),
                "disk_alive": np.ones((4, num_disks), bool)}


# ---- K6 round inputs ---------------------------------------------------------

# Chains whose goals K6's checks take as active in turn: every one of the
# 14 goal families appears (BrokerSetAwareGoal's sets and the leader
# minimum are set per case).
K6_CHAINS = {
    "default": None,
    "extra": ("RackAwareDistributionGoal", "BrokerSetAwareGoal",
              "MinTopicLeadersPerBrokerGoal", "ReplicaCapacityGoal",
              "LeaderReplicaDistributionGoal",
              "LeaderBytesInDistributionGoal"),
    "kafka": ("KafkaAssignerEvenRackAwareGoal",
              "KafkaAssignerDiskUsageDistributionGoal"),
    "demote": ("PreferredLeaderElectionGoal",),
}


def k6_goals(chain: str, num_brokers: int, min_leaders: int = 1) -> tuple:
    """The goals of a ``K6_CHAINS`` entry (the default chain for
    "default"), BrokerSetAwareGoal on sets of broker index mod 3."""
    from ..analyzer.goals import ALL_GOALS
    from ..config import DEFAULT_GOALS
    names = K6_CHAINS[chain] or tuple(g.rsplit(".", 1)[-1]
                                      for g in DEFAULT_GOALS)
    overrides = {
        "BrokerSetAwareGoal": {"broker_sets": tuple(
            b % 3 for b in range(num_brokers))},
        "MinTopicLeadersPerBrokerGoal": {"min_leaders": min_leaders}}
    return tuple(ALL_GOALS[n](**overrides.get(n, {})) for n in names)


def k6_round_inputs(state, goals, active: int, num_topics: int, cfg,
                    masks=None) -> dict:
    """The arguments of K6's grid mode and of the round's selection in one
    eager round of ``goals[active]`` with every earlier goal prior:
    {"grid": (...), "select": (args, kwargs) of ``cumulative_select``,
    "recheck": (state, derived, constraint, goals, aux_list, active,
    prior, sub, has_earlier, num_topics, table)}, the last the joint
    recheck's batch (``recheck_plain``'s arguments first); the round runs
    the kernels as the round body does (K6 and K3 with its recheck on the
    card)."""
    from ..analyzer import agg as agg_mod
    from ..analyzer import chain as chain_mod
    from ..analyzer.constraint import BalancingConstraint
    from ..analyzer.search import ExclusionMasks
    rec = {}
    orig = (chain_mod.score_grid, chain_mod.cumulative_select,
            chain_mod.JointRecheck)

    def grid(*args):
        rec["grid"] = args
        return orig[0](*args)

    def select(*args, **kwargs):
        rec["select"] = (args, kwargs)
        return orig[1](*args, **kwargs)

    class Recorded(orig[2]):
        def _record(self, sub, has_earlier):
            rec["recheck"] = (self.state, self.derived, self.constraint,
                              self.goals, self.aux_list, self.active,
                              self.prior, sub, has_earlier, self.num_topics,
                              self.table)

        def __call__(self, sub, has_earlier):
            self._record(sub, has_earlier)
            return super().__call__(sub, has_earlier)

        def params(self, sub, has_earlier):
            self._record(sub, has_earlier)
            return super().params(sub, has_earlier)

    (chain_mod.score_grid, chain_mod.cumulative_select,
     chain_mod.JointRecheck) = grid, select, Recorded
    try:
        chain_mod._chain_round_body(
            state, agg_mod.compute_agg(state, num_topics), active,
            [j < active for j in range(len(goals))], goals,
            BalancingConstraint(), cfg, num_topics,
            masks if masks is not None else ExclusionMasks())
    finally:
        (chain_mod.score_grid, chain_mod.cumulative_select,
         chain_mod.JointRecheck) = orig
    return rec


def build_host_library(name: str, out_dir: str):
    """``csrc/<name>.cu`` compiled as host C++ (g++, no contraction of
    multiply-adds) into ``out_dir``, loaded with ctypes."""
    import ctypes
    import subprocess

    from .. import kernels
    out = f"{out_dir}/lib{name}_host.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-x", "c++",
                    str(kernels.CSRC / f"{name}.cu"), "-o", out],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(out)


def k3_tail_mismatches(args, kwargs, host_lib=None) -> list[str]:
    """K3 with its tail (``search.cumulative_select``'s arguments) against
    the plain composition on the same inputs: ``select_batch_plain``, the
    joint recheck's twin, the move cap and the freeze flag. K3 runs on
    the inputs' device, or as ``host_lib`` (``select_batch.cu`` built for
    the host) on CPU inputs. The names of the outputs that differ (every
    field of the selected rows bit for bit, sel exactly)."""
    import ctypes
    import dataclasses

    from ..analyzer import search

    (state, deltas, score, layout, m, moves_cap, independent,
     recheck) = args[:8]
    extra = kwargs.get("extra_last_col", args[8] if len(args) > 8 else False)
    live = kwargs.get("live", args[9] if len(args) > 9 else None)
    tail = search.SelectTail(recheck, moves_cap, independent, live)
    if host_lib is None:
        got = search.select_batch(state, deltas, score, layout, m, extra,
                                  tail)
    else:
        deltas = dataclasses.replace(deltas, **{
            f.name: getattr(deltas, f.name).contiguous()
            for f in dataclasses.fields(deltas)
            if getattr(deltas, f.name) is not None})
        params, rq, buffers = search.select_batch_params(
            state, deltas, score.contiguous(), layout, m, extra, tail)
        if host_lib.cc_select_batch_host(ctypes.byref(params),
                                         ctypes.byref(rq)) != 0:
            return ["host call refused"]
        got = search.select_batch_outputs(buffers)
    return k3_mismatches(got, k3_plain(
        (state, deltas, score, layout, m, extra, tail), {}))


def k8_round_inputs(state, goals, active: int, num_topics: int) -> tuple:
    """The arguments of K8's wrapper (``search.swap_top_replicas``) in one
    eager swap round of ``goals[active]`` with every earlier goal prior."""
    from ..analyzer import agg as agg_mod
    from ..analyzer import chain as chain_mod
    from ..analyzer import search as search_mod
    from ..analyzer.constraint import BalancingConstraint
    from ..analyzer.search import ExclusionMasks
    rec = []
    orig = search_mod.swap_top_replicas

    def record(*args):
        rec.append(args)
        return orig(*args)

    search_mod.swap_top_replicas = record
    try:
        chain_mod._chain_swap_body(
            state, agg_mod.compute_agg(state, num_topics), active,
            [j < active for j in range(len(goals))], goals,
            BalancingConstraint(), num_topics, ExclusionMasks())
    finally:
        search_mod.swap_top_replicas = orig
    return rec[0]


def k6_random_case(seed: int, device) -> tuple:
    """(state, num_topics, goals, masks, cfg) of a small seeded case: 8-16
    brokers, 64-256 partitions, RF 2-3, 3-7 racks, the chain
    ``K6_CHAINS`` entry seed mod 4, some brokers DEAD, NEW or DEMOTED
    and, on every third seed, a replica-move and a leadership
    exclusion."""
    import torch

    from ..analyzer.search import ExclusionMasks, SearchConfig
    from ..common.broker_state import BrokerState
    from ..model.fixtures import Dist, random_cluster
    from ..model.tensors import set_broker_state
    rng = np.random.default_rng(seed)
    b = 8 + seed % 9
    state, meta = random_cluster(
        b, 4 + seed % 5, 64 + 32 * (seed % 7), rf=2 + seed % 2,
        num_racks=3 + seed % 5, dist=Dist.EXPONENTIAL, seed=seed,
        skew_to_first=2.0, target_utilization=0.55, device=device)
    chain = list(K6_CHAINS)[seed % 4]
    picks = rng.permutation(b)
    codes = {"demote": (BrokerState.DEMOTED, BrokerState.DEMOTED)}.get(
        chain, (BrokerState.DEAD, BrokerState.NEW))
    for k, code in enumerate(codes):
        if k == 0 or seed % 2:
            state = set_broker_state(state, torch.tensor(int(picks[k])),
                                     code)
    masks = ExclusionMasks()
    if seed % 3 == 0 or chain == "demote":
        rm = np.zeros(b, dtype=bool)
        ld = np.zeros(b, dtype=bool)
        rm[picks[2]] = seed % 3 == 0
        ld[picks[:2 if chain == "demote" else 3]] = True
        masks = ExclusionMasks.from_numpy(
            device, excluded_replica_move_brokers=rm,
            excluded_leadership_brokers=ld)
    cfg = SearchConfig(num_sources=16 + 16 * (seed % 4), num_dests=4 + seed
                       % 8, moves_per_round=8 + seed % 16)
    return (state, meta.num_topics, k6_goals(chain, b, 1 + seed % 2), masks,
            cfg)


def k6_mismatches(rec: dict) -> list[str]:
    """K6's grid mode against its twin on recorded inputs and, where the
    round's selection was recorded, K3 with the joint recheck against the
    composition (``k3_tail_mismatches``), every output compared bit for
    bit: the names of the outputs that differ."""
    import dataclasses

    import torch

    from ..analyzer import score_grid as sg

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    bad = []
    got = sg.score_grid(*rec["grid"])
    want = sg.score_grid_plain(*rec["grid"][:11])
    for f in dataclasses.fields(want[0]):
        w = getattr(want[0], f.name)
        if w is not None and not torch.equal(bits(getattr(got[0], f.name)),
                                             bits(w)):
            bad.append(f.name)
    for name, g, w in zip(("kind", "accept", "score"), got[1:], want[1:]):
        if g.dtype != w.dtype or not torch.equal(bits(g), bits(w)):
            bad.append(name)
    if "select" in rec:
        bad += [f"select {name}" for name in k3_tail_mismatches(
            *rec["select"])]
    return bad


# KD1's edge cases (``kd1_case``): the names, and the sizes the tests use
# (N = 1, about a 2,048-element half tile, one 4,096-element tile and one
# element either side, and many tiles).
KD1_CASES = ("all_ties", "signed_zeros", "nan_inf", "near_max_key",
             "top_bit", "sentinel", "wide_keys")
KD1_SIZES = (1, 2047, 2049, 4095, 4096, 4097, 100_003)


def kd1_case(name: str, n: int, seed: int = 0):
    """(int32 keys, f32 second keys, key_max) of one KD1 edge case, from
    numpy alone: every key and second key tied; signed zeros among a few
    keys; NaNs of both signs, infinities, denormals and the extremes;
    keys near 2**23 - 1 and near 2**31 - 1 (every key pass runs); every
    key on the sentinel (the key passes trivial); the mover sort's cell
    keys at 7k/1M with 30 % on the sentinel."""
    rng = np.random.default_rng(seed + n)
    if name == "all_ties":
        return np.zeros(n, np.int32), np.zeros(n, np.float32), 0
    if name == "signed_zeros":
        key = rng.integers(0, 3, n).astype(np.int32)
        sec = np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(np.float32)
        sec[::7] = rng.choice([1.0, -1.0, np.inf, -np.inf], n)[::7]
        return key, sec, 2
    if name == "nan_inf":
        pool = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0,
                         -1.0, 1e-45, -1e-45, 3.4028235e38, -3.4028235e38],
                        np.float32)
        sec = rng.choice(pool, n)
        sec[rng.random(n) < 0.1] = np.float32(np.nan) * -1.0
        return rng.integers(0, 5, n).astype(np.int32), sec, 4
    if name in ("near_max_key", "top_bit"):
        key_max = 2 ** 23 - 1 if name == "near_max_key" else 2 ** 31 - 1
        key = (key_max - rng.integers(0, 9, n)).astype(np.int32)
        key[rng.random(n) < 0.2] = rng.integers(0, 256)
        sec = rng.integers(-3, 4, n).astype(np.float32) * 0.25
        return key, sec, key_max
    if name == "sentinel":
        key_max = 700 * 7001
        return (np.full(n, key_max, np.int32),
                rng.exponential(1.0, n).astype(np.float32), key_max)
    key_max = 700 * 7001
    key = rng.integers(0, key_max + 1, n).astype(np.int32)
    key[rng.random(n) < 0.3] = key_max
    sec = rng.integers(0, 4, n).astype(np.float32) * 0.5
    return key, sec, key_max


# KD2's edge cases (``kd2_case``): segment layouts, and N at 16^k and one
# either side for k = 1..4 (every level of the 16-blocked scan full,
# partial or one over) plus 16^5 + 1 (two levels above the tiles).
KD2_CASES = ("one_segment", "many_segments", "length_one", "span_tiles")
KD2_SIZES = (15, 16, 17, 255, 256, 257, 4095, 4096, 4097, 65535, 65536,
             65537)


def kd2_case(name: str, n: int, r: int, seed: int = 0):
    """(sorted int32 keys [N], non-negative f32 values [N, r], table
    length) of one KD2 edge case, from numpy alone: one segment; segments
    of about five; every segment of length 1; segments of 3,000-9,000
    elements, so they span tiles. A third of the values are 0."""
    rng = np.random.default_rng(seed + 7 * n + r)
    if name == "one_segment":
        keys = np.zeros(n, np.int32)
    elif name == "length_one":
        keys = np.arange(n, dtype=np.int32)
    elif name == "span_tiles":
        cuts = np.cumsum(rng.integers(3000, 9000, n // 3000 + 2))
        keys = np.searchsorted(cuts, np.arange(n), side="right").astype(
            np.int32)
    else:
        keys = np.sort(rng.integers(0, max(1, n // 5), n)).astype(np.int32)
    vals = (rng.exponential(1.0, (n, r))
            * 10.0 ** rng.integers(-3, 4, (n, 1))).astype(np.float32)
    vals[rng.random((n, r)) < 0.3] = 0.0
    return keys, vals, int(keys.max()) + 1


# KD3's cases (``kd3_case``).
KD3_CASES = ("dense", "sparse", "balanced")


def kd3_case(name: str, g: int, b: int, seed: int = 0):
    """(cnt [G, B] f32, lower [G, 1], upper [G, 1], alive [B], elig [B])
    of one KD3 case, from numpy alone: dense counts (Poisson 30, a tenth
    of the brokers at a third of that, so the deficits exceed the surplus
    and donors widen), sparse counts (Poisson 0.6) or a balanced plane;
    the band from each row's mean; about 5 % of the brokers dead and 5 %
    more ineligible."""
    rng = np.random.default_rng(seed)
    if name == "dense":
        cnt = rng.poisson(30.0, (g, b)).astype(np.float32)
        low = rng.random(b) < 0.1
        cnt[:, low] = np.floor(cnt[:, low] / 3.0)
    elif name == "sparse":
        cnt = rng.poisson(0.6, (g, b)).astype(np.float32)
    else:
        cnt = np.full((g, b), 3.0, np.float32)
    avg = cnt.mean(axis=1, keepdims=True)
    upper = np.ceil(avg * 1.1).astype(np.float32)
    lower = np.floor(avg / 1.1).astype(np.float32)
    alive = rng.random(b) > 0.05
    elig = alive & (rng.random(b) > 0.05)
    return cnt, lower, upper, alive, elig


def kd2_checks(n: int, r: int, table: int, count: int = 12, seed: int = 0):
    """``count`` KD2 checks as (limit, base, column, own_column, floor,
    gate) numpy tuples, in pairs that share all but their limit (the same
    base and gate arrays, so KD2 judges a pair as one): caps and floors,
    with and without a base table, an own column and a gate, over every
    column; a cap's last limit +inf (the sentinel's)."""
    rng = np.random.default_rng(seed + n + r)
    out = []
    for c in range(count):
        j = c // 2
        if c % 2 == 0:
            floor = j % 3 == 2
            base = rng.exponential(5.0, table).astype(np.float32) \
                if j % 2 == 1 else None
            gate = rng.random(n) < 0.5 if j % 4 == 3 else None
            own = (j % r) if j % 3 != 0 else None
        limit = rng.exponential(50.0, table).astype(np.float32)
        if floor:
            limit = -limit
        else:
            limit[-1] = np.inf
        out.append((limit, base, j % r, own, floor, gate))
    return out


# KD4's cases (``kd4_case``).
KD4_CASES = ("sorted", "g1", "sentinel", "short_runs", "unsorted")


def kd4_case(name: str, n: int, g: int, b: int, seed: int = 0):
    """(group [n] int32, rank [n] f32, deficit [G, B] f32, headroom
    [G, B] f32, eligible [B] bool) of one KD4 case, from numpy alone, as
    ``analyzer/direct.py`` builds them: movers sorted by group, each
    group's ranks rotated by the golden-ratio offset and wrapped at its
    total (two increasing runs a group; ranks at or above the total stay,
    and are not placed: each group's total holds about 80 % of its
    movers); a third of the profiles' cells zero-width. The
    cases: groups drawn at random and sorted (groups split across the
    kernel's CTA ranges);
    one group; a third of the movers in a clamped sentinel tail of the
    last group at rank 0; runs of about three movers (``g`` ignored:
    n // 3 groups); the sorted case shuffled."""
    rng = np.random.default_rng(seed + n + 31 * g + b)
    if name == "g1":
        g = 1
    elif name == "short_runs":
        g = max(1, n // 3)
    movers = n - n // 3 if name == "sentinel" else n
    # Cells sized so each group's total holds ~80 % of its movers.
    lam = 0.8 * movers / g / (b * 2 * 0.7 * 0.95)
    deficit = rng.poisson(lam, (g, b)).astype(np.float32)
    headroom = rng.poisson(lam, (g, b)).astype(np.float32)
    deficit[rng.random((g, b)) < 0.3] = 0.0
    headroom[rng.random((g, b)) < 0.3] = 0.0
    eligible = rng.random(b) > 0.05
    group = np.sort(rng.integers(0, g, movers)).astype(np.int32)
    starts = np.searchsorted(group, group, side="left")
    rank = (np.arange(movers) - starts).astype(np.float32)
    cum_d = np.cumsum(np.where(eligible, deficit, 0.0), axis=1,
                      dtype=np.float32)
    cum_h = np.cumsum(np.where(eligible, headroom, 0.0), axis=1,
                      dtype=np.float32)
    t_g = (cum_d[:, -1] + cum_h[:, -1])[group]
    rot = np.float32(1 + seed % 7) * np.float32(0.6180339887)
    offs = np.floor(t_g * rot)
    rank = np.where(rank < t_g, np.fmod(rank + offs, np.maximum(t_g, 1.0)),
                    rank).astype(np.float32)
    if name == "sentinel":
        group = np.concatenate([group, np.full(n - movers, g - 1, np.int32)])
        rank = np.concatenate([rank, np.zeros(n - movers, np.float32)])
    if name == "unsorted":
        perm = rng.permutation(n)
        group, rank = group[perm], rank[perm]
    return group, rank, deficit, headroom, eligible


# K5's edge cases (``k5_edge_case``).
K5_EDGE_CASES = ("broker_at_limit", "d32", "all_64_rounds", "fixup_64")


def k5_edge_case(name: str, seed: int = 0):
    """``(cluster arrays, disk arrays, movable [P] bool, band)`` of one of
    K5's edge cases, RF 1, from numpy alone: a broker at exactly K5's
    8,192 replicas (D = 4, everything on two dirs, the band); four brokers
    on 32 dirs (the band); four brokers, each draining a dead dir of more
    than 64 movable replicas, so every one runs all 64 rounds (the
    capacity goal); and the same with the last partition's replica, the
    8th heaviest on broker 0's dead dir, blocked from round 5 by broker 3,
    which has no replica on its source dir from then on (its dir 0 absent,
    its dead dir drained in five rounds), so the sentinel fix-up reruns
    broker 0."""
    rng = np.random.default_rng(seed)
    sizes = {"broker_at_limit": (8192, 300, 200),
             "d32": (900, 700, 500, 300)}.get(name, (260, 150, 120, 90))
    d = {"broker_at_limit": 4, "d32": 32}.get(name, 4)
    b = len(sizes)
    broker = np.repeat(np.arange(b), sizes)
    load = (rng.exponential(50.0, broker.shape[0])
            * 10.0 ** rng.integers(-1, 2, broker.shape[0]))
    disk = rng.integers(0, d, broker.shape[0])
    cap = np.zeros((b, d), np.float32)
    alive = np.ones((b, d), bool)
    movable = rng.random(broker.shape[0]) >= 0.05
    band = (0.9, 1.1)
    if name == "broker_at_limit":
        disk = np.where(rng.random(broker.shape[0]) < 0.8, 0, 1)
    if name in ("all_64_rounds", "fixup_64"):
        band = None
        alive[:, 3] = False
        dead = np.zeros(broker.shape[0], bool)
        for k in range(b):
            mine = np.flatnonzero(broker == k)
            dead[mine[:100 if k < 3 or name == "all_64_rounds" else 5]] = True
        disk = np.where(dead, 3, rng.integers(0, 3, broker.shape[0]))
        movable |= dead
    if name == "fixup_64":
        # Broker 3: five replicas on its dead dir 1, the rest on dirs 2 and
        # 3, dir 0 absent, room everywhere.
        three = broker == 3
        alive[3, 1], alive[3, 3] = False, True
        disk = np.where(three, np.where(dead, 1, 2 + rng.integers(
            0, 2, broker.shape[0])), disk)
        # The last partition: broker 0's 8th heaviest on its dead dir.
        zero = np.flatnonzero((broker == 0) & (disk == 3))
        pick = zero[np.argsort(-load[zero], kind="stable")[7]]
        order = np.r_[np.delete(np.arange(broker.shape[0]), pick), pick]
        broker, load, disk, movable = (broker[order], load[order],
                                       disk[order], movable[order])
    total = np.zeros(b)
    np.add.at(total, broker, load)
    cap[:] = (2.0 * total / d)[:, None] * rng.uniform(0.8, 1.6, (b, d))
    if name == "fixup_64":
        cap[3] = 10.0 * total[3]
        cap[3, 0] = 0.0
    cl = disk_cluster_arrays(broker[:, None], load, b)
    dk = {"disk_assignment": disk[:, None].astype(np.int32),
          "disk_capacity": cap.astype(np.float32), "disk_alive": alive}
    return cl, dk, movable, band
