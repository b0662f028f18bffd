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
call's launches, and the JBOD disk fixtures of K5 (``jbod_disks``,
``sentinel_case``, ``random_disk_case``), all built from numpy alone.

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
    """The arguments of K6's two wrappers in one eager round of
    ``goals[active]`` with every earlier goal prior:
    {"grid": (...), "recheck": (...)}; the round runs the wrappers as
    the round body does (K6 on the card)."""
    from ..analyzer import agg as agg_mod
    from ..analyzer import chain as chain_mod
    from ..analyzer.constraint import BalancingConstraint
    from ..analyzer.search import ExclusionMasks
    rec = {}
    orig_grid, orig_recheck = chain_mod.score_grid, chain_mod.recheck

    def grid(*args):
        rec["grid"] = args
        return orig_grid(*args)

    def recheck(*args):
        rec["recheck"] = args
        return orig_recheck(*args)

    chain_mod.score_grid, chain_mod.recheck = grid, recheck
    try:
        chain_mod._chain_round_body(
            state, agg_mod.compute_agg(state, num_topics), active,
            [j < active for j in range(len(goals))], goals,
            BalancingConstraint(), cfg, num_topics,
            masks if masks is not None else ExclusionMasks())
    finally:
        chain_mod.score_grid, chain_mod.recheck = orig_grid, orig_recheck
    return rec


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
    """K6 against its twin on recorded inputs, both modes, every output
    compared bit for bit: the names of the outputs that differ."""
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
    if not torch.equal(sg.recheck(*rec["recheck"]),
                       sg.recheck_plain(*rec["recheck"][:9])):
        bad.append("recheck")
    return bad
