"""Reference outcomes of the JAX package, carried across as data.

``reference_outcomes.json`` holds the JAX package's CPU outcomes of
``GoalOptimizer.optimizations`` on named fixtures (the ``bench.py``
``_run_stage`` recipe at 1,000 brokers / 100k partitions, healthy and with
its last 50 brokers DEAD, and at 7,000 brokers / 1M partitions), regenerated
and checked by
``tests/test_torch_reference_outcomes.py``. ``chip_smoke.py`` holds the
port's card run against them without importing JAX. The module also
holds what the card checks and the tests share: the kernels' adversarial
inputs, the swap grid's inputs and the CUDA-graph capture that counts a
call's launches.

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
