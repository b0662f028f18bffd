"""The round loop's CUDA graphs on the card.

- A captured block replayed over a 100/10k state equals the same block
  run eagerly on the card, bitwise: state, aggregate carry, rounds, total
  and the freeze flag.
- Capture runs under ``torch.cuda.set_sync_debug_mode("error")`` and
  raises nothing; a function that syncs does raise there.
- A steady solve replays what the first captured: no capture, the kernel
  launches counted per replay, and the outcome of the first.
- A dispatch captures every refresh variant its pass can reach, so a
  later dispatch given a larger budget captures nothing.

These tests need an NVIDIA GPU with nvcc; they skip elsewhere. On the card
run them with ``python -m pytest --noconftest -q -m cuda
tests/test_torch_graphs_cuda.py``.
"""

import dataclasses

import pytest
import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer import agg as tagg
from cruise_control_tpu_torch.analyzer import chain as tchain
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals import ALL_GOALS
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.analyzer.search import ExclusionMasks, SearchConfig
from cruise_control_tpu_torch.config import DEFAULT_GOALS, CruiseControlConfig
from cruise_control_tpu_torch.model.fixtures import Dist, random_cluster
from cruise_control_tpu_torch.utils import graphs

pytestmark = pytest.mark.cuda

GOALS = tuple(ALL_GOALS[g.rsplit(".", 1)[-1]]() for g in DEFAULT_GOALS)
STAGE = dict(rf=3, num_racks=8, seed=42, skew_to_first=2.0,
             target_utilization=0.55)
CFG = SearchConfig(num_sources=256, num_dests=25, moves_per_round=64,
                   max_rounds=40)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _fields(carry: tchain.LoopCarry):
    yield carry.state.assignment
    yield carry.state.leader_slot
    for f in dataclasses.fields(carry.agg):
        yield getattr(carry.agg, f.name)
    yield from (carry.live, carry.rounds, carry.total)


@pytest.mark.parametrize("goal", [6, 8, 12])
def test_replayed_block_equals_the_eager_block(card, goal):
    state, meta = random_cluster(100, 10, 10_000, **STAGE,
                                 dist=Dist.EXPONENTIAL, device=card)
    t = meta.num_topics
    masks = ExclusionMasks()
    prior = tuple(j < goal for j in range(len(GOALS)))

    def round_fn(s, a, m, live):
        return tchain._chain_round_body(s, a, goal, prior, GOALS,
                                        BalancingConstraint(), CFG, t, m,
                                        live)

    agg = tagg.compute_agg(state, t)
    tchain.clear_graphs()
    loop = tchain._static_loop(state, agg, masks)
    loop.load(state, agg, masks, cap=3)
    # 62 rounds counted before the dispatch: the block refreshes the
    # aggregate carry on its second round.
    refresh = tchain.refresh_rounds(62, 0, tchain.ROUNDS_PER_BLOCK)
    assert refresh == (1,)
    eager = tchain.run_block(round_fn, loop.carry(), masks, t,
                             k=tchain.ROUNDS_PER_BLOCK, refresh=refresh)
    eager = [x.clone() for x in _fields(eager)]
    graph = loop.graph(("test", goal), round_fn, t, refresh)
    graph.replay()
    replayed = list(_fields(loop.carry()))
    for a, b in zip(eager, replayed):
        assert torch.equal(a, b)
    assert int(loop.rounds) == min(3, tchain.ROUNDS_PER_BLOCK)
    assert graph.launches["select_batch"] == tchain.ROUNDS_PER_BLOCK


def test_capture_raises_on_a_sync_and_not_on_a_block(card):
    x = torch.arange(8, device=card)
    with pytest.raises(RuntimeError):
        graphs.capture(lambda: x.sum().item(), card)
    state, meta = random_cluster(16, 8, 512, **STAGE, dist=Dist.EXPONENTIAL,
                                 device=card)
    tchain.clear_graphs()
    tchain.LOOP_STATS.clear()
    for i in range(len(GOALS)):
        tchain.chain_optimize_rounds(state, i, [j < i for j in range(15)],
                                     GOALS, BalancingConstraint(), CFG,
                                     meta.num_topics, ExclusionMasks(),
                                     budget=5)
        if GOALS[i].supports_swap:
            tchain.chain_swap_rounds(state, i, [j < i for j in range(15)],
                                     GOALS, BalancingConstraint(),
                                     meta.num_topics, ExclusionMasks(),
                                     budget=5)
    assert tchain.LOOP_STATS["captures"] == 15 + 4


def test_steady_solve_replays_and_counts_launches(card):
    conf = CruiseControlConfig({"solver.fused.chain.max.brokers": 8,
                                "solver.wide.batch.min.brokers": 8,
                                "solver.dispatch.target.seconds": 0})
    state, meta = random_cluster(16, 8, 512, **STAGE, dist=Dist.EXPONENTIAL,
                                 device=card)
    opt = GoalOptimizer(conf, device=card)
    tchain.clear_graphs()
    first, res1 = opt.optimizations(state, meta)
    assert opt.last_loop_stats()["captures"] > 0
    kernels.LAUNCHES.clear()
    again, res2 = opt.optimizations(state, meta)
    stats = opt.last_loop_stats()
    assert stats.get("captures", 0) == 0 and stats["replays"] > 0
    assert torch.equal(first.assignment, again.assignment)
    assert torch.equal(first.leader_slot, again.leader_slot)
    assert res1.balancedness_after == res2.balancedness_after
    for name in ("segment_reduce", "slot_weights",
                 "select_sources", "select_batch", "apply_deltas"):
        assert kernels.LAUNCHES[name] > 0, name
    # The round's offline count comes from K7, not K1's offline mode.
    assert kernels.LAUNCHES["segment_reduce_offline"] == 0
    cpu_final, cpu_res = GoalOptimizer(conf, device="cpu").optimizations(
        state.to("cpu"), meta)
    assert torch.equal(again.assignment.cpu(), cpu_final.assignment)
    assert res2.violated_goals_after == cpu_res.violated_goals_after


def test_a_larger_budget_captures_nothing_new(card):
    state, meta = random_cluster(16, 8, 512, **STAGE, dist=Dist.EXPONENTIAL,
                                 device=card)
    cfg = dataclasses.replace(CFG, max_rounds=256)
    prior = [j < 6 for j in range(len(GOALS))]
    tchain.clear_graphs()
    tchain.LOOP_STATS.clear()
    for budget in (4, 200):
        tchain._dispatch("move", state, 6, prior, GOALS,
                         BalancingConstraint(), meta.num_topics,
                         ExclusionMasks(), budget, cfg=cfg, reach=256)
        # The plain block and the one refreshing on its last round.
        assert tchain.LOOP_STATS["captures"] == 2
