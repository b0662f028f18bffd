"""The port's four CUDA kernels against their plain twins on the card.

K1 and K4 are held bit for bit against the twin run on a CPU copy, which
adds in the reference's order; the twin on the card (PyTorch's CUDA
scatter-adds) sums in another order.

These tests need an NVIDIA GPU with nvcc; they skip elsewhere. On the card
run them with ``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``
(``chip_smoke.py`` holds the kernels against their twins at the
100-broker / 10k-partition shapes as well).
"""

import dataclasses

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer import agg as tagg
from cruise_control_tpu_torch.analyzer import candidates as tc
from cruise_control_tpu_torch.analyzer import chain as tchain
from cruise_control_tpu_torch.analyzer import search as tsearch
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals import ALL_GOALS
from cruise_control_tpu_torch.analyzer.search import ExclusionMasks, SearchConfig
from cruise_control_tpu_torch.config import DEFAULT_GOALS
from cruise_control_tpu_torch.model import tensors as tt
from cruise_control_tpu_torch.model.fixtures import Dist, random_cluster
from cruise_control_tpu_torch.testing import (
    K2_CASES, cuda_graph_capture, cuda_graph_nodes, k2_adversarial_inputs,
    k2_round_inputs, k4_adversarial_batch, k4_drain_batch,
)

pytestmark = pytest.mark.cuda

FIXTURE = dict(num_brokers=16, num_topics=8, num_partitions=512, rf=3,
               num_racks=8, seed=42, skew_to_first=2.0,
               target_utilization=0.55)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _state(dev, dead=()):
    state, meta = random_cluster(**FIXTURE, dist=Dist.EXPONENTIAL, device=dev)
    for b in dead:
        state = tt.set_broker_state(state, torch.tensor(b), 1)
    return state, meta


@pytest.mark.parametrize("dead", [(), (3, 11)])
def test_segment_reduce_matches_twin(card, dead):
    state, meta = _state(card, dead)
    got = tagg.compute_agg(state, meta.num_topics)
    want = tagg.compute_agg_plain(state.to("cpu"), meta.num_topics)
    for f in ("broker_load", "broker_replicas", "broker_leaders",
              "pot_nw_out", "lbi", "topic_counts"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert torch.equal(tagg.offline_per_broker(state).cpu(),
                       tagg.offline_per_broker_plain(state.to("cpu")))


def test_round_kernels_match_twins_on_a_recorded_round(card):
    state, meta = _state(card, dead=(5,))
    goals = tuple(ALL_GOALS[g.rsplit(".", 1)[-1]]() for g in DEFAULT_GOALS)
    calls = {}
    orig_src, orig_batch = tchain.select_sources, tsearch.select_batch

    def rec(name, fn):
        def wrapper(*args, **kwargs):
            calls.setdefault(name, (args, kwargs))
            return fn(*args, **kwargs)
        return wrapper

    tchain.select_sources = rec("select_sources", orig_src)
    tsearch.select_batch = rec("select_batch", orig_batch)
    try:
        cfg = SearchConfig(num_sources=256, num_dests=16, moves_per_round=64)
        agg = tagg.compute_agg(state, meta.num_topics)
        tchain._chain_round_body(state, agg, 6, [j < 6 for j in range(15)],
                                 goals, BalancingConstraint(), cfg,
                                 meta.num_topics, ExclusionMasks())
    finally:
        tchain.select_sources, tsearch.select_batch = orig_src, orig_batch
    args, _ = calls["select_sources"]
    for a, b in zip(tc.select_sources(*args), tc.select_sources_plain(*args)):
        assert torch.equal(a, b)
    args, kwargs = calls["select_batch"]
    got = tsearch.select_batch(*args, **kwargs)
    want = tsearch.select_batch_plain(*args, **kwargs)
    for i in (0, 1, 3):
        assert torch.equal(got[i], want[i])
    for name in ("pre_src_load", "pre_dst_load") + tc.PRE_FIELDS:
        torch.testing.assert_close(getattr(got[2], name),
                                   getattr(want[2], name), rtol=1e-5,
                                   atol=1e-6)
    assert kernels.LAUNCHES["select_batch"] > 0


def test_apply_deltas_matches_row_order_twin(card):
    state, meta = _state(card, dead=(5,))
    goals = tuple(ALL_GOALS[g.rsplit(".", 1)[-1]]() for g in DEFAULT_GOALS)
    calls = []
    orig = tchain.apply_deltas_to_agg

    def rec(*args):
        calls.append(args)
        return orig(*args)

    tchain.apply_deltas_to_agg = rec
    try:
        cfg = SearchConfig(num_sources=256, num_dests=16, moves_per_round=64)
        agg = tagg.compute_agg(state, meta.num_topics)
        tchain._chain_round_body(state, agg, 6, [j < 6 for j in range(15)],
                                 goals, BalancingConstraint(), cfg,
                                 meta.num_topics, ExclusionMasks())
    finally:
        tchain.apply_deltas_to_agg = orig
    agg_in, sub, sel, pot, lbi = calls[0]
    assert int(sel.sum()) > 1
    got = tagg.apply_deltas_to_agg(agg_in, sub, sel, pot, lbi)
    cpu_sub = type(sub)(**{f: (v.cpu() if v is not None else None)
                           for f, v in vars(sub).items()})
    cpu_agg = type(agg_in)(*(x.cpu() for x in
                             (agg_in.broker_load, agg_in.broker_replicas,
                              agg_in.broker_leaders, agg_in.pot_nw_out,
                              agg_in.lbi, agg_in.topic_counts)))
    want = tagg.apply_deltas_to_agg_plain(cpu_agg, cpu_sub, sel.cpu(),
                                          pot.cpu(), lbi.cpu())
    for f in ("broker_load", "broker_replicas", "broker_leaders",
              "pot_nw_out", "lbi", "topic_counts"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


def _recorded_select_batch(state, meta, goal_index, cfg):
    """The inputs of K3 in one chain round of the default chain's goal
    ``goal_index`` (every earlier goal prior) under ``cfg``."""
    goals = tuple(ALL_GOALS[g.rsplit(".", 1)[-1]]() for g in DEFAULT_GOALS)
    calls = []
    orig = tsearch.select_batch

    def rec(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    tsearch.select_batch = rec
    try:
        agg = tagg.compute_agg(state, meta.num_topics)
        tchain._chain_round_body(
            state, agg, goal_index, [j < goal_index for j in range(15)],
            goals, BalancingConstraint(), cfg, meta.num_topics,
            ExclusionMasks())
    finally:
        tsearch.select_batch = orig
    return calls[0]


def test_select_batch_at_its_cap_matches_twin(card):
    """K3 at the bounded path's largest grid: a deficit-sized
    ReplicaDistributionGoal round at 1,000 brokers / 100k partitions,
    2,048 move and 2,048 leadership rows, m = 2,048: exact on idx /
    part_ok / has_earlier and bitwise on the pre-deltas."""
    state, meta = random_cluster(1000, 100, 100_000, rf=3, num_racks=8,
                                 seed=42, skew_to_first=2.0,
                                 target_utilization=0.55,
                                 dist=Dist.EXPONENTIAL, device=card)
    cfg = SearchConfig(num_sources=2048, num_dests=250, moves_per_round=2048)
    args, kwargs = _recorded_select_batch(state, meta, 6, cfg)
    (r0, _c0), (r1, _c1) = args[3]
    assert (r0, r1, min(args[4], r0 + r1)) == (2048, 2048, 2048)
    got = tsearch.select_batch(*args, **kwargs)
    want = tsearch.select_batch_plain(*args, **kwargs)
    for i in (0, 1, 3):
        assert torch.equal(got[i], want[i])
    assert int(got[1].sum()) > 100
    for name in ("pre_src_load", "pre_dst_load") + tc.PRE_FIELDS:
        assert torch.equal(getattr(got[2], name), getattr(want[2], name)), \
            name


def test_segment_reduce_and_select_sources_at_7k_brokers_1m_partitions(card):
    """K1 (full and offline) bitwise against its twin on a CPU copy and K2
    exact against its twin at 7,000 brokers / 1M partitions, with 50
    brokers DEAD."""
    state, meta = random_cluster(7000, 700, 1_000_000, rf=3, num_racks=8,
                                 seed=42, skew_to_first=2.0,
                                 target_utilization=0.55,
                                 dist=Dist.EXPONENTIAL, device=card)
    state = tt.set_broker_state(state, torch.arange(6950, 7000), 1)
    host = state.to("cpu")
    got = tagg.compute_agg(state, meta.num_topics)
    want = tagg.compute_agg_plain(host, meta.num_topics)
    for f in ("broker_load", "broker_replicas", "broker_leaders",
              "pot_nw_out", "lbi", "topic_counts"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert torch.equal(tagg.offline_per_broker(state).cpu(),
                       tagg.offline_per_broker_plain(host))
    g = torch.Generator(device="cpu").manual_seed(7)
    weight = torch.rand(tuple(state.assignment.shape), generator=g).to(card)
    score = (torch.rand(7000, generator=g) - 0.5).to(card)
    for a, b in zip(tc.select_sources(state, score, weight, 2048),
                    tc.select_sources_plain(state, score, weight, 2048)):
        assert torch.equal(a, b)


AGG_FIELDS = ("broker_load", "broker_replicas", "broker_leaders",
              "pot_nw_out", "lbi", "topic_counts")


def _k4_matches_cpu_twin(agg, sub, sel, pot, lbi):
    got = tagg.apply_deltas_to_agg(agg, sub, sel, pot, lbi)
    cpu_agg = type(agg)(*(getattr(agg, f).cpu() for f in AGG_FIELDS))
    cpu_sub = type(sub)(**{k: v.cpu() for k, v in vars(sub).items()})
    want = tagg.apply_deltas_to_agg_plain(cpu_agg, cpu_sub, sel.cpu(),
                                          pot.cpu(), lbi.cpu())
    for f in AGG_FIELDS:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


def test_apply_deltas_on_an_adversarial_batch(card):
    """K4 at 1,000 brokers / 100 topics, m = 2,048: every row leaves one
    broker within one topic; every 4th row unselected, naming B-1."""
    state, meta = random_cluster(1000, 100, 100_000, rf=3, num_racks=8,
                                 seed=42, skew_to_first=2.0,
                                 target_utilization=0.55,
                                 dist=Dist.EXPONENTIAL, device=card)
    agg = tagg.compute_agg(state, meta.num_topics)
    _k4_matches_cpu_twin(agg, *k4_adversarial_batch(1000, meta.num_topics,
                                                    card, seed=3))


def test_apply_deltas_on_a_7k_drain_batch(card):
    """K4 at 7,000 brokers / 700 topics with 50 brokers DEAD: 2,048
    replicas of the DEAD brokers moved to live ones, every 8th row
    unselected."""
    state, meta = random_cluster(7000, 700, 1_000_000, rf=3, num_racks=8,
                                 seed=42, skew_to_first=2.0,
                                 target_utilization=0.55,
                                 dist=Dist.EXPONENTIAL, device=card)
    state = tt.set_broker_state(state, torch.arange(6950, 7000), 1)
    agg = tagg.compute_agg(state, meta.num_topics)
    _k4_matches_cpu_twin(agg, *k4_drain_batch(state, seed=5))


@pytest.mark.parametrize("case", ["one_broker", "pad_slots",
                                  "masked_partitions"])
def test_segment_reduce_on_edge_states(card, case):
    """K1 where its sort has the most to get wrong: every replica on one
    broker (one bucket of every slot), empty slots, masked partitions."""
    state, meta = _state(card)
    rng = np.random.default_rng(4)
    a = state.assignment.cpu().numpy().copy()
    mask = state.partition_mask.cpu().numpy().copy()
    if case == "one_broker":
        a[a >= 0] = 2
    elif case == "pad_slots":
        a[rng.random(a.shape) < 0.3] = -1
    else:
        mask[rng.random(mask.shape) < 0.3] = False
    state = dataclasses.replace(state,
                                assignment=torch.from_numpy(a).to(card),
                                partition_mask=torch.from_numpy(mask).to(card))
    got = tagg.compute_agg(state, meta.num_topics)
    want = tagg.compute_agg_plain(state.to("cpu"), meta.num_topics)
    for f in AGG_FIELDS:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.fixture(scope="module")
def k2_states():
    """The 1k/100k fixture, and 7k/1M with its last 50 brokers DEAD."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    fx = dict(rf=3, num_racks=8, seed=42, skew_to_first=2.0,
              target_utilization=0.55, dist=Dist.EXPONENTIAL, device=dev)
    small = random_cluster(1000, 100, 100_000, **fx)
    big, big_meta = random_cluster(7000, 700, 1_000_000, **fx)
    big = tt.set_broker_state(big, torch.arange(6950, 7000), 1)
    return {"1k_100k": small, "7k_1m_dead50": (big, big_meta)}


def _k2_matches_twin(state, score, weight, num_sources=2048):
    got = tc.select_sources(state, score, weight, num_sources)
    want = tc.select_sources_plain(state, score, weight, num_sources)
    for a, b, name in zip(got, want, ("cand_p", "cand_s", "src_valid")):
        assert torch.equal(a, b), name
    return got


@pytest.mark.parametrize("shape", ["1k_100k", "7k_1m_dead50"])
@pytest.mark.parametrize("case", K2_CASES)
def test_select_sources_on_adversarial_inputs(k2_states, shape, case):
    """K2 exact against its twin where ties reach the row index, zeros are
    signed, the block outruns the source rows, or a top broker has no
    second row."""
    state, _meta = k2_states[shape]
    weight, score = k2_adversarial_inputs(state.assignment.cpu().numpy(),
                                          state.num_brokers, 2048, case,
                                          seed=11)
    dev = state.device
    _k2_matches_twin(state, torch.from_numpy(score).to(dev),
                     torch.from_numpy(weight).to(dev))


@pytest.mark.parametrize("offline_override", [True, False])
def test_select_sources_on_round_inputs_at_7k(k2_states, offline_override):
    """K2 at 7k/1M with 50 brokers DEAD on DiskUsageDistributionGoal's
    scores and weights as the round body builds them: with the offline
    override, 6,830 replicas weigh 1e30, more than the global block."""
    state, meta = k2_states["7k_1m_dead50"]
    score, weight = k2_round_inputs(state, meta.num_topics,
                                    offline_override=offline_override)
    ties = int((weight == 1e30).sum())
    assert (ties > 1024) == offline_override
    _k2_matches_twin(state, score, weight)


def test_select_sources_is_one_fixed_cuda_graph(k2_states):
    """A CUDA graph captures a whole call (no host read, no host-side pass
    count), its replay equals the twin, and it has as many launches at
    1k/100k as at 7k/1M."""
    nodes = {}
    for shape, (state, meta) in k2_states.items():
        score, weight = k2_round_inputs(state, meta.num_topics)
        graph, out = cuda_graph_capture(
            lambda: tc.select_sources(state, score, weight, 2048))
        nodes[shape] = cuda_graph_nodes(graph)
        graph.replay()
        torch.cuda.synchronize()
        want = tc.select_sources_plain(state, score, weight, 2048)
        for a, b in zip(out, want):
            assert torch.equal(a, b)
    assert len(set(nodes.values())) == 1, nodes
    assert nodes["1k_100k"] > 1
