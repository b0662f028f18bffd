"""The port's CUDA kernels against their plain twins on the card.

K1, K4 and K5 are held bit for bit against the twin run on a CPU copy,
which adds in the reference's order; the twin on the card (PyTorch's CUDA
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


def _k5_case(card, cl, dk, movable, band):
    """K5 against its twin on a CPU copy: the disk assignment and the
    final per-disk loads (load mode against the twin's segment sum), bit
    for bit."""
    from cruise_control_tpu_torch.model import disks as td
    state = tt.cluster_from_numpy(cl, card)
    disks = td.disks_from_numpy(dk, card)
    mv = None if movable is None else torch.as_tensor(movable, device=card)
    got = td.balance_intra_broker(state, disks, 0.8, band, 64, mv)
    host = state.to("cpu")
    want = td.balance_intra_broker_plain(
        host, disks.to("cpu"), 0.8, band, 64,
        None if movable is None else torch.as_tensor(movable))
    assert torch.equal(got.disk_assignment.cpu(), want.disk_assignment)
    loads = td.disk_load(state, got).cpu()
    assert torch.equal(loads.view(torch.int32),
                       td.disk_load(host, want).view(torch.int32))


@pytest.mark.parametrize("case", ["empty_above", "empty_below",
                                  "pinned_above", "late_empty_above",
                                  "rf3_both"])
def test_intra_broker_on_sentinel_cases(card, case):
    from cruise_control_tpu_torch.testing import sentinel_case
    _k5_case(card, *sentinel_case(case))


def test_intra_broker_on_random_small_cases(card):
    from cruise_control_tpu_torch.testing import random_disk_case
    for seed in range(60):
        _k5_case(card, *random_disk_case(
            seed, num_brokers=4 + seed % 5, num_partitions=10 + seed % 30,
            rf=1 + seed % 3, num_disks=2 + seed % 3))


@pytest.mark.parametrize("num_disks,band", [(2, None), (4, (0.91, 1.09)),
                                            (8, (0.91, 1.09))])
def test_intra_broker_on_jbod_and_random_placements_at_1k(card, num_disks,
                                                         band):
    from cruise_control_tpu_torch.testing import (
        jbod_disks, random_placement_disks,
    )
    state, _meta = random_cluster(1000, 100, 100_000, rf=3, num_racks=8,
                                  dist=Dist.EXPONENTIAL, seed=42,
                                  skew_to_first=2.0, target_utilization=0.55,
                                  device=card)
    cl = tt.cluster_to_numpy(state)
    _k5_case(card, cl, jbod_disks(cl["assignment"], cl["partition_mask"],
                                  cl["capacity"][:, 3], num_disks), None,
             band)
    dk, movable = random_placement_disks(cl["assignment"],
                                         cl["partition_mask"],
                                         cl["capacity"][:, 3], num_disks,
                                         seed=num_disks)
    _k5_case(card, cl, dk, movable, band)


def test_intra_broker_launches_are_counted_apart(card):
    from cruise_control_tpu_torch.model import disks as td
    from cruise_control_tpu_torch.testing import sentinel_case
    cl, dk, movable, band = sentinel_case("rf3_both")
    state = tt.cluster_from_numpy(cl, card)
    disks = td.disks_from_numpy(dk, card)
    kernels.LAUNCHES.clear()
    td.balance_intra_broker(state, disks, 0.8, band, 64)
    td.disk_load(state, disks)
    td.intra_broker_violations(state, disks)
    assert kernels.LAUNCHES["intra_broker"] == 1
    assert kernels.LAUNCHES["intra_broker_load"] == 2


def _disk_load_case(card, cl, dk):
    """K5's load mode against its twin on a CPU copy, bit for bit, run
    with PyTorch's sync debug mode set to raise: no host read."""
    from cruise_control_tpu_torch.model import disks as td
    state = tt.cluster_from_numpy(cl, card)
    disks = td.disks_from_numpy(dk, card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = td.disk_load(state, disks)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = td.disk_load(state.to("cpu"), disks.to("cpu"))
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    return want


@pytest.mark.parametrize("num_disks", [1, 2, 4, 8, 32])
def test_disk_load_matches_twin(card, num_disks):
    """Random small cases, a broker above the balancer's 8,192 replicas
    (the load mode returns its loads) and 60,000 brokers (buckets of 256
    brokers, ranked by lists)."""
    from cruise_control_tpu_torch.model import disks as td
    from cruise_control_tpu_torch.testing import (
        crowded_broker_case, disk_cluster_arrays, random_disk_case,
    )
    for seed in range(10):
        cl, dk, _mv, _band = random_disk_case(
            seed, num_brokers=4 + seed % 5, num_partitions=10 + 97 * seed,
            rf=1 + seed % 3, num_disks=num_disks)
        _disk_load_case(card, cl, dk)
    cl, dk = crowded_broker_case(num_disks, seed=num_disks)
    assert (cl["assignment"] == 1).sum() > td.INTRA_BROKER_MAX_REPLICAS
    assert float(_disk_load_case(card, cl, dk)[1].sum()) > 0
    with pytest.raises(ValueError, match="a broker hosts"):
        td.balance_intra_broker(tt.cluster_from_numpy(cl, card),
                                td.disks_from_numpy(dk, card))
    rng = np.random.default_rng(num_disks)
    b, p = 60_000, 5_000
    assign = rng.integers(0, b, (p, 3)).astype(np.int32)
    cl = disk_cluster_arrays(assign, rng.exponential(50.0, p), b)
    dk = {"disk_assignment": rng.integers(-1, num_disks, (p, 3))
          .astype(np.int32),
          "disk_capacity": np.full((b, num_disks), 1e6, np.float32),
          "disk_alive": np.ones((b, num_disks), bool)}
    _disk_load_case(card, cl, dk)


# ---- K6 score_grid -----------------------------------------------------------

@pytest.mark.parametrize("seed", range(40))
def test_score_grid_matches_twin_on_random_small_cases(card, seed):
    from cruise_control_tpu_torch.testing import (
        k6_mismatches, k6_random_case, k6_round_inputs,
    )
    state, topics, goals, masks, cfg = k6_random_case(seed, card)
    kernels.LAUNCHES.clear()
    for active in range(len(goals)):
        rec = k6_round_inputs(state, goals, active, topics, cfg, masks)
        assert k6_mismatches(rec) == [], (seed, goals[active].name)
    assert kernels.LAUNCHES["score_grid"] >= 2 * len(goals)
    assert kernels.LAUNCHES["score_grid_recheck"] >= 2 * len(goals)


@pytest.mark.parametrize("variant", ["no targeted column",
                                     "odd destinations"])
def test_score_grid_without_targeted_column_or_with_odd_destinations(
        card, variant):
    """K6's grid mode on recorded rounds whose grid has no targeted
    column (extra = 0) or an odd number of destination columns."""
    from cruise_control_tpu_torch.testing import (
        k6_mismatches, k6_random_case, k6_round_inputs,
    )
    for seed in range(8):
        state, topics, goals, masks, cfg = k6_random_case(seed, card)
        for active in range(len(goals)):
            rec = k6_round_inputs(state, goals, active, topics, cfg, masks)
            spec = rec["grid"][8]
            if variant == "no targeted column":
                spec = dataclasses.replace(spec, t_dst=None, t_ok=None)
            else:
                k = spec.dst_idx.shape[0]
                k = k - 1 if k % 2 == 0 else k
                spec = dataclasses.replace(
                    spec, dst_idx=spec.dst_idx[:k].contiguous(),
                    dst_val=spec.dst_val[:k].contiguous())
            grid = rec["grid"][:8] + (spec,) + rec["grid"][9:]
            assert k6_mismatches({"grid": grid, "recheck": rec["recheck"]}) \
                == [], (seed, goals[active].name, variant)


def test_score_grid_in_a_replayed_block_equals_the_eager_twin(card):
    """A captured block's K6 launches read goal arrays allocated inside
    the capture: replayed, the block equals the same block run eagerly
    with the plain twins in K6's place, bit for bit."""
    from cruise_control_tpu_torch.analyzer import score_grid as sg
    state, meta = _state(card, dead=(5,))
    goals = tuple(ALL_GOALS[g.rsplit(".", 1)[-1]]() for g in DEFAULT_GOALS)
    t = meta.num_topics
    goal = 13   # TopicReplicaDistributionGoal: the [T, B] plane in its table
    prior = tuple(j < goal for j in range(len(goals)))
    cfg = SearchConfig(num_sources=128, num_dests=16, moves_per_round=32)
    masks = ExclusionMasks()

    def round_fn(s, a, m, live):
        return tchain._chain_round_body(s, a, goal, prior, goals,
                                        BalancingConstraint(), cfg, t, m,
                                        live)

    agg = tagg.compute_agg(state, t)
    tchain.clear_graphs()
    loop = tchain._static_loop(state, agg, masks)
    loop.load(state, agg, masks, cap=2)
    orig = tchain.score_grid, tchain.recheck
    tchain.score_grid = lambda *a: sg.score_grid_plain(*a[:11])
    tchain.recheck = lambda *a: sg.recheck_plain(*a[:9])
    try:
        eager = tchain.run_block(round_fn, loop.carry(), masks, t,
                                 k=tchain.ROUNDS_PER_BLOCK, refresh=())
    finally:
        tchain.score_grid, tchain.recheck = orig
    eager = [eager.state.assignment.clone(), eager.state.leader_slot.clone(),
             *(getattr(eager.agg, f.name).clone()
               for f in dataclasses.fields(eager.agg)), eager.total.clone()]
    graph = loop.graph(("k6", goal), round_fn, t, ())
    for _ in range(2):
        loop._loaded.clear()
        loop.load(state, agg, masks, cap=2)
        graph.replay()
        c = loop.carry()
        got = [c.state.assignment, c.state.leader_slot,
               *(getattr(c.agg, f.name) for f in dataclasses.fields(c.agg)),
               c.total]
        for a, b in zip(eager, got):
            assert torch.equal(a, b)
    assert int(eager[-1]) > 0
    assert graph.launches["score_grid"] == tchain.ROUNDS_PER_BLOCK
    assert graph.launches["score_grid_recheck"] == tchain.ROUNDS_PER_BLOCK


# ---- K7 slot_weights, K2's leadership mode, K8 swap_top_replicas -------------

def _to(obj, dev):
    """A tensor, or a dataclass, dict, tuple or list of them, on ``dev``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, dict):
        return {k: _to(v, dev) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to(x, dev) for x in obj)
    return obj


def _goal(name, num_brokers):
    kwargs = {"BrokerSetAwareGoal": {"broker_sets": tuple(
        b % 4 for b in range(num_brokers))},
        "MinTopicLeadersPerBrokerGoal": {"min_leaders": 2}}.get(name, {})
    return ALL_GOALS[name](**kwargs)


def _bitwise(a, b, what):
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b), what


@pytest.mark.parametrize("name", sorted(ALL_GOALS))
def test_slot_weights_matches_twin_for_every_goal(card, name):
    """K7 bit for bit against its twin on a CPU copy, with and without the
    offline override, two brokers DEAD."""
    from cruise_control_tpu_torch.analyzer import derived as tderived
    from cruise_control_tpu_torch.analyzer import slot_pass
    state, meta = _state("cpu", dead=(3, 11))
    goal = _goal(name, state.num_brokers)
    derived = tderived.compute_derived(state)
    aux = tsearch.goal_aux(goal, state, derived, BalancingConstraint(),
                           meta.num_topics)
    on_card = _to((state, derived, aux), card)
    kernels.LAUNCHES.clear()
    for override in (False, True):
        got = slot_pass.slot_weights(goal, on_card[0], on_card[1],
                                     BalancingConstraint(), on_card[2],
                                     meta.num_topics, override)
        want = slot_pass.slot_weights_plain(goal, state, derived,
                                            BalancingConstraint(), aux,
                                            override)
        for g, w, what in zip(got, want, ("weight", "off", "off_any")):
            _bitwise(g, w, f"{name} override={override} {what}")
    assert kernels.LAUNCHES["slot_weights"] == 2


@pytest.mark.parametrize("name", ["DiskUsageDistributionGoal",
                                  "RackAwareGoal",
                                  "KafkaAssignerEvenRackAwareGoal",
                                  "TopicReplicaDistributionGoal"])
def test_slot_weights_at_7k_brokers_1m_partitions(k2_states, name):
    """K7 bit for bit against its twin on the card at 7k/1M, 50 brokers
    DEAD (the twin's ops are elementwise, so the card's twin is exact)."""
    from cruise_control_tpu_torch.analyzer import derived as tderived
    from cruise_control_tpu_torch.analyzer import slot_pass
    state, meta = k2_states["7k_1m_dead50"]
    goal = _goal(name, state.num_brokers)
    derived = tderived.compute_derived(state)
    aux = tsearch.goal_aux(goal, state, derived, BalancingConstraint(),
                           meta.num_topics)
    for override in (False, True):
        got = slot_pass.slot_weights(goal, state, derived,
                                     BalancingConstraint(), aux,
                                     meta.num_topics, override)
        want = slot_pass.slot_weights_plain(goal, state, derived,
                                            BalancingConstraint(), aux,
                                            override)
        for g, w, what in zip(got, want, ("weight", "off", "off_any")):
            _bitwise(g, w, f"{name} override={override} {what}")


def _lead_inputs(state, meta, kind, seed=5):
    dev = state.device
    b = state.num_brokers
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shape = tuple(state.assignment.shape)
    if kind == "round":
        return k2_round_inputs(state, meta.num_topics)
    if kind == "ties":
        return (torch.ones(b, device=dev),
                torch.full(shape, 1e30, device=dev))
    score = torch.rand(b, generator=gen) * 2 - 1
    if kind == "signed_zeros":
        w = torch.where(torch.rand(shape, generator=gen) < 0.5,
                        torch.tensor(0.0), torch.tensor(-0.0))
        w[torch.rand(shape, generator=gen) < 0.01] = 1.0
    else:   # few_finite: one source broker
        score = torch.full((b,), -1.0)
        score[1] = 2.0
        w = torch.randn(shape, generator=gen)
    return score.to(dev), w.to(dev)


@pytest.mark.parametrize("kind", ["round", "ties", "signed_zeros",
                                  "few_finite"])
@pytest.mark.parametrize("shape", ["16_512", "1k_100k", "7k_1m_dead50"])
def test_leadership_sources_matches_twin(k2_states, shape, kind):
    """K2's leadership mode exact against its twin (values bit for bit,
    partitions equal, top_k's -inf padding included)."""
    if shape == "16_512":
        state, meta = _state(torch.device("cuda"), dead=(3,))
    else:
        state, meta = k2_states[shape]
    score, weight = _lead_inputs(state, meta, kind)
    kernels.LAUNCHES.clear()
    for k in (64, 2048):
        got = tc.leadership_sources(state, score, weight, k)
        want = tc.leadership_sources_plain(state, score, weight, k)
        _bitwise(got[0], want[0], f"{shape} {kind} k={k} top_lw")
        _bitwise(got[1], want[1], f"{shape} {kind} k={k} lp")
    assert kernels.LAUNCHES["select_sources_leadership"] == 2


@pytest.mark.parametrize("kind", ["round", "ties", "signed_zeros",
                                  "few_finite"])
@pytest.mark.parametrize("shape", ["16_512", "1k_100k", "7k_1m_dead50"])
def test_swap_top_replicas_matches_twin(k2_states, shape, kind):
    """K8 exact against its twin: the j best replicas of 8 source and 8
    destination brokers (overlapping), padding included."""
    if shape == "16_512":
        state, meta = _state(torch.device("cuda"), dead=(3,))
    else:
        state, meta = k2_states[shape]
    score, weight = _lead_inputs(state, meta, kind, seed=9)
    b = state.num_brokers
    gen = torch.Generator(device="cpu").manual_seed(3)
    src_b = torch.randperm(b, generator=gen)[:8].to(torch.int32)
    dst_b = torch.cat([src_b[:2], torch.randperm(b, generator=gen)[:6]
                       .to(torch.int32)])
    dev = state.device
    if kind == "few_finite":
        # src_b[0] keeps one finite replica; dst_b[7] none.
        for broker, keep in ((int(src_b[0]), 1), (int(dst_b[7]), 0)):
            on = torch.nonzero(state.assignment.reshape(-1) == broker)[:, 0]
            weight.reshape(-1)[on[keep:]] = float("nan")
    src_b, dst_b = src_b.to(dev), dst_b.to(dev)
    kernels.LAUNCHES.clear()
    for j in (1, 4):
        got = tsearch.swap_top_replicas(state, weight, src_b, dst_b, j)
        want = (*tsearch._per_broker_top_replicas(state, weight, src_b, j,
                                                  largest=True),
                *tsearch._per_broker_top_replicas(state, weight, dst_b, j,
                                                  largest=False))
        for g, w, what in zip(got, want, ("heavy_idx", "heavy_ok",
                                          "light_idx", "light_ok")):
            _bitwise(g, w, f"{shape} {kind} j={j} {what}")
    assert kernels.LAUNCHES["swap_top_replicas"] == 2


def test_round_and_swap_launches_are_counted(card):
    """A fused solve runs K7 once per move round and per swap round, K2's
    leadership mode once per move round and K8 once per swap round."""
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.config import CruiseControlConfig
    state, meta = _state(card, dead=(5,))
    kernels.LAUNCHES.clear()
    GoalOptimizer(CruiseControlConfig(), device="cuda").optimizations(
        state, meta)
    n = kernels.LAUNCHES
    assert n["select_sources_leadership"] == n["score_grid"] > 0
    assert n["swap_top_replicas"] > 0
    assert n["slot_weights"] == n["select_sources_leadership"] \
        + n["swap_top_replicas"]
