"""Kernel K7 (``slot_weights``) off the card.

- The twin ``slot_weights_plain`` against the JAX package: every goal of
  ``ALL_GOALS`` (all 21, so every weight family), each goal's
  ``replica_weight`` and the round body's offline override
  (``where(off & ~lead_only, 1e30, weight)``) with ``offline_replicas``,
  on numpy-seeded clusters at 12/96, 16/512 and 100/10k with DEAD brokers.
  Bit for bit: the weights are selections, sums in one association and
  products that XLA:CPU does not contract here.
- The twin's offline count per broker equal to the reference's
  ``segment_sum`` of the offline mask (chain.py:234-238, through the JAX
  package) at the same sizes, also with a broker outside ``broker_mask``
  that hosts replicas, masked partitions and empty slots; zeros without
  the override.
- ``csrc/slot_pass.cu`` built as host C++ with g++ (no ``__CUDACC__``,
  no contraction) against the twin, bit for bit (weight, off, off_any,
  count), for every goal and both override settings, on the same
  clusters, and on every template instance it compiles: S = 1, 2, 3, 4
  and the generic one (S = 5 and 16).
- One ``_chain_round_body`` at 100/10k with DEAD brokers, the count
  coming from K7's twin (K1's offline mode is never called), against the
  JAX package's jitted round body: state, aggregate carry and applied
  count bit for bit.

K2's leadership mode is held in tests/test_torch_leadership_select.py.
"""

import ctypes
import dataclasses
import functools
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import agg as jagg
from cruise_control_tpu.analyzer import chain as jchain
from cruise_control_tpu.analyzer import derived as jderived
from cruise_control_tpu.analyzer import goals as jgoals
from cruise_control_tpu.analyzer import search as jsearch
from cruise_control_tpu.analyzer.constraint import BalancingConstraint as JBC
from cruise_control_tpu.analyzer.search import ExclusionMasks as JMasks
from cruise_control_tpu.analyzer.search import SearchConfig as JCfg
from cruise_control_tpu.common.broker_state import BrokerState
from cruise_control_tpu.config.cruise_control_config import DEFAULT_GOALS
from cruise_control_tpu.model import tensors as jt
from cruise_control_tpu.model.fixtures import Dist as JDist
from cruise_control_tpu.model.fixtures import random_cluster as j_random_cluster
from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer import agg as tagg
from cruise_control_tpu_torch.analyzer import chain as tchain
from cruise_control_tpu_torch.analyzer import derived as tderived
from cruise_control_tpu_torch.analyzer import goals as tgoals
from cruise_control_tpu_torch.analyzer import search as tsearch
from cruise_control_tpu_torch.analyzer import slot_pass
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint as TBC
from cruise_control_tpu_torch.analyzer.goals.base import WeightFamily
from cruise_control_tpu_torch.analyzer.search import ExclusionMasks as TMasks
from cruise_control_tpu_torch.analyzer.search import SearchConfig as TCfg
from cruise_control_tpu_torch.model import tensors as tt
from cruise_control_tpu_torch.model.fixtures import Dist as TDist
from cruise_control_tpu_torch.model.fixtures import random_cluster as t_random_cluster
from tests.torch_support import one_torch_thread  # noqa: F401  (autouse)

BASE = dict(rf=3, num_racks=8, seed=42, skew_to_first=2.0,
            target_utilization=0.55)
# name -> (brokers, topics, partitions, DEAD brokers)
CASES = {
    "12_96": (12, 4, 96, (3,)),
    "16_512": (16, 8, 512, (14,)),
    "100_10k": (100, 10, 10_000, (97, 98, 99)),
}
GOALS = sorted(tgoals.ALL_GOALS)


def _variant(name, num_brokers):
    if name == "BrokerSetAwareGoal":
        return {"broker_sets": tuple(b % 4 for b in range(num_brokers))}
    if name == "MinTopicLeadersPerBrokerGoal":
        return {"min_leaders": 2}
    return {}


@functools.lru_cache(maxsize=None)
def _states(case):
    b, t, p, dead = CASES[case]
    params = dict(num_brokers=b, num_topics=t, num_partitions=p, **BASE)
    js, jm = j_random_cluster(**params, dist=JDist.EXPONENTIAL)
    ts, _ = t_random_cluster(**params, dist=TDist.EXPONENTIAL, device="cpu")
    js = jt.set_broker_state(js, jnp.asarray(dead), BrokerState.DEAD)
    ts = tt.set_broker_state(ts, torch.tensor(dead), BrokerState.DEAD)
    return (js, jderived.compute_derived(js), ts,
            tderived.compute_derived(ts), jm.num_topics)


@functools.lru_cache(maxsize=None)
def _goal_world(case, name):
    js, jd, ts, td, topics = _states(case)
    kwargs = _variant(name, ts.num_brokers)
    jg = jgoals.ALL_GOALS[name](**kwargs)
    tg = tgoals.ALL_GOALS[name](**kwargs)
    jaux = jsearch.goal_aux(jg, js, jd, JBC(), topics)
    taux = tsearch.goal_aux(tg, ts, td, TBC(), topics)
    return jg, tg, (js, jd, JBC(), jaux), (ts, td, TBC(), taux)


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_bitwise(got, want, what):
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape, what
    bad = np.flatnonzero(g.reshape(-1) != w.reshape(-1))
    assert bad.size == 0, (
        f"{what}: {bad.size} differ, first at {bad[0]}: "
        f"{np.asarray(got).reshape(-1)[bad[0]]!r} vs "
        f"{np.asarray(want).reshape(-1)[bad[0]]!r}")


def _jax_weight(jg, jargs, override):
    js = jargs[0]
    w = jg.replica_weight(*jargs).astype(jnp.float32)
    off = jt.offline_replicas(js)
    if override:
        w = jnp.where(off & (not jg.leadership_only), 1e30, w)
    return np.asarray(w), np.asarray(off)


def _jax_offline_count(js):
    """The reference's per-broker offline count: the segment sum of the
    offline mask in f32 (cruise_control_tpu/analyzer/chain.py:234-238)."""
    off = jt.offline_replicas(js)
    b = js.num_brokers
    seg = jnp.where(js.assignment >= 0, js.assignment, b).reshape(-1)
    return np.asarray(jax.ops.segment_sum(
        off.astype(jnp.float32).reshape(-1), seg, num_segments=b + 1)[:b])


def _assert_count(got, want_f32, what):
    """K7's int32 count against the reference's f32 sum: the same
    integers, and bit for bit the f32 the round adds."""
    assert got.dtype == torch.int32, what
    np.testing.assert_array_equal(got.numpy(), want_f32.astype(np.int64),
                                  err_msg=what)
    _assert_bitwise(got.to(torch.float32), want_f32, what)


@pytest.mark.parametrize("name", GOALS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_equals_jax(case, name):
    jg, tg, jargs, targs = _goal_world(case, name)
    count = _jax_offline_count(jargs[0])
    for override in (False, True):
        want_w, want_off = _jax_weight(jg, jargs, override)
        healing = override and not tg.leadership_only
        w, off, off_any, off_pb = slot_pass.slot_weights_plain(
            tg, *targs, healing)
        _assert_bitwise(w, want_w, f"{case} {name} override={override}")
        _assert_bitwise(off, want_off, f"{case} {name} offline")
        assert bool(off_any) == bool(want_off.any())
        _assert_count(off_pb, count if healing else np.zeros_like(count),
                      f"{case} {name} override={override} count")
    assert want_off.any(), "the fixture has offline replicas"


@functools.lru_cache(maxsize=None)
def _edge_states(case):
    """The case's cluster in both packages with empty slots, masked
    partitions and a live broker outside ``broker_mask`` that hosts
    replicas (the reference counts its replicas offline)."""
    js, _jd, ts, _td, topics = _states(case)
    a = ts.assignment.numpy().copy()
    a[::5, -1] = -1
    a[1::7, 0] = -1
    pmask = ts.partition_mask.numpy().copy()
    pmask[-4:] = False
    bmask = ts.broker_mask.numpy().copy()
    bmask[1] = False
    assert (a[pmask] == 1).any(), "broker 1 hosts replicas"
    arrays = dict(assignment=a, partition_mask=pmask, broker_mask=bmask)
    js = dataclasses.replace(js, **{k: jnp.asarray(v)
                                    for k, v in arrays.items()})
    ts = dataclasses.replace(ts, **{k: torch.from_numpy(v)
                                    for k, v in arrays.items()})
    return js, ts, topics


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_offline_count_equals_jax_segment_sum(case):
    js, ts, topics = _edge_states(case)
    want = _jax_offline_count(js)
    assert want[1] > 0 and want[list(CASES[case][3])].sum() > 0
    td = tderived.compute_derived(ts)
    for name in ("RackAwareGoal", "DiskUsageDistributionGoal",
                 "LeaderReplicaDistributionGoal"):
        tg = tgoals.ALL_GOALS[name]()
        aux = tsearch.goal_aux(tg, ts, td, TBC(), topics)
        _w, off, off_any, off_pb = slot_pass.slot_weights_plain(
            tg, ts, td, TBC(), aux, True)
        _assert_count(off_pb, want, f"{case} {name} count")
        _assert_count(off_pb, tagg.offline_per_broker_plain(ts).numpy(),
                      f"{case} {name} against K1's offline twin")
        _assert_bitwise(off, np.asarray(jt.offline_replicas(js)),
                        f"{case} {name} offline")
        assert bool(off_any)
        _w, _off, _any, zeros = slot_pass.slot_weights_plain(
            tg, ts, td, TBC(), aux, False)
        _assert_count(zeros, np.zeros_like(want), f"{case} {name} zeros")


def test_every_weight_family_is_reached():
    _js, _jd, ts, td, topics = _states("16_512")
    seen = set()
    for name in GOALS:
        _jg, tg, _ja, targs = _goal_world("16_512", name)
        seen.add(tg.weight_args(*targs).family)
    assert seen == set(WeightFamily)


@functools.lru_cache(maxsize=1)
def _host_library(tmp_dir):
    out = f"{tmp_dir}/libslot_pass_host.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-x", "c++",
                    str(kernels.CSRC / "slot_pass.cu"), "-o", out],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(out)
    lib.cc_slot_weights_host.argtypes = [ctypes.c_void_p]
    lib.cc_slot_weights_params_bytes.restype = ctypes.c_longlong
    assert lib.cc_slot_weights_params_bytes() \
        == ctypes.sizeof(slot_pass.WeightParams)
    assert lib.cc_slot_weights_scratch_head() == slot_pass.SCRATCH_HEAD
    return lib


def _host_weights(lib, tg, targs, topics, override):
    args = tg.weight_args(*targs)
    q, outs = slot_pass.weight_params(targs[0], targs[1], args, topics,
                                      override)
    assert lib.cc_slot_weights_host(ctypes.byref(q)) == 0
    return outs


OUTPUTS = ("weight", "off", "off_any", "count")


@pytest.mark.parametrize("name", GOALS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_built_for_the_host_equals_the_twin(case, name,
                                                   tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler")
    lib = _host_library(str(tmp_path_factory.getbasetemp()))
    _jg, tg, _ja, targs = _goal_world(case, name)
    topics = _states(case)[4]
    for override in (False, True):
        got = _host_weights(lib, tg, targs, topics, override)
        want = slot_pass.slot_weights_plain(tg, *targs, override)
        for g, w, what in zip(got, want, OUTPUTS, strict=True):
            _assert_bitwise(g, w, f"{case} {name} override={override} "
                            f"{what}")


def test_host_kernel_on_signed_zero_and_empty_slots(tmp_path_factory):
    """Empty slots of -total are -0.0 in the twin; zero loads give +0.0
    or -0.0 by sign; the rack and set families on partitions with empty
    slots and a masked partition."""
    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler")
    lib = _host_library(str(tmp_path_factory.getbasetemp()))
    _js, _jd, ts, td, topics = _states("12_96")
    a = ts.assignment.clone()
    a[::5, 2] = -1
    a[::7, 1] = -1
    lead = ts.leader_load.clone()
    lead[::3] = 0.0
    fol = ts.follower_load.clone()
    fol[1::3] = -0.0
    pmask = ts.partition_mask.clone()
    pmask[-4:] = False
    state = dataclasses.replace(ts, assignment=a, leader_load=lead,
                                follower_load=fol, partition_mask=pmask)
    derived = tderived.compute_derived(state)
    for name in GOALS:
        tg = tgoals.ALL_GOALS[name](**_variant(name, state.num_brokers))
        aux = tsearch.goal_aux(tg, state, derived, TBC(), topics)
        targs = (state, derived, TBC(), aux)
        for override in (False, True):
            got = _host_weights(lib, tg, targs, topics, override)
            want = slot_pass.slot_weights_plain(tg, *targs, override)
            for g, w, what in zip(got, want, OUTPUTS, strict=True):
                _assert_bitwise(g, w, f"{name} override={override} {what}")


@functools.lru_cache(maxsize=None)
def _slot_count_state(slots):
    """16 brokers, 600 partitions (two full tiles of 256 and a ragged
    one) at replication factor ``slots``, a DEAD broker, a broker outside
    ``broker_mask``, empty slots and masked partitions."""
    ts, meta = t_random_cluster(16, 8, 600, rf=slots, num_racks=8, seed=7,
                                skew_to_first=2.0, target_utilization=0.55,
                                dist=TDist.EXPONENTIAL, device="cpu")
    ts = tt.set_broker_state(ts, torch.tensor(14), BrokerState.DEAD)
    a = ts.assignment.clone()
    a[::5, slots - 1] = -1
    pmask = ts.partition_mask.clone()
    pmask[-3:] = False
    bmask = ts.broker_mask.clone()
    bmask[2] = False
    ts = dataclasses.replace(ts, assignment=a, partition_mask=pmask,
                             broker_mask=bmask)
    return ts, tderived.compute_derived(ts), meta.num_topics


@pytest.mark.parametrize("slots", [1, 2, 3, 4, 5, 16])
def test_host_kernel_on_every_slot_count(slots, tmp_path_factory):
    """Every template instance of the kernel (S = 1-4, and the generic
    one at 5 and 16 slots) against the twin, every goal, both override
    settings: weight, off, off_any and the count bit for bit."""
    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler")
    lib = _host_library(str(tmp_path_factory.getbasetemp()))
    state, derived, topics = _slot_count_state(slots)
    assert tuple(state.assignment.shape) == (600, slots)
    offline = int(tagg.offline_per_broker_plain(state).sum())
    assert offline > 0
    for name in GOALS:
        tg = tgoals.ALL_GOALS[name](**_variant(name, state.num_brokers))
        aux = tsearch.goal_aux(tg, state, derived, TBC(), topics)
        targs = (state, derived, TBC(), aux)
        for override in (False, True):
            got = _host_weights(lib, tg, targs, topics, override)
            want = slot_pass.slot_weights_plain(tg, *targs, override)
            for g, w, what in zip(got, want, OUTPUTS, strict=True):
                _assert_bitwise(g, w, f"S={slots} {name} "
                                f"override={override} {what}")
            assert int(got[3].sum()) == (offline if override else 0)


ROUND_NAMES = [g.rsplit(".", 1)[-1] for g in DEFAULT_GOALS]
ROUND_CFG = dict(num_sources=256, num_dests=16, moves_per_round=64)


@pytest.mark.parametrize("active", [0, 8, 14])
def test_round_body_with_k7s_count_equals_jax(active, monkeypatch):
    """One round at 100/10k with 3 brokers DEAD (offline replicas in the
    sources' bonus), RackAwareGoal, DiskUsageDistributionGoal (8 goals
    prior) and the leadership-only LeaderBytesInDistributionGoal (the
    zero-vector add) active: the count comes from K7's twin, and K1's
    offline mode is not called."""
    js, _jd, ts, _td, topics = _states("100_10k")
    prior = [j < active for j in range(len(ROUND_NAMES))]
    jchain_goals = tuple(jgoals.ALL_GOALS[n]() for n in ROUND_NAMES)
    tchain_goals = tuple(tgoals.ALL_GOALS[n]() for n in ROUND_NAMES)
    assert tchain_goals[active].leadership_only == (active == 14)

    def jax_round(state, agg):
        return jchain._chain_round_body(
            state, agg, jnp.int32(active), jnp.asarray(prior), jchain_goals,
            JBC(), JCfg(**ROUND_CFG), topics, JMasks())

    want_state, want_agg, want_applied, _stat = jax.jit(jax_round)(
        js, jagg.compute_agg(js, topics))

    def offline_mode(*_a, **_kw):
        raise AssertionError("the round called K1's offline mode")

    monkeypatch.setattr(tagg, "offline_per_broker", offline_mode)
    got_state, got_agg, got_applied = tchain._chain_round_body(
        ts, tagg.compute_agg(ts, topics), active, prior, tchain_goals,
        TBC(), TCfg(**ROUND_CFG), topics, TMasks())
    assert int(got_applied) == int(want_applied) > 0
    for field in ("assignment", "leader_slot"):
        _assert_bitwise(getattr(got_state, field),
                        getattr(want_state, field), f"state {field}")
    for f in dataclasses.fields(got_agg):
        _assert_bitwise(getattr(got_agg, f.name), getattr(want_agg, f.name),
                        f"agg {f.name}")


def test_weight_params_refuse_wrong_arrays_and_sizes():
    _js, _jd, ts, td, topics = _states("16_512")
    _jg, tg, _ja, targs = _goal_world("16_512", "DiskUsageDistributionGoal")
    args = tg.weight_args(*targs)
    bad = type(args)(args.family, args.arrays[:1], args.resource)
    with pytest.raises(ValueError, match="takes 2 arrays"):
        slot_pass.weight_params(ts, td, bad, topics, True)
    wrong = type(args)(args.family, (args.arrays[0],
                                     args.arrays[1].double()), args.resource)
    with pytest.raises(ValueError, match="dtype"):
        slot_pass.weight_params(ts, td, wrong, topics, True)
    wide = ts.assignment.new_zeros((ts.num_partitions,
                                    slot_pass.MAX_SLOTS + 1))
    with pytest.raises(ValueError, match="slot_weights kernel"):
        slot_pass.weight_params(dataclasses.replace(ts, assignment=wide), td,
                                args, topics, True)
