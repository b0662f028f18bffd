"""K1's twin and the aggregate carry of the PyTorch port against the JAX
package (analyzer/agg.py, the offline segment sum of analyzer/chain.py).

The fixture has padded partitions and brokers and a DEAD broker, so empty
slots, pad rows and offline replicas all reach the segment sums. The twin
must equal the reference exactly: its sums run in the reference's order.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import agg as jagg
from cruise_control_tpu.analyzer import derived as jderived
from cruise_control_tpu.analyzer.constraint import BalancingConstraint as JBC
from cruise_control_tpu.common.broker_state import BrokerState
from cruise_control_tpu.common.resources import Resource
from cruise_control_tpu.model import tensors as jt
from cruise_control_tpu.model.fixtures import random_cluster as j_random_cluster
from cruise_control_tpu_torch.analyzer import agg as tagg
from cruise_control_tpu_torch.analyzer import derived as tderived
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint as TBC
from cruise_control_tpu_torch.model import tensors as tt
from cruise_control_tpu_torch.model.fixtures import random_cluster as t_random_cluster
from cruise_control_tpu_torch.utils.numerics import (
    VECTOR_SUM_LENGTHS, fma_f32, xla_sum, xla_vector_sum,
)
from tests.torch_support import one_torch_thread  # noqa: F401  (autouse)

FIXTURE = dict(num_brokers=14, num_topics=6, num_partitions=300, rf=3,
               num_racks=4, seed=11, skew_to_first=2.0, partition_bucket=64,
               broker_bucket=4)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(dead=(3, 9)):
    js, jm = j_random_cluster(**FIXTURE)
    ts, _tm = t_random_cluster(**FIXTURE, device="cpu")
    for b in dead:
        js = jt.set_broker_state(js, jnp.asarray(b), BrokerState.DEAD)
        ts = tt.set_broker_state(ts, torch.tensor(b), BrokerState.DEAD)
    return js, ts, jm.num_topics


def _assert_agg_equal(a, b):
    for f in ("broker_load", "broker_replicas", "broker_leaders",
              "pot_nw_out", "lbi", "topic_counts"):
        x, y = _np(getattr(a, f)), _np(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(y, x, err_msg=f)


@pytest.mark.parametrize("dead", [(), (3, 9)])
def test_compute_agg_matches_exactly(dead):
    js, ts, topics = _pair(dead)
    _assert_agg_equal(jagg.compute_agg(js, topics),
                      tagg.compute_agg(ts, topics))


@pytest.mark.parametrize("dead", [(), (3, 9)])
def test_offline_per_broker_matches_exactly(dead):
    js, ts, _topics = _pair(dead)
    off = jt.offline_replicas(js)
    b = js.num_brokers
    seg = jnp.where(js.assignment >= 0, js.assignment, b).reshape(-1)
    want = jax.ops.segment_sum(off.astype(jnp.float32).reshape(-1), seg,
                               num_segments=b + 1)[:b]
    got = tagg.offline_per_broker(ts)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert (np.asarray(want) > 0).any() == bool(dead)


def test_compute_agg_without_topics_matches_derived_sums():
    js, ts, _topics = _pair()
    got = tagg.compute_agg(ts, 0)
    assert tuple(got.topic_counts.shape) == (0, ts.num_brokers)
    np.testing.assert_array_equal(_np(got.broker_load),
                                  np.asarray(jt.broker_load(js)))
    np.testing.assert_array_equal(_np(got.pot_nw_out),
                                  np.asarray(jt.potential_nw_out(js)))


def _batch(num_brokers, num_topics, m=40, seed=5):
    rng = np.random.default_rng(seed)
    return dict(
        src_broker=rng.integers(0, num_brokers, m).astype(np.int32),
        dst_broker=rng.integers(0, num_brokers, m).astype(np.int32),
        load_delta=(rng.random((m, 4)) * 3).astype(np.float32),
        replica_delta=rng.integers(0, 2, m).astype(np.int32),
        leader_delta=rng.integers(0, 2, m).astype(np.int32),
        topic=rng.integers(0, num_topics, m).astype(np.int32),
        partition=rng.integers(0, 300, m).astype(np.int32),
        sel=rng.random(m) < 0.6,
        pot=(rng.random(m) * 2).astype(np.float32),
        lbi=(rng.random(m) * 2).astype(np.float32))


def test_apply_deltas_to_agg_matches_with_dropped_rows():
    js, ts, topics = _pair()
    d = _batch(js.num_brokers, topics)
    keys = ("src_broker", "dst_broker", "load_delta", "replica_delta",
            "leader_delta", "topic")
    jsub = jagg.AggDelta(**{k: jnp.asarray(d[k]) for k in keys})
    tsub = types.SimpleNamespace(**{k: torch.from_numpy(d[k]) for k in keys})
    want = jagg.apply_deltas_to_agg(
        jagg.compute_agg(js, topics), jsub, jnp.asarray(d["sel"]),
        jnp.asarray(d["pot"]), jnp.asarray(d["lbi"]))
    got = tagg.apply_deltas_to_agg(
        tagg.compute_agg(ts, topics), tsub, torch.from_numpy(d["sel"]),
        torch.from_numpy(d["pot"]), torch.from_numpy(d["lbi"]))
    _assert_agg_equal(want, got)
    # Unselected rows change nothing.
    none = tagg.apply_deltas_to_agg(
        tagg.compute_agg(ts, topics), tsub,
        torch.zeros(len(d["sel"]), dtype=torch.bool),
        torch.from_numpy(d["pot"]), torch.from_numpy(d["lbi"]))
    _assert_agg_equal(tagg.compute_agg(ts, topics), none)


# Batches that stress K4's event order (csrc/apply_deltas.cu) at the
# bounded path's cap, m = 2,048: one source broker for every row, one
# (topic, broker) cell named by every row, no row selected, leadership-only
# rows, rows whose source is their destination. Load deltas span seven
# decades so that the order of the adds shows in the bits.
ADVERSARIAL = ("one_source", "one_cell", "none_selected", "leadership_only",
               "src_is_dst")
BATCH_KEYS = ("src_broker", "dst_broker", "load_delta", "replica_delta",
              "leader_delta", "topic")


def _adversarial_batch(case, num_brokers, num_topics, m=2048, seed=9):
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.integers(-3, 4, (m, 1))
    d = dict(
        src_broker=rng.integers(0, num_brokers, m).astype(np.int32),
        dst_broker=rng.integers(0, num_brokers, m).astype(np.int32),
        load_delta=(rng.random((m, 4)) * scale).astype(np.float32),
        replica_delta=np.ones(m, np.int32),
        leader_delta=rng.integers(0, 2, m).astype(np.int32),
        topic=rng.integers(0, num_topics, m).astype(np.int32),
        sel=rng.random(m) < 0.75,
        pot=(rng.random(m) * scale[:, 0]).astype(np.float32),
        lbi=(rng.random(m) * scale[:, 0]).astype(np.float32))
    if case == "one_source":
        d["src_broker"][:] = 3
    elif case == "one_cell":
        d["topic"][:] = 1
        d["src_broker"][::2] = 4
        d["dst_broker"][1::2] = 4
    elif case == "none_selected":
        d["sel"][:] = False
    elif case == "leadership_only":
        d["replica_delta"][:] = 0
        d["leader_delta"][:] = 1
        d["pot"][:] = 0.0
    else:
        d["dst_broker"] = d["src_broker"].copy()
    return d


def _k4_event_order(agg, d):
    """A model of K4's float outputs: every selected row gives the events
    (src, 0, row) and (dst, 1, row); a stable sort by (broker, phase,
    row), then each broker's run folded serially from its input value.
    Returns [B, 6] f32 (four load columns, pot, lbi)."""
    m = len(d["sel"])
    rows = torch.nonzero(torch.from_numpy(d["sel"]), as_tuple=True)[0]
    broker = torch.cat([torch.from_numpy(d["src_broker"])[rows],
                        torch.from_numpy(d["dst_broker"])[rows]]).long()
    phase = torch.cat([torch.zeros_like(rows), torch.ones_like(rows)])
    row = torch.cat([rows, rows])
    order = torch.sort(broker * 2 * m + phase * m + row, stable=True)[1]
    vals = torch.cat([torch.from_numpy(d["load_delta"]),
                      torch.from_numpy(d["pot"])[:, None],
                      torch.from_numpy(d["lbi"])[:, None]], dim=1)
    out = torch.cat([agg.broker_load, agg.pot_nw_out[:, None],
                     agg.lbi[:, None]], dim=1).clone()
    for e in order.tolist():
        b, v = int(broker[e]), vals[int(row[e])]
        out[b] = out[b] + (v if int(phase[e]) else -v)
    return out


@pytest.mark.parametrize("case", ADVERSARIAL)
def test_apply_deltas_to_agg_matches_on_adversarial_batches(case):
    js, ts, topics = _pair()
    d = _adversarial_batch(case, js.num_brokers, topics)
    want = jagg.apply_deltas_to_agg(
        jagg.compute_agg(js, topics),
        jagg.AggDelta(**{k: jnp.asarray(d[k]) for k in BATCH_KEYS}),
        jnp.asarray(d["sel"]), jnp.asarray(d["pot"]), jnp.asarray(d["lbi"]))
    agg = tagg.compute_agg(ts, topics)
    got = tagg.apply_deltas_to_agg(
        agg, types.SimpleNamespace(**{k: torch.from_numpy(d[k])
                                      for k in BATCH_KEYS}),
        torch.from_numpy(d["sel"]), torch.from_numpy(d["pot"]),
        torch.from_numpy(d["lbi"]))
    _assert_agg_equal(want, got)
    # K4's event order gives the twin's bits.
    model = _k4_event_order(agg, d)
    twin = torch.cat([got.broker_load, got.pot_nw_out[:, None],
                      got.lbi[:, None]], dim=1)
    assert torch.equal(model, twin)


def _with_fields(js, ts, **fields):
    """Both packages' states with the same numpy ``fields`` replaced."""
    return (dataclasses.replace(js, **{k: jnp.asarray(v)
                                       for k, v in fields.items()}),
            dataclasses.replace(ts, **{k: torch.from_numpy(v)
                                       for k, v in fields.items()}))


@pytest.mark.parametrize("case", ["one_broker", "idle_brokers", "pad_slots",
                                  "masked_partitions"])
def test_compute_agg_matches_on_edge_states(case):
    """K1's twin against the reference where its fold has the most to get
    wrong: every replica on one broker (one long serial sum), brokers
    that host nothing, empty slots, and masked partitions."""
    js, ts, topics = _pair()
    rng = np.random.default_rng(21)
    a = np.asarray(js.assignment).copy()
    mask = np.asarray(js.partition_mask).copy()
    if case == "one_broker":
        a[a >= 0] = 2
    elif case == "idle_brokers":
        a[np.isin(a, (1, 5, 6))] = 7
    elif case == "pad_slots":
        a[rng.random(a.shape) < 0.3] = -1
    else:
        mask[rng.random(mask.shape) < 0.3] = False
    js, ts = _with_fields(js, ts, assignment=a, partition_mask=mask)
    want = jagg.compute_agg(js, topics)
    _assert_agg_equal(want, tagg.compute_agg(ts, topics))
    reps = np.asarray(want.broker_replicas)
    if case == "one_broker":
        assert reps[2] == int(((a >= 0) & mask[:, None]).sum())
    elif case == "idle_brokers":
        assert (reps[[1, 5, 6]] == 0).all()


def test_pot_lbi_deltas_match():
    js, ts, topics = _pair()
    d = _batch(js.num_brokers, topics)
    keys = ("partition", "replica_delta", "leader_delta")
    jp, jl = jagg.pot_lbi_deltas(js, types.SimpleNamespace(
        **{k: jnp.asarray(d[k]) for k in keys}))
    tp, tl = tagg.pot_lbi_deltas(ts, types.SimpleNamespace(
        **{k: torch.from_numpy(d[k]) for k in keys}))
    np.testing.assert_array_equal(_np(tp), np.asarray(jp))
    np.testing.assert_array_equal(_np(tl), np.asarray(jl))


@pytest.mark.parametrize("rounds_done", [0, 1, 62, 63, 64, 127, 191])
def test_maybe_refresh_cadence_matches(rounds_done):
    js, ts, topics = _pair()
    d = _batch(js.num_brokers, topics)
    keys = ("src_broker", "dst_broker", "load_delta", "replica_delta",
            "leader_delta", "topic")
    sel = np.ones(len(d["sel"]), bool)
    stale_j = jagg.apply_deltas_to_agg(
        jagg.compute_agg(js, topics),
        jagg.AggDelta(**{k: jnp.asarray(d[k]) for k in keys}),
        jnp.asarray(sel), jnp.asarray(d["pot"]), jnp.asarray(d["lbi"]))
    stale_t = tagg.apply_deltas_to_agg(
        tagg.compute_agg(ts, topics),
        types.SimpleNamespace(**{k: torch.from_numpy(d[k]) for k in keys}),
        torch.from_numpy(sel), torch.from_numpy(d["pot"]),
        torch.from_numpy(d["lbi"]))
    want = jagg.maybe_refresh(stale_j, js, topics, jnp.int32(rounds_done))
    got = tagg.maybe_refresh(stale_t, ts, topics, rounds_done)
    _assert_agg_equal(want, got)
    refreshed = rounds_done % tagg.REFRESH_EVERY == tagg.REFRESH_EVERY - 1
    assert (got is stale_t) != refreshed


def test_compute_derived_and_limits_match():
    js, ts, topics = _pair()
    rm = np.zeros(js.num_brokers, bool)
    rm[[1, 6]] = True
    ld = np.zeros(js.num_brokers, bool)
    ld[4] = True
    tm = np.zeros(js.num_partitions, bool)
    tm[2] = True
    jd = jderived.compute_derived(js, jnp.asarray(tm), jnp.asarray(rm),
                                  jnp.asarray(ld))
    td = tderived.compute_derived(ts, torch.from_numpy(tm),
                                  torch.from_numpy(rm), torch.from_numpy(ld))
    for f in ("broker_load", "broker_replicas", "broker_leaders",
              "pot_nw_out", "alive", "new_brokers", "allowed_replica_move",
              "allowed_leadership", "avg_util", "avg_replicas",
              "avg_leaders", "movable_partition"):
        np.testing.assert_array_equal(_np(getattr(td, f)),
                                      np.asarray(getattr(jd, f)), err_msg=f)
    for r in Resource:
        for a, b in zip(jderived.resource_limits(js, jd, JBC(), r),
                        tderived.resource_limits(ts, td, TBC(), r)):
            np.testing.assert_array_equal(_np(b), np.asarray(a))
    for a, b in zip(jderived.count_limits(jd.avg_replicas, 1.1),
                    tderived.count_limits(td.avg_replicas, 1.1)):
        np.testing.assert_array_equal(_np(b), np.asarray(a))


def test_fma_f32_is_xla_contracted_band_arithmetic():
    """``load - t * cap`` and ``t * cap - load`` in one jitted XLA:CPU
    loop round once (a fused multiply-add); ``fma_f32`` gives those bits,
    which a multiply and a subtract rounded apart do not always give."""
    rng = np.random.default_rng(8)
    load = (rng.random(4096) * 1e4).astype(np.float32)
    cap = (rng.random(4096) * 1e4).astype(np.float32)
    t = np.float32(0.91) * np.float32(rng.random())
    over, under = jax.jit(lambda l, c: (l - t * c, t * c - l))(load, cap)
    tl, tc = torch.from_numpy(load), torch.from_numpy(cap)
    np.testing.assert_array_equal(fma_f32(-t, tc, tl).numpy(), np.asarray(over))
    np.testing.assert_array_equal(fma_f32(t, tc, -tl).numpy(),
                                  np.asarray(under))
    assert (np.asarray(over) != load - t * cap).any()


def test_fma_f32_rounds_once_where_f64_rounds_twice():
    """The exact value lies just above a midpoint of two f32 values, and
    its f64 rounding lands on the midpoint: rounding that to f32 again
    would tie to even, one ulp low."""
    a = torch.tensor(-(2.0 ** -24) * (1 + 2.0 ** -23), dtype=torch.float32)
    b = torch.tensor(1 - 2.0 ** -23, dtype=torch.float32)
    c = torch.tensor(1 + 2.0 ** -23, dtype=torch.float32)
    assert (a.double() * b.double() + c.double()).float().item() == 1.0
    assert fma_f32(a, b, c).item() == c.item()


@pytest.mark.parametrize("n", [9, 15, 16, 19, 24, 32])
def test_violation_reduce_association_matches_jitted_xla(n):
    """A masked band-violation reduce over a strided load column, as the
    reference's resource distribution goals fuse it: XLA:CPU sums it in
    index order up to 15 elements and with 8 vector lanes at the lengths
    of ``VECTOR_SUM_LENGTHS`` (``xla_vector_sum``)."""
    rng = np.random.default_rng(n)
    for _ in range(6):
        load = (rng.random((n + 1, 4))
                * 10.0 ** rng.integers(-3, 5, (n + 1, 1))).astype(np.float32)
        cap = (rng.random((n, 4)) * 1e3).astype(np.float32)
        alive = rng.random(n) < 0.9
        excluded = rng.random(n) < 0.2
        avg = np.float32(rng.random())

        def reduce(load, cap, alive, excluded, avg):
            # alive and not excluded, inside the fusion, as the reference
            up, lo = avg * 1.09, avg * 0.91
            v = jnp.maximum(load[:n, 1] - up * cap[:, 1], 0) \
                + jnp.maximum(lo * cap[:, 1] - load[:n, 1], 0)
            return jnp.where(alive & ~excluded, v, 0.0).sum()

        want = np.asarray(jax.jit(reduce)(load, cap, alive, excluded, avg))
        up = np.float32(avg * np.float32(1.09))
        lo = np.float32(avg * np.float32(0.91))
        tl, tcap = torch.from_numpy(load[:n, 1]), torch.from_numpy(cap[:, 1])
        v = torch.clamp(fma_f32(-up, tcap, tl), min=0) \
            + torch.clamp(fma_f32(lo, tcap, -tl), min=0)
        v = torch.where(torch.from_numpy(alive & ~excluded), v,
                        torch.zeros(()))
        got = xla_vector_sum(v) if n in VECTOR_SUM_LENGTHS else xla_sum(v)
        assert got.numpy() == want
