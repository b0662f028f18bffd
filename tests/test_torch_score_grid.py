"""Kernel K6's twin (``analyzer/score_grid.py``) on the CPU.

Round inputs are recorded from ``chain._chain_round_body`` run on the
``_run_stage`` recipe (numpy seed 42) at 16/512 and 100/10k, one round a
goal with that goal active and every earlier goal of its chain prior: the
default chain (with a DEAD broker, so offline replicas reach the bonus,
and at 16/512 a NEW broker and exclusion masks), the 18-goal chain (with
BrokerSetAwareGoal on seeded sets), the kafka-assigner chain, the
PreferredLeaderElectionGoal alone on DEMOTED brokers and a
MinTopicLeadersPerBrokerGoal with a minimum of one.

- Grid mode: ``score_grid_plain`` equals the round body's scoring as it
  was written before K6 (``generate_candidates``, the block flags,
  ``compute_deltas``, the goal loop, the offline bonus), bit for bit.
- Against JAX: the same candidates go through the JAX package's
  ``compute_deltas``, every prior goal's ``acceptance`` and the active
  goal's ``improvement``, jitted on the CPU as the reference's round body
  is. Integers and bools are exact; the f32 deltas and scores bitwise.
- Recheck mode: the same on the round's selected batch with its pre-deltas
  and ``has_earlier``.
- The goal table packs every one of the 14 families, and a table beyond
  ``MAX_GOALS`` raises ``kernels.limit_error``.
- K6's row functions compiled as host C++ (``csrc/score_grid.cu`` without
  ``__CUDACC__``, where the compiler is present) equal the twin bit for bit
  on every recorded round, in both modes. In grid mode they run as the
  kernels do: the destination panel, then the move block's source groups
  staged (the targeted column read where it lies), then the leadership
  rows; each recorded grid also runs without its targeted column and with
  an odd number of destinations. The recorded grids cover every goal
  family, sources whose ``src_valid`` is false and both block flags.
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

from cruise_control_tpu.analyzer import candidates as jc
from cruise_control_tpu.analyzer import derived as jderived
from cruise_control_tpu.analyzer import goals as jgoals
from cruise_control_tpu.analyzer import search as jsearch
from cruise_control_tpu.analyzer.constraint import BalancingConstraint as JBC
from cruise_control_tpu.config.cruise_control_config import DEFAULT_GOALS
from cruise_control_tpu.model import tensors as jt
from cruise_control_tpu.model.fixtures import Dist as JDist
from cruise_control_tpu.model.fixtures import random_cluster as j_random_cluster
from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer import agg as tagg
from cruise_control_tpu_torch.analyzer import candidates as tc
from cruise_control_tpu_torch.analyzer import chain as tchain
from cruise_control_tpu_torch.analyzer import score_grid as sg
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals import ALL_GOALS
from cruise_control_tpu_torch.analyzer.goals.base import Family
from cruise_control_tpu_torch.analyzer.search import (
    _OFFLINE_BONUS, ExclusionMasks, SearchConfig,
)
from cruise_control_tpu_torch.common.broker_state import BrokerState
from cruise_control_tpu_torch.model import tensors as tt
from cruise_control_tpu_torch.model.fixtures import Dist, random_cluster
from tests.torch_support import one_torch_thread  # noqa: F401  (autouse)

SIZES = {
    "16_512": dict(num_brokers=16, num_topics=8, num_partitions=512, rf=3,
                   num_racks=8, seed=42, skew_to_first=2.0,
                   target_utilization=0.55),
    "100_10k": dict(num_brokers=100, num_topics=10, num_partitions=10_000,
                    rf=3, num_racks=8, seed=42, skew_to_first=2.0,
                    target_utilization=0.55),
}
CFG = {"16_512": SearchConfig(num_sources=64, num_dests=16,
                              moves_per_round=32),
       "100_10k": SearchConfig(num_sources=256, num_dests=32,
                               moves_per_round=64)}
DEFAULT = tuple(g.rsplit(".", 1)[-1] for g in DEFAULT_GOALS)
SETS16 = tuple(b % 3 for b in range(16))
# (chain name, size): goals as (name, constructor overrides), broker
# states, the brokers excluded for replica moves and for leadership.
CASES = {
    "default-16_512": ("16_512", [(g, {}) for g in DEFAULT],
                       {14: BrokerState.DEAD, 15: BrokerState.NEW},
                       ((3,), (4,))),
    "default-100_10k": ("100_10k", [(g, {}) for g in DEFAULT],
                        {98: BrokerState.DEAD}, None),
    "extra18-16_512": ("16_512", [
        ("RackAwareDistributionGoal", {}),
        ("BrokerSetAwareGoal", {"broker_sets": SETS16}),
        ("MinTopicLeadersPerBrokerGoal", {})]
        + [(g, {}) for g in DEFAULT], {14: BrokerState.DEAD}, None),
    "kafka-16_512": ("16_512", [("KafkaAssignerEvenRackAwareGoal", {}),
                                ("KafkaAssignerDiskUsageDistributionGoal",
                                 {})], {14: BrokerState.DEAD}, None),
    "demote-16_512": ("16_512", [("PreferredLeaderElectionGoal", {})],
                      {12: BrokerState.DEMOTED, 13: BrokerState.DEMOTED},
                      ((), (12, 13))),
    "min_leaders-16_512": ("16_512", [
        ("LeaderReplicaDistributionGoal", {}),
        ("MinTopicLeadersPerBrokerGoal", {"min_leaders": 1}),
        ("LeaderBytesInDistributionGoal", {})], {}, None),
}


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_bitwise(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(_bits(got), _bits(want)), what


def _exclusions(b, excluded):
    """(replica-move, leadership) numpy masks, or None."""
    if excluded is None:
        return None
    masks = []
    for brokers in excluded:
        mask = np.zeros(b, dtype=bool)
        mask[list(brokers)] = True
        masks.append(mask)
    return masks


@functools.lru_cache(maxsize=None)
def _recorded(case):
    """(state, masks, goals, rounds): each goal's round inputs of K6's two
    modes (the wrappers' arguments), recorded from the round body."""
    size, chain, states, excluded = CASES[case]
    state, meta = random_cluster(**SIZES[size], dist=Dist.EXPONENTIAL,
                                 device="cpu")
    for b, code in states.items():
        state = tt.set_broker_state(state, torch.tensor(b), code)
    ex = _exclusions(state.num_brokers, excluded)
    masks = ExclusionMasks() if ex is None else ExclusionMasks.from_numpy(
        "cpu", excluded_replica_move_brokers=ex[0],
        excluded_leadership_brokers=ex[1])
    goals = tuple(ALL_GOALS[name](**kw) for name, kw in chain)
    rounds = []
    orig_grid, orig_recheck = tchain.score_grid, tchain.recheck
    try:
        for active in range(len(goals)):
            rec = {}

            def grid(*args, _rec=rec):
                _rec["grid"] = args
                return orig_grid(*args)

            def recheck(*args, _rec=rec):
                _rec["recheck"] = args
                return orig_recheck(*args)

            tchain.score_grid, tchain.recheck = grid, recheck
            prior = [j < active for j in range(len(goals))]
            agg = tagg.compute_agg(state, meta.num_topics)
            tchain._chain_round_body(state, agg, active, prior, goals,
                                     BalancingConstraint(), CFG[size],
                                     meta.num_topics, masks)
            rounds.append(rec)
    finally:
        tchain.score_grid, tchain.recheck = orig_grid, orig_recheck
    return state, meta.num_topics, goals, rounds


def _old_round_scoring(args):
    """The round body's scoring as written before K6 (chain.py), from the
    recorded grid-mode arguments."""
    (state, derived, constraint, goals, aux_list, active, prior, off, spec,
     move_ok, lead_ok, _num_topics, _table) = args
    dev = state.device
    cand = tc.expand_grid(spec)
    (r0, c0), (r1, c1) = spec.layout
    block_ok = torch.cat([
        torch.full((r0 * c0,), move_ok, dtype=torch.bool, device=dev),
        torch.full((r1 * c1,), lead_ok, dtype=torch.bool, device=dev)])
    cand = dataclasses.replace(cand, valid=cand.valid & block_ok)
    deltas = tc.compute_deltas(state, derived, cand)
    accept = deltas.valid
    for i, g in enumerate(goals):
        if prior[i]:
            accept = accept & g.acceptance(state, derived, constraint,
                                           aux_list[i], deltas)
    moving_offline = off[deltas.partition.long(), deltas.src_slot.long()] \
        & (deltas.replica_delta > 0)
    imp = goals[active].improvement(state, derived, constraint,
                                    aux_list[active], deltas) \
        .to(torch.float32)
    imp = torch.where(moving_offline & torch.isfinite(imp) & deltas.valid,
                      torch.clamp(imp, min=0.0) + _OFFLINE_BONUS, imp)
    score = torch.where(accept, imp,
                        torch.full((), float("-inf"), device=dev))
    return cand, deltas, accept, score


def _twin(args):
    return sg.score_grid_plain(*args[:11])


def _delta_fields(d):
    return {f.name: getattr(d, f.name) for f in dataclasses.fields(d)
            if getattr(d, f.name) is not None}


@pytest.mark.parametrize("case", sorted(CASES))
def test_grid_twin_equals_the_round_body_scoring(case):
    _state, _topics, goals, rounds = _recorded(case)
    for active, rec in enumerate(rounds):
        what = f"{case} {goals[active].name}"
        cand, deltas, accept, score = _old_round_scoring(rec["grid"])
        got_d, kind, got_a, got_s = _twin(rec["grid"])
        for name, want in _delta_fields(deltas).items():
            _assert_bitwise(getattr(got_d, name), want, f"{what} {name}")
        _assert_bitwise(kind, cand.kind, f"{what} kind")
        _assert_bitwise(got_a, accept, f"{what} accept")
        _assert_bitwise(got_s, score, f"{what} score")
        assert not torch.isnan(got_s).any(), what
    # The grids reach what the comparison is about.
    scores = torch.cat([_twin(r["grid"])[3] for r in rounds])
    assert torch.isfinite(scores).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_recheck_twin_equals_the_round_body_closure(case):
    _state, _topics, goals, rounds = _recorded(case)
    for active, rec in enumerate(rounds):
        (state, derived, constraint, _goals, aux_list, act, prior, sub,
         has_earlier, _n, _t) = rec["recheck"]
        want = torch.ones(sub.valid.shape[0], dtype=torch.bool)
        for i, g in enumerate(goals):
            if prior[i] or i == act:
                g_acc = g.acceptance(state, derived, constraint, aux_list[i],
                                     sub)
                if prior[i]:
                    want = want & g_acc
                if i == act:
                    want = want & ((~has_earlier) | g_acc)
        got = sg.recheck_plain(*rec["recheck"][:9])
        _assert_bitwise(got, want, f"{case} {goals[active].name}")
        assert sub.pre_src_load is not None


@functools.lru_cache(maxsize=None)
def _jax_world(case):
    size, chain, states, excluded = CASES[case]
    js, jm = j_random_cluster(**SIZES[size], dist=JDist.EXPONENTIAL)
    for b, code in states.items():
        js = jt.set_broker_state(js, jnp.asarray(b), code)
    ex = _exclusions(js.num_brokers, excluded)
    jd = jderived.compute_derived(js) if ex is None else \
        jderived.compute_derived(js, None, jnp.asarray(ex[0]),
                                 jnp.asarray(ex[1]))
    goals = tuple(jgoals.ALL_GOALS[name](**kw) for name, kw in chain)
    return js, jd, goals, jm.num_topics


def _jax_deltas(rows: dict):
    return jc.CandidateDeltas(**{k: jnp.asarray(v.numpy())
                                 for k, v in rows.items()})


def _jax_scoring(js, jd, goals, jaux, active, prior, off, cand):
    """The reference's round-body scoring (chain.py:272-295), jitted."""
    jbc = JBC()

    @jax.jit
    def run(js, jd, jaux, off, cand):
        deltas = jc.compute_deltas(js, jd, cand)
        accept = deltas.valid
        for i, g in enumerate(goals):
            if prior[i]:
                accept &= g.acceptance(js, jd, jbc, jaux[i], deltas)
        moving_offline = off[deltas.partition, deltas.src_slot] \
            & (deltas.replica_delta > 0)
        imp = goals[active].improvement(js, jd, jbc, jaux[active],
                                        deltas).astype(jnp.float32)
        imp = jnp.where(moving_offline & jnp.isfinite(imp) & deltas.valid,
                        jnp.maximum(imp, 0.0) + 1e12, imp)
        return deltas, accept, jnp.where(accept, imp, -jnp.inf)

    return run(js, jd, jaux, off, cand)


def _jax_aux(js, jd, goals, active, prior, topics):
    return [jsearch.goal_aux(g, js, jd, JBC(), topics)
            if (prior[i] or i == active) else None
            for i, g in enumerate(goals)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_grid_and_recheck_match_jax(case):
    _state, _topics, goals, rounds = _recorded(case)
    js, jd, jgoal_objs, topics = _jax_world(case)
    for active, rec in enumerate(rounds):
        what = f"{case} {goals[active].name}"
        args = rec["grid"]
        prior = tuple(bool(p) for p in args[6])
        cand = tc.expand_grid(args[8])
        (r0, c0), (r1, c1) = args[8].layout
        block_ok = torch.cat([torch.full((r0 * c0,), args[9]),
                              torch.full((r1 * c1,), args[10])])
        jcand = jc.Candidates(**{
            f.name: jnp.asarray(getattr(cand, f.name).numpy())
            for f in dataclasses.fields(cand)})
        jcand = dataclasses.replace(
            jcand, valid=jcand.valid & jnp.asarray(block_ok.numpy()))
        jaux = _jax_aux(js, jd, jgoal_objs, active, prior, topics)
        jdel, jacc, jscore = _jax_scoring(
            js, jd, jgoal_objs, jaux, active, prior,
            jnp.asarray(args[7].numpy()), jcand)
        got_d, _kind, got_a, got_s = _twin(args)
        for name, got in _delta_fields(got_d).items():
            want = torch.from_numpy(np.array(getattr(jdel, name)))
            _assert_bitwise(got, want.to(got.dtype), f"{what} {name}")
        _assert_bitwise(got_a, torch.from_numpy(np.array(jacc)),
                        f"{what} accept")
        _assert_bitwise(got_s, torch.from_numpy(np.array(jscore)),
                        f"{what} score")

        (_s, _d, _c, _g, _a, act, rprior, sub, has_earlier, _n,
         _t) = rec["recheck"]
        jsub = _jax_deltas(_delta_fields(sub))
        he = jnp.asarray(has_earlier.numpy())

        @jax.jit
        def jax_recheck(jaux, jsub, he):
            a = jnp.ones(jsub.valid.shape[0], dtype=bool)
            for i, g in enumerate(jgoal_objs):
                if rprior[i] or i == act:
                    g_acc = g.acceptance(js, jd, JBC(), jaux[i], jsub)
                    if rprior[i]:
                        a &= g_acc
                    if i == act:
                        a &= (~he) | g_acc
            return a

        _assert_bitwise(sg.recheck_plain(*rec["recheck"][:9]),
                        torch.from_numpy(np.array(jax_recheck(jaux, jsub,
                                                                he))),
                        f"{what} recheck")


def test_goal_table_packs_every_family():
    state, topics, _goals, rounds = _recorded("default-16_512")
    (state, derived, constraint, _g, _aux, _a, _p, off, spec, move_ok,
     lead_ok, _n, _t) = rounds[0]["grid"]
    sets = tuple(b % 3 for b in range(state.num_brokers))
    overrides = {"BrokerSetAwareGoal": {"broker_sets": sets},
                 "MinTopicLeadersPerBrokerGoal": {"min_leaders": 1}}
    goals = tuple(cls(**overrides.get(name, {}))
                  for name, cls in ALL_GOALS.items())
    active = len(goals) - 1
    prior = [i < active for i in range(len(goals))]
    aux_list = tchain._aux_list(goals, active, prior, state, derived,
                                constraint, topics, None)
    table = sg.goal_table(goals, aux_list, active, prior, state, derived,
                          constraint)
    assert {a.family for a in table.args} == set(Family)
    assert table.active == active and table.prior == tuple(prior)
    q, _outs, _keep = sg.grid_params(state, derived, off, spec, move_ok,
                                     lead_ok, table, topics)
    assert q.n_goals == len(goals) and q.active == active
    assert q.prior_mask == (1 << active) - 1
    for j, a in enumerate(table.args):
        desc = q.goals[j]
        assert desc.family == int(a.family)
        assert desc.resource == a.resource and desc.ival == a.ival
        assert [desc.p[k] for k in range(len(a.arrays))] \
            == [t.data_ptr() for t in a.arrays]
        assert all(not desc.p[k] for k in range(len(a.arrays), 4))
    assert ctypes.sizeof(sg.GridParams) < 4096


def test_goal_table_beyond_its_limit_raises():
    state, topics, goals, rounds = _recorded("default-16_512")
    (state, derived, constraint, *_rest) = rounds[0]["grid"]
    many = tuple(goals) * 2
    active = sg.MAX_GOALS
    prior = [i < active for i in range(len(many))]
    aux_list = tchain._aux_list(many, active, prior, state, derived,
                                constraint, topics, None)
    with pytest.raises(ValueError, match="score_grid kernel: a goal table "
                       f"of {sg.MAX_GOALS + 1} goals"):
        sg.goal_table(many, aux_list, active, prior, state, derived,
                      constraint)
    assert len(sg.goal_table(many, aux_list, active - 1, prior[:active - 1]
                             + [False] * (len(many) - active + 1), state,
                             derived, constraint).args) == sg.MAX_GOALS


@functools.lru_cache(maxsize=1)
def _host_library(tmp_dir):
    out = f"{tmp_dir}/libscore_grid_host.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-x", "c++",
                    str(kernels.CSRC / "score_grid.cu"), "-o", out],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(out)
    lib.cc_score_grid_host.argtypes = [ctypes.c_void_p]
    lib.cc_score_grid_params_bytes.restype = ctypes.c_longlong
    return lib


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_rows_built_for_the_host_equal_the_twin(case,
                                                       tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler")
    lib = _host_library(str(tmp_path_factory.getbasetemp()))
    assert lib.cc_score_grid_params_bytes() == ctypes.sizeof(sg.GridParams)
    _state, topics, goals, rounds = _recorded(case)
    for active, rec in enumerate(rounds):
        (state, derived, constraint, gl, aux_list, act, prior, off, spec,
         move_ok, lead_ok, _n, _t) = rec["grid"]
        table = sg.goal_table(gl, aux_list, act, prior, state, derived,
                              constraint)
        for label, variant in _grid_variants(spec):
            what = f"{case} {goals[active].name}, {label}"
            args = rec["grid"][:8] + (variant,) + rec["grid"][9:]
            q, outs, _keep = sg.grid_params(state, derived, off, variant,
                                            move_ok, lead_ok, table, topics)
            assert lib.cc_score_grid_host(ctypes.byref(q)) == 0
            got_d, kind, got_a, got_s = outs
            want_d, want_kind, want_a, want_s = _twin(args)
            for name, want in _delta_fields(want_d).items():
                _assert_bitwise(getattr(got_d, name), want, f"{what} {name}")
            _assert_bitwise(kind, want_kind, f"{what} kind")
            _assert_bitwise(got_a, want_a, f"{what} accept")
            _assert_bitwise(got_s, want_s, f"{what} score")

        sub, has_earlier = rec["recheck"][7:9]
        sub = dataclasses.replace(sub, **{
            k: v.contiguous() for k, v in _delta_fields(sub).items()})
        q, ok = sg.recheck_params(state, derived, sub, has_earlier, table,
                                  topics)
        assert lib.cc_score_grid_host(ctypes.byref(q)) == 0
        _assert_bitwise(ok, sg.recheck_plain(*rec["recheck"][:9]),
                        f"{case} {goals[active].name} recheck")


def test_host_kernel_cases_cover_every_family_and_flag():
    """The recorded grids the host build runs on hold every goal family
    (active or prior), a targeted column, sources whose ``src_valid`` is
    false, and each block flag both ways."""
    seen = set()
    for case in CASES:
        _state, _topics, goals, rounds = _recorded(case)
        for active, rec in enumerate(rounds):
            spec, move_ok, lead_ok = rec["grid"][8:11]
            seen |= {goals[i].score_args(*rec["grid"][:3],
                                         rec["grid"][4][i]).family
                     for i in range(len(goals))
                     if rec["grid"][6][i] or i == active}
            seen |= {f"move_ok {move_ok}", f"lead_ok {lead_ok}"}
            if spec.t_dst is not None:
                seen.add("targeted column")
            if not bool(spec.src_valid.all()):
                seen.add("src_valid false")
    assert set(Family) <= seen
    assert {"targeted column", "src_valid false", "move_ok True",
            "move_ok False", "lead_ok True", "lead_ok False"} <= seen


def _grid_variants(spec):
    """The recorded grid, the same grid without its targeted column
    (extra 0) and with an odd number of destination columns."""
    yield "recorded", spec
    if spec.t_dst is not None:
        yield "no targeted column", dataclasses.replace(spec, t_dst=None,
                                                        t_ok=None)
    k = spec.dst_idx.shape[0]
    odd = k - 1 if k % 2 == 0 else k - 2
    if odd > 0:
        yield f"{odd} destinations", dataclasses.replace(
            spec, dst_idx=spec.dst_idx[:odd].contiguous(),
            dst_val=spec.dst_val[:odd].contiguous())
