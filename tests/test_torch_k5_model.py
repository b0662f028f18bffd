"""K5's balancer (``csrc/intra_broker.cu``) as a numpy model of its
algorithm, against the plain twin (``model/disks.py``'s
``balance_intra_broker`` on the CPU) and the JAX reference, bit for bit.

The kernel runs each broker's loop apart and repairs the sentinel
collision afterwards (``tests/test_torch_disks.py`` models that part). It
keeps, for every slot, its disk's fold over the slots before it, and after
a move refolds only the two disks that changed, from the moved slot on: the
source from the moved slot's prefix over its own later slots, the
destination from its prefix at the moved slot (the prefix of its first
later slot, or its whole fold when none follows). The shed pressure runs
one lane a disk, every operation rounded alone, the mean's sum in disk
order; the pick is the heaviest movable replica on the source disk, lowest
flat index first. The model does the same in float32 and, after every
move, checks each disk's fold and every slot's prefix against a fold from
scratch, so the incremental refold is shown equal to the reference's
segment sum round by round. It runs on the sentinel cases, the small
random cases, the JBOD fixtures and K5's edge cases
(``testing.k5_edge_case``), and its final per-disk loads equal the twin's
``disk_load`` of the final assignment (K5's ``out_load``).
"""

import numpy as np
import pytest

from cruise_control_tpu_torch.model import disks as td
from cruise_control_tpu_torch.model.tensors import cluster_from_numpy
from cruise_control_tpu_torch.testing import (
    K5_EDGE_CASES, SENTINEL_CASES, disk_cluster_arrays, k5_edge_case,
    random_disk_case, sentinel_case,
)
from tests.test_torch_disks import _balance_both, _jbod, _movable, _same
from tests.torch_support import one_torch_thread  # noqa: F401  (autouse)

INT32_MAX = 2 ** 31 - 1
F32 = np.float32


def _fold(ld, dsk, d):
    """(each slot's prefix on disk d before it, the fold) from scratch."""
    acc, pre = F32(0.0), {}
    for j in range(len(dsk)):
        if dsk[j] == d:
            pre[j] = acc
            acc = F32(acc + ld[j])
    return pre, acc


def _pick_disks(loads, cap, alive, threshold, upper):
    """Warp 0's shed pressure and first-index argmax / argmin."""
    present = cap > 0
    al = present & alive
    dead = present & ~alive
    over = np.maximum(loads - cap * F32(threshold), F32(0.0))
    v = np.where(present, over, F32(0.0)) + np.where(dead, loads, F32(0.0))
    util = np.where(present, loads / np.maximum(cap, F32(1e-9)), F32(0.0))
    if upper is not None:
        total = F32(0.0)
        for d in range(cap.shape[0]):
            total = F32(total + F32(util[d] * F32(1.0 if al[d] else 0.0)))
        avg = F32(total / F32(max(int(al.sum()), 1)))
        bar = F32(avg * F32(upper))
        above = np.maximum(util - bar, F32(0.0))
        v = v + np.where(al, above * cap, F32(0.0))
    src = int(np.argmax(v))
    dst = int(np.argmin(np.where(al, util, F32(np.inf))))
    return src, dst, bool(v[src] > F32(1e-9)) and bool(al[dst]) \
        and dst != src


def k5_model(cl, dk, movable, band, threshold=0.8, max_rounds=64):
    """(final disk assignment, final per-disk loads [B, D], rounds a
    broker) of K5's algorithm."""
    assign = cl["assignment"]
    p, s = assign.shape
    b = cl["capacity"].shape[0]
    lead = np.arange(s)[None, :] == cl["leader_slot"][:, None]
    load = np.where(lead, cl["leader_load"][:, 3:4],
                    cl["follower_load"][:, 3:4]).astype(F32)
    da0 = dk["disk_assignment"]
    cap = dk["disk_capacity"].astype(F32)
    alive = dk["disk_alive"].astype(bool)
    n_disks = cap.shape[1]
    mov = np.ones(p, bool) if movable is None else movable
    upper = None if band is None else band[1]
    out = da0.copy()
    out_load = np.zeros((b, n_disks), F32)
    rounds = np.zeros(b, np.int64)
    exists = (assign >= 0) & cl["partition_mask"][:, None]
    slots = {k: [] for k in range(b)}
    for i in np.flatnonzero(exists.ravel()):
        slots[int(assign.flat[i])].append(int(i))
    nopick = {}

    def run(k, blocks):
        sl = slots[k]
        n = len(sl)
        dsk = [int(da0.flat[i]) for i in sl]
        ld = [F32(load.flat[i]) for i in sl]
        pre = [F32(0.0)] * n
        loads = np.zeros(n_disks, F32)
        for d in range(n_disks):
            got, loads[d] = _fold(ld, dsk, d)
            for j, v in got.items():
                pre[j] = v
        first = (INT32_MAX, 0)
        r = 0
        while r < max_rounds:
            src, dst, ok = _pick_disks(loads, cap[k], alive[k], threshold,
                                       upper)
            on = [j for j in range(n) if dsk[j] == src]
            cand = [j for j in on if mov[sl[j] // s]]
            pick = None
            if cand:
                best = max(ld[j] for j in cand)
                pick = min(j for j in cand if ld[j] == best)
                if not best >= 0:
                    pick = None
            r += 1
            if not on:
                first = (r - 1, 2)
                break
            if pick is None:
                first = (r - 1, 1)
                break
            if not ok or any(sl[pick] == f and r - 1 >= br
                             for f, br in blocks):
                break
            from_src = pre[pick]
            dsk[pick] = dst
            # The source without the moved slot, from its prefix on.
            acc = from_src
            for j in range(pick + 1, n):
                if dsk[j] == src:
                    pre[j] = acc
                    acc = F32(acc + ld[j])
            loads[src] = acc
            # The destination with it, from its prefix at the moved slot.
            later = [j for j in range(pick + 1, n) if dsk[j] == dst]
            at = pre[later[0]] if later else loads[dst]
            pre[pick] = at
            acc = F32(at + ld[pick])
            for j in later:
                pre[j] = acc
                acc = F32(acc + ld[j])
            loads[dst] = acc
            for d in (src, dst):
                got, total = _fold(ld, dsk, d)
                assert total.view(np.int32) == loads[d].view(np.int32)
                assert all(pre[j].view(np.int32) == v.view(np.int32)
                           for j, v in got.items())
        for i, d in zip(sl, dsk):
            out.flat[i] = d
        out_load[k] = loads
        rounds[k] = r
        nopick[k] = first

    for k in range(b):
        run(k, [])
    flat_pin, flat_empty = td.sentinel_slots(p, s)
    flats = (flat_pin, flat_empty)
    owners = [int(assign.flat[f]) if exists.flat[f] and da0.flat[f] >= 0
              else -1 for f in flats]
    for o in sorted({x for x in owners if x >= 0}, reverse=True):
        blocks = []
        for kind, f in ((1, flat_pin), (2, flat_empty)):
            if owners[kind - 1] != o or (kind == 2 and flat_empty == flat_pin):
                continue
            firsts = [nopick[k][0] for k in range(o + 1, b)
                      if nopick[k][1] and flats[nopick[k][1] - 1] == f]
            if firsts:
                blocks.append((f, min(firsts)))
        if blocks:
            run(o, blocks)
    return out, out_load, rounds


def _hold(cl, dk, movable, band, what):
    """The model against the twin and JAX: the assignment, and its final
    loads against the twin's ``disk_load`` of the twin's assignment."""
    want_jax, want = _balance_both(cl, dk, movable, band)
    got, got_load, rounds = k5_model(cl, dk, movable, band)
    _same(want_jax, want, f"{what}: twin vs JAX")
    _same(got, want, f"{what}: model vs twin")
    state = cluster_from_numpy(cl, "cpu")
    final = td.disks_from_numpy(dict(dk, disk_assignment=want), "cpu")
    _same(got_load, td.disk_load(state, final), f"{what}: loads")
    return got, rounds


def test_model_on_sentinel_cases():
    for case in SENTINEL_CASES:
        _hold(*sentinel_case(case), case)


@pytest.mark.parametrize("part", [0, 1])
def test_model_on_random_cases(part):
    """The 16 small random cases of ``tests/test_torch_disks.py`` (both
    sentinel kinds, dead and unused dirs, pinned partitions)."""
    for seed in range(8 * part, 8 * part + 8):
        _hold(*random_disk_case(seed, num_brokers=4 + seed % 5,
                                num_partitions=10 + seed % 20,
                                rf=1 + seed % 3, num_disks=2 + seed % 3),
              f"seed {seed}")


@pytest.mark.parametrize("num_disks,seed,dead,pinned", [
    (2, 0, 0.0, 0.0), (3, 1, 0.1, 0.2), (4, 2, 0.2, 0.0), (8, 3, 0.1, 0.3)])
def test_model_on_jbod_fixtures(num_disks, seed, dead, pinned):
    """20 brokers / 600 partitions; some brokers run many rounds."""
    cl, dk = _jbod(num_disks, seed, dead)
    movable = _movable(cl["assignment"].shape[0], pinned, seed)
    for band in (None, (0.91, 1.09)):
        got, rounds = _hold(cl, dk, movable, band,
                            f"D={num_disks} band={band}")
        assert (got != dk["disk_assignment"]).any() and rounds.max() > 2


def test_model_refolds_from_the_moved_slot():
    """One broker, 40 replicas of loads spread over five decades on two
    dirs, most on the first: the moves land before, between and after the
    other disk's slots, and each round's refold starts at the moved slot
    (the model checks each against a fold from scratch)."""
    rng = np.random.default_rng(5)
    p = 40
    cl = disk_cluster_arrays(np.zeros((p, 1), np.int32),
                             rng.exponential(10.0, p)
                             * 10.0 ** rng.integers(-2, 3, p), 1)
    dk = {"disk_assignment": (rng.random((p, 1)) < 0.2).astype(np.int32),
          "disk_capacity": np.array([[400.0, 900.0]], np.float32),
          "disk_alive": np.ones((1, 2), bool)}
    for band in (None, (0.95, 1.05)):
        got, rounds = _hold(cl, dk, None, band, f"band={band}")
        assert rounds[0] > 3 and (got != dk["disk_assignment"]).sum() >= 3


@pytest.mark.parametrize("name", K5_EDGE_CASES)
def test_model_on_edge_cases(name):
    """A broker at exactly 8,192 replicas, 32 dirs, brokers that run all
    64 rounds, and an active fix-up (broker 0 rerun with its move of the
    last partition frozen from round 5, where broker 3 runs out of
    replicas on its source dir)."""
    cl, dk, movable, band = k5_edge_case(name)
    got, rounds = _hold(cl, dk, movable, band, name)
    if name == "broker_at_limit":
        assert (cl["assignment"] == 0).sum() == td.INTRA_BROKER_MAX_REPLICAS
    if name == "d32":
        assert dk["disk_capacity"].shape[1] == td.INTRA_BROKER_MAX_DISKS
    if name == "all_64_rounds":
        assert (rounds == 64).all()
    if name == "fixup_64":
        assert list(rounds) == [8, 64, 64, 6]
        assert ((got != dk["disk_assignment"])[:, 0]
                & (cl["assignment"][:, 0] == 0)).sum() == 7
