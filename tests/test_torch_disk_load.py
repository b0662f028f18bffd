"""K5's load mode (``model/disks.py::disk_load`` on the card,
``csrc/intra_broker.cu`` ``cc_intra_broker_load``) modelled in numpy and
held bit for bit against the plain twin (``_disk_load_plain``) and the JAX
package's ``disk_load`` on the CPU.

The model follows the kernel's steps: buckets of consecutive brokers (at
most 256), per-tile bucket counts and their scan, each tile's slots sorted
stably by bucket chunk by chunk (a slot ranked among its bucket's slots of
the chunk by index) and written as its buckets' runs, then per bucket its
entries in chunks sorted stably by broker and each broker's loads added per
disk onto running sums, serially in f32. Cases: D = 1, 2, 4, 8 and 32 with padded
partitions, slots with disk -1 and dead dirs; tiles split mid-bucket
(tiles of 64 slots) and the kernel's own tiles; the bucket plan at 1,000,
3,000, 7,000, 20,000 and 2**20 brokers; a broker
hosting more than 8,192 replicas (the balancer's limit, not the load
mode's). The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.model import disks as jd
from cruise_control_tpu.model.tensors import ClusterTensors as JCT
from cruise_control_tpu_torch.model import disks as td
from cruise_control_tpu_torch.model.tensors import cluster_from_numpy
from cruise_control_tpu_torch.testing import (
    crowded_broker_case, disk_cluster_arrays,
)
from tests.torch_support import one_torch_thread  # noqa: F401  (autouse)

# csrc/intra_broker.cu, load mode.
MAX_BUCKETS, TILE, CHUNK = 256, 8192, 1024


def load_plan(n: int, b: int) -> tuple[int, int, int]:
    """(bucket width, buckets, tiles) as the kernel's ``load_plan`` picks
    them: the width a power of two."""
    width = 1
    while MAX_BUCKETS * width < b:
        width *= 2
    return width, -(-b // width), -(-n // TILE)


def _stable_by(keys: np.ndarray) -> np.ndarray:
    """The kernel's ranking of one chunk: each item's place among its
    key's items by index (``rank_in_chunk``), runs in key order."""
    order = []
    for k in np.unique(keys[keys >= 0]):
        order.extend(np.flatnonzero(keys == k).tolist())
    return np.asarray(order, np.int64)


def k5_load_model(cl: dict, dk: dict, tile: int = TILE):
    """[B, D] f32 by the load mode's algorithm (``tile`` overrides the
    kernel's pass-1 tile)."""
    assign, pmask = cl["assignment"], cl["partition_mask"]
    p, s = assign.shape
    b, d = dk["disk_capacity"].shape
    n = p * s
    width, buckets, _tiles = load_plan(n, b)
    tiles = -(-n // tile)
    flat_b = assign.reshape(-1).astype(np.int64)
    ok = (flat_b >= 0) & (flat_b < b) & np.repeat(pmask, s)
    key = np.where(ok, flat_b, -1)
    disk = dk["disk_assignment"].reshape(-1)
    disk = np.where((disk >= 0) & (disk < d), disk, -1)
    lead = np.arange(s)[None, :] == cl["leader_slot"][:, None]
    load = np.where(lead, cl["leader_load"][:, 3:4],
                    cl["follower_load"][:, 3:4]).astype(np.float32).ravel()
    bucket = np.where(key >= 0, key // width, -1)
    # 1. count, 2. scan: each tile's first position in each bucket
    table = np.zeros((tiles, buckets), np.int64)
    for t in range(tiles):
        ks = bucket[t * tile:(t + 1) * tile]
        table[t] = np.bincount(ks[ks >= 0], minlength=buckets)
    total = table.sum(0)
    base = np.cumsum(total) - total
    start = base + np.cumsum(table, 0) - table
    # 3. scatter: each tile sorted stably by bucket chunk by chunk (each
    # chunk's slots appended to their bucket's run), the runs written out
    entries = np.full(int(total.sum()), -1, np.int64)   # slot of a place
    for t in range(tiles):
        lo, hi = t * tile, min(n, (t + 1) * tile)
        runs = {k: [] for k in range(buckets)}
        for c0 in range(lo, hi, CHUNK):
            i = np.arange(c0, min(hi, c0 + CHUNK))
            for j in _stable_by(bucket[i]):
                runs[int(bucket[i[j]])].append(int(i[j]))
        for k, run in runs.items():
            entries[start[t, k]:start[t, k] + len(run)] = run
    # 4. fold: per bucket, chunks (of 4,096 entries at 32 brokers a
    # bucket, 2,048 at 16, else 1,024) sorted stably by broker, each
    # broker's run added per disk onto its running sums, serially in f32
    out = np.zeros((b, d), np.float32)
    fold_chunk = CHUNK * (4 if width == 32 else 2 if width == 16 else 1)
    for k in range(buckets):
        mine = entries[base[k]:base[k] + total[k]]
        for c0 in range(0, len(mine), fold_chunk):
            chunk = mine[c0:c0 + fold_chunk]
            for j in _stable_by(key[chunk]):
                slot = chunk[j]
                if disk[slot] >= 0:
                    out[key[slot], disk[slot]] = np.float32(
                        out[key[slot], disk[slot]] + load[slot])
    return out


def _case(num_brokers, num_partitions, rf, num_disks, seed,
          pad_frac=0.1, dead_frac=0.1, none_frac=0.1):
    """A seeded cluster and disks: padded partitions, empty slots, slots
    without a disk (-1) and dead dirs."""
    rng = np.random.default_rng(seed)
    assign = np.full((num_partitions, rf), -1, np.int32)
    for p in range(num_partitions):
        k = int(rng.integers(1, rf + 1))
        assign[p, :k] = rng.integers(0, num_brokers, k)
    cl = disk_cluster_arrays(assign, rng.exponential(100.0, num_partitions),
                             num_brokers)
    cl["partition_mask"] = rng.random(num_partitions) >= pad_frac
    cl["leader_slot"] = rng.integers(0, rf, num_partitions).astype(np.int32)
    cl["follower_load"][:, 3] *= np.float32(0.75)
    disk = rng.integers(0, num_disks, assign.shape)
    disk[rng.random(assign.shape) < none_frac] = -1
    disk[assign < 0] = -1
    cap = rng.uniform(100.0, 600.0, (num_brokers, num_disks))
    return cl, {"disk_assignment": disk.astype(np.int32),
                "disk_capacity": cap.astype(np.float32),
                "disk_alive": rng.random(cap.shape) >= dead_frac}


def _hold(cl, dk, tile=TILE, jax_too=True):
    want = td._disk_load_plain(cluster_from_numpy(cl, "cpu"),
                               torch.as_tensor(dk["disk_assignment"]),
                               dk["disk_capacity"].shape[1]).numpy()
    got = k5_load_model(cl, dk, tile)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert td.disk_load(cluster_from_numpy(cl, "cpu"),
                        td.disks_from_numpy(dk, "cpu")).numpy().tobytes() \
        == want.tobytes()
    if jax_too:
        js = JCT(**{k: jnp.asarray(v) for k, v in cl.items()})
        jdk = jd.DiskTensors(**{k: jnp.asarray(v) for k, v in dk.items()})
        np.testing.assert_array_equal(
            np.asarray(jd.disk_load(js, jdk)).view(np.int32),
            want.view(np.int32))
    return want


@pytest.mark.parametrize("num_disks", [1, 2, 4, 8, 32])
@pytest.mark.parametrize("tile", [64, TILE])
def test_load_model_equals_the_twin_and_jax(num_disks, tile):
    """Tiles of 64 slots split every bucket's slots over many tiles; the
    kernel's own plan puts the 1,800 slots in one tile."""
    cl, dk = _case(20, 600, 3, num_disks, seed=num_disks)
    want = _hold(cl, dk, tile)
    assert (want > 0).sum() >= min(20 * num_disks, 600) // 2


@pytest.mark.parametrize("num_disks", [1, 4])
def test_load_model_with_a_broker_above_the_balancers_limit(num_disks):
    """Broker 1 hosts over 9,000 replicas: more than the balancer's 8,192,
    no limit of the load mode."""
    cl, dk = crowded_broker_case(num_disks, seed=7)
    assert (cl["assignment"] == 1).sum() > td.INTRA_BROKER_MAX_REPLICAS
    assert load_plan(12_000, 4) == (1, 4, 2)
    assert load_plan(3_000_000, 7_000) == (32, 219, 367)
    _hold(cl, dk)
    _hold(cl, dk, tile=333)


@pytest.mark.parametrize("num_brokers,num_partitions,plan", [
    (1_000, 3_000, (4, 250, 2)),
    (3_000, 20_000, (16, 188, 8)),
    (7_000, 20_000, (32, 219, 8)),
    (20_000, 3_000, (128, 157, 2)),
    (1 << 20, 12_000, (4096, 256, 5))])
def test_load_plan_buckets_many_brokers(num_brokers, num_partitions, plan):
    """At most 256 buckets of a power of two of consecutive brokers at any
    B: at 2**20 brokers a bucket holds 4,096 of them."""
    cl, dk = _case(num_brokers, num_partitions, 3, 2, seed=num_brokers,
                   dead_frac=0.0)
    assert load_plan(num_partitions * 3, num_brokers) == plan
    _hold(cl, dk, jax_too=num_brokers < 100_000)
