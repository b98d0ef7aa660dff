"""The port's mesh rules and the criteria's shares, in one process.

  * parallel/mesh.shard_slices against the JAX package's shard_batch: each
    device of the 8-device CPU mesh (tests/conftest.py) holds, by its
    addressable shard's index, the slices shard_slices gives its mesh
    coordinate: 4-D, 2-D, 1-D and scalar leaves, stacked leaves, and the
    ValueError of a batch the mesh does not divide;
  * make_mesh's shapes and dist_mesh's cases, over a fake process group of
    8 ranks (torch's "fake" backend: groups and meshes, no traffic);
  * each criterion's shares: a batch split over two ranks, each a thread
    of this process with a gloo group of its own over one in-memory store,
    so the counts really are all-reduced.  The shares add up to the loss of
    the whole batch, and each share's gradient is the whole batch's on its
    rows: l2 (and l2 with the latency term), the local/global loss with
    its flags split unevenly (3 local of 4 in one shard, 1 of 4 in the
    other), and the frozen-YOLO criterion with every object in one shard
    (so the no-box gate differs per shard and only the global count gives
    the global loss).  Tolerances: the shares add in another order than
    the whole batch's sums, 1e-6 relative on the loss; gradients 1e-6 of
    their largest component.
"""

import datetime
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from reconfigisp_tpu.parallel import mesh as jmesh
from reconfigisp_tpu.utils import losses as jlosses

from reconfigisp_tpu_torch.parallel import mesh as meshlib
from reconfigisp_tpu_torch.search.trainer import (
    build_yolo_evaluator, dist_mesh, make_yolo_criterion)
from reconfigisp_tpu_torch.utils import losses

LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-6


# ---------------------------------------------------------------- sharding

def _jax_mesh(space):
    devs = np.asarray(jax.devices()[:8]).reshape(8 // space, space)
    return Mesh(devs, (jmesh.DATA_AXIS, jmesh.SPACE_AXIS)), devs


def _index(slc, shape):
    return tuple(range(*s.indices(n)) for s, n in zip(slc, shape))


@pytest.mark.parametrize("space", [1, 2], ids=["mesh8x1", "mesh4x2"])
@pytest.mark.parametrize("shape,stacked", [
    ((8, 16, 16, 1), False), ((8, 6), False), ((16,), False), ((), False),
    ((3, 8, 16, 16, 3), True), ((3, 8, 2), True), ((3,), True)],
    ids=["4d", "2d", "1d", "scalar", "stacked_4d", "stacked_2d",
         "stacked_steps"])
def test_shard_slices_match_jax(space, shape, stacked):
    """Every device's shard of jax shard_batch is the slice shard_slices
    gives its (data, space) coordinate."""
    mesh, devs = _jax_mesh(space)
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    placed = jmesh.shard_batch(mesh, {"x": x}, stacked=stacked)["x"]
    by_device = {s.device: s.index for s in placed.addressable_shards}
    for (d, s), dev in np.ndenumerate(devs):
        got = meshlib.shard_slices(shape, d, devs.shape[0], s, space,
                                   stacked=stacked)
        assert _index(got, shape) == _index(by_device[dev], shape), (d, s)


@pytest.mark.parametrize("shape", [(4, 16, 16, 1), (8, 5, 16, 1)],
                         ids=["batch", "height"])
def test_indivisible_shard_raises_as_jax(shape):
    """A batch of 4 over 8 data shards, or a height of 5 over 2 space
    shards: ValueError from both packages."""
    mesh, devs = _jax_mesh(1 if shape[0] == 4 else 2)
    with pytest.raises(ValueError):
        jax.block_until_ready(jmesh.shard_batch(mesh, np.zeros(shape)))
    with pytest.raises(ValueError, match="do not"):
        meshlib.shard_slices(shape, 0, devs.shape[0], 0, devs.shape[1])


def test_shard_batch_takes_views_of_each_type():
    """Numpy leaves stay numpy, tensors tensors, numbers pass through."""
    batch = {"img": np.arange(32, dtype=np.float32).reshape(4, 2, 2, 2),
             "flag": torch.arange(4.0), "lr": 0.5}

    class _Mesh:  # the two calls shard_batch makes of a DeviceMesh
        def get_local_rank(self, axis):
            return 1 if axis == meshlib.DATA_AXIS else 0

        def size(self, dim):
            return (2, 1)[dim]

    got = meshlib.shard_batch(_Mesh(), batch)
    np.testing.assert_array_equal(got["img"], batch["img"][2:])
    assert isinstance(got["flag"], torch.Tensor)
    assert got["flag"].tolist() == [2.0, 3.0] and got["lr"] == 0.5


# ------------------------------------------------------ meshes, dist_mesh

@pytest.fixture
def fake_group():
    """A process group of 8 ranks, this process rank 0, moving no data."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_shapes(fake_group):
    """As tests/test_parallel.py's TestMesh: 8 ranks as (8, 1) and (4, 2),
    dims named data and space; a mesh the group cannot hold raises."""
    m = meshlib.make_mesh(8)
    assert tuple(m.shape) == (8, 1)
    assert m.mesh_dim_names == ("data", "space")
    m2 = meshlib.make_mesh(8, space=2)
    assert tuple(m2.shape) == (4, 2)
    assert meshlib.coordinate(m2) == (0, 4, 0, 2)
    assert tuple(meshlib.make_mesh(4).shape) == (4, 1)
    with pytest.raises(ValueError, match="has 8 ranks"):
        meshlib.make_mesh(16)


def test_dist_mesh_serial_without_a_group():
    """No process group: the run is serial (JAX on one device)."""
    assert not dist.is_initialized()
    assert dist_mesh(4) is None


def test_dist_mesh_over_the_group_or_raises(fake_group):
    """A batch the 8 ranks divide: a (8, 1) mesh.  One they do not: a
    ValueError that names the rank count to launch (4 for a batch of 4, 6
    for 6) where JAX would use that many of its devices."""
    assert tuple(dist_mesh(16).shape) == (8, 1)
    with pytest.raises(ValueError, match="launch 4 ranks"):
        dist_mesh(4)
    with pytest.raises(ValueError, match="launch 6 ranks"):
        dist_mesh(6)


# ------------------------------------------------------------------ shares

def _on_two_ranks(fn):
    """fn(rank, group) on two threads, each with a gloo group of two over
    one store -> [fn's result of each]."""
    store = dist.HashStore()
    out, errors = [None, None], []

    def work(rank):
        try:
            group = dist.ProcessGroupGloo(store, rank, 2,
                                          datetime.timedelta(seconds=60))
            out[rank] = fn(rank, group)
        except Exception as err:  # noqa: BLE001 - reraised below
            errors.append(err)

    threads = [threading.Thread(target=work, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return out


def _shares_vs_whole(criterion, pred, target, **kw):
    """The two shares and their gradients, the whole batch's loss and
    gradient; kw are batch-sized tensors split with the rows."""
    half = pred.shape[0] // 2
    rows = [slice(0, half), slice(half, None)]

    def share(rank, group):
        p = pred[rows[rank]].clone().requires_grad_()
        part = {k: v[rows[rank]] for k, v in kw.items()}
        loss = criterion(p, target[rows[rank]], group=group, **part)
        return float(loss.detach()), torch.autograd.grad(loss, p)[0]

    shares = _on_two_ranks(share)
    p = pred.clone().requires_grad_()
    whole = criterion(p, target, **kw)
    return shares, float(whole.detach()), torch.autograd.grad(whole, p)[0], rows


def _assert_shares(shares, whole, grad, rows):
    assert sum(s for s, _ in shares) == pytest.approx(whole, rel=LOSS_RTOL)
    scale = float(grad.abs().max())
    assert scale > 0
    for (_, g), r in zip(shares, rows):
        np.testing.assert_allclose(g.numpy(), grad[r].numpy(), rtol=0,
                                   atol=GRAD_RTOL * scale)


def _images(seed, n=4, size=16):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.uniform(0.05, 0.95, (n, size, size, 3))
                             .astype(np.float32)),
            torch.from_numpy(rng.uniform(0.05, 0.95, (n, size, size, 3))
                             .astype(np.float32)))


@pytest.mark.parametrize("name", ["l2", "l2_latency"])
def test_mean_square_shares_add_up(name):
    """l2: each shard's mean over the group's size; with the latency term
    (the same on both ranks) the fidelity's share times it.  The whole
    batch's loss is JAX's."""
    pred, gt = _images(0)
    opt = {"w": 0.5, "target_latency": 2.0}
    crit = losses.make_criterion(name, opt)
    latency = torch.tensor(3.0)
    shares, whole, grad, rows = _shares_vs_whole(
        lambda p, t, group=None: crit(p, t, latency=latency, group=group),
        pred, gt)
    _assert_shares(shares, whole, grad, rows)
    want = jlosses.make_criterion(name, opt)(
        jnp.asarray(pred.numpy()), jnp.asarray(gt.numpy()),
        latency=jnp.float32(3.0))
    assert whole == pytest.approx(float(want), rel=1e-6)


def test_local_global_shares_add_up_with_uneven_flags():
    """glb_flag [0, 0, 0, 1 | 1, 1, 1, 0]: 3 local samples in one shard and
    1 in the other, so each shard's own counts would weigh its samples
    wrongly; the global counts give the whole batch's loss (JAX's)."""
    pred, gt = _images(1, n=8, size=32)
    # errors growing with the sample, so that counting samples per shard
    # would weigh them visibly otherwise
    gt = pred + (gt - pred) * torch.arange(1.0, 9.0).reshape(8, 1, 1, 1) / 8
    flag = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 0.0])
    crit = losses.make_criterion("local_global_l2")
    shares, whole, grad, rows = _shares_vs_whole(
        lambda p, t, glb_flag, group=None: crit(p, t, glb_flag=glb_flag,
                                                group=group),
        pred, gt, glb_flag=flag)
    _assert_shares(shares, whole, grad, rows)
    alone = [float(crit(pred[r], gt[r], glb_flag=flag[r])) / 2 for r in rows]
    assert abs(sum(alone) - whole) > 1e-3 * whole   # the counts matter
    want = jlosses.local_global_loss(jnp.asarray(pred.numpy()),
                                     jnp.asarray(gt.numpy()),
                                     jnp.asarray(flag.numpy()))
    assert whole == pytest.approx(float(want), rel=1e-6)


def test_yolo_shares_add_up_with_every_object_in_one_shard():
    """The frozen tiny_test criterion, boxes in images 0-1 only: shard 1
    has none, so alone it would take the no-box branch and normalise by 1;
    with the global object count and gate its share is its part of the
    whole batch's loss."""
    torch.manual_seed(0)
    crit = make_yolo_criterion(
        build_yolo_evaluator({"cfg": "tiny_test", "classes": 1}, "cpu"), 32)
    pred, _ = _images(2, size=32)
    labels = torch.zeros((4, 3, 6))
    labels[0, 0] = torch.tensor([1.0, 0.0, 0.5, 0.5, 0.4, 0.3])
    labels[1, 0] = torch.tensor([1.0, 0.0, 0.3, 0.6, 0.2, 0.5])
    labels[1, 1] = torch.tensor([1.0, 0.0, 0.7, 0.2, 0.3, 0.3])
    shares, whole, grad, rows = _shares_vs_whole(crit, pred, labels)
    _assert_shares(shares, whole, grad, rows)
    alone = float(crit(pred[2:], labels[2:]))
    assert abs(shares[1][0] - alone) > 1e-3 * abs(alone)


def test_parallel_modules_and_card_tools_import_no_jax():
    """parallel/mesh, dp, launch, dryrun and the card's tools
    (tools/time_kernels.py, tools/profile_torch_training.py) pull in
    neither JAX nor the JAX package."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    code = ("import sys; sys.path.insert(0, '.'); "
            "import reconfigisp_tpu_torch.parallel.mesh, "
            "reconfigisp_tpu_torch.parallel.dp, "
            "reconfigisp_tpu_torch.parallel.launch, "
            "reconfigisp_tpu_torch.parallel.dryrun, tools.time_kernels, "
            "tools.profile_torch_training; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'reconfigisp_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(repo),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
