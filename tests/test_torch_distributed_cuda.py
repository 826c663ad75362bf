"""The distributed package on the card: a world of one rank over NCCL.

Run on a machine with a CUDA device (it needs no JAX, which
tests/conftest.py imports):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_distributed_cuda.py

At world size 1 the sharded paths run the unsharded kernels at the
unsharded shapes, so they give the unsharded bits: the sharded fit (the
canonical route through fwht_op on the slab, against srht_t's; the fused
route through fit_sketch on the slab's valid rows), the ShardedExtender
(extend_embed on the whole reference set, then one all_reduce), the
butterfly (fwht_op on the one slab). Data from a numpy seed: the
segmentation proxy, n = 3,000, p = 19, K = 7, r = 2, block 256.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import KernelKMeans
from repro_torch.data import segmentation_proxy
from repro_torch.distributed.dfwht import distributed_fwht
from repro_torch.kernels import OPS, fwht_op, reset_launches
from repro_torch.serve import (ComputePolicy, Extender, MicroBatcher,
                               ShardedExtender)

N, NQ, P, K, R, BLOCK = 3000, 700, 19, 7, 2, 256
BACKENDS = ["onepass-srht", "onepass-gaussian"]
KW = dict(k=K, r=R, kernel="polynomial",
          kernel_params={"gamma": 0.0, "degree": 2},
          backend_params={"oversampling": 5}, block=BLOCK, device="cuda")


@pytest.fixture(scope="module")
def card():
    """(the NCCL mesh of one rank, training points, held-out queries)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    made = not dist.is_initialized()
    mesh = make_debug_mesh()
    X, _ = segmentation_proxy(np.random.default_rng(7), n=N + NQ, p=P, k=K)
    X = torch.from_numpy(X.numpy()).cuda()
    yield mesh, X[:, :N].contiguous(), X[:, N:].contiguous()
    if made:
        dist.destroy_process_group()


def _equal_fits(a, b):
    for name in a.model_._fields[1:]:
        va, vb = getattr(a.model_, name), getattr(b.model_, name)
        if va is not None:
            assert torch.equal(va, vb), name
    assert torch.equal(a.labels_, b.labels_)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fused", [False, True])
def test_sharded_fit_bit_identical_on_the_card(card, backend, fused):
    mesh, X, _ = card
    ref = KernelKMeans(backend=backend, policy=ComputePolicy(
        fit_fused=fused), **KW).fit(X, seed=3)
    reset_launches()
    sh = KernelKMeans(backend=backend, policy=ComputePolicy(
        fit_fused=fused, mesh=mesh), **KW).fit(X, seed=3)
    _equal_fits(ref, sh)
    blocks = -(-N // BLOCK)
    if fused:
        assert OPS["fit_sketch"].launches == blocks
    elif backend == "onepass-srht":
        assert OPS["fwht"].launches == blocks       # the slab's transform


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_sharded_partial_fit_equals_one_shot_on_the_card(card, fused):
    mesh, X, _ = card
    pol = ComputePolicy(fit_fused=fused, mesh=mesh)
    one = KernelKMeans(policy=pol, **KW).fit(X, seed=3)
    est = KernelKMeans(policy=pol, **KW)
    for lo, hi in ((0, 700), (700, 1901), (1901, N)):
        est.partial_fit(X[:, lo:hi], seed=3, capacity=N, reeig=(hi == N))
    _equal_fits(one, est)


@pytest.mark.cuda
def test_sharded_extender_equals_extender_on_the_card(card):
    mesh, X, Xq = card
    model = KernelKMeans(policy=ComputePolicy(), **KW).fit(X, seed=3).model_
    ext = Extender(model, policy=ComputePolicy())
    reset_launches()
    sh = ShardedExtender(model, policy=ComputePolicy(mesh=mesh))
    assert torch.equal(sh.embed(Xq), ext.embed(Xq))
    assert OPS["extend_embed"].launches == 2 * -(-NQ // BLOCK)
    labels, d2 = sh.assign(Xq)
    assert OPS["kmeans_assign"].launches == 1
    want = ext.assign(Xq, fused=True)
    assert (labels != want[0]).float().mean() < 0.01
    torch.testing.assert_close(d2, want[1], rtol=2e-3, atol=2e-3)
    batcher = MicroBatcher(model, policy=ComputePolicy(mesh=mesh))
    got = batcher.assign_batch(Xq[:, :300])
    unbatched = sh.assign(Xq[:, :300])
    assert np.array_equal(got[0], unbatched[0].cpu().numpy())
    assert np.array_equal(got[1], unbatched[1].cpu().numpy())


@pytest.mark.cuda
def test_distributed_fwht_equals_fwht_op_on_the_card(card):
    mesh = card[0]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1 << 14, 96)).astype(np.float32)).cuda()
    assert torch.equal(distributed_fwht(x, mesh), fwht_op(x))


@pytest.mark.cuda
def test_cpu_tensor_on_an_nccl_mesh_raises(card):
    mesh = card[0]
    with pytest.raises(ValueError, match="for a cuda mesh"):
        distributed_fwht(torch.zeros((8, 2)), mesh)
