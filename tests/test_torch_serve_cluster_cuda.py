"""The serving launcher and its benches on the card.

Run on a machine with a CUDA device (it needs no JAX, which
tests/conftest.py imports):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_serve_cluster_cuda.py

The launcher's check 4 holds the mesh-sharded one-pass fit against the
unsharded fit. A policy-less fit takes the canonical route, while a policy
resolves fit_fused=None to the fused route on the card, so the sharded
estimator names the canonical route (fit_fused=False): at world size 1
over NCCL both then give the same bits. benchmark_fused's two engines,
the extend_embed kernel and the two-pass gram + projection, agree within
the registry's 2e-3. Data: blob_ring from torch seed 0, n = 4,000.
"""
import pytest
import torch

from repro_torch.api import KernelKMeans
from repro_torch.data import blob_ring
from repro_torch.kernels import OPS, reset_launches
from repro_torch.serve import ComputePolicy, Extender, benchmark_fused

N, NQ = 4000, 512
KW = dict(k=2, r=2, kernel="polynomial",
          kernel_params={"gamma": 0.0, "degree": 2},
          backend_params={"oversampling": 10}, block=512, device="cuda")


@pytest.fixture(scope="module")
def card():
    """(the NCCL mesh of one rank, training points, queries, the
    policy-less fit) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    made = not dist.is_initialized()
    mesh = make_debug_mesh()
    gen = torch.Generator(device="cuda").manual_seed(0)
    X, _ = blob_ring(gen, n=N)
    Xq = torch.randn((2, NQ), generator=gen, device="cuda")
    est = KernelKMeans(**KW).fit(X, seed=1)
    yield mesh, X, Xq, est
    if made:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_check4_sharded_fit_bit_for_bit_on_one_route(card):
    mesh, X, _, est = card
    reset_launches()
    sharded = KernelKMeans(**KW, policy=ComputePolicy(
        fit_fused=False, mesh=mesh)).fit(X, seed=1)
    assert OPS["fit_sketch"].launches == 0       # the canonical route
    assert torch.equal(est.labels_, sharded.labels_)
    for leaf in ("U", "eigvals", "centroids", "stream_w"):
        assert torch.equal(getattr(est.model_, leaf),
                           getattr(sharded.model_, leaf)), leaf


@pytest.mark.cuda
def test_launcher_check4_on_the_card(card, tmp_path, capsys):
    from repro_torch.launch import serve_cluster
    rc = serve_cluster.main([
        "--n", str(N), "--queries", str(NQ), "--bench", "sync",
        "--repeats", "1", "--artifact-dir", str(tmp_path / "demo"),
        "--bench-out", str(tmp_path / "bench.json")])
    out = capsys.readouterr().out
    assert rc == 0 and out.strip().splitlines()[-1] == "serve_cluster: OK"
    assert "sharded fit (1 shard) bit-identical" in out


@pytest.mark.cuda
def test_benchmark_fused_engines_agree(card):
    _, _, Xq, est = card
    model = est.model_
    fused = Extender(model, policy=ComputePolicy(embed_fused=True))
    two = Extender(model, policy=ComputePolicy(embed_fused=False))
    reset_launches()
    got = fused.embed(Xq)
    assert OPS["extend_embed"].launches > 0
    torch.testing.assert_close(got, two.embed(Xq), rtol=2e-3, atol=2e-3)
    bench = benchmark_fused(model, repeats=1)
    assert bench["interpret"] is False and bench["backend"] == "cuda"
    assert bench["speedup"] > 0 and bench["hbm"]["saved_ratio"] > 0.9
