"""launch/op_analysis.py against repro.launch.hlo_analysis.analyze.

The hand-computable programs of tests/test_hlo_analysis.py, written in
torch and run under op_analysis.analyze, give JAX analyze's figures of
the same programs compiled on one CPU device exactly: the flops of a
matmul, of a loop of matmuls and of nested loops; the collective bytes
and counts by kind of a loop of collectives; the flops of a gradient
through a loop; and traffic that scales with the trip count. Also the
smoke train steps' flops against JAX analyze's of the same config and
batch, the live-bytes tracker on a hand-counted program, and the
collectives sized by their result at a world of 16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_config
from repro.launch import specs as jspecs
from repro.launch.hlo_analysis import analyze as jax_analyze
from repro.models.registry import get_api as jax_api
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.launch import specs
from repro_torch.launch.mesh import destroy_dryrun_mesh, make_dryrun_mesh
from repro_torch.launch.op_analysis import analyze
from repro_torch.models import get_api
from repro_torch.train import (AdamWConfig, TrainState, adamw_init,
                               make_train_step)

MIB = 2 ** 20


def _jax(f, *shapes):
    text = jax.jit(f).lower(*(jax.ShapeDtypeStruct(s, jnp.float32)
                              for s in shapes)).compile().as_text()
    return jax_analyze(text)


def _fake(*shapes, grad=False):
    return [torch.empty(s, requires_grad=grad) for s in shapes]


def test_single_matmul_flops():
    want = _jax(lambda a, b: a @ b, (64, 128), (128, 256))["flops"]
    with FakeTensorMode():
        got = analyze(lambda a, b: a @ b, *_fake((64, 128), (128, 256)))
    assert got["flops"] == want == 2 * 64 * 128 * 256


def test_loop_multiplies_by_trip_count():
    L = 7

    def jf(x, w):
        return jax.lax.scan(lambda c, wi: (jnp.tanh(c @ wi), None), x, w)[0]

    def tf(x, w):
        for i in range(L):
            x = torch.tanh(x @ w[i])
        return x

    want = _jax(jf, (32, 64), (L, 64, 64))["flops"]
    with FakeTensorMode():
        got = analyze(tf, *_fake((32, 64), (L, 64, 64)))
    assert got["flops"] == want == L * 2 * 32 * 64 * 64


def test_nested_loops_multiply():
    Lo, Li = 3, 5

    def jf(x, w):
        def outer(c, _):
            inner = jax.lax.scan(lambda c2, wi: (jnp.tanh(c2 @ wi), None),
                                 c, w)[0]
            return inner, None
        return jax.lax.scan(outer, x, None, length=Lo)[0]

    def tf(x, w):
        for _ in range(Lo):
            for i in range(Li):
                x = torch.tanh(x @ w[i])
        return x

    want = _jax(jf, (16, 32), (Li, 32, 32))["flops"]
    with FakeTensorMode():
        got = analyze(tf, *_fake((16, 32), (Li, 32, 32)))
    assert got["flops"] == want == Lo * Li * 2 * 16 * 32 * 32


def test_collectives_weighted_by_trips():
    """JAX: psum, all_gather and psum_scatter in a scan of 5 under
    shard_map on a one-device mesh (XLA keeps the collectives); the port:
    all_reduce, all_gather_into_tensor and reduce_scatter_tensor 5 times
    in a dry-run world of one rank. The same bytes and counts by kind."""
    trips, shape = 5, (64, 32)
    from jax.experimental.shard_map import shard_map
    mesh = Mesh(np.array(jax.devices()[:1]), ("d",))

    def jf(x):
        def inner(x):
            def body(c, _):
                a = jax.lax.psum(c, "d")
                b = jax.lax.all_gather(c, "d", tiled=True)
                s = jax.lax.psum_scatter(c, "d", tiled=True)
                return c + a + b[:c.shape[0]] + s, None
            return jax.lax.scan(body, x, None, length=trips)[0]
        return shard_map(inner, mesh=mesh, in_specs=JP("d"),
                         out_specs=JP("d"))(x)

    want = _jax(jf, shape)

    def tf(x):
        for _ in range(trips):
            a = x.clone()
            dist.all_reduce(a)
            b = torch.empty_like(x)
            dist.all_gather_into_tensor(b, x)
            s = torch.empty_like(x)
            dist.reduce_scatter_tensor(s, x)
            x = x + a + b + s
        return x

    world = make_dryrun_mesh(shape=(1, 1))
    try:
        with FakeTensorMode():
            got = analyze(tf, *_fake(shape))
    finally:
        destroy_dryrun_mesh(world)
    assert got["collective_bytes"] == want["collective_bytes"]
    assert got["collective_counts"] == want["collective_counts"]
    assert got["collective_total"] == want["collective_total"] \
        == 3 * trips * 64 * 32 * 4


def test_collectives_sized_by_their_result():
    """At a world of 16: an all-gather's bytes are the gathered tensor's,
    a reduce-scatter's its chunk's; the list form of all_gather counts as
    an all-gather; a broadcast, which fits no JAX kind, counts under its
    own name."""
    world = make_dryrun_mesh(shape=(16, 1))

    def tf(x):
        out = torch.empty((16 * 8, 4))
        dist.all_gather_into_tensor(out, x)
        dist.all_gather([torch.empty_like(x) for _ in range(16)], x)
        dist.reduce_scatter_tensor(torch.empty((1, 4)), torch.empty((16, 4)))
        dist.broadcast(x, src=0)
        return out

    try:
        with FakeTensorMode():
            got = analyze(tf, *_fake((8, 4)))
    finally:
        destroy_dryrun_mesh(world)
    assert not dist.is_initialized()
    assert got["collective_bytes"]["all-gather"] == 2 * 16 * 8 * 4 * 4
    assert got["collective_counts"]["all-gather"] == 2
    assert got["collective_bytes"]["reduce-scatter"] == 4 * 4
    assert got["collective_bytes"]["broadcast_"] == 8 * 4 * 4
    assert got["collective_counts"]["broadcast_"] == 1
    assert got["collective_total"] == (2 * 16 + 1) * 8 * 4 * 4 + 16


def test_grad_through_loop_counts_forward_and_backward():
    """JAX's backward scan transposes every trip's product for both the
    weight and the carry, the first trip's included (the loop cannot drop
    one trip's carry cotangent): 3 L products. The torch program asks for
    x's gradient too, so its autograd runs the same 3 L products (without
    it, it would skip the first trip's, 3 L - 1)."""
    L = 4

    def jloss(x, w):
        out = jax.lax.scan(lambda c, wi: (jnp.tanh(c @ wi), None), x, w)[0]
        return jnp.sum(out * out)

    def tf(x, w):
        for i in range(L):
            x = torch.tanh(x @ w[i])
        (x * x).sum().backward()

    want = _jax(lambda x, w: jax.grad(jloss, 1)(x, w), (8, 16),
                (L, 16, 16))["flops"]
    with FakeTensorMode():
        got = analyze(tf, *_fake((8, 16), (L, 16, 16), grad=True))
    assert got["flops"] == want == 3 * L * 2 * 8 * 16 * 16


def test_traffic_scales_with_trip_count():
    """c * 1.5 + 1.0 on 4 MiB, L times: two eager ops a trip, each reading
    and writing 4 MiB (XLA fuses them into one pass of 8 MB, which JAX's
    figure counts): L x 16 MiB exactly, at least JAX's, and linear in L.
    The live bytes: x, the carry, c * 1.5 and the new carry at once."""
    def jf(x, L):
        return jax.lax.scan(lambda c, _: (c * 1.5 + 1.0, None), x, None,
                            length=L)[0]

    def tf(c, L):
        for _ in range(L):
            c = c * 1.5 + 1.0
        return c

    got = {}
    for L in (1, 9):
        want = _jax(lambda x: jf(x, L), (1024, 1024))["traffic_bytes"]
        with FakeTensorMode():
            got[L] = analyze(tf, *_fake((1024, 1024)), L)
        assert got[L]["traffic_bytes"] == L * 16 * MIB >= want >= L * 8e6
    assert got[9]["traffic_bytes"] == 9 * got[1]["traffic_bytes"]
    assert got[9]["memory"] == {"argument": 4 * MIB, "output": 4 * MIB,
                                "temp": 12 * MIB, "peak": 16 * MIB}
    assert got[1]["memory"]["peak"] == 12 * MIB


def test_live_bytes_views_and_release():
    """Each storage once however many views it has; a storage dropped in
    the call stops counting; output is what the call returns new."""
    def tf(x):
        a = torch.empty(256, 256)             # 256 KiB
        views = [a[i] for i in range(8)] + [a.t(), a.view(-1)]
        del a, views
        b = torch.empty(512, 256)             # 512 KiB, after a is gone
        return x, b[:1]

    with FakeTensorMode():
        got = analyze(tf, *_fake((64, 64)))    # 16 KiB
    kib = 1024
    assert got["memory"] == {"argument": 16 * kib, "output": 512 * kib,
                             "temp": 512 * kib, "peak": 528 * kib}


SMOKE = ("phi4-mini-3.8b", "rwkv6-1.6b", "mixtral-8x7b")


@pytest.mark.parametrize("arch", SMOKE)
def test_smoke_train_step_flops_match_jax(arch):
    """The smoke config's train step at B 4 x S 16 on the CPU, JAX's
    compiled (analyze of its HLO text) and the port's run under analyze:
    the same flops within 1 % (phi4 and mixtral exactly, capacity
    routing's dispatch and combine products included). rwkv6 0.495 %
    under JAX's: JAX's scan over the WKV chunks transposes the carried
    state's product (r_s @ state) for the carry on every chunk, the first
    included, whose carry is the zero initial state and needs no
    gradient; the port's autograd skips it, 2 B H Lc dh^2 = 131,072 flops
    a layer here."""
    B, S = 4, 16
    jcfg, pcfg = jax_config(arch, True), get_config(arch, True)
    japi = jax_api(jcfg)
    jo = jopt.AdamWConfig(moment_dtype=jcfg.optimizer_dtype)

    def init():
        params = japi.init(jax.random.PRNGKey(0), jcfg, 1)
        return jsteps.TrainState(params, jopt.adamw_init(params, jo))

    text = jax.jit(jsteps.make_train_step(jcfg, japi, opt_cfg=jo)).lower(
        jax.eval_shape(init), jspecs.train_inputs(jcfg, S, B)
    ).compile().as_text()
    want = jax_analyze(text)["flops"]
    api = get_api(pcfg)
    model = api.init(pcfg, 1, device="cpu")
    state = TrainState(model, adamw_init(dict(model.named_parameters()),
                                         AdamWConfig()))
    batch = specs.train_inputs(pcfg, S, B, torch.Generator().manual_seed(0))
    got = analyze(make_train_step(pcfg, api), state, batch)["flops"]
    if arch == "rwkv6-1.6b":
        H, dh = pcfg.d_model // pcfg.rwkv_head_dim, pcfg.rwkv_head_dim
        Lc = min(pcfg.rwkv_chunk, S)              # one chunk: S < 64
        assert want - got == pcfg.n_layers * 2 * B * H * Lc * dh * dh
    else:
        assert got == want
    assert abs(got - want) / want < 0.01
