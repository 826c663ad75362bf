"""Artifacts on disk in both directions between the JAX package and the port.

A model saved by JAX (f32, bf16, int8, and a legacy artifact without
leaves.json or with the old ModelSpec schema) loads in the port and serves
the labels of `repro.serve.assign` (distances within 2e-3, labels differ
only on ties: the kmeans_assign rule); a model saved by the port loads in
JAX with exactly equal leaves. The same holds for Nystrom (landmark)
artifacts in f32 and bf16, their labels by the near-tie rule, and for
exact ones. The bf16 and int8 codecs equal JAX's bit
for bit, and the checkpoint layer writes JAX's manifest.
"""
import dataclasses
import json
import pathlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import KernelKMeans as JaxKernelKMeans
from repro.distributed import checkpoint as jax_ckpt
from repro.distributed import compression as jax_codec
from repro.serve import load_model as jax_load_model
from repro.serve import save_model as jax_save_model
from repro.serve.artifact import ClusteringSpec as JaxSpec
from repro.serve.extend import assign as jax_assign
from repro_torch.api import KernelKMeans, spec_to_estimator
from repro_torch.data import segmentation_proxy
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import compression as codec
from repro_torch.kernels.registry import assign_compare, near_tie_compare
from repro_torch.serve import (ClusteringSpec, Extender, MicroBatcher,
                               load_model, save_model)

N, NQ, P, K, R, BLOCK = 300, 96, 19, 7, 2, 64
KPARAMS = {"gamma": 0.0, "degree": 2}
TOL = 2e-3


@pytest.fixture(scope="module")
def data():
    X, _ = segmentation_proxy(np.random.default_rng(21), n=N + NQ, p=P, k=K)
    X = X.numpy()
    return X[:, :N].copy(), X[:, N:].copy()


@pytest.fixture(scope="module")
def jax_est(data):
    return JaxKernelKMeans(
        k=K, r=R, kernel="polynomial", kernel_params=KPARAMS,
        backend="onepass-srht", backend_params={"oversampling": 5},
        block=BLOCK).fit(data[0], key=0)


def _port_est(X, backend="onepass-srht"):
    return KernelKMeans(k=K, r=R, kernel="polynomial", kernel_params=KPARAMS,
                        backend=backend, backend_params={"oversampling": 5},
                        block=BLOCK, device="cpu").fit(X, seed=0)


def _leaves(model):
    return {name: getattr(model, name) for name in model._fields[1:]
            if getattr(model, name) is not None}


# -- JAX -> port -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_jax_artifact_serves_in_the_port(data, jax_est, tmp_path, dtype):
    Xq = data[1]
    path = jax_save_model(jax_est.model_, str(tmp_path / dtype), dtype=dtype)
    jax_model = jax_load_model(path)
    model = load_model(path, device="cpu")
    assert model.spec == ClusteringSpec(**dataclasses.asdict(jax_model.spec))
    for name, leaf in _leaves(jax_model).items():
        np.testing.assert_array_equal(getattr(model, name).numpy(),
                                      np.asarray(leaf), err_msg=name)
    assert model.sketch_rows.dtype == torch.int64
    assert model.stream_counts.dtype == torch.int32
    want = jax_assign(jax_model, Xq)
    got = MicroBatcher(model, max_bucket=64).assign_batch(Xq)
    assign_compare(got, want, TOL, TOL)
    est = KernelKMeans.load(path, device="cpu")
    np.testing.assert_array_equal(est.predict(Xq).numpy(), got[0])


@pytest.mark.parametrize("legacy", ["keystr-paths", "model-spec"])
def test_legacy_jax_artifact_loads(data, jax_est, tmp_path, legacy):
    path = pathlib.Path(jax_save_model(jax_est.model_, str(tmp_path / "a")))
    if legacy == "keystr-paths":
        (path / "leaves.json").unlink()
    else:
        spec = json.loads((path / "spec.json").read_text())
        spec["sketch_type"] = spec.pop("backend").split("-", 1)[1]
        spec["oversampling"] = spec.pop("backend_params")["oversampling"]
        for f in ("n_restarts", "max_iter"):
            spec.pop(f)
        (path / "spec.json").write_text(json.dumps(spec))
    model = load_model(str(path), device="cpu")
    jax_model = jax_load_model(str(path))
    assert model.spec.backend == "onepass-srht"
    assert model.spec.oversampling == 5
    assert model.spec.backend_params == dict(jax_model.spec.backend_params)
    np.testing.assert_array_equal(model.U.numpy(), np.asarray(jax_model.U))
    assign_compare(Extender(model).assign(data[1]),
                   jax_assign(jax_model, data[1]), TOL, TOL)


def _jax_nystrom(X):
    return JaxKernelKMeans(k=K, r=R, kernel="polynomial",
                           kernel_params=KPARAMS, backend="nystrom",
                           backend_params={"m": 64}, block=BLOCK).fit(X, key=0)


def test_nystrom_artifact_is_refused(data, tmp_path):
    """Refused no longer: a JAX Nystrom artifact loads with its landmark
    leaves, landmark_idx int32 on disk and int64 in memory."""
    path = jax_save_model(_jax_nystrom(data[0]).model_,
                          str(tmp_path / "nys"))
    manifest = jax_ckpt.read_manifest(path)
    names = json.loads((pathlib.Path(path) / "leaves.json").read_text())[
        "names"]
    assert manifest["dtypes"][names.index("landmark_idx")] == "int32"
    model = load_model(path, device="cpu")
    assert model.landmark_idx.dtype == torch.int64
    assert model.landmarks.shape == (P, 64) and model.n_ref == 64
    assert torch.equal(model.landmarks, model.X_train[:, model.landmark_idx])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_jax_nystrom_artifact_serves_in_the_port(data, tmp_path, dtype):
    Xq = data[1]
    path = jax_save_model(_jax_nystrom(data[0]).model_, str(tmp_path / dtype),
                          dtype=dtype)
    jax_model = jax_load_model(path)
    model = load_model(path, device="cpu")
    for name, leaf in _leaves(jax_model).items():
        np.testing.assert_array_equal(getattr(model, name).numpy(),
                                      np.asarray(leaf), err_msg=name)
    got = MicroBatcher(model, max_bucket=64).assign_batch(Xq)
    emb = Extender(model).embed(Xq).T.double()
    dist = ((emb[:, None, :] - model.centroids.double()[None]) ** 2).sum(
        -1).numpy()
    near_tie_compare(got, jax_assign(jax_model, Xq), TOL, TOL, dist)


# -- port -> JAX -------------------------------------------------------------

@pytest.mark.parametrize("backend", ["onepass-srht", "onepass-gaussian"])
def test_port_artifact_loads_in_jax(data, tmp_path, backend):
    est = _port_est(data[0], backend)
    path = save_model(est.model_, str(tmp_path / "f32"))
    jax_model = jax_load_model(path)
    for name, leaf in _leaves(est.model_).items():
        got = np.asarray(getattr(jax_model, name))
        np.testing.assert_array_equal(got, leaf.numpy(), err_msg=name)
        if leaf.is_floating_point():
            assert got.dtype == np.float32, name
    assert jax_model.spec.backend == backend
    assert dict(jax_model.spec.backend_params) == {"oversampling": 5}
    assert jax_model.spec.n == N and jax_model.spec.p == P
    # The JAX estimator serves it as the port does.
    assign_compare(est.extender().assign(data[1]),
                   jax_assign(jax_model, data[1]), TOL, TOL)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_port_quantized_artifact_decodes_alike(data, tmp_path, dtype):
    est = _port_est(data[0])
    path = est.save(str(tmp_path / dtype), dtype=dtype)
    meta = json.loads((pathlib.Path(path) / "leaves.json").read_text())
    assert meta["names"] == sorted(meta["names"])
    assert "stream_counts" not in meta["quantized"]
    jax_model, model = jax_load_model(path), load_model(path, device="cpu")
    for name, leaf in _leaves(model).items():
        np.testing.assert_array_equal(leaf.numpy(),
                                      np.asarray(getattr(jax_model, name)),
                                      err_msg=name)
    f32 = est.predict(data[1])
    got = KernelKMeans.from_model(model).predict(data[1])
    assert float((got == f32).float().mean()) >= 0.95


def test_spec_json_round_trip_and_refit(data):
    spec = _port_est(data[0]).spec_
    text = spec.to_json()
    assert ClusteringSpec.from_json(text) == spec
    assert text == JaxSpec.from_json(text).to_json()
    refit = spec_to_estimator(spec, device="cpu").fit(data[0], seed=0)
    assert torch.equal(refit.labels_, _port_est(data[0]).labels_)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_port_nystrom_artifact_loads_in_jax(data, tmp_path, dtype):
    est = KernelKMeans(k=K, r=R, kernel="polynomial", kernel_params=KPARAMS,
                       backend="nystrom", backend_params={"m": 64},
                       block=BLOCK, device="cpu").fit(data[0], seed=0)
    path = est.save(str(tmp_path / dtype), dtype=dtype)
    jax_model, model = jax_load_model(path), load_model(path, device="cpu")
    for name, leaf in _leaves(model).items():
        got = np.asarray(getattr(jax_model, name))
        np.testing.assert_array_equal(got, leaf.numpy(), err_msg=name)
    assert np.asarray(jax_model.landmark_idx).dtype == np.int32
    assert jax_model.n_ref == 64 and jax_model.spec.backend == "nystrom"
    if dtype == "f32":
        for name, leaf in _leaves(est.model_).items():
            assert torch.equal(getattr(model, name), leaf), name
    got = KernelKMeans.from_model(model).extender().assign(data[1])
    emb = Extender(model).embed(data[1]).T.double()
    dist = ((emb[:, None, :] - model.centroids.double()[None]) ** 2).sum(
        -1).numpy()
    near_tie_compare(got, jax_assign(jax_model, data[1]), TOL, TOL, dist)


def test_exact_artifacts_load_both_ways(data, tmp_path):
    """An exact model, saved by either package, loads in the other with
    equal leaves and serves the other package's labels."""
    kw = dict(k=K, r=R, kernel="polynomial", kernel_params=KPARAMS,
              backend="exact", block=BLOCK)
    jax_path = jax_save_model(JaxKernelKMeans(**kw).fit(data[0], key=0)
                              .model_, str(tmp_path / "jax"))
    port_path = KernelKMeans(**kw, device="cpu").fit(data[0], seed=0).save(
        str(tmp_path / "port"))
    for path in (jax_path, port_path):
        jax_model, model = jax_load_model(path), load_model(path,
                                                            device="cpu")
        assert model.spec.backend == jax_model.spec.backend == "exact"
        assert model.landmarks is None and model.n_ref == N
        for name, leaf in _leaves(model).items():
            np.testing.assert_array_equal(
                leaf.numpy(), np.asarray(getattr(jax_model, name)),
                err_msg=name)
        assign_compare(Extender(model).assign(data[1]),
                       jax_assign(jax_model, data[1]), TOL, TOL)


# -- codecs and the checkpoint layer -----------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_codecs_equal_jax_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((64, 33)) * 10.0 ** rng.uniform(-5, 4)
         ).astype(np.float32)
    x[0, :8] = [0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 0.0, -0.0]   # ties
    np.testing.assert_array_equal(codec.bf16_encode(x),
                                  np.asarray(jax_codec.bf16_encode(x)))
    q, scale = codec.int8_encode(x)
    jq, jscale = jax_codec.int8_encode(jnp.asarray(x))
    assert scale == jscale
    np.testing.assert_array_equal(q, np.asarray(jq))
    np.testing.assert_array_equal(codec.int8_decode(q, scale),
                                  np.asarray(jax_codec.int8_decode(jq, jscale)))
    u = codec.bf16_encode(x)
    np.testing.assert_array_equal(codec.bf16_decode(u),
                                  np.asarray(jax_codec.bf16_decode(u)))
    state = {"w": torch.from_numpy(x), "idx": torch.arange(4)}
    for dtype in ("bf16", "int8"):
        enc, quantized = codec.quantize_state(state, dtype)
        jenc, jquantized = jax_codec.quantize_state(
            {"w": jnp.asarray(x), "idx": jnp.arange(4)}, dtype)
        assert quantized == jquantized and "idx" not in quantized
        np.testing.assert_array_equal(enc["w"], np.asarray(jenc["w"]))
        np.testing.assert_array_equal(
            codec.dequantize_state(enc, quantized)["w"],
            np.asarray(jax_codec.dequantize_state(jenc, jquantized)["w"]))
    with pytest.raises(ValueError, match="unknown quantized dtype"):
        codec.quantize_state(state, "fp4")
    with pytest.raises(ValueError, match="unknown dtype"):
        codec.dequantize_state(enc, {"w": {"codec": "fp4"}})


def test_checkpoint_manifest_and_restore_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    state = {"b": [rng.standard_normal(3).astype(np.float32),
                   np.arange(5, dtype=np.int32)],
             "a": {"z": np.ones((2, 2), np.float32), "y": None},
             "X_train": rng.standard_normal((2, 4)).astype(np.float32)}
    ckpt.save_checkpoint(str(tmp_path / "port"), 3, state)
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 3, state)
    mine = ckpt.read_manifest(str(tmp_path / "port"))
    theirs = jax_ckpt.read_manifest(str(tmp_path / "jax"))
    for key in ("step", "paths", "shapes", "dtypes"):
        assert mine[key] == theirs[key], key
    like = {"b": [torch.zeros(3), np.zeros(5, np.int32)],
            "a": {"z": torch.zeros((2, 2)), "y": None},
            "X_train": np.zeros((2, 4), np.float32)}
    for src in ("port", "jax"):
        got, step = ckpt.restore_checkpoint(str(tmp_path / src), like)
        assert step == 3 and got["a"]["y"] is None
        assert isinstance(got["b"][0], torch.Tensor)
        np.testing.assert_array_equal(got["b"][0].numpy(), state["b"][0])
        np.testing.assert_array_equal(got["b"][1], state["b"][1])
        np.testing.assert_array_equal(got["X_train"], state["X_train"])
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_checkpoint(str(tmp_path / "port"), {"a": np.zeros(1)})


def test_async_saves_commit_atomically(tmp_path):
    base = str(tmp_path / "ck")
    assert ckpt.latest_step(base) is None
    with pytest.raises(FileNotFoundError):
        ckpt.read_manifest(base)
    for step in (1, 5, 2):
        ckpt.save_checkpoint(base, step, {"w": torch.full((3,), step)},
                             blocking=False)
    ckpt.wait_for_async_saves()
    (tmp_path / "ck" / "step_9.tmp").mkdir()        # a crashed write
    assert ckpt.latest_step(base) == 5
    got, _ = ckpt.restore_checkpoint(base, {"w": torch.zeros(3)})
    assert torch.equal(got["w"], torch.full((3,), 5.0))
    jax_got, _ = jax_ckpt.restore_checkpoint(base, {"w": jnp.zeros(3)},
                                             step=2)
    np.testing.assert_array_equal(np.asarray(jax_got["w"]), [2.0] * 3)
    shutil.rmtree(tmp_path / "ck")
