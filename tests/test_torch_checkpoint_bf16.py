"""bf16 leaves in the port's checkpoints, in both directions with the JAX
package: the port writes a bf16 tensor as JAX writes an ml_dtypes
bfloat16 array (its raw words under the .npy descr '<V2', "bfloat16" in
the manifest's dtypes), and reads JAX's bf16 leaves back bit for bit."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import checkpoint as jckpt
from repro_torch.distributed import checkpoint as ckpt


def _bf16(seed=0, shape=(3, 5, 7)) -> torch.Tensor:
    t = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    t.view(-1)[:4] = torch.tensor([0.0, -0.0, float("inf"), 1e-40])
    return t.to(torch.bfloat16)


def _words(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def test_bf16_tensor_round_trips_bit_for_bit(tmp_path):
    state = {"w": _bf16(), "step": torch.tensor(4, dtype=torch.int32),
             "m": torch.randn(6)}
    ckpt.save_checkpoint(str(tmp_path), 4, state)
    like = {k: torch.zeros_like(v) for k, v in state.items()}
    got, step = ckpt.restore_checkpoint(str(tmp_path), like)
    assert step == 4 and got["w"].dtype == torch.bfloat16
    assert np.array_equal(_words(got["w"]), _words(state["w"]))
    assert torch.equal(got["m"], state["m"])
    assert int(got["step"]) == 4


def test_bf16_save_is_a_snapshot(tmp_path):
    """An asynchronous save copies the leaves first: a state updated in
    place after the call (the train state) does not change the files."""
    w = _bf16()
    want = _words(w).copy()
    ckpt.save_checkpoint(str(tmp_path), 1, {"w": w}, blocking=False)
    w.add_(1.0)
    ckpt.wait_for_async_saves()
    got, _ = ckpt.restore_checkpoint(str(tmp_path), {"w": w})
    assert np.array_equal(_words(got["w"]), want)


def test_jax_bf16_leaf_restores_into_the_port(tmp_path):
    t = _bf16(1)
    arr = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    jckpt.save_checkpoint(str(tmp_path), 2, {"a": arr, "b": jnp.ones(3)})
    got, step = ckpt.restore_checkpoint(
        str(tmp_path), {"a": torch.zeros(t.shape, dtype=torch.bfloat16),
                        "b": torch.zeros(3)})
    assert step == 2
    assert np.array_equal(_words(got["a"]),
                          np.asarray(arr).view(np.int16))
    assert np.array_equal(_words(got["a"]), _words(t))


@pytest.mark.parametrize("like", (torch.float32, torch.bfloat16))
def test_bf16_leaf_casts_to_the_like(tmp_path, like):
    t = _bf16(2)
    ckpt.save_checkpoint(str(tmp_path), 0, {"a": t})
    got, _ = ckpt.restore_checkpoint(str(tmp_path),
                                     {"a": torch.zeros(t.shape, dtype=like)})
    assert got["a"].dtype == like
    assert torch.equal(got["a"].float(), t.float())


def test_port_writes_jax_bytes(tmp_path):
    t = _bf16(3)
    arr = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 5,
                          {"a": arr, "b": jnp.arange(4, dtype=jnp.int32)})
    ckpt.save_checkpoint(str(tmp_path / "port"), 5,
                         {"a": t, "b": torch.arange(4, dtype=torch.int32)})
    for i in range(2):
        name = f"step_5/leaf_{i}.npy"
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    man = {k: json.loads((tmp_path / k / "step_5" / "manifest.json")
                         .read_text()) for k in ("jax", "port")}
    for key in ("dtypes", "shapes", "paths", "step"):
        assert man["port"][key] == man["jax"][key], key
    assert man["port"]["dtypes"] == ["bfloat16", "int32"]
    assert np.load(tmp_path / "port" / "step_5" / "leaf_0.npy").dtype == \
        np.dtype("V2")
