"""AdamW, written out (the port of repro/train/optimizer.py).

The same config (`AdamWConfig`, the same fields and defaults) and the same
arithmetic, operation for operation, in f32: the moments in
`cfg.moment_dtype` (f32 by default, bf16 for the giants), the bias
corrections c1 = 1 - b1 ** step and c2 as f32 tensors on the step's device,
decoupled weight decay, the new parameter (p.f32 - lr * delta) cast back to
the parameter's dtype.

Two differences of form. The state is a dict of tensors keyed by the
parameters' names, {"m": {name: tensor}, "v": {name: tensor}, "step": an
int32 0-d tensor}, and `adamw_update` writes the parameters and moments in
place (the port's train state is updated in place: a second copy of a
training state would not fit beside the first on one card). And the set of
parameters to decay is given (`decay`): JAX decays a leaf when its ndim >=
2, and its leaves are the port's tensors stacked over the layers of a scan,
so a per-layer norm scale is 1-D here but decayed there.
`repro_torch.models.convert.decayed_names` gives a model's set.

Each leaf is updated in slices of at most `CHUNK` elements (the update is
elementwise, so the slicing changes no bit): the f32 temporaries of one
slice are all that the update adds to the state, whatever the leaf's size
(phi4-mini's embedding is 614.6 M elements, 2.46 GB in f32).
"""
from __future__ import annotations

import dataclasses
from typing import Collection, Dict, Mapping, Tuple

import torch

CHUNK = 1 << 26             # elements of a leaf updated at once (256 MB f32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"


def adamw_init(params: Mapping[str, torch.Tensor], cfg: AdamWConfig) -> Dict:
    """Zero moments in cfg.moment_dtype beside each parameter, step 0."""
    dt = getattr(torch, cfg.moment_dtype)
    device = next(iter(params.values())).device if params else None

    def zeros():
        return {name: torch.zeros(p.shape, dtype=dt, device=p.device)
                for name, p in params.items()}

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _update(p, g, m, v, c1, c2, cfg: AdamWConfig, decay: bool) -> None:
    """optimizer.py:45 `upd` on one slice, written into p, m and v."""
    b1, b2 = cfg.b1, cfg.b2
    gf = g.float()
    m32 = b1 * m.float() + (1 - b1) * gf
    v32 = b2 * v.float() + (1 - b2) * gf * gf
    del gf
    delta = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
    m.copy_(m32)
    v.copy_(v32)
    del m32, v32
    if decay:
        delta = delta + cfg.weight_decay * p.float()
    p.copy_(p.float() - cfg.lr * delta)


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], opt_state: Dict,
                 cfg: AdamWConfig, *, decay: Collection[str]
                 ) -> Tuple[Mapping[str, torch.Tensor], Dict]:
    """One AdamW step on every parameter, in place; returns (params,
    opt_state), the objects given. `decay`: the names decayed (JAX's
    leaves of ndim >= 2)."""
    step = opt_state["step"] + 1
    c1 = 1.0 - torch.pow(cfg.b1, step.float())
    c2 = 1.0 - torch.pow(cfg.b2, step.float())
    for name, p in params.items():
        m, v = opt_state["m"][name], opt_state["v"][name]
        if not all(t.is_contiguous() for t in (p, m, v)):
            raise ValueError(f"{name}: the parameter and its moments are "
                             "updated in place and must be contiguous")
        parts = [t.reshape(-1) for t in (p, grads[name], m, v)]
        for a in range(0, p.numel(), CHUNK):
            _update(*(t[a:a + CHUNK] for t in parts), c1, c2, cfg,
                    name in decay)
    opt_state["step"] = step
    return params, opt_state
