"""ComputePolicy: one frozen object for every compute-path knob.

Fields (all tri-state: None = auto, True/False = explicit):

    embed_fused   extend_embed kernel (serving embed).
    assign_fused  kmeans_assign kernel (serving assign).
    fit_fused     fit_sketch kernel (training block update).
    interpret     acknowledges that the kernel path runs on CPU tensors,
                  where every wrapper runs its plain PyTorch version (the
                  counterpart of Pallas interpret mode). It chooses
                  nothing: the tensors' device does. It only decides
                  whether a request warns or conflicts, by the JAX rules.

The JAX package resolved a field against the default backend; the port
resolves it against the device of the tensors the path will see, which a
caller always states. The conflict rules are the JAX package's.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch


def resolve_kernel_path(fused: Optional[bool], interpret: Optional[bool],
                        what: str, device) -> bool:
    """Resolve a (fused, interpret) request on `device`: whether to take
    the kernel path. On CPU tensors the kernel path runs the plain
    versions; `interpret` only feeds the checks below.

      fused=None       the kernel on a CUDA device; on the CPU only when
                       interpret=True explicitly opts in.
      fused=True, CPU  honoured through the plain version, warning unless
                       interpret=True was passed.
      fused=True, interpret=False, CPU   ValueError: the CUDA kernel
                       cannot run on CPU tensors.
      fused=False, interpret set         ValueError: interpret only
                       applies to the kernel path.
      interpret=True, CUDA               ValueError: the plain version
                       stands in for a kernel only on the CPU.
    """
    cpu = torch.device(device).type == "cpu"
    if fused is False:
        if interpret is not None:
            raise ValueError(
                f"{what}: fused=False conflicts with interpret={interpret} "
                f"— the interpret flag only applies to the kernel path")
        return False
    if fused is None and cpu and interpret is not True:
        return False
    if cpu:
        if interpret is False:
            raise ValueError(
                f"{what}: the kernel path was requested with "
                f"interpret=False for CPU tensors, where the CUDA kernel "
                f"cannot run — drop interpret=False or run on the card")
        if interpret is None:
            warnings.warn(
                f"{what}: kernel path requested for CPU tensors; running "
                f"its plain version (pass interpret=True to acknowledge, "
                f"or fused=False for the unfused path)", stacklevel=3)
        return True
    if interpret:
        raise ValueError(
            f"{what}: interpret=True runs the plain version, which stands "
            f"in for a kernel only on the CPU; on {device} the kernel runs")
    return True


@dataclasses.dataclass(frozen=True)
class ComputePolicy:
    """Frozen compute-path selection, shared by fit and serve; compares
    by value."""

    embed_fused: Optional[bool] = None
    assign_fused: Optional[bool] = None
    fit_fused: Optional[bool] = None
    interpret: Optional[bool] = None

    def resolve_embed(self, device, where: str = "fused extend_embed stripe"
                      ) -> bool:
        return resolve_kernel_path(self.embed_fused, self.interpret, where,
                                   device)

    def resolve_assign(self, device, where: str = "kmeans_assign kernel"
                       ) -> bool:
        return resolve_kernel_path(self.assign_fused, self.interpret, where,
                                   device)

    def resolve_fit(self, device, where: str = "fused fit_sketch accumulate"
                    ) -> bool:
        return resolve_kernel_path(self.fit_fused, self.interpret, where,
                                   device)
