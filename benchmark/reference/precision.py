"""The precision a reference computes its products in.

``FP32`` is float32 throughout, TF32 off.  ``TF32`` rounds every operand
of a product to TF32's 10-bit mantissa first, as the tensor cores do, so
that the lower precision holds whatever cuBLAS picks for a shape: the
benchmark's control (the reference in the program's place, one precision
below the configuration's float32)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def no_tf32() -> None:
    """Float32 products in float32 (PyTorch may otherwise pick TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, ties to even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    round: Callable[[torch.Tensor], torch.Tensor]

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.round(a), self.round(b))

    def einsum(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *(self.round(o) for o in ops))


FP32 = Precision("float32", lambda x: x)
TF32 = Precision("tf32", round_tf32)
