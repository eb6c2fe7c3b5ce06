"""The precision of the plain reference's matrix products.

Every product of activations with weights in the reference goes through
`Precision.mm`, so the reference can be run at the precision the
configuration states ("fp32": float32 operands, TF32 off) and, as the
control that has to fail the comparison, one step below it ("tf32":
operands rounded to TF32's 10-bit mantissa, the step below float32 with
TF32 off, products summed in float32).

The rounding is done here, in plain tensor code, so the control reads
the same on the CPU as on the card. The rounded operand passes its
gradient straight through, so a training step runs under the control.
"""
from __future__ import annotations

import contextlib

import torch

MODES = ("fp32", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (ties to even), as float32."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & -0x2000
    return bits.view(torch.float32)


class Precision:
    def __init__(self, mode: str = "fp32"):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r} is not one of {MODES}")
        self.mode = mode

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.mode == "fp32":
            return x
        return x + (round_tf32(x.detach()) - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.operand(a) @ self.operand(b)


@contextlib.contextmanager
def exact_float32():
    """float32 products computed in float32 on the card (TF32 off) for
    the duration; the previous settings come back after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
