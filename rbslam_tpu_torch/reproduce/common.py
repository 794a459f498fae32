"""What every reproduction script shares: the card's stamp, TF32 off, and
one JSON line per result (the call's output carries the numbers; a file is
written beside it where asked)."""

from __future__ import annotations

import json
import os
import subprocess

import torch
from torch.overrides import TorchFunctionMode

from ..workloads.common import report

_PRODUCTS = frozenset({"matmul", "__matmul__", "__rmatmul__", "mm", "bmm",
                       "mv", "dot", "einsum", "tensordot"})
_ADD_PRODUCTS = frozenset({"baddbmm", "addmm", "addbmm", "addmv"})


def _bf16(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    if isinstance(x, (list, tuple)):
        return type(x)(_bf16(v) for v in x)
    return x


class Bf16MatmulInputs(TorchFunctionMode):
    """Inside this mode every matrix product of float32 tensors (matmul,
    ``@``, mm, bmm, mv, dot, einsum, tensordot, and the products of
    baddbmm, addmm, addbmm, addmv, whose addend is left alone) takes its
    operands rounded to bfloat16 and returns float32: the one-pass
    precision of a float32 product under JAX's default on a TPU, which
    the JAX package's dense paths kept (``rbslam_tpu/engines/rbpf.py``
    turns ``highest`` on for sparse models only). Factorizations and
    solves keep float32. A diagnostic: the port itself never rounds."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in _PRODUCTS:
            args = tuple(_bf16(a) for a in args)
        elif name in _ADD_PRODUCTS:
            args = args[:1] + tuple(_bf16(a) for a in args[1:])
        return func(*args, **(kwargs or {}))


def setup(device) -> torch.device:
    """The device, with TF32 matmuls off: the information-form smoother
    and the batched EKF raise on a CUDA device with them on (they keep W
    by cancellation)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device(device)


def stamp(device) -> dict:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit`` gives them ("cpu" for a CPU run) and the torch
    version."""
    device = torch.device(device)
    card = "cpu"
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            check=True, capture_output=True, text=True).stdout.strip()
    return {"card": card, "torch": torch.__version__}


def emit(result: dict, path=None) -> None:
    """Print ``result`` as one JSON line; with ``path``, also write it
    there (indented, parent directories made)."""
    report(result)
    if path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")


def load(path) -> dict:
    with open(path) as f:
        return json.load(f)
