"""Process-wide defaults of the PyTorch port (subset of
``sparkdq4ml_tpu/config.py``): the float and int dtype policy, the
``show()`` row default, and the device a session runs on.

There is no kernel on/off switch: a wrapper in ``ops/kernels.py`` launches
its CUDA kernel on a CUDA tensor and runs its plain PyTorch version on a
CPU tensor, and on nothing else.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class _Config:
    # Default floating dtype for frame columns and solvers: float32 on the
    # card; the CPU parity tests select float64, as the JAX suite does.
    default_float_dtype: torch.dtype = torch.float32
    # Spark CSV inference yields IntegerType -> int32.
    default_int_dtype: torch.dtype = torch.int32
    # Rows shown by Frame.show() when no argument is given (Spark: 20).
    default_show_rows: int = 20
    # Device of a session whose conf does not set spark.torch.device.
    default_device: str = "cuda"


config = _Config()


def float_dtype() -> torch.dtype:
    return config.default_float_dtype


def int_dtype() -> torch.dtype:
    return config.default_int_dtype


def wide_types() -> bool:
    """True under the float64 policy: the counterpart of JAX's x64 mode,
    where 64-bit numpy inputs keep their width instead of narrowing."""
    return config.default_float_dtype == torch.float64


@contextlib.contextmanager
def float_policy(dtype: torch.dtype):
    """Run a block under another float dtype, restoring the old one."""
    old = config.default_float_dtype
    config.default_float_dtype = dtype
    try:
        yield
    finally:
        config.default_float_dtype = old


_NUMPY_OF = {torch.float32: np.float32, torch.float64: np.float64,
             torch.int32: np.int32, torch.int64: np.int64,
             torch.bool: np.bool_}


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(_NUMPY_OF[dtype])


def check_device(device) -> torch.device:
    """The device a caller asked for, refusing a CUDA device that is absent:
    the port never continues on the CPU when the card was asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was requested but no CUDA device is "
            "present; set spark.torch.device=cpu to run on the CPU")
    return dev


def resolve_device(device=None) -> torch.device:
    """``device`` if given, else the active session's, else the default."""
    if device is not None:
        return check_device(device)
    from .session import TorchSession

    active = TorchSession.active()
    if active is not None:
        return active.device
    return check_device(config.default_device)


def as_tensor(values, dtype: torch.dtype = None) -> torch.Tensor:
    """Tensor of ``values``: a tensor keeps its device, anything else goes
    to the resolved device (see :func:`resolve_device`)."""
    if isinstance(values, torch.Tensor):
        return values if dtype is None else values.to(dtype)
    return torch.as_tensor(np.asarray(values), dtype=dtype,
                           device=resolve_device())
