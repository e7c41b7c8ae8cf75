"""The packed single-device fit."""

from .distributed import (fused_linear_fit_packed, pack_design,
                          unpack_fit_result)
