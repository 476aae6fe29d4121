"""Scoring parameters as torch tensors.

Port of ``lightdock_tpu/engine/gso_jax.py`` ``device_params``: the NumPy
``BatchScoringParams`` built by the shared host layer
(``energy_batch.build_batch_params``) is carried across field by field,
floating arrays cast to the run dtype, integer arrays to int64 (torch's
index type).  Both packages are fed from the same NumPy object.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lightdock_tpu.engine.energy_batch import BatchScoringParams

_STATIC_FIELDS = ("method", "use_anm", "rec_num_membrane")
_ARRAY_FIELDS = tuple(f.name for f in dataclasses.fields(BatchScoringParams)
                     if f.name not in _STATIC_FIELDS)

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def torch_params(params: BatchScoringParams, device,
                 dtype: torch.dtype) -> BatchScoringParams:
    """Copy ``params`` with every array field as a tensor on ``device``."""
    if dtype not in _NP_DTYPE:
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    np_dtype = _NP_DTYPE[dtype]

    def conv(x):
        if x is None:
            return None
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            x = x.astype(np_dtype)
        else:
            x = x.astype(np.int64)
        return torch.as_tensor(x, device=device)

    return dataclasses.replace(
        params, **{name: conv(getattr(params, name)) for name in _ARRAY_FIELDS})
