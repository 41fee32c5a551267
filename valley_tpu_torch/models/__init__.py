"""Model code of the PyTorch port: weights as `nn.Module`s under the JAX
package's names and layouts, forward passes as plain functions."""

from __future__ import annotations

from typing import Mapping, Union

import torch
from torch import nn


class Weights(nn.Module):
    """Named tensors held as frozen parameters, read like the JAX package's
    parameter dicts (``w["wq"]``).  Subclasses fix the names in ``NAMES``;
    a value that is a `Weights` becomes a child module."""

    NAMES: tuple[str, ...] = ()

    def __init__(self, tensors: Mapping[str, Union[torch.Tensor, nn.Module]]):
        super().__init__()
        if set(tensors) != set(self.NAMES):
            missing = sorted(set(self.NAMES) - set(tensors))
            extra = sorted(set(tensors) - set(self.NAMES))
            raise ValueError(f"{type(self).__name__}: missing {missing}, "
                             f"unexpected {extra}")
        for name in self.NAMES:
            value = tensors[name]
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)
