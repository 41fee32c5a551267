"""Model code of the PyTorch port: weights as `nn.Module`s under the JAX
package's names and layouts, forward passes as plain functions."""

from __future__ import annotations

from typing import Mapping, Union

import torch
from torch import nn


class Weights(nn.Module):
    """Named tensors held as frozen parameters, read like the JAX package's
    parameter dicts (``w["wq"]``).  Subclasses fix the names in ``NAMES``,
    or compute them from the tensors given in `expected_names`; a value
    that is a `Weights` becomes a child module."""

    NAMES: tuple[str, ...] = ()

    @classmethod
    def expected_names(cls, tensors: Mapping) -> tuple[str, ...]:
        return cls.NAMES

    def __init__(self, tensors: Mapping[str, Union[torch.Tensor, nn.Module]]):
        super().__init__()
        names = self.expected_names(tensors)
        if set(tensors) != set(names):
            missing = sorted(set(names) - set(tensors))
            extra = sorted(set(tensors) - set(names))
            raise ValueError(f"{type(self).__name__}: missing {missing}, "
                             f"unexpected {extra}")
        for name in names:
            value = tensors[name]
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def get(self, name: str, default=None):
        return self[name] if name in self else default
