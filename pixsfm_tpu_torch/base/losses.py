"""Robust loss functions (Ceres-compatible rho semantics).

Port of ``pixsfm_tpu/base/losses.py``. Ceres convention: ``rho(s)`` operates
on the *squared* residual norm ``s = ||r||^2`` and solvers use ``rho'(s)`` as
the IRLS weight. All functions act elementwise on tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["robust_loss", "loss_weight", "RobustLoss", "make_loss"]


def _rho(name: str, s, params: Sequence[float]):
    name = name.lower()
    if name == "trivial":
        return s
    if name == "scaled":
        return params[0] * s
    if name == "huber":
        a = params[0]
        a2 = a * a
        return torch.where(s <= a2, s,
                           2.0 * a * torch.sqrt(torch.clamp(s, min=0.0)) - a2)
    if name in ("soft_l1", "softlone", "softl1"):
        a2 = params[0] * params[0]
        return 2.0 * a2 * (torch.sqrt(1.0 + s / a2) - 1.0)
    if name == "cauchy":
        a2 = params[0] * params[0]
        return a2 * torch.log1p(s / a2)
    if name == "arctan":
        a = params[0]
        return a * torch.atan2(s, torch.full_like(s, a))
    if name == "tukey":
        a2 = params[0] * params[0]
        inside = a2 / 3.0 * (1.0 - (1.0 - s / a2) ** 3)
        return torch.where(s <= a2, inside, torch.full_like(s, a2 / 3.0))
    raise ValueError(f"unknown loss {name!r}")


def _drho(name: str, s, params: Sequence[float]):
    name = name.lower()
    if name == "trivial":
        return torch.ones_like(s)
    if name == "scaled":
        return torch.full_like(s, params[0])
    if name == "huber":
        a = params[0]
        return torch.where(s <= a * a, torch.ones_like(s),
                           a / torch.sqrt(torch.clamp(s, min=1e-20)))
    if name in ("soft_l1", "softlone", "softl1"):
        a2 = params[0] * params[0]
        return 1.0 / torch.sqrt(1.0 + s / a2)
    if name == "cauchy":
        a2 = params[0] * params[0]
        return 1.0 / (1.0 + s / a2)
    if name == "arctan":
        a = params[0]
        return a * a / (a * a + s * s)
    if name == "tukey":
        a2 = params[0] * params[0]
        return torch.where(s <= a2, (1.0 - s / a2) ** 2, torch.zeros_like(s))
    raise ValueError(f"unknown loss {name!r}")


def _d2rho(name: str, s, params: Sequence[float]):
    """rho''(s): query bundle adjustment's exact Hessian needs it."""
    name = name.lower()
    if name in ("trivial", "scaled"):
        return torch.zeros_like(s)
    if name == "huber":
        a = params[0]
        return torch.where(s <= a * a, torch.zeros_like(s),
                           -0.5 * a * torch.clamp(s, min=1e-20) ** -1.5)
    if name in ("soft_l1", "softlone", "softl1"):
        a2 = params[0] * params[0]
        return -0.5 / a2 * (1.0 + s / a2) ** -1.5
    if name == "cauchy":
        a2 = params[0] * params[0]
        return -1.0 / (a2 * (1.0 + s / a2) ** 2)
    if name == "arctan":
        a2 = params[0] * params[0]
        return -2.0 * a2 * s / (a2 + s * s) ** 2
    if name == "tukey":
        a2 = params[0] * params[0]
        return torch.where(s <= a2, -2.0 / a2 * (1.0 - s / a2),
                           torch.zeros_like(s))
    raise ValueError(f"unknown loss {name!r}")


class RobustLoss:
    """rho(s) on squared norms; ``weight`` is rho'(s) for IRLS reweighting."""

    def __init__(self, name: str = "trivial",
                 params: Optional[Sequence[float]] = None,
                 scale: float = 1.0):
        self.name = name
        self.params = list(params or [])
        self.scale = scale  # outer ScaledLoss factor

    def __call__(self, s):
        return self.scale * _rho(self.name, s, self.params)

    def weight(self, s):
        return self.scale * _drho(self.name, s, self.params)

    def weight_derivative(self, s):
        """rho''(s), scaled like :meth:`weight`."""
        return self.scale * _d2rho(self.name, s, self.params)

    def __repr__(self):
        return f"RobustLoss({self.name}, {self.params}, scale={self.scale})"


def make_loss(conf=None, scale: float = 1.0) -> RobustLoss:
    """Build from a ``{name, params}`` config subtree."""
    if conf is None:
        return RobustLoss("trivial", scale=scale)
    if isinstance(conf, RobustLoss):
        return conf
    name = conf.get("name", "trivial") if hasattr(conf, "get") else conf["name"]
    params = conf.get("params", []) if hasattr(conf, "get") else conf["params"]
    return RobustLoss(name, list(params or []), scale=scale)


def robust_loss(name, s, params=()):
    """rho(s) of the loss ``name`` (unscaled)."""
    return _rho(name, s, params)


def loss_weight(name, s, params=()):
    """rho'(s) of the loss ``name``, the IRLS weight (unscaled)."""
    return _drho(name, s, params)
