"""Hyper-parameters of the elastic-averaging family (``repro/core/easgd.py``:
``EASGDConfig`` only — the pytree update rules belong to the multi-pod
slice, which is not ported yet)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EASGDConfig:
    """η learning rate, ρ elastic strength, μ momentum, τ communication
    period (workers exchange every ``tau`` local steps)."""

    eta: float = 0.01
    rho: float = 0.01
    mu: float = 0.9
    tau: int = 1

    @property
    def alpha(self) -> float:
        """Elastic step size α = η·ρ (the EASGD paper's notation)."""
        return self.eta * self.rho
