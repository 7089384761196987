"""Core types shared by the serving layer (the port keeps its own copy of
the reference's ``core/types.py`` pieces it needs: ``SLO``)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SLO:
    ttft: float                      # seconds (scheduler steps in the engine)
    tpot: float                      # seconds / token

    def scaled(self, f: float) -> "SLO":
        return SLO(self.ttft * f, self.tpot * f)
