"""Frequency/amount specs like ``100u``, ``10e``, ``1Mt`` (reference:
src/common/scheduling_parameter.h :: SchedulingParameter::parse). A copy
of ``marian_tpu/common/scheduling_parameter.py``.

Units: t = target labels, e = epochs, u = updates (default when no unit).
Multipliers: k/K = 1e3, m/M = 1e6, g/G = 1e9 (Marian accepts K/M/G; we accept
both cases).
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Union


class SchedulingUnit(Enum):
    TRG_LABELS = "t"
    EPOCHS = "e"
    UPDATES = "u"


@dataclasses.dataclass(frozen=True)
class SchedulingParameter:
    n: int = 0
    unit: SchedulingUnit = SchedulingUnit.UPDATES

    @classmethod
    def parse(cls, spec: Union[str, int, float, "SchedulingParameter"]) -> "SchedulingParameter":
        if isinstance(spec, SchedulingParameter):
            return spec
        if isinstance(spec, (int, float)):
            return cls(int(spec), SchedulingUnit.UPDATES)
        s = str(spec).strip()
        if not s:
            return cls(0, SchedulingUnit.UPDATES)
        unit = SchedulingUnit.UPDATES
        if s[-1] in "teu":
            unit = SchedulingUnit(s[-1])
            s = s[:-1]
        mult = 1
        if s and s[-1] in "kKmMgG":
            mult = {"k": 10**3, "m": 10**6, "g": 10**9}[s[-1].lower()]
            s = s[:-1]
        if not s:
            raise ValueError(f"Malformed scheduling parameter '{spec}'")
        return cls(int(float(s) * mult), unit)

    def __bool__(self) -> bool:
        return self.n != 0

    def __str__(self) -> str:
        return f"{self.n}{self.unit.value}"

    def mult(self, factor: float) -> "SchedulingParameter":
        return SchedulingParameter(int(self.n * factor), self.unit)
