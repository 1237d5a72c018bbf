"""TrainingState: everything needed for exact resume, serialized to
``<model>.progress.yml`` (reference: src/training/training_state.h ::
TrainingState::save/load). A copy of
``marian_tpu/training/training_state.py``; field names kept
Marian-compatible."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..common import io as mio


@dataclasses.dataclass
class TrainingState:
    epochs: int = 0                 # completed epochs
    batches: int = 0                # total updates
    batches_epoch: int = 0          # updates in current epoch
    samples_epoch: int = 0          # sentences seen in current epoch
    labels_total: int = 0           # total target labels
    stalled: int = 0                # consecutive non-improved validations
    max_stalled: int = 0
    validators: Dict[str, dict] = dataclasses.field(default_factory=dict)
    eta: float = 0.0                # current LR (for display)
    factor: float = 1.0             # accumulated --lr-decay factor
    warmed_up: bool = False
    corpus: Optional[dict] = None   # CorpusState snapshot
    seed: int = 1

    def new_epoch(self) -> None:
        self.epochs += 1
        self.batches_epoch = 0
        self.samples_epoch = 0

    def save(self, path: str) -> None:
        mio.save_yaml(path, dataclasses.asdict(self))

    @classmethod
    def load(cls, path: str) -> "TrainingState":
        data = mio.load_yaml(path)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})
