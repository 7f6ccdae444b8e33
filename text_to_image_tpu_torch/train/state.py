"""Train state (counterpart of ``text_to_image_tpu/train/state.py``): both
networks, their BN state, both optimizers, the step counter and ``aux``
(``ema_g_params`` when the generator EMA is on; for StackGAN Stage-II the
frozen Stage-I generator as ``stage1_g_params`` / ``stage1_g_state``), under
the JAX field names.

Parameters are f32 leaf tensors that require grad; the optimizers update
them in place.  BN state tensors carry no autograd history.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from text_to_image_tpu_torch.train.optim import Adam


@dataclasses.dataclass
class TrainState:
    g_params: Dict
    g_state: Dict
    d_params: Dict
    d_state: Dict
    g_opt: Adam
    d_opt: Adam
    step: int = 0
    aux: Dict[str, Any] = dataclasses.field(default_factory=dict)
