"""Lazy per-segment recovery gate (paper Sec. 4.8).

Only the access-path half of ``repro.core.recovery`` is ported so far: the
check that finds which touched segments still owe post-crash recovery.
Nothing in the ported paths can leave a segment dirty (crash simulation and
restart come with the recovery slice), so finding one raises.
"""
from __future__ import annotations

import torch

from .layout import DashConfig, DashState


def dirty_touched_segments(state: DashState, touched) -> list:
    """Which of the ``touched`` segment ids (a tensor) still owe post-crash
    recovery (their ``seg_version`` lags the recovery generation)?"""
    touched = touched[touched >= 0].long()
    lag = state.seg_version[touched] != state.gver
    if not bool(lag.any()):
        return []
    return torch.unique(touched[lag]).tolist()


def lazy_recover_touched(cfg: DashConfig, mode: str, state: DashState,
                         touched, note=None):
    """Recover exactly the dirty segments among ``touched``. Returns
    ``(state, recovered_ids)``; recovering a segment is not ported yet."""
    dirty = dirty_touched_segments(state, touched)
    if dirty:
        raise NotImplementedError(
            f"segments {dirty[:8]} need crash recovery, which is not ported yet")
    return state, []
