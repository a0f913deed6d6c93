"""Track state machine basics, copied from ``deft_tpu/tracking/basetrack.py``
(the reference DEFT's ``src/lib/utils/basetrack.py``)."""

from __future__ import annotations

import itertools


class TrackState:
    New = 0
    Tracked = 1
    Lost = 2
    Removed = 3


class IdAllocator:
    """Monotonic track-id source.

    The reference uses a class-global counter (basetrack.py:22-25); an
    explicit allocator object keeps ids unique across the per-class trackers
    of nuScenes while staying resettable per sequence (test.py re-creates it
    on reset_tracking).
    """

    def __init__(self):
        self._counter = itertools.count(1)

    def next_id(self) -> int:
        return next(self._counter)

    def reset(self):
        self._counter = itertools.count(1)


class BaseTrack:
    track_id = 0
    is_activated = False
    state = TrackState.New
    history = None
    features = None
    curr_feature = None
    score = 0.0
    start_frame = 0
    frame_id = 0
    time_since_update = 0

    @property
    def end_frame(self) -> int:
        return self.frame_id

    def mark_lost(self):
        self.state = TrackState.Lost

    def mark_removed(self):
        self.state = TrackState.Removed
