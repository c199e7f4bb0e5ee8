"""Simulation time: int64 nanoseconds since simulation start
(counterpart of shadow1_tpu/core/simtime.py; constants are plain ints)."""

from __future__ import annotations

import torch

SIMTIME_ONE_NANOSECOND = 1
SIMTIME_ONE_MICROSECOND = 1_000
SIMTIME_ONE_MILLISECOND = 1_000_000
SIMTIME_ONE_SECOND = 1_000_000_000
SIMTIME_ONE_MINUTE = 60 * SIMTIME_ONE_SECOND
SIMTIME_ONE_HOUR = 60 * SIMTIME_ONE_MINUTE

# "No event pending": int64 max, so a plain min over candidates ignores it.
SIMTIME_INVALID = (1 << 63) - 1
SIMTIME_MAX = SIMTIME_INVALID - 1

EMULATED_TIME_OFFSET = 946_684_800 * SIMTIME_ONE_SECOND

TIME_DTYPE = torch.int64

