"""The umbilical's messages: what a runner's heartbeat carries up to the AM
and what comes back down.

The port's copy of HeartbeatRequest and HeartbeatResponse from
tez_tpu.am.task_comm (reference: TezHeartbeatRequest/Response).  The
umbilical itself (TaskCommunicator) comes with the AM.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from tez_tpu_torch.api.events import TezAPIEvent, TezEvent
from tez_tpu_torch.common.counters import TezCounters
from tez_tpu_torch.common.ids import TaskAttemptId


@dataclasses.dataclass
class HeartbeatRequest:
    attempt_id: TaskAttemptId
    events: List[TezEvent]
    counters: Optional[TezCounters] = None
    progress: float = 0.0
    #: AM epoch stamped into the runner's TaskSpec (0 = unstamped/legacy)
    epoch: int = 0
    #: Streaming window coordinate of the generalized fence (0 = batch)
    window_id: int = 0
    #: Stream identity the window belongs to ("" = not streaming)
    stream: str = ""


@dataclasses.dataclass
class HeartbeatResponse:
    events: List[TezAPIEvent]
    should_die: bool = False
