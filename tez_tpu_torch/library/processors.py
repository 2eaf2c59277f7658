"""Stock processors.

Reference parity: tez-runtime-library/.../library/processor/
{SimpleProcessor,SleepProcessor}.java.

The port's copy of tez_tpu.library.processors.
"""
from __future__ import annotations

import time
from typing import Dict

from tez_tpu_torch.api.runtime import (LogicalIOProcessor, LogicalInput,
                                       LogicalOutput)


class SimpleProcessor(LogicalIOProcessor):
    """Base for processors that just need run(); IOs are started by the
    framework (reference: SimpleProcessor.java)."""

    def initialize(self) -> None:
        pass

    def run(self, inputs: Dict[str, LogicalInput],
            outputs: Dict[str, LogicalOutput]) -> None:
        pass

    def close(self) -> None:
        pass


class SleepProcessor(SimpleProcessor):
    """Sleeps for payload-configured ms; used by tests and pre-warm
    (reference: SleepProcessor.java)."""

    def run(self, inputs: Dict[str, LogicalInput],
            outputs: Dict[str, LogicalOutput]) -> None:
        payload = self.context.user_payload.load() or {}
        ms = payload.get("sleep_ms", 1) if isinstance(payload, dict) else 1
        time.sleep(ms / 1000.0)
