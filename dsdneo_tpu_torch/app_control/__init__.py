"""app_control: the UI-facing boundary — metric snapshots + command queue.

The rebuild of the reference's app_control layer
(src/app_control/app_command_queue.c, include/dsd-neo/app_control/
frontend.h): frontends never touch live decoder state; they poll
published immutable snapshots and enqueue typed commands that the
engine drains between blocks.

The port's own copy of ``dsdneo_tpu/app_control/__init__.py`` (host Python,
numpy), unchanged in its logic.
"""

from dsdneo_tpu_torch.app_control.snapshot import (DecodeHealth, FrontendMetrics,
                                             MetricsHub)
from dsdneo_tpu_torch.app_control.commands import AppCommand, CommandQueue

__all__ = ["AppCommand", "CommandQueue", "DecodeHealth", "FrontendMetrics",
           "MetricsHub"]
