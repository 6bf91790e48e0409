from .scheduler import ExecGroup, SigSched, WaveState
from .signal_service import (GroupInfo, SignalRequest, SignalService,
                             StreamSession)

__all__ = ["SignalService", "SignalRequest", "StreamSession", "GroupInfo",
           "SigSched", "WaveState", "ExecGroup"]
