from .signal_service import GroupInfo, SignalRequest, SignalService

__all__ = ["SignalService", "SignalRequest", "GroupInfo"]
