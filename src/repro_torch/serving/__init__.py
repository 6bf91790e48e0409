from .engine import DecodeWave, Request, ServingEngine
from .quantized import dequantize_tree, quantize_tree, quantized_bytes
from .scheduler import ExecGroup, SigSched, WaveState
from .signal_mesh import DeviceRouter, SignalMesh, trim_rows
from .signal_service import (CoScheduler, CostBalancedPolicy, GroupInfo,
                             LatencyAwarePolicy, RoundRobinPolicy,
                             SchedulePolicy, SignalRequest, SignalService,
                             StreamSession, TickPlan, get_policy)

__all__ = ["ServingEngine", "Request", "DecodeWave",
           "quantize_tree", "dequantize_tree", "quantized_bytes",
           "SignalService", "SignalRequest", "StreamSession", "GroupInfo",
           "CoScheduler", "SignalMesh", "DeviceRouter", "trim_rows",
           "SigSched", "WaveState", "ExecGroup",
           "TickPlan", "SchedulePolicy", "RoundRobinPolicy",
           "LatencyAwarePolicy", "CostBalancedPolicy", "get_policy"]
