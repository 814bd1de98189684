from repro_torch.runtime.heartbeat import HeartbeatMonitor
from repro_torch.runtime.straggler import StragglerPolicy
from repro_torch.runtime.elastic import ElasticGroup
from repro_torch.runtime.supervisor import TrainSupervisor, SimulatedFailure

__all__ = ["ElasticGroup", "HeartbeatMonitor", "SimulatedFailure",
           "StragglerPolicy", "TrainSupervisor"]
