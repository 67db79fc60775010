from repro_torch.runtime.fault import DriverConfig, RunReport, SimulatedFailure, run
from repro_torch.runtime.straggler import StragglerMonitor, StragglerEvent
