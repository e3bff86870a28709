"""Checkpoints, failure management and the chaos harness of the port
(paper Sections 5.5 and 5.7). The out-of-core checkpoint functions come
with the out-of-core slice."""
from repro_torch.runtime.checkpoint import (CheckpointCorruption,
                                            latest_checkpoint,
                                            load_checkpoint, repartition,
                                            save_checkpoint)
from repro_torch.runtime.failure import (FailureManager, StragglerMonitor,
                                         WorkerFailure)
from repro_torch.runtime.faults import (FaultInjector, FaultPlan, FaultSpec,
                                        InjectedFault)

__all__ = ["latest_checkpoint", "load_checkpoint", "repartition",
           "save_checkpoint", "CheckpointCorruption", "FailureManager",
           "StragglerMonitor", "WorkerFailure", "FaultInjector",
           "FaultPlan", "FaultSpec", "InjectedFault"]
