"""Checkpoints, failure management and the chaos harness of the port
(paper Sections 5.5 and 5.7), the npz and the out-of-core checkpoints."""
from repro_torch.runtime.checkpoint import (CheckpointCorruption,
                                            latest_checkpoint,
                                            latest_ooc_checkpoint,
                                            load_checkpoint, load_ooc_meta,
                                            ooc_checkpoints, repartition,
                                            save_checkpoint,
                                            save_ooc_checkpoint,
                                            verify_ooc_checkpoint)
from repro_torch.runtime.failure import (FailureManager, StragglerMonitor,
                                         WorkerFailure)
from repro_torch.runtime.faults import (FaultInjector, FaultPlan, FaultSpec,
                                        InjectedFault)

__all__ = ["latest_checkpoint", "load_checkpoint", "repartition",
           "save_checkpoint", "save_ooc_checkpoint",
           "verify_ooc_checkpoint", "ooc_checkpoints",
           "latest_ooc_checkpoint", "load_ooc_meta",
           "CheckpointCorruption", "FailureManager", "StragglerMonitor", "WorkerFailure", "FaultInjector",
           "FaultPlan", "FaultSpec", "InjectedFault"]
