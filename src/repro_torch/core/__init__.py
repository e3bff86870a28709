"""Pregelix core of the port: Pregel semantics as an iterative dataflow
of relational operators (join + group-by + connectors) over torch
tensors, with physical plan flexibility."""
from repro_torch.core.driver import (RunResult, default_engine_config,
                                     run_host, run_jit)
from repro_torch.core.plan import (DEFAULT_PLAN, SPARSE_PLAN, STORAGES,
                                   PhysicalPlan)
from repro_torch.core.program import ComputeOut, VertexProgram
from repro_torch.core.relations import (N_OVERFLOW, OVF_BUCKET, OVF_EDGE,
                                        OVF_FRONTIER, OVF_MUTATION,
                                        GlobalState, MsgRel, VertexRel,
                                        empty_msgs, gather_values,
                                        gs_from_numpy, gs_to_numpy, init_gs,
                                        load_graph,
                                        msgs_from_numpy, msgs_to_numpy,
                                        out_degrees, vertex_from_numpy,
                                        vertex_to_numpy)
from repro_torch.core.superstep import EngineConfig, make_superstep

__all__ = [
    "RunResult", "default_engine_config", "run_host", "run_jit",
    "DEFAULT_PLAN", "SPARSE_PLAN", "STORAGES", "PhysicalPlan", "ComputeOut",
    "VertexProgram", "GlobalState", "MsgRel", "VertexRel", "empty_msgs",
    "gather_values", "init_gs", "load_graph", "out_degrees",
    "vertex_from_numpy", "vertex_to_numpy", "msgs_from_numpy",
    "msgs_to_numpy", "gs_from_numpy", "gs_to_numpy",
    "N_OVERFLOW", "OVF_BUCKET", "OVF_FRONTIER", "OVF_MUTATION", "OVF_EDGE",
    "EngineConfig", "make_superstep",
]
