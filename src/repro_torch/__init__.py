"""PyTorch/CUDA port of the Pregelix engine (``repro``, the JAX package,
is its reference). Slice 1: the in-memory superstep engine on one device
— ``load_graph`` -> ``run_host`` / ``run_jit`` -> ``gather_values`` — with
the D7 sender fold and the D3 edge gather in hand-written Hopper kernels.
"""
