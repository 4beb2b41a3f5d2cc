"""Distributed execution of the port (``repro.dist``): sharding rules as
DTensor placements, ring attention, pipelining.

Modules
-------
sharding        path-based partition-spec rules over a ("data", "model")
                mesh, and their placement as DTensors
ctx             the logits / activation specs of a ModelConfig, and the
                data-parallel context of the sharded training step
ring_attention  sequence-parallel exact attention over a process-group ring
pipeline        streamed microbatch pipeline over a stage axis
"""
from repro_torch.dist import ctx, pipeline, ring_attention, sharding

__all__ = ["ctx", "pipeline", "ring_attention", "sharding"]
