"""Multi-chip scaling: batched PBS over a device mesh.

The reference's only parallelism is rayon within one process (SURVEY.md §2);
this library scales as SPMD over a device mesh:
- **dp** (the scaling unit): thousands of independent bootstraps sharded on
  the ciphertext batch axis; key material replicated;
- **tp**: the external-product MAC sharded over the GGSW level axis and the
  keyswitch contraction sharded over the input-key axis, partial results
  combined with psum over the device interconnect.
"""

from .mesh import (
    make_mesh,
    gate_pipeline_dp,
    gate_pipeline_dp_tp,
    gate_pipeline_dp_tp_mxu,
    gate_pipeline_dp_tp_nuss,
)

__all__ = [
    "make_mesh",
    "gate_pipeline_dp",
    "gate_pipeline_dp_tp",
    "gate_pipeline_dp_tp_mxu",
    "gate_pipeline_dp_tp_nuss",
]
