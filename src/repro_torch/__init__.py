"""PyTorch port of ``repro``: communication-region profiling on an H100.

Slice 1 carries the paper's workflow for kripke and the compiled (HLO)
layer: the trace substrate, the reduction backend with its CUDA
segmented-reduce kernel, the profilers, the Thicket ``Frame`` and the
SPMD shim.  Slice 2 carries the dense LM's serving path (``configs``,
``models``, ``serve_lm``) with attention in two CUDA kernels, flash
(prefill) and decode.  Entry points run on the CUDA card unless the caller
passes ``device="cpu"`` (see :mod:`repro_torch.core.backend`).
"""
