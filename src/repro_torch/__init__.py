"""PyTorch/CUDA port of the ESG reproduction.

Imports torch, numpy and the standard library only.  The numpy control
plane (``configs``, ``core``, ``cluster``, ``gpu``, ``obs``, ``serving``)
is a copy of the reference package's, so the port shares no module with
it; the model, kernels, executor and launchers are ported to PyTorch with
hand-written CUDA kernels for Hopper under ``kernels/*/csrc``.
"""
