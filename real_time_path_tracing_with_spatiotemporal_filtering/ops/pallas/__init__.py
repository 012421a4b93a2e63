"""Pallas kernels for the GPU (Triton route).

``pathtrace``: the per-pixel path-trace kernel, the hot pass of the frame.
The other passes stay XLA fusions inside the one jitted frame program.
"""
