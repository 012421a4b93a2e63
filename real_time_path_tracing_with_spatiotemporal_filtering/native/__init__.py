"""Native (C++) runtime components, loaded via ctypes.

The reference's native layer is the Vulkan context/loader plumbing
(context.cpp, tinyobjloader); the analogue here is host-side
scene ingestion and preprocessing in C++ (native/objloader.cpp), with pure
Python fallbacks everywhere so the framework works without a toolchain.
Build with: ``make -C real_time_path_tracing_with_spatiotemporal_filtering/native``.
"""
