"""Native (C++) runtime components, loaded via ctypes.

The compute path is torch and CUDA; the runtime around it uses C++
where the reference's runtime does (SURVEY §2.1 N19/N23).  Modules
here compile lazily with the system toolchain into a per-user cache
and degrade loudly (ImportError with the compiler output) if the
toolchain is missing.
"""

from .channel import Channel, ChannelClosed  # noqa: F401

__all__ = ["Channel", "ChannelClosed"]
