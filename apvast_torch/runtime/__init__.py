"""The native real-time host runtime: C++ rings and hop framing
(``apvast_rt.cpp``), and the stream host that drives a model from them."""

from apvast_torch.runtime.native import HopFramer, RingBuffer, load_native
from apvast_torch.runtime.stream_host import StreamHost

__all__ = ["HopFramer", "RingBuffer", "StreamHost", "load_native"]
