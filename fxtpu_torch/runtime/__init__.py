"""fxtpu_torch.runtime — host-side concurrency & buffering (the reference's
L4 layer, ``effex/effex.py:105-110,420-474,630-664``): a copy
of ``fxtpu.runtime`` without its JAX package import, plus a
``torch.profiler`` hook in place of ``jax.profiler``."""

from fxtpu_torch.runtime.ringbuffer import RingBuffer, BufferFull, BufferClosed
from fxtpu_torch.runtime.feeder import Feeder, BlockAligner

__all__ = ["RingBuffer", "BufferFull", "BufferClosed", "Feeder", "BlockAligner"]
