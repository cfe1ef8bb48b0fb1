"""Serving stack of the port (counterpart of bigdl_tpu/serve)."""
from bigdl_tpu_torch.serve.decode import ContinuousDecoder, continuous_decode
from bigdl_tpu_torch.serve.paging import PagePool, RequestTooLongError

__all__ = ["ContinuousDecoder", "PagePool", "RequestTooLongError",
           "continuous_decode"]
