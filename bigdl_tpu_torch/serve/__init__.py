"""Serving stack of the port (counterpart of bigdl_tpu/serve): the
continuous decoder, its page pool and prefix cache, streaming futures
and the sampler (``serve.sampling``)."""
from bigdl_tpu_torch.serve.decode import ContinuousDecoder, continuous_decode
from bigdl_tpu_torch.serve.paging import PagePool, RequestTooLongError
from bigdl_tpu_torch.serve.prefix import PrefixCache, chain_keys
from bigdl_tpu_torch.serve.sampling import GREEDY, SamplingParams
from bigdl_tpu_torch.serve.streaming import (SafeFuture, StreamFuture,
                                             TokenDelivery)

__all__ = ["ContinuousDecoder", "GREEDY", "PagePool", "PrefixCache",
           "RequestTooLongError", "SafeFuture", "SamplingParams",
           "StreamFuture", "TokenDelivery", "chain_keys",
           "continuous_decode"]
