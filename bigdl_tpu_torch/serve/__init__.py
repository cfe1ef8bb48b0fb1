"""Serving stack of the port (counterpart of bigdl_tpu/serve): the
continuous decoder, its page pool and prefix cache, streaming futures
and the sampler (``serve.sampling``).

``ContinuousDecoder(mesh=)`` / ``continuous_decode(mesh=)`` serve tensor
parallel over a mesh's ``model`` axis (``parallel.hybrid_mesh(dp,
mp)``), SPMD: every rank of the axis builds the decoder on the same
weights and submits the same requests in the same order; each holds its
heads' weights and KV pools, sums each branch over the axis, and its
futures resolve to the same rows.  A boundary whose admissions part
across the ranks raises :class:`ReplicaMismatchError` on every rank."""
from bigdl_tpu_torch.serve.decode import (ContinuousDecoder,
                                          ReplicaMismatchError,
                                          continuous_decode)
from bigdl_tpu_torch.serve.paging import PagePool, RequestTooLongError
from bigdl_tpu_torch.serve.prefix import PrefixCache, chain_keys
from bigdl_tpu_torch.serve.sampling import GREEDY, SamplingParams
from bigdl_tpu_torch.serve.streaming import (SafeFuture, StreamFuture,
                                             TokenDelivery)

__all__ = ["ContinuousDecoder", "GREEDY", "PagePool", "PrefixCache",
           "ReplicaMismatchError", "RequestTooLongError", "SafeFuture",
           "SamplingParams",
           "StreamFuture", "TokenDelivery", "chain_keys",
           "continuous_decode"]
