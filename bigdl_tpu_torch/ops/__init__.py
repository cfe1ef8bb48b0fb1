"""Hand-written Hopper kernels of the port (counterpart of
bigdl_tpu/ops/pallas_kernels.py), each beside its plain PyTorch version.

``KERNELS`` lists every kernel wrapper; each carries a ``launches`` count
that only a real kernel launch increments.  ``Act`` describes the
element-wise activation the RNN kernels apply.
"""
from bigdl_tpu_torch.ops._activation import Act
from bigdl_tpu_torch.ops.bilstm import (bilstm_backward,
                                        bilstm_backward_reference, bilstm_dwh,
                                        bilstm_dwh_reference, bilstm_forward,
                                        bilstm_forward_reference,
                                        bilstm_recurrence)
from bigdl_tpu_torch.ops.gru import (gru_backward, gru_backward_reference,
                                     gru_dwh, gru_dwh_reference, gru_forward,
                                     gru_forward_reference, gru_recurrence)
from bigdl_tpu_torch.ops.lrn import (lrn_backward, lrn_backward_reference,
                                     lrn_channel, lrn_forward,
                                     lrn_forward_reference)
from bigdl_tpu_torch.ops.lstm_scan import lstm_scan, lstm_scan_reference
from bigdl_tpu_torch.ops.maxpool import (maxpool2d, maxpool2d_backward,
                                         maxpool2d_backward_reference,
                                         maxpool2d_forward,
                                         maxpool2d_forward_reference)
from bigdl_tpu_torch.ops.maxpool_s1 import (maxpool2d_s1,
                                            maxpool2d_s1_backward,
                                            maxpool2d_s1_backward_reference,
                                            maxpool2d_s1_forward,
                                            maxpool2d_s1_forward_reference)
from bigdl_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_int8, paged_attention_int8_reference,
    paged_attention_reference)
from bigdl_tpu_torch.ops.rnn import (rnn_backward, rnn_backward_reference,
                                     rnn_dwh, rnn_dwh_reference, rnn_forward,
                                     rnn_forward_reference, rnn_recurrence)
from bigdl_tpu_torch.ops.sgd import fused_sgd, fused_sgd_reference

KERNELS = (paged_attention, paged_attention_int8, fused_sgd,
           maxpool2d_forward, maxpool2d_backward, maxpool2d_s1_forward,
           maxpool2d_s1_backward, lrn_forward,
           lrn_backward, bilstm_forward, bilstm_backward, bilstm_dwh,
           rnn_forward, rnn_backward, rnn_dwh, gru_forward, gru_backward,
           gru_dwh, lstm_scan)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = ["Act", "KERNELS", "bilstm_backward", "bilstm_backward_reference",
           "bilstm_dwh", "bilstm_dwh_reference", "bilstm_forward",
           "bilstm_forward_reference", "bilstm_recurrence", "fused_sgd",
           "fused_sgd_reference", "gru_backward", "gru_backward_reference",
           "gru_dwh", "gru_dwh_reference", "gru_forward",
           "gru_forward_reference", "gru_recurrence", "launch_counts",
           "lrn_backward", "lrn_backward_reference", "lrn_channel",
           "lrn_forward", "lrn_forward_reference", "lstm_scan",
           "lstm_scan_reference",
           "maxpool2d", "maxpool2d_backward", "maxpool2d_backward_reference",
           "maxpool2d_forward", "maxpool2d_forward_reference",
           "maxpool2d_s1", "maxpool2d_s1_backward",
           "maxpool2d_s1_backward_reference", "maxpool2d_s1_forward",
           "maxpool2d_s1_forward_reference",
           "paged_attention", "paged_attention_int8",
           "paged_attention_int8_reference", "paged_attention_reference",
           "reset_launch_counts", "rnn_backward", "rnn_backward_reference",
           "rnn_dwh", "rnn_dwh_reference", "rnn_forward",
           "rnn_forward_reference", "rnn_recurrence"]
