"""Model harnesses of the port (counterpart of bigdl_tpu/models/utils):
the synthetic-data throughput CLIs (``perf``, ``local_optimizer_perf``,
``distri_optimizer_perf``) and the real-data train and evaluate loop over
an image folder (``real_data``)."""
