"""Multi-GPU serving and training on ``torch.distributed`` (counterpart of
``lemas_tts_tpu/parallel/``): process-group set-up (``distributed``), the
device mesh, the data-parallel sampler and the training plans (``mesh``),
tensor parallelism of the DiT's training route (``tensor``), the
sequence-parallel sampler (``sequence``) and pipeline parallelism
(``pipeline``)."""
