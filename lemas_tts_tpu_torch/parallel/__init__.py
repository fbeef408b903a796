"""Multi-GPU serving on ``torch.distributed`` (counterpart of
``lemas_tts_tpu/parallel/``): process-group set-up (``distributed``), the
device mesh and the data-parallel sampler (``mesh``) and the
sequence-parallel sampler (``sequence``). Training parallelism (the JAX
package's DP/FSDP specs and ``pipeline.py``) is not ported yet."""
