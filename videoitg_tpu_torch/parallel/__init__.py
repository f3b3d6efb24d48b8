"""Multi-device serving: the device mesh, tensor, sequence-ring and pipeline
parallelism (counterpart of videoitg_tpu/parallel/). One process per device,
SPMD, plain local tensors and explicit torch.distributed collectives."""
