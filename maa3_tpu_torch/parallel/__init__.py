"""Data, FSDP, tensor, pipeline and expert parallelism on torch.distributed
(counterpart of maa3_tpu/parallel/): `mesh` (the DeviceMesh over torchrun's
process group, with "data", "model", "pipe" and "expert" dims, the parameter
placements and owners, sharding and gathering of state), `tp` (Megatron's
collectives as autograd functions, sequence parallelism, the MoE's expert
group), `fsdp` (ZeRO-3 over the data group) and `pipeline` (GPipe over the
pipe group). One process per GPU, launched by torchrun."""
