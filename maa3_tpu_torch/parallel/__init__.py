"""Data, FSDP and tensor parallelism on torch.distributed (counterpart of
maa3_tpu/parallel/): `mesh` (the ("data", "model") DeviceMesh, the
parameter placements, sharding and gathering of state), `tp` (Megatron's
collectives as autograd functions, sequence parallelism) and `fsdp` (ZeRO-3
over the data group). One process per GPU, launched by torchrun."""
