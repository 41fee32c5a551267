"""Multi-process training and serving of the PyTorch port over
``torch.distributed``: the process group (`distributed`), the (data, fsdp,
model) mesh (`mesh`), the ZeRO-3 and tensor-parallel sharding rules (`sharding`), the
``model`` axis's collectives (`tensor`) and the lockstep of a
tensor-parallel server's ranks (`lockstep`), the counterparts of
``valley_tpu/parallel/``.  Training on the ``model`` axis is not ported
yet."""
