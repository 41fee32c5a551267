"""Multi-process training of the PyTorch port over ``torch.distributed``:
the process group (`distributed`), the (data, fsdp, model) mesh (`mesh`)
and the ZeRO-3 sharding rules and collectives (`sharding`), the
counterparts of ``valley_tpu/parallel/``.  The ``model`` axis (tensor
parallelism) is not ported yet."""
