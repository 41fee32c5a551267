"""Host-side data pipeline of the PyTorch port: numpy copies of
``valley_tpu/data`` (conversation preprocessing, the supervised dataset,
collator and loaders, video decoding and clip transforms)."""
