"""The serving stack of the PyTorch port: the model worker, the controller,
the JSON-over-HTTP server they speak through, the OpenAI-compatible
routes, the dynamic batcher, the device-memory budget and the chat CLI
(the counterparts of ``valley_tpu/serve``)."""
